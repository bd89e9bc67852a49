"""The random-cloud AtlasNet decoder (``atlas.mesh=False``, the port's
``AtlasBranch.forward``; JAX models/branches.py:312-328, handnet.py:246-260)
against the JAX package on the CPU.

The ``jax.random`` stream cannot be reproduced, so the sphere points are
drawn in the test: normal draws by ``jax.random``, handed to the JAX
decoder in place of its own draw (``jax.random.normal`` patched for the
call) and, normalised onto the sphere by JAX, injected into the port
(``points=``). Tolerances: float32, rtol 1e-5 / atol 1e-3 mm (per-point
float32 products of the same inputs; the f32 bound of
``tests/test_torch_encoder_branches.py``); bf16, within a tenth of JAX's own
bf16-vs-float32 gap on the same points (``tests/test_torch_bf16.py``'s
``HEADS_FACTOR``); the whole HandNet with its losses, float32, each loss to
rtol 1e-4 (``tests/test_torch_losses.py``'s bound). The port's own draws
are unit vectors from its generator, a function of the seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obman_train_tpu.models import BatchSpec as JSpec
from obman_train_tpu_torch.models import BatchSpec
from tests.test_torch_bf16 import HEADS_FACTOR, _f, _nets, _rel, _strict
from tests.test_torch_handnet import _configs
from tests.test_torch_losses import loss_pair

torch.set_num_threads(2)

# the CLI's default edge regularizer: on the cloud it reads the icosphere's
# faces, out-of-range indices clamped as jnp's gather clamps them
CLOUD = dict(atlas=dict(predict_trans=True, mesh=False, lambda_regul_edges=0.167))


@pytest.fixture(scope="module")
def cloud():
    jnet, variables, pnet, batch = loss_pair(CLOUD, 2, 64, 0)
    return jnet, variables, pnet, batch


def _draw(B, N, dtype, seed=5):
    raw = jax.random.normal(jax.random.PRNGKey(seed), (B, N, 3), dtype)
    pts = raw / jnp.sqrt(jnp.sum(raw ** 2, axis=-1, keepdims=True) + 1e-12)
    return raw, pts


def _jax_decoder(jnet, variables, feats, raw, monkeypatch):
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype: raw.astype(dtype))
    try:
        return _strict(lambda v, f: jnet.apply(v, f, method=lambda m, x: m.atlas_branch(x),
                                               rngs={"points": jax.random.PRNGKey(0)}),
                       variables, feats)
    finally:
        monkeypatch.undo()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_random_cloud_decoder_matches_jax_on_injected_points(cloud, dtype, monkeypatch):
    jnet32, variables, _, _ = cloud
    spec = dict(CLOUD, compute_dtype=dtype)
    jnet, pnet = _nets(spec, variables)
    jdt = jnp.dtype(dtype)
    feats = np.random.default_rng(1).normal(0, 1, (2, 512)).astype(np.float32)
    raw, pts = _draw(2, 600, jdt)
    want = _jax_decoder(jnet, variables, jnp.asarray(feats), raw, monkeypatch)
    with torch.no_grad():
        got = pnet.atlas_branch(torch.from_numpy(feats),
                                points=torch.from_numpy(_f(pts)).to(getattr(torch, dtype)))
    assert set(got) == set(want) == {"objpoints3d", "objtrans", "objpointscentered3d"}
    for k in want:
        assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name, k
        if dtype == "float32":
            np.testing.assert_allclose(_f(got[k]), _f(want[k]), rtol=1e-5, atol=1e-3,
                                       err_msg=k)
        else:
            want32 = _jax_decoder(jnet32, variables, jnp.asarray(feats), raw, monkeypatch)
            gap = _rel(_f(want[k]), _f(want32[k]))
            assert _rel(_f(got[k]), _f(want[k])) <= HEADS_FACTOR * gap, k


def test_random_cloud_handnet_losses_match_jax(cloud, monkeypatch):
    jnet, variables, pnet, batch = cloud
    raw, pts = _draw(2, 600, jnp.float32, seed=7)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype: raw)
    jtotal, _, jl = jax.jit(lambda v, b: jnet.apply(
        v, b, JSpec(), rngs={"points": jax.random.PRNGKey(0)}))(variables, batch)
    monkeypatch.undo()
    branch = pnet.atlas_branch
    monkeypatch.setattr(branch, "forward", lambda f, generator=None, points=None: type(
        branch).forward(branch, f, points=torch.from_numpy(np.asarray(pts))))
    with torch.no_grad():
        ttotal, res, tl = pnet({k: torch.from_numpy(v) for k, v in batch.items()}, BatchSpec())
    assert res["objpoints3d"].shape == (2, 600, 3) and "objfaces" not in res
    assert set(tl) == set(jl) and "atlas_edge_regul" in jl
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-4, err_msg=k)


def test_random_cloud_draws_unit_vectors_from_its_generator(cloud):
    _, _, pnet, _ = cloud
    feats = torch.zeros((2, 512))

    def cloud_of(seed):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return pnet.atlas_branch(feats, generator=gen)["objpointscentered3d"]

    assert torch.equal(cloud_of(0), cloud_of(0))
    assert not torch.equal(cloud_of(0), cloud_of(1))
    with pytest.raises(ValueError, match="Generator"):
        pnet.atlas_branch(feats)
    gen = torch.Generator().manual_seed(0)
    rand = torch.randn((2, 600, 3), generator=gen)
    unit = rand / torch.sqrt(torch.sum(rand ** 2, dim=-1, keepdim=True) + 1e-12)
    with torch.no_grad():
        got = pnet.atlas_branch(feats, points=unit)["objpointscentered3d"]
    assert torch.equal(got, cloud_of(0))
    torch.testing.assert_close(unit.norm(dim=-1), torch.ones(2, 600))


def test_random_cloud_refuses_the_contact_block():
    """The contact terms read the icosphere's faces; the cloud has none."""
    from obman_train_tpu_torch.assets import synthetic_mano_assets
    from obman_train_tpu_torch.models import build_handnet

    _, pcfg = _configs(dict(CLOUD, contact=dict(contact_lambda=0.167)))
    with pytest.raises(ValueError, match="icosphere"):
        build_handnet(pcfg, synthetic_mano_assets("right"), synthetic_mano_assets("left"),
                      device="cpu")


def test_random_cloud_serves_and_exports_at_a_pinned_batch(tmp_path):
    """``DemoModel`` serves a random-cloud model (the points of seed 0, as
    the JAX eval step's ``PRNGKey(0)``); the export wants a pinned batch
    and then equals live bit for bit."""
    from obman_train_tpu_torch.config import AtlasConfig, ExperimentConfig, ModelConfig
    from obman_train_tpu_torch.demo import DemoModel
    from obman_train_tpu_torch.demo.export import export_model, load_exported

    cfg = ExperimentConfig(mano_assets="synthetic", model=ModelConfig(
        image_size=64, atlas=AtlasConfig(predict_trans=True, mesh=False)))
    model = DemoModel(config=cfg, device="cpu")
    out = model.predict(np.zeros((64, 64, 3), np.uint8))
    assert out["objpoints3d"].shape == (1, 600, 3) and np.isfinite(out["objpoints3d"]).all()
    with pytest.raises(ValueError, match="batch_size"):
        export_model(model, str(tmp_path / "x.pt2"))
    path = str(tmp_path / "cloud.pt2")
    export_model(model, path, batch_size=2)
    rng = np.random.default_rng(0)
    args = (torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)),
            torch.tensor([0, 1], dtype=torch.int32), torch.tensor([False, True]))
    got, live = load_exported(path)(*args), model._infer(model._variables, *args)
    assert sorted(got) == sorted(live)
    assert all(torch.equal(got[k], live[k]) for k in live)
