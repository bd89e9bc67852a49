"""The whole slice: the port's HandNet against the JAX HandNet on the same
weights, plus the weights round trip through the JAX package's unchanged
torch importer.

Contact config (bench.py:110-116), ResNet-18, 64 px uint8 frames, B=2,
both sides, ``no_loss=True, force_hand=True, force_objects=True``.
Tolerances: verts/joints atol 1e-2 mm; objpoints3d/objtrans/objscale atol
2e-2; ``min_dists`` rtol 1e-4, atol 1e-2 mm^2. The contact masks are held
exactly by recomputing the JAX ``compute_contact_loss`` on the port's own
output floats: tiny float differences in the verts can legitimately flip
a near-surface parity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obman_train_tpu.assets import synthetic_mano_assets as jax_synthetic
from obman_train_tpu.config import AtlasConfig as JAtlas
from obman_train_tpu.config import ContactConfig as JContact
from obman_train_tpu.config import ManoConfig as JMano
from obman_train_tpu.config import ModelConfig as JModel
from obman_train_tpu.models import BatchSpec as JSpec
from obman_train_tpu.models import build_handnet as jax_build
from obman_train_tpu.models import mano_params_from_assets
from obman_train_tpu.ops.contact import compute_contact_loss as jax_contact
from obman_train_tpu.train.checkpoint import import_torch_handnet
from obman_train_tpu_torch import config as tcfg
from obman_train_tpu_torch.assets import synthetic_mano_assets
from obman_train_tpu_torch.infer import make_infer
from obman_train_tpu_torch.models import INFER_SPEC, BatchSpec, build_handnet
from obman_train_tpu_torch.weights import init_weights, state_dict_from_jax

torch.set_num_threads(2)

JAX_SPEC = JSpec(has_joints3d=False, has_verts3d=False, has_objpoints3d=False,
                 has_camintrs=False, has_center3d=False)
INFER_KW = dict(no_loss=True, force_hand=True, force_objects=True)

CONTACT = dict(atlas=dict(predict_trans=True, predict_scale=True),
               contact=dict(contact_lambda=0.167, collision_lambda=0.167))
# every head the importer knows, for the key round trip
RICH = dict(
    fc_dropout=0.2, absolute_lambda=1.0,
    mano=dict(lambda_joints2d=1.0, use_shape=True, use_trans=True,
              adapt_skeleton=True),
    atlas=dict(predict_trans=True, predict_scale=True, use_residual=True,
               adapt_decoder=True, separate_encoder=True),
)


def _configs(spec):
    j = JModel(**{k: v for k, v in spec.items() if not isinstance(v, dict)},
               mano=JMano(**spec.get("mano", {})), atlas=JAtlas(**spec.get("atlas", {})),
               contact=JContact(**spec.get("contact", {})))
    t = tcfg.ModelConfig(
        **{k: v for k, v in spec.items() if not isinstance(v, dict)},
        mano=tcfg.ManoConfig(**spec.get("mano", {})),
        atlas=tcfg.AtlasConfig(**spec.get("atlas", {})),
        contact=tcfg.ContactConfig(**spec.get("contact", {})),
    )
    return j, t


def _randomize_stats(variables, seed):
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (
            rng.normal(0, 0.1, v.shape) if path[-1].key == "mean"
            else rng.uniform(0.5, 1.5, v.shape)
        ).astype(np.float32),
        variables["batch_stats"],
    )
    return {"params": jax.tree_util.tree_map(np.asarray, variables["params"]),
            "batch_stats": stats}


CAM_FIELDS = dict(has_joints3d=False, has_verts3d=False, has_objpoints3d=False,
                  has_camintrs=True, has_center3d=True)


def _pair(spec, B, S, seed, jspec=JAX_SPEC):
    """JAX net + variables, the port net loaded with the same weights, and
    a uint8 batch (with camera intrinsics when ``jspec`` has them)."""
    jcfg, pcfg = _configs(spec)
    jnet = jax_build(jcfg, mano_params_from_assets(jax_synthetic("right")),
                     mano_params_from_assets(jax_synthetic("left")))
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (B, S, S, 3)).astype(np.uint8)
    sides = (np.arange(B) % 2).astype(np.int32)
    batch = {"images": frames, "sides": sides}
    if jspec.has_camintrs:
        batch["camintrs"] = np.tile(
            np.array([[480.0, 0, 128], [0, 480.0, 128], [0, 0, 1]], np.float32), (B, 1, 1)
        ) + rng.normal(0, 1.0, (B, 3, 3)).astype(np.float32)
    init = jax.jit(lambda rngs, b: jnet.init(rngs, b, jspec, **INFER_KW))
    variables = _randomize_stats(
        init({"params": jax.random.PRNGKey(seed), "points": jax.random.PRNGKey(1)},
             batch), seed)
    pnet = build_handnet(pcfg, synthetic_mano_assets("right"),
                         synthetic_mano_assets("left"), device="cpu")
    pnet.load_state_dict(state_dict_from_jax(variables, dropout=pcfg.fc_dropout),
                         strict=True)
    return jnet, variables, pnet, batch


def _jax_results(jnet, variables, batch, jspec=JAX_SPEC):
    apply = jax.jit(lambda v, b: jnet.apply(v, b, jspec, **INFER_KW)[1])
    return apply(variables, batch)


@pytest.fixture(scope="module")
def contact_slice():
    jnet, variables, pnet, batch = _pair(CONTACT, 2, 64, 0)
    want = _jax_results(jnet, variables, batch)
    got = make_infer(pnet)(batch["images"], batch["sides"])
    with torch.no_grad():
        _, full, _ = pnet({k: torch.from_numpy(v) for k, v in batch.items()},
                          INFER_SPEC, **INFER_KW)
    return variables, want, got, full


def test_slice_outputs_match_jax(contact_slice):
    _, want, got, full = contact_slice
    assert set(got) == {"verts", "joints", "objpoints3d", "contact_info"}
    assert got["verts"].shape == (2, 778, 3) and got["joints"].shape == (2, 21, 3)
    assert got["objpoints3d"].shape == (2, 642, 3)
    for key in ("verts", "joints"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-2,
                                   err_msg=key)
    for key in ("objpoints3d", "objtrans", "objscale", "objpointscentered3d"):
        np.testing.assert_allclose(full[key].numpy(), np.asarray(want[key]), atol=2e-2,
                                   err_msg=key)
    for key in ("pose",):
        np.testing.assert_allclose(full[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4)


def test_slice_contact_info_matches_jax(contact_slice):
    _, want, got, _ = contact_slice
    info, jinfo = got["contact_info"], want["contact_info"]
    assert set(info) == set(jinfo) == {
        "attraction_masks", "repulsion_masks", "contact_points", "min_dists"}
    np.testing.assert_allclose(info["min_dists"].numpy(), np.asarray(jinfo["min_dists"]),
                               rtol=1e-4, atol=1e-2)
    # masks exactly, recomputed by JAX on the port's own output floats
    c = tcfg.ContactConfig(contact_lambda=0.167, collision_lambda=0.167)
    _, _, rinfo, _ = jax_contact(
        jnp.asarray(got["verts"].numpy()), jnp.asarray(got["objpoints3d"].numpy()),
        jnp.asarray(_faces()),
        contact_thresh=c.contact_thresh, contact_mode=c.contact_mode,
        collision_thresh=c.collision_thresh, collision_mode=c.collision_mode,
        contact_target=c.contact_target, contact_sym=c.contact_sym,
        contact_zones=c.contact_zones,
    )
    for key in ("attraction_masks", "repulsion_masks"):
        assert info[key].dtype == torch.bool and info[key].shape == (2, 778)
        np.testing.assert_array_equal(info[key].numpy(), np.asarray(rinfo[key]),
                                      err_msg=key)
    np.testing.assert_allclose(info["min_dists"].numpy(), np.asarray(rinfo["min_dists"]),
                               rtol=1e-4, atol=1e-2)


def _faces():
    from obman_train_tpu_torch.assets import icosphere

    return np.array(icosphere(3)[1])


def test_weights_round_trip_through_jax_importer(contact_slice):
    """JAX init -> state_dict_from_jax -> the JAX package's unchanged
    import_torch_handnet gives back the original arrays exactly: the port's
    keys are the reference torch names that release checkpoints use."""
    variables = contact_slice[0]
    _assert_round_trip(variables, 0.0)


def _assert_round_trip(variables, dropout):
    sd = state_dict_from_jax(variables, dropout=dropout)
    back = import_torch_handnet({k: v.numpy() for k, v in sd.items()}, variables)
    for col in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(variables[col])
        got = dict(jax.tree_util.tree_leaves_with_path(back[col]))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                          err_msg=jax.tree_util.keystr(path))


def test_rich_config_round_trip_and_forward():
    """Every head the importer maps (absolute/scaletrans, shape/trans,
    skeleton, residual decoder, adapter, separate encoder, dropout-shifted
    MLP indices) round-trips, loads strictly and matches the JAX forward."""
    jspec = JSpec(**CAM_FIELDS)
    jnet, variables, pnet, batch = _pair(RICH, 2, 32, 1, jspec)
    _assert_round_trip(variables, RICH["fc_dropout"])
    want = _jax_results(jnet, variables, batch, jspec)
    with torch.no_grad():
        _, got, _ = pnet({k: torch.from_numpy(v) for k, v in batch.items()},
                         BatchSpec(**CAM_FIELDS), **INFER_KW)
    assert "contact_info" not in got
    for key in ("verts", "joints"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-2)
    for key in ("objpoints3d", "objtrans", "objscale"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-2)
    for key in ("shape", "trans", "center3d"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["joints2d"].numpy(), np.asarray(want["joints2d"]),
                               atol=2e-2)


def test_loss_path_and_training_mode_raise():
    """The loss path runs (``no_loss=False`` gives a finite total and the
    loss dict; its parity with JAX is tests/test_torch_losses.py), and so
    does training mode (``net.train()``, the JAX ``train=True``; its parity
    is tests/test_torch_train_bn.py): BN folds the batch statistics into
    the running ones, which ``eval()`` then reads."""
    _, pcfg = _configs(CONTACT)
    net = build_handnet(pcfg, synthetic_mano_assets("right"),
                        synthetic_mano_assets("left"), device="cpu")
    rng = np.random.default_rng(0)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)),
             "sides": torch.zeros((2,), dtype=torch.int32),
             "joints3d": torch.from_numpy(rng.normal(0, 30, (2, 21, 3)).astype(np.float32)),
             "verts3d": torch.from_numpy(rng.normal(0, 30, (2, 778, 3)).astype(np.float32)),
             "objpoints3d": torch.from_numpy(rng.normal(0, 50, (2, 600, 3)).astype(np.float32))}
    with torch.no_grad():
        total, _, losses = net(batch, BatchSpec(), no_loss=False)
    assert torch.isfinite(total) and losses["total_loss"] is total
    stats = {k: v.clone() for k, v in net.state_dict().items() if "running" in k}
    net.train()
    for no_loss in (False, True):
        with torch.no_grad():
            total_t, res, _ = net(batch, BatchSpec(), no_loss=no_loss)
        assert res["verts"].shape == (2, 778, 3)
        assert no_loss or (torch.isfinite(total_t) and float(total_t) != float(total))
    moved = [k for k, v in net.state_dict().items() if k in stats and not torch.equal(v, stats[k])]
    assert len(moved) == len(stats)  # every running statistic, encoder and decoder
    assert int(net.base_net.bn1.num_batches_tracked) == 2
    net.eval()
    with torch.no_grad():
        total_e, _, _ = net(batch, BatchSpec(), no_loss=False)
    assert float(total_e) != float(total)  # eval reads the updated statistics


def test_unported_dtypes_raise():
    """bf16, the geometry rungs and the random cloud build since they were
    ported (parity: test_torch_bf16.py, test_torch_geometry_dtype.py,
    test_torch_random_cloud.py); names neither package knows raise."""
    net = build_handnet(
        tcfg.ModelConfig(compute_dtype="bfloat16", geometry_dtype="bfloat16",
                         atlas=tcfg.AtlasConfig(mesh=False)),
        synthetic_mano_assets("right"), synthetic_mano_assets("left"), device="cpu")
    layers = [m for m in net.modules() if hasattr(m, "compute_dtype")]
    assert len(layers) > 40 and {m.compute_dtype for m in layers} == {torch.bfloat16}
    assert net.plane_dtype == torch.bfloat16 and net.atlas_branch.points_nb == 600
    assert {p.dtype for p in net.parameters()} == {torch.float32}
    for bad in (dict(compute_dtype="float16"), dict(geometry_dtype="float16")):
        with pytest.raises(ValueError):
            build_handnet(tcfg.ModelConfig(**bad), synthetic_mano_assets("right"),
                          synthetic_mano_assets("left"), device="cpu")


def test_entry_points_default_to_cuda():
    """Without a GPU the default device raises; device='cpu' is explicit."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    from obman_train_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        build_handnet(tcfg.ModelConfig(), synthetic_mano_assets("right"),
                      synthetic_mano_assets("left"))
    assert resolve_device("cpu").type == "cpu"


def test_seeded_init_is_deterministic():
    nets = [
        init_weights(build_handnet(tcfg.ModelConfig(), synthetic_mano_assets("right"),
                                   synthetic_mano_assets("left"), device="cpu"), seed=3)
        for _ in range(2)
    ]
    a, b = (n.state_dict() for n in nets)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
