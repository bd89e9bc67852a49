"""A bf16 experiment end to end on the CPU, 64 px: ``cli.traineval
--compute_dtype bfloat16`` with the contact flags trains one epoch;
``DemoModel`` reloads it and serves it in bf16 (its attention-map encoder
too, JAX demo/inference.py:101-109); ``cli.export --smoke`` exports it and
the exported program equals the live one; ``state_dict_from_jax`` takes a
bf16 JAX net's variables unchanged (flax keeps them float32).

Tolerances: the reloaded net equals the trained one bit for bit, and the
demo path equals the net's own forward bit for bit. Exported against
live: ``EXPORT_RTOL`` relative (the float32 bound of
``tests/test_torch_export.py`` is atol 2e-3; a bf16 output is held to its
own resolution instead, one bf16 ulp, 2^-7 relative), float32 outputs to
the float32 bound.
"""

import io
import zipfile

import jax
import numpy as np
import pytest
import torch

from obman_train_tpu.assets import synthetic_mano_assets as jax_synthetic
from obman_train_tpu.config import ModelConfig as JModel
from obman_train_tpu.models import BatchSpec as JSpec
from obman_train_tpu.models import build_handnet as jax_build
from obman_train_tpu.models import mano_params_from_assets
from obman_train_tpu_torch.assets import synthetic_mano_assets
from obman_train_tpu_torch.config import ModelConfig
from obman_train_tpu_torch.demo import DemoModel
from obman_train_tpu_torch.demo.export import load_exported
from obman_train_tpu_torch.models import INFER_SPEC, build_handnet
from obman_train_tpu_torch.ops.image import preprocess_frames
from obman_train_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(2)

SIZE = 64
EXPORT_RTOL = 2.0 ** -7


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    from obman_train_tpu_torch.cli import traineval

    exp = str(tmp_path_factory.mktemp("bf16") / "run")
    mp = pytest.MonkeyPatch()
    mp.setenv("OBMAN_PLATFORM", "cpu")
    try:
        state, _ = traineval.main([
            "--train_datasets", "synthetic", "--val_datasets", "synthetic", "--mano_assets",
            "synthetic", "--synthetic_size", "8", "--image_size", str(SIZE), "--train_batch",
            "4", "--test_batch", "4", "--workers", "2", "--display_freq", "0", "--epochs",
            "1", "--atlas_predict_trans", "--atlas_predict_scale", "--contact_lambda",
            "0.167", "--collision_lambda", "0.167", "--compute_dtype", "bfloat16",
            "--exp_id", exp])
    finally:
        mp.undo()
    return exp, state


def _frames(seed, B=2, H=72, W=90):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8))


def test_demo_model_serves_a_bf16_experiment(experiment):
    exp, state = experiment
    model = DemoModel(exp_dir=exp, device="cpu")
    assert model.cfg.model.compute_dtype == "bfloat16" and model.epoch == 1
    for name, want in state.net.state_dict().items():
        assert torch.equal(model.net.state_dict()[name], want), name
    assert model.net.base_net.conv1.compute_dtype == torch.bfloat16
    frames = _frames(3)
    sides, flip = torch.tensor([1, 0], dtype=torch.int32), torch.tensor([True, False])
    got = model._infer(model._variables, frames, sides, flip)
    assert got["verts"].dtype == torch.float32 and got["objpoints3d"].dtype == torch.bfloat16
    with torch.no_grad():
        _, want, _ = state.net(
            {"images": preprocess_frames(frames.to(torch.float32), size=SIZE, flip=flip),
             "sides": sides}, INFER_SPEC, no_loss=True, force_hand=True, force_objects=True)
    assert all(torch.equal(got[k], want[k]) for k in got)
    # the host copy: numpy has no bf16, so bf16 outputs arrive as float32
    out = model.predict(frames[0].numpy(), hand_side="right")
    assert out["objpoints3d"].dtype == np.float32 and out["verts"].shape == (1, 778, 3)
    assert np.isfinite(out["objpoints3d"]).all()
    # the attention maps run the experiment's bf16 encoder
    with torch.no_grad():
        _, inters = model.net.base_net(
            preprocess_frames(frames.to(torch.float32), size=SIZE).permute(0, 3, 1, 2),
            return_inter=True)
    assert {t.dtype for t in inters} == {torch.bfloat16}
    maps = model.attention_maps(frames.numpy())
    assert maps.shape == (2, SIZE, SIZE) and np.isfinite(maps).all()


def test_export_of_a_bf16_experiment_equals_live(experiment, tmp_path, monkeypatch, capsys):
    from obman_train_tpu_torch.cli import export as cli_export

    exp, _ = experiment
    monkeypatch.setenv("OBMAN_PLATFORM", "cpu")
    out = str(tmp_path / "bf16.pt2")
    cli_export.main(["--resume", exp, "--out", out, "--smoke", "--platforms", "cpu"])
    assert "smoke OK" in capsys.readouterr().out
    serve = load_exported(out)
    model = DemoModel(exp_dir=exp, device="cpu")
    for B in (1, 3):
        frames = _frames(B, B=B, H=SIZE, W=SIZE)
        sides = torch.from_numpy((np.arange(B) % 2).astype(np.int32))
        flip = torch.from_numpy(np.arange(B) % 2 == 0)
        got = serve(frames, sides, flip)
        live = model._infer(model._variables, frames, sides, flip)
        assert sorted(got) == sorted(live)
        for k in live:
            assert got[k].dtype == live[k].dtype, k
            if live[k].dtype == torch.bfloat16:
                torch.testing.assert_close(got[k].float(), live[k].float(), rtol=EXPORT_RTOL,
                                           atol=0.0, msg=k)
            else:
                torch.testing.assert_close(got[k], live[k], rtol=1e-5, atol=2e-3, msg=k)
    # the program carries the casts on float32 weights
    program = torch.export.load(io.BytesIO(zipfile.ZipFile(out).read("cpu.pt2")))
    consts = list(program.state_dict.values()) + list(program.constants.values())
    assert {t.dtype for t in consts if t.is_floating_point()} == {torch.float32}


def test_state_dict_from_jax_takes_bf16_variables():
    """flax keeps a bf16 net's parameters float32, so its variables are a
    float32 net's: the same keys and values."""
    jnets = [jax_build(JModel(compute_dtype=dt), mano_params_from_assets(jax_synthetic("right")),
                       mano_params_from_assets(jax_synthetic("left")))
             for dt in ("bfloat16", "float32")]
    batch = {"images": np.zeros((1, SIZE, SIZE, 3), np.uint8),
             "sides": np.zeros((1,), np.int32)}
    spec = JSpec(has_joints3d=False, has_verts3d=False, has_objpoints3d=False)
    kw = dict(no_loss=True, force_hand=True, force_objects=True)
    variables = [jax.jit(lambda b, n=n: n.init({"params": jax.random.PRNGKey(0),
                                                  "points": jax.random.PRNGKey(1)},
                                                 b, spec, **kw))(batch) for n in jnets]
    leaves = jax.tree_util.tree_leaves(variables[0])
    assert {str(v.dtype) for v in leaves} == {"float32"}
    sd16, sd32 = (state_dict_from_jax(v) for v in variables)
    assert set(sd16) == set(sd32)
    assert all(torch.equal(sd16[k], sd32[k]) for k in sd32)
    net = build_handnet(ModelConfig(compute_dtype="bfloat16"), synthetic_mano_assets("right"),
                        synthetic_mano_assets("left"), device="cpu")
    net.load_state_dict(sd16, strict=True)
