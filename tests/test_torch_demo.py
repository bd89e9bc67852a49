"""The port's ``DemoModel`` and attention maps against the JAX package's, on
the CPU at 64 px, the JAX model's weights carried over with
``weights.state_dict_from_jax`` (BN statistics randomised so that they
matter).

- ``predict`` / ``predict_dual`` / ``attention_maps`` on frames that are
  cropped and shrunk, enlarged, or kept: the JAX key set, values to 1e-4
  (rtol and atol, BASELINE.json's output tolerance; measured 1.1e-4 mm
  absolute at ~77 mm); attention to 1e-5.
- A contact-config ``DemoModel`` returns the same keys and values, never
  enters the contact block, and its outputs equal the full ``HandNet``
  forward on the same preprocessed batch bit for bit.
- ``DemoModel(exp_dir=...)`` reloads a port ``cli.traineval`` run and
  reproduces its model's forward exactly.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from obman_train_tpu.config import AtlasConfig as JAtlas
from obman_train_tpu.config import ExperimentConfig as JExperiment
from obman_train_tpu.config import ModelConfig as JModel
from obman_train_tpu.demo import DemoModel as JDemoModel
from obman_train_tpu.demo import attention as jattention
from obman_train_tpu_torch.config import AtlasConfig, ContactConfig, ExperimentConfig, ModelConfig
from obman_train_tpu_torch.demo import DemoModel
from obman_train_tpu_torch.demo import attention as pattention
from obman_train_tpu_torch.demo.inference import DEMO_KEYS
from obman_train_tpu_torch.models import INFER_SPEC
from obman_train_tpu_torch.ops.image import preprocess_frames
from obman_train_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(2)

SIZE = 64
TOL = dict(rtol=1e-4, atol=1e-4)
HEADS = dict(predict_trans=True, predict_scale=True)
CONTACT = dict(contact_lambda=0.167, collision_lambda=0.167)


def _randomize_stats(variables, seed):
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.normal(0, 0.1, v.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32),
        variables["batch_stats"])
    return {"params": jax.tree_util.tree_map(np.asarray, variables["params"]),
            "batch_stats": stats}


def _port_model(variables, contact=False):
    cfg = ExperimentConfig(mano_assets="synthetic", model=ModelConfig(
        atlas=AtlasConfig(**HEADS), contact=ContactConfig(**(CONTACT if contact else {}))))
    model = DemoModel(config=cfg, image_size=SIZE, device="cpu")
    model.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def models():
    jm = JDemoModel(config=JExperiment(model=JModel(atlas=JAtlas(**HEADS))),
                    mano_assets="synthetic", image_size=SIZE)
    jm._variables = _randomize_stats(jm._variables, 0)
    return jm, _port_model(jm._variables), _port_model(jm._variables, contact=True)


def _frame(seed, H, W):
    return np.random.default_rng(seed).integers(0, 256, (H, W, 3)).astype(np.uint8)


def _assert_outputs_match(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("H,W", [(96, 128), (40, 50), (64, 64)])
@pytest.mark.parametrize("side", ["left", "right"])
def test_predict_and_predict_dual_match_jax(models, H, W, side):
    jm, pm, _ = models
    frame = _frame(H * W, H, W)
    for flip in (False, True):
        out = pm.predict(frame, hand_side=side, flip=flip)
        _assert_outputs_match(out, jm.predict(frame, hand_side=side, flip=flip))
        assert out["verts"].shape == (1, 778, 3) and out["objpoints3d"].shape == (1, 642, 3)
    dual = pm.predict_dual(frame, hand_side=side)
    _assert_outputs_match(dual, jm.predict_dual(frame, hand_side=side))
    assert not np.allclose(dual["verts"][0], dual["verts"][1])


def test_attention_maps_match_jax(models):
    jm, pm, _ = models
    frames = np.stack([_frame(1, 96, 128), _frame(2, 96, 128)])
    got, want = pm.attention_maps(frames), np.asarray(jm.attention_maps(frames))
    assert got.shape == (2, SIZE, SIZE)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_stage_attention_matches_jax():
    rng = np.random.default_rng(0)
    # NHWC for the JAX package, NCHW for the port; one stage larger than
    # the frame, so the resize also shrinks
    nhwc = [rng.random(s).astype(np.float32)
            for s in ((2, 40, 40, 8), (2, 8, 8, 16), (2, 4, 4, 32), (2, 2, 2, 64))]
    want = np.asarray(jattention.stage_attention(nhwc, (32, 32)))
    got = pattention.stage_attention([torch.from_numpy(a).permute(0, 3, 1, 2) for a in nhwc],
                                     (32, 32))
    assert got.shape == (2, 32, 32) and got.min() >= 0 and got.max() <= 1 + 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_attention_overlay_matches_jax(monkeypatch):
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    att = rng.random((32, 32)).astype(np.float32)
    got = pattention.attention_overlay(frame, att)
    assert got.dtype == np.uint8 and got.shape == (32, 32, 3)
    np.testing.assert_array_equal(got, jattention.attention_overlay(frame, att))
    # without matplotlib: red for high attention, blue for low
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    plain = pattention.attention_overlay(frame, att, alpha=1.0)
    np.testing.assert_array_equal(plain[..., 0], (att * 255).astype(np.uint8))
    np.testing.assert_array_equal(plain[..., 1], 0)
    np.testing.assert_array_equal(plain[..., 2], ((1 - att) * 255).astype(np.uint8))
    np.testing.assert_array_equal(pattention.attention_overlay(frame, att),
                                  jattention.attention_overlay(frame, att))


def test_contact_config_leaves_out_the_contact_block(models, monkeypatch):
    jm, pm, cm = models
    assert cm.cfg.model.need_collisions
    frame = _frame(5, 80, 100)
    full_in = preprocess_frames(torch.from_numpy(np.stack([frame, frame])).to(torch.float32),
                                size=SIZE, flip=torch.tensor([False, True]))
    with torch.no_grad():
        _, full, _ = cm.net({"images": full_in, "sides": torch.tensor([1, 0], dtype=torch.int32)},
                            INFER_SPEC, no_loss=True, force_hand=True, force_objects=True)
    assert "contact_info" in full  # the full forward computes the block
    with pytest.raises(ValueError, match="no_loss"):
        cm.net({"images": full_in, "sides": torch.tensor([1, 0], dtype=torch.int32)},
               INFER_SPEC, contact=False)

    def no_contact(*a, **k):
        raise AssertionError("the demo path entered the contact block")

    monkeypatch.setattr("obman_train_tpu_torch.models.handnet.compute_contact_loss", no_contact)
    dual, jdual = cm.predict_dual(frame), jm.predict_dual(frame)
    assert set(dual) == set(jdual) == {k for k in DEMO_KEYS if k in full}
    _assert_outputs_match(dual, jdual)
    for k in dual:  # bit for bit: the block changes none of these
        np.testing.assert_array_equal(dual[k], full[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(dual[k], pm.predict_dual(frame)[k], err_msg=k)


def test_predict_takes_one_frame(models):
    with pytest.raises(ValueError, match="ONE"):
        models[1].predict(_frame(0, 64, 64)[None])


def test_infer_is_a_function_of_its_variables(models):
    _, pm, _ = models
    frames = torch.from_numpy(np.stack([_frame(3, 64, 64)] * 2))
    sides, flip = torch.tensor([0, 1], dtype=torch.int32), torch.tensor([False, True])
    live = pm._infer(pm._variables, frames, sides, flip)
    other = {k: (v * 0.5 if k.endswith("decoder.conv4.weight") else v)
             for k, v in pm._variables.items()}
    halved = pm._infer(other, frames, sides, flip)
    assert not torch.equal(halved["objpoints3d"], live["objpoints3d"])
    torch.testing.assert_close(halved["verts"], live["verts"], rtol=0, atol=0)
    again = pm._infer(pm._variables, frames, sides, flip)  # the live weights untouched
    assert all(torch.equal(again[k], live[k]) for k in live)


def test_demo_model_reloads_a_traineval_run(tmp_path, monkeypatch):
    from obman_train_tpu_torch.cli import traineval

    monkeypatch.setenv("OBMAN_PLATFORM", "cpu")
    exp = str(tmp_path / "run")
    state, _ = traineval.main([
        "--train_datasets", "synthetic", "--val_datasets", "synthetic", "--mano_assets",
        "synthetic", "--synthetic_size", "8", "--image_size", str(SIZE), "--train_batch", "4",
        "--test_batch", "4", "--workers", "2", "--display_freq", "0", "--epochs", "1",
        "--atlas_predict_trans", "--contact_lambda", "0.167", "--collision_lambda", "0.167",
        "--exp_id", exp])
    model = DemoModel(exp_dir=exp, device="cpu")
    assert model.epoch == 1 and model.image_size == SIZE and model.cfg.model.need_collisions
    for name, want in state.net.state_dict().items():
        assert torch.equal(model.net.state_dict()[name], want), name
    frames = torch.from_numpy(np.stack([_frame(7, 72, 90), _frame(8, 72, 90)]))
    sides, flip = torch.tensor([1, 0], dtype=torch.int32), torch.tensor([True, False])
    got = model._infer(model._variables, frames, sides, flip)
    with torch.no_grad():
        _, want, _ = state.net(
            {"images": preprocess_frames(frames.to(torch.float32), size=SIZE, flip=flip),
             "sides": sides}, INFER_SPEC, no_loss=True, force_hand=True, force_objects=True)
    assert set(got) == {"verts", "joints", "objpoints3d", "objtrans"}
    assert all(torch.equal(got[k], want[k]) for k in got)


def test_demo_model_wants_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: DemoModel runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DemoModel(config=ExperimentConfig(mano_assets="synthetic"))
    with pytest.raises(ValueError, match="exp_dir or config"):
        DemoModel(device="cpu")
