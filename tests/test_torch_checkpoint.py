"""The port's checkpoints (``train/checkpoint.py``) on the CPU.

- save/load round trip exact: weights, optimizer moments, update count,
  regul scale, epoch; the snapshot and best files and ``opt.json``;
- lax load with a mismatched head and ``ncomps``, strict load raising,
  averaged load, the ``module.`` prefix strip and the atlas remap (the
  last two against the JAX package's functions);
- a port checkpoint read by the JAX package's ``import_torch_handnet``
  gives a JAX net whose eval outputs match the port's to 1e-4;
- ``opt.json`` cross-loads both ways to equal configs.
"""

import os

import jax
import numpy as np
import pytest
import torch

from obman_train_tpu.assets import synthetic_mano_assets as jax_synthetic
from obman_train_tpu.cli import traineval as jcli
from obman_train_tpu.config import ExperimentConfig as JExperiment
from obman_train_tpu.models import build_handnet as jax_build
from obman_train_tpu.models import mano_params_from_assets
from obman_train_tpu.train import checkpoint as jckpt
from obman_train_tpu_torch import train
from obman_train_tpu_torch.assets import synthetic_mano_assets
from obman_train_tpu_torch.cli import traineval as pcli
from obman_train_tpu_torch.config import (
    AtlasConfig,
    ExperimentConfig,
    ManoConfig,
    ModelConfig,
    TrainConfig,
)
from obman_train_tpu_torch.infer import make_infer
from obman_train_tpu_torch.models import BatchSpec, build_handnet
from obman_train_tpu_torch.train import checkpoint as ckpt
from obman_train_tpu_torch.weights import init_weights
from tests.test_torch_handnet import INFER_KW, JAX_SPEC
from tests.test_torch_losses import gt_batch

torch.set_num_threads(2)

TCFG = TrainConfig(lr=1e-3)


def _state(model_cfg=ModelConfig(), seed=0, steps=2):
    net = init_weights(build_handnet(model_cfg, synthetic_mano_assets("right"),
                                     synthetic_mano_assets("left"), device="cpu"), seed)
    opt = train.make_optimizer(TCFG, net)
    state = train.create_train_state(net, opt, TCFG)
    step = train.make_train_step(net, opt, BatchSpec(), device="cpu")
    for i in range(steps):
        state, _ = step(state, gt_batch(2, 32, seed + i))
    return state


def _assert_states_equal(a, b):
    sa, sb = a.net.state_dict(), b.net.state_dict()
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i, st in oa["state"].items():
        assert all(torch.equal(v, ob["state"][i][k]) for k, v in st.items())
    assert a.step == b.step and a.regul_scale == b.regul_scale


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    exp = str(tmp_path_factory.mktemp("exp"))
    state = _state()
    state.regul_scale = 0.5
    cfg = ExperimentConfig(exp_id=exp)
    path = ckpt.save_checkpoint(exp, state, 3, config=cfg, is_best=True, snapshot=3)
    return exp, path, state


def test_round_trip_is_exact(saved):
    exp, path, state = saved
    assert path == os.path.join(exp, "checkpoint.pth.tar")
    for name in ("checkpoint.pth.tar", "checkpoint_3.pth.tar", "model_best.pth.tar",
                 "opt.json"):
        assert os.path.exists(os.path.join(exp, name)), name
    payload = torch.load(path, weights_only=True)
    assert set(payload) == {"epoch", "state_dict", "optimizer", "step", "regul_scale"}
    assert payload["step"] == 2 and payload["regul_scale"] == 0.5
    for where in (exp, path, os.path.join(exp, "checkpoint_3.pth.tar")):
        fresh = _state(seed=5, steps=0)
        loaded, epoch = ckpt.load_checkpoint(where, fresh)
        assert epoch == 3
        _assert_states_equal(loaded, state)
    assert ckpt.load_config(exp) == ExperimentConfig(exp_id=exp)
    # not a snapshot epoch, not best: only the latest file changes
    ckpt.save_checkpoint(exp, state, 4, snapshot=3)
    assert not os.path.exists(os.path.join(exp, "checkpoint_4.pth.tar"))
    assert torch.load(os.path.join(exp, "model_best.pth.tar"), weights_only=True)["epoch"] == 3
    ckpt.save_checkpoint(exp, state, 3, config=ExperimentConfig(exp_id=exp), is_best=True,
                         snapshot=3)


def test_strict_load_raises_and_lax_load_keeps_the_template(saved, capsys):
    exp, _, state = saved
    other = ModelConfig(mano=ManoConfig(ncomps=12), atlas=AtlasConfig(predict_trans=True))
    template = _state(other, seed=7, steps=0)
    before = {k: v.clone() for k, v in template.net.state_dict().items()}
    with pytest.raises(RuntimeError):
        ckpt.load_checkpoint(exp, template)
    template = _state(other, seed=7, steps=0)
    loaded, epoch = ckpt.load_checkpoint_lax(exp, template)
    assert epoch == 3 and loaded.step == 2 and loaded.regul_scale == 0.5
    saved_sd = state.net.state_dict()
    kept = [k for k, v in loaded.net.state_dict().items()
            if not (k in saved_sd and saved_sd[k].shape == v.shape)]
    assert "mano_branch.pose_reg.weight" in kept
    assert any(k.startswith("atlas_branch.decode_trans") for k in kept)
    for k, v in loaded.net.state_dict().items():
        want = before[k] if k in kept else saved_sd[k]
        assert torch.equal(v, want), k
    assert f"kept {len(kept) + 1} template entries" in capsys.readouterr().out
    assert not loaded.optimizer.state  # the optimizer's structure differs: kept fresh


def test_averaged_load(tmp_path):
    a, b = _state(seed=1), _state(seed=2, steps=3)
    ckpt.save_checkpoint(str(tmp_path / "a"), a, 2)
    ckpt.save_checkpoint(str(tmp_path / "b"), b, 5)
    avg, epoch = ckpt.load_checkpoints_averaged(
        [str(tmp_path / "a"), str(tmp_path / "b")], _state(seed=3, steps=0))
    assert epoch == 5 and avg.step == a.step
    sa, sb = a.net.state_dict(), b.net.state_dict()
    params = dict(avg.net.named_parameters())
    for k, v in avg.net.state_dict().items():
        want = (sa[k] + sb[k]) / 2.0 if k in params else sa[k]
        assert torch.equal(v, want), k


def test_prefix_strip_and_atlas_remap_match_jax():
    rng = np.random.default_rng(0)
    sd = {"module.base_net.conv1.weight": rng.normal(size=(2, 2)),
          "module.base_net.bn1.running_mean": rng.normal(size=2),
          "module.mano_branch.pose_reg.bias": rng.normal(size=3),
          "atlas_branch.decoder.conv1.bias": rng.normal(size=4)}
    for fn in ("strip_module_prefix", "remap_atlas_resume"):
        src = sd if fn == "strip_module_prefix" else ckpt.strip_module_prefix(sd)
        got, want = getattr(ckpt, fn)(src), getattr(jckpt, fn)(src)
        assert list(got) == list(want) and all(got[k] is want[k] for k in got)
    assert "atlas_base_net.conv1.weight" in ckpt.remap_atlas_resume(ckpt.strip_module_prefix(sd))


def test_jax_importer_reads_a_port_checkpoint(saved):
    _, path, state = saved
    payload = torch.load(path, weights_only=True)
    jnet = jax_build(JExperiment().model,
                     mano_params_from_assets(jax_synthetic("right")),
                     mano_params_from_assets(jax_synthetic("left")))
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    sides = np.array([0, 1], np.int32)
    batch = {"images": frames, "sides": sides}
    template = jax.jit(lambda r, b: jnet.init(r, b, JAX_SPEC, **INFER_KW))(
        {"params": jax.random.PRNGKey(0), "points": jax.random.PRNGKey(1)}, batch)
    variables = jckpt.import_torch_handnet(payload.get("state_dict", payload), template)
    want = jax.jit(lambda v, b: jnet.apply(v, b, JAX_SPEC, **INFER_KW)[1])(variables, batch)
    got = make_infer(state.net)(frames, sides)
    for key in ("verts", "joints", "objpoints3d"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(want[key]).max())),
                                   err_msg=key)


@pytest.mark.parametrize("argv", [
    [],
    ["--atlas_predict_trans", "--contact_lambda", "0.167", "--hidden_neurons", "512", "128",
     "--train_datasets", "synthetic", "synthetic", "--train_splits", "train", "test",
     "--mano_lambda_joints2d", "0.5", "--workers", "3", "--evaluate"],
])
def test_opt_json_cross_loads_both_ways(tmp_path, argv):
    pcfg = pcli.args_to_config(pcli.build_parser().parse_args(argv))
    jcfg = jcli.args_to_config(jcli.build_parser().parse_args(argv))
    assert pcfg.to_json() == jcfg.to_json()
    assert JExperiment.from_json(pcfg.to_json()) == jcfg
    assert ExperimentConfig.from_json(jcfg.to_json()) == pcfg
    jcfg.to_json(str(tmp_path / "opt.json"))
    assert ckpt.load_config(str(tmp_path)) == pcfg
    pcfg.to_json(str(tmp_path / "opt.json"))
    assert jckpt.load_config(str(tmp_path)) == jcfg
    # old files miss keys and carry unknown ones: backfilled and ignored
    assert ExperimentConfig.from_json('{"exp_id": "x", "gone": 1}') == ExperimentConfig(exp_id="x")
