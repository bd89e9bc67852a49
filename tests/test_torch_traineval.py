"""The port's training entry point ``cli.traineval`` on the CPU
(``OBMAN_PLATFORM=cpu``), synthetic data, 64 px, B=4.

- every JAX flag exists with the same dest and default, and
  ``args_to_config`` gives the JAX package's config, JSON for JSON;
- the flags of later slices raise, and without ``OBMAN_PLATFORM=cpu`` the
  CLI wants a GPU; the precision rungs (``--compute_dtype bfloat16``, each
  ``--geometry_dtype``) and ``--no_atlas_mesh`` train one epoch; ``--mano_assets <dir>`` reads real MANO pkl files;
- ``--loader_processes`` trains the run the threaded loader trains, bit
  for bit; ``--no_freeze_batchnorm`` with ``--fc_dropout`` trains (the
  running statistics move) and its dropout masks follow ``--manual_seed``;
- 2 epochs and a resumed third equal 3 straight epochs bitwise (weights,
  running statistics, optimizer moments, counters, logged losses), lr and
  regul decay on, with frozen BN and with unfrozen BN and dropout;
- ``main()`` end to end: train with device augmentation, gradient
  accumulation, a freeze flag, result dumps and a profiler trace; then
  evaluate the checkpoint (its val metrics equal the logged ones), an
  averaged evaluation, ``--auto_resume`` and ``--atlas_resume``.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from obman_train_tpu.cli import traineval as jcli
from obman_train_tpu_torch.cli import traineval as pcli
from obman_train_tpu_torch.utils.logging import parse_log_line

torch.set_num_threads(2)

BASE = ["--train_datasets", "synthetic", "--val_datasets", "synthetic",
        "--mano_assets", "synthetic", "--synthetic_size", "8", "--image_size", "64",
        "--train_batch", "4", "--test_batch", "4", "--workers", "2",
        "--display_freq", "0"]


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("OBMAN_PLATFORM", "cpu")


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_every_jax_flag_with_its_dest_and_default():
    jp, pp = _actions(jcli.build_parser()), _actions(pcli.build_parser())
    assert set(jp) == set(pp)
    for dest, ja in jp.items():
        pa = pp[dest]
        assert pa.option_strings == ja.option_strings, dest
        for attr in ("default", "nargs", "choices", "type", "const"):
            assert getattr(pa, attr) == getattr(ja, attr), (dest, attr)
    negations = {s for a in pcli.build_parser()._actions for s in a.option_strings}
    assert {"--no_freeze_batchnorm", "--no_atlas_mesh", "--no_mano_use_pca"} <= negations


@pytest.mark.parametrize("argv", [
    [],
    BASE + ["--contact_lambda", "0.167", "--collision_lambda", "0.167",
            "--atlas_predict_trans", "--atlas_predict_scale", "--train_batch", "256"],
    ["--absolute_lambda", "0.5", "--mano_use_shape", "--no_mano_use_pca", "--optimizer",
     "sgd", "--lr_decay_gamma", "1", "--freeze_encoder", "--grad_accum", "4",
     "--val_datasets", "synthetic", "synthetic", "--val_splits", "val", "test",
     "--exp_id", "checkpoints/x", "--host_folder", "/srv/plots", "--mini_factor", "0.5"],
])
def test_args_to_config_matches_jax(argv):
    pcfg = pcli.args_to_config(pcli.build_parser().parse_args(argv))
    jcfg = jcli.args_to_config(jcli.build_parser().parse_args(argv))
    assert json.loads(pcfg.to_json()) == json.loads(jcfg.to_json())


# the ids are those of the cases when all five raised; bf16, geometry_dtype
# and the random cloud are ported now and train (``refused`` None)
@pytest.mark.parametrize("extra,refused", [
    pytest.param(["--distributed"], "DDP", id="extra0-DDP"),
    pytest.param(["--compute_dtype", "bfloat16"], None, id="extra1-bf16"),
    pytest.param(["--geometry_dtype", "float32_select"], None, id="extra2-geometry_dtype"),
    pytest.param(["--no_atlas_mesh"], None, id="extra3-random-cloud"),
    pytest.param(["--evaluate", "--save_results"], "host-tooling", id="extra4-host-tooling"),
])
def test_flags_of_later_slices_raise(cpu, tmp_path, extra, refused):
    if refused is not None:
        with pytest.raises(NotImplementedError, match=refused):
            pcli.main(BASE + ["--exp_id", str(tmp_path / "x")] + extra)
        assert not os.path.exists(tmp_path / "x")  # raised before any side effect
        return
    _trains(tmp_path / "x", extra)


def _trains(exp, extra):
    """One epoch with ``extra``: the flags reach the saved config, and the
    logged train and val losses are finite."""
    state, _ = pcli.main(BASE + ["--exp_id", str(exp), "--epochs", "1"] + extra)
    want = json.loads(jcli.args_to_config(jcli.build_parser().parse_args(
        BASE + ["--exp_id", str(exp), "--epochs", "1"] + extra)).to_json())
    with open(os.path.join(exp, "opt.json")) as f:
        assert json.load(f)["model"] == want["model"]
    for split in ("train", "val"):
        rows = _logged(str(exp), split)
        assert rows and all(np.isfinite(v) for _, r in rows for k, v in r.items()
                            if k.endswith("loss")), split
    assert state.step == 2
    return state


@pytest.mark.parametrize("extra", [
    ["--compute_dtype", "bfloat16", "--geometry_dtype", "bfloat16", "--no_freeze_batchnorm"],
    ["--compute_dtype", "bfloat16", "--no_atlas_mesh", "--atlas_predict_trans"],
], ids=["bf16-bf16sel-unfrozen", "bf16-random-cloud"])
def test_precision_rungs_train_with_the_contact_terms(cpu, tmp_path, extra):
    contact = ([] if "--no_atlas_mesh" in extra else
               ["--contact_lambda", "0.167", "--collision_lambda", "0.167"])
    state = _trains(tmp_path / "x", contact + extra)
    want = extra[extra.index("--compute_dtype") + 1] if "--compute_dtype" in extra else "float32"
    assert state.net.cfg.compute_dtype == want


@pytest.mark.parametrize("fix", [False, True])
def test_real_mano_files(cpu, tmp_path, fix):
    """``--mano_assets <dir>`` builds the net on the tables of the MANO pkl
    files there; ``--fix_left_shapedirs`` mirrors the left hand's."""
    from obman_train_tpu_torch.assets import load_mano_assets
    from tests.test_torch_mano_assets import write_mano_dir

    (tmp_path / "mano").mkdir()
    mano = write_mano_dir(tmp_path / "mano", seed=3)
    argv = list(BASE)
    argv[argv.index("synthetic", argv.index("--mano_assets"))] = mano
    state, _ = pcli.main(argv + ["--exp_id", str(tmp_path / "x"), "--epochs", "0"]
                         + (["--fix_left_shapedirs"] if fix else []))
    branch = state.net.mano_branch
    for layer, side in ((branch.mano_layer_right, "right"), (branch.mano_layer_left, "left")):
        want = load_mano_assets(mano, side, fix_left_shapedirs=fix)
        for name in ("v_template", "shapedirs", "posedirs", "J_regressor", "weights",
                     "hands_components", "hands_mean"):
            assert torch.equal(getattr(layer, name), torch.from_numpy(getattr(want, name))), name
    with pytest.raises(FileNotFoundError, match="MANO_RIGHT"):
        pcli.main(argv[:argv.index(mano)] + [str(tmp_path / "none")]
                  + argv[argv.index(mano) + 1:] + ["--exp_id", str(tmp_path / "y")])


def test_real_datasets_raise(cpu, tmp_path):
    argv = BASE + ["--exp_id", str(tmp_path / "x"), "--val_datasets", "obman"]
    with pytest.raises(NotImplementedError, match="real-dataset"):
        pcli.main(argv)


def test_the_cli_wants_a_gpu_unless_told_cpu(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI runs on it")
    monkeypatch.delenv("OBMAN_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(BASE + ["--exp_id", str(tmp_path / "x")])
    monkeypatch.setenv("OBMAN_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="OBMAN_PLATFORM"):
        pcli.main(BASE + ["--exp_id", str(tmp_path / "x")])


def _logged(exp, split):
    with open(os.path.join(exp, "logs", f"{split}.txt")) as f:
        return [parse_log_line(line) for line in f if line.strip()]


def _ckpt(exp):
    return torch.load(os.path.join(exp, "checkpoint.pth.tar"), weights_only=True)


DECAY = ["--lr", "1e-3", "--lr_decay_step", "1", "--lr_decay_gamma", "0.5",
         "--regul_decay_step", "1", "--regul_decay_gamma", "0.5", "--snapshot", "1"]


def _assert_resume_equals_straight(tmp_path, extra):
    straight, split = str(tmp_path / "straight"), str(tmp_path / "split")
    pcli.main(BASE + DECAY + extra + ["--exp_id", straight, "--epochs", "3"])
    pcli.main(BASE + DECAY + extra + ["--exp_id", split, "--epochs", "2"])
    state, _ = pcli.main(BASE + DECAY + extra + ["--exp_id", split, "--epochs", "3",
                                                 "--resume", split])
    assert state.step == 6
    a, b = _ckpt(straight), _ckpt(split)
    assert a["epoch"] == b["epoch"] == 3 and a["step"] == b["step"] == 6
    assert a["regul_scale"] == b["regul_scale"] == 0.125
    assert a["state_dict"].keys() == b["state_dict"].keys()
    assert all(torch.equal(v, b["state_dict"][k]) for k, v in a["state_dict"].items())
    for i, st in a["optimizer"]["state"].items():
        assert all(torch.equal(v, b["optimizer"]["state"][i][k]) for k, v in st.items())
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    timing = ("data_time", "batch_time")
    for split_name in ("train", "val"):
        sa, sb = _logged(straight, split_name), _logged(split, split_name)
        assert [e for e, _ in sa] == [e for e, _ in sb] == [1, 2, 3]
        for (_, va), (_, vb) in zip(sa, sb):
            assert {k: v for k, v in va.items() if k not in timing} == \
                {k: v for k, v in vb.items() if k not in timing}
    lrs = [v["lr"] for _, v in _logged(straight, "train")]
    assert lrs == [1e-3 * 0.5 ** e for e in range(3)]  # StepLR per epoch
    assert [v["regul_scale"] for _, v in _logged(straight, "train")] == [1.0, 0.5, 0.25]
    for n in (1, 2, 3):
        assert os.path.exists(os.path.join(straight, f"checkpoint_{n}.pth.tar"))
    return a


def test_two_epochs_and_a_resumed_third_equal_three_straight(cpu, tmp_path):
    _assert_resume_equals_straight(tmp_path, [])


UNFROZEN = ["--no_freeze_batchnorm", "--fc_dropout", "0.3"]


def test_unfrozen_bn_resume_equals_three_straight(cpu, tmp_path):
    """The running statistics (and their ``num_batches_tracked``) travel in
    the checkpoint; the dropout masks are a function of the seed and the
    update count, so the resumed epoch draws the straight run's."""
    a = _assert_resume_equals_straight(tmp_path, UNFROZEN)
    assert int(a["state_dict"]["base_net.bn1.num_batches_tracked"]) == 6
    assert "mano_branch.base_layer.1.weight" in a["state_dict"]  # after its Dropout


@pytest.mark.parametrize("extra", [["--loader_processes"], UNFROZEN],
                         ids=["loader_processes", "no_freeze_batchnorm"])
def test_flags_of_this_slice_run(cpu, tmp_path, extra):
    """``--loader_processes`` gives the threaded run's weights bit for bit;
    unfrozen BN moves every running statistic, and another
    ``--manual_seed`` draws other dropout masks."""
    runs = {}
    for name, flags in (("base", []), ("flag", extra)):
        state, metrics = pcli.main(BASE + CONTACT + flags + [
            "--exp_id", str(tmp_path / name), "--epochs", "1"])
        assert all(np.isfinite(v) for s in metrics["total_loss"].values() for v in s.values())
        runs[name] = {k: v.clone() for k, v in state.net.state_dict().items()}
        assert not state.net.training
    base, flag = runs["base"], runs["flag"]
    if extra == ["--loader_processes"]:
        assert all(torch.equal(v, flag[k]) for k, v in base.items())
        return
    stats = [k for k in flag if k.endswith(("running_mean", "running_var"))]
    assert stats and all(not torch.equal(flag[k], base[k]) for k in stats)
    other, _ = pcli.main(BASE + CONTACT + extra + ["--exp_id", str(tmp_path / "seed1"),
                                                   "--epochs", "1", "--manual_seed", "1"])
    again, _ = pcli.main(BASE + CONTACT + extra + ["--exp_id", str(tmp_path / "again"),
                                                   "--epochs", "1"])
    w = "mano_branch.base_layer.1.weight"  # Dropout, Linear, ReLU, ...
    assert torch.equal(again.net.state_dict()[w], flag[w])
    assert not torch.equal(other.net.state_dict()[w], flag[w])


CONTACT = ["--atlas_predict_trans", "--contact_lambda", "0.167", "--collision_lambda", "0.167",
           "--atlas_freeze_decoder"]


def test_main_end_to_end(cpu, tmp_path):
    exp = str(tmp_path / "run")
    prof = str(tmp_path / "prof")
    state, metrics = pcli.main(
        BASE + CONTACT + ["--exp_id", exp, "--epochs", "2", "--device_augment",
                          "--grad_accum", "2", "--save_results", "--profile_dir", prof,
                          "--compilation_cache"])
    for name in ("checkpoint.pth.tar", "model_best.pth.tar", "opt.json", "opt.txt",
                 "logs/train.txt", "logs/val.txt", "metrics.json", "pcks/val/epoch_1.pkl",
                 "save_results/val/epoch_1/batch_000001.pkl"):
        assert os.path.exists(os.path.join(exp, name)), name
    assert os.listdir(prof) == ["train_epoch_0.json"]
    assert set(metrics["total_loss"]) == {"train", "val"}
    assert all(np.isfinite(v) for s in metrics["total_loss"].values() for v in s.values())
    train_lines = _logged(exp, "train")
    assert "contact_loss" in train_lines[-1][1] and "auc" in train_lines[-1][1]
    with open(os.path.join(exp, "pcks", "val", "epoch_1.pkl"), "rb") as f:
        pck = pickle.load(f)
    assert set(pck) == {"auc", "epe_mean", "epe_median", "pck_curve", "thres"}
    with open(os.path.join(exp, "save_results", "val", "epoch_1", "batch_000000.pkl"),
              "rb") as f:
        dump = pickle.load(f)
    assert dump["results"]["verts"].shape == (4, 778, 3) and dump["root"] == "wrist"
    # the frozen decoder did not move; the rest did
    fresh = pcli.main(BASE + CONTACT + ["--exp_id", str(tmp_path / "fresh"),
                                        "--epochs", "0"])[0].net.state_dict()
    trained = state.net.state_dict()
    assert torch.equal(fresh["atlas_branch.decoder.conv1.weight"],
                       trained["atlas_branch.decoder.conv1.weight"])
    assert not torch.equal(fresh["base_net.conv1.weight"], trained["base_net.conv1.weight"])

    # evaluate the checkpoint: the val metrics logged for these weights
    logged_val = _logged(exp, "val")[-1][1]
    _, val = pcli.main(BASE + CONTACT + ["--exp_id", exp, "--evaluate", "--resume", exp,
                                         "--save_results", "--no_simulate"])
    for k in ("total_loss", "contact_loss", "auc", "epe_mean"):
        assert abs(val[k] - logged_val[k]) <= 1e-5 * max(1.0, abs(logged_val[k])), k
    assert _logged(exp, "val")[-1][0] == 3
    assert os.path.exists(os.path.join(exp, "save_results", "val", "epoch_2"))

    # an averaged evaluation of the latest and the best checkpoint
    _, avg = pcli.main(BASE + CONTACT + ["--exp_id", exp, "--evaluate", "--resume",
                                         os.path.join(exp, "checkpoint.pth.tar"),
                                         os.path.join(exp, "model_best.pth.tar")])
    assert np.isfinite(avg["total_loss"])
    with pytest.raises(ValueError, match="evaluate mode"):
        pcli.main(BASE + ["--exp_id", exp, "--resume", exp, exp])

    # --auto_resume picks up the run; a structure mismatch falls back to lax
    state, _ = pcli.main(BASE + CONTACT + ["--exp_id", exp, "--epochs", "3",
                                           "--auto_resume"])
    assert _ckpt(exp)["epoch"] == 3 and state.step == 3 * 2
    state, _ = pcli.main(BASE + ["--exp_id", str(tmp_path / "lax"), "--epochs", "4",
                                 "--resume", exp, "--mano_comps", "12"])
    assert _ckpt(str(tmp_path / "lax"))["epoch"] == 4

    # --atlas_resume seeds the separate object encoder from the image encoder
    state, _ = pcli.main(BASE + ["--exp_id", str(tmp_path / "atlas"), "--epochs", "0",
                                 "--atlas_separate_encoder", "--atlas_resume", exp])
    sd = state.net.state_dict()
    saved = _ckpt(exp)["state_dict"]
    assert torch.equal(sd["atlas_base_net.layer1.0.conv1.weight"],
                       saved["base_net.layer1.0.conv1.weight"])
