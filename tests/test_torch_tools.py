"""The port's evaluation tools on the CPU, against the JAX package's:

- ``visualize.triage``: Chamfer scores within 1e-5 relative of JAX's (one
  batched ``chamfer_loss`` against JAX's call per sample; each package's
  plane rounds on its own), the same best, median and worst groups, and
  the files, also with matplotlib hidden (PIL grids);
- ``utils.tables`` / ``cli.process_table``: the markdown and HTML of the
  same two port experiments identical to JAX's;
- ``train.debug.inspect_feature_grads``: each loss's feature-gradient norm
  within rtol 1e-3 of JAX's on the same weights (``state_dict_from_jax``),
  64 px, B=2, contact flags; the attraction term within 1e-2 of JAX's and
  2e-3 of the port's float64 run (see ``CONTACT_TERMS``);
- ``cli.import_torch``: a reference-style checkpoint written by the test
  (JAX weights in the reference keys, ``module.`` prefixes, an ``opt.pkl``
  beside it) becomes a port experiment whose ``DemoModel`` equals the
  source weights' bit for bit; JAX's ``cli.import_torch`` of the same file
  serves the same frames within 1e-4;
- ``cli.simulate --intersect --save_gifs`` (``OBMAN_PLATFORM=cpu``, with
  matplotlib hidden): every file of every sample.
"""

import argparse
import json
import os
import pickle
import shutil
import sys
import types

import jax
import numpy as np
import pytest
import torch

from obman_train_tpu.utils import tables as jtables
from obman_train_tpu.visualize import triage as jtriage
from obman_train_tpu_torch.cli import process_table, simulate
from obman_train_tpu_torch.cli import traineval as pcli
from obman_train_tpu_torch.utils import tables
from obman_train_tpu_torch.visualize import triage

torch.set_num_threads(2)

BASE = ["--train_datasets", "synthetic", "--val_datasets", "synthetic",
        "--mano_assets", "synthetic", "--synthetic_size", "8", "--image_size", "64",
        "--train_batch", "4", "--test_batch", "4", "--workers", "2",
        "--display_freq", "0", "--atlas_predict_trans"]


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("OBMAN_PLATFORM", "cpu")


def _drop_checkpoints(*exps):
    """The tests read the metrics and saved results only: free the disk the
    checkpoints take (~140 MB each at 64 px with the optimizer's moments)."""
    for exp in exps:
        for name in os.listdir(exp):
            if name.endswith(".pth.tar"):
                os.remove(os.path.join(exp, name))


@pytest.fixture(scope="module")
def experiments(tmp_path_factory):
    """Two port experiments (one and two epochs, other learning rates) and
    the saved val results of the second, evaluated without the simulation."""
    root = tmp_path_factory.mktemp("tools")
    old = os.environ.get("OBMAN_PLATFORM")
    os.environ["OBMAN_PLATFORM"] = "cpu"
    try:
        a, b = str(root / "a"), str(root / "b")
        pcli.main(BASE + ["--exp_id", a, "--epochs", "1", "--lr", "1e-3"])
        pcli.main(BASE + ["--exp_id", b, "--epochs", "2"])
        pcli.main(BASE + ["--exp_id", b, "--resume", b, "--evaluate", "--save_results",
                          "--no_simulate"])
        _drop_checkpoints(a, b)
    finally:
        if old is None:
            os.environ.pop("OBMAN_PLATFORM")
        else:
            os.environ["OBMAN_PLATFORM"] = old
    return a, b, os.path.join(b, "save_results", "val", "epoch_2")


def test_triage_matches_jax(experiments, tmp_path, monkeypatch):
    results = experiments[2]
    want = jtriage.triage(results, out_dir=str(tmp_path / "jax"), n_show=2)
    got = triage.triage(results, out_dir=str(tmp_path / "port"), n_show=2,
                        export_meshes=True, device="cpu")
    assert len(got["scores"]) == 8 and got["scores"].min() > 0
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5)
    for group in ("best", "median", "worst"):
        np.testing.assert_array_equal(got[group], want[group])
        for ext in ("png", "html"):
            assert (tmp_path / "port" / f"{group}.{ext}").exists()
        for idx in got[group]:
            assert (tmp_path / "port" / f"{group}_{idx}_obj.obj").exists()
    # one score a sample, as a call on that sample alone gives
    samples = triage.load_eval_samples(results)
    alone = [triage.score_samples([s], device="cpu")[0] for s in samples]
    np.testing.assert_array_equal(got["scores"], alone)
    np.testing.assert_array_equal(
        triage.score_samples(samples, "max_depth"), np.zeros(8))
    # without matplotlib the grids are PIL images
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    triage.triage(results, out_dir=str(tmp_path / "pil"), n_show=2, device="cpu")
    from PIL import Image

    with Image.open(tmp_path / "pil" / "worst.png") as img:
        assert img.size[0] == 2 * img.size[1] - 40


def test_process_table_matches_jax(experiments, tmp_path, capsys):
    exps = list(experiments[:2])
    md = tables.process_table(exps, str(tmp_path / "port.html"))
    assert md == jtables.process_table(exps, str(tmp_path / "jax.html"))
    assert (tmp_path / "port.html").read_text() == (tmp_path / "jax.html").read_text()
    assert md.count("\n") == 3 and "total_loss" in md
    for metrics in (None, ["total_loss", "auc"]):
        assert tables.make_table(exps, metrics, "train") == \
            jtables.make_table(exps, metrics, "train")
    process_table.main(["--exp_dirs", *exps, "--out", str(tmp_path / "cli.html")])
    assert md in capsys.readouterr().out
    assert (tmp_path / "cli.html").read_text() == (tmp_path / "port.html").read_text()


# The attraction term's feature gradient is ~1e-7 of the total's and
# float32-conditioned: the port's float32 norm is 1.05e-3 from its own
# float64 run, JAX's CPU one 7e-3 from it (6.1e-3 from the port's). It is
# held to 1e-2 against JAX and 2e-3 against float64; every other loss to
# rtol 1e-3 against JAX (measured <= 2e-5).
CONTACT_TERMS = ("attraction_loss", "contact_loss")


def test_inspect_feature_grads_matches_jax():
    import copy

    from obman_train_tpu.models import BatchSpec as JSpec
    from obman_train_tpu.train.debug import DEFAULT_INSPECT_LOSSES
    from obman_train_tpu.train.debug import inspect_feature_grads as jinspect
    from obman_train_tpu_torch.models import BatchSpec
    from obman_train_tpu_torch.train.debug import inspect_feature_grads
    from tests.test_torch_handnet import CONTACT
    from tests.test_torch_losses import loss_pair

    jnet, variables, pnet, batch = loss_pair(CONTACT, 2, 64, 0)
    names = DEFAULT_INSPECT_LOSSES + ("attraction_loss",)
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    want = jinspect(jnet, state, batch, JSpec(), loss_names=names,
                    rng=jax.random.PRNGKey(0))
    got = inspect_feature_grads(pnet, batch, BatchSpec(), loss_names=names, device="cpu")
    assert got.keys() == want.keys() == {"atlas_trans3d", "atlas_objpoints3d", "mano_verts3d",
                                         "total_loss", "attraction_loss"}
    for k in want:
        rtol = 1e-2 if k in CONTACT_TERMS else 1e-3
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    assert got["total_loss"] > 0 and got["mano_verts3d"] != got["atlas_objpoints3d"]
    assert not any(p.grad is not None for p in pnet.parameters())
    # the same net in float64
    net64 = copy.deepcopy(pnet).double()
    batch64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v
               for k, v in batch.items()}
    ref = inspect_feature_grads(net64, batch64, BatchSpec(), loss_names=names, device="cpu")
    np.testing.assert_allclose(got["attraction_loss"], ref["attraction_loss"], rtol=2e-3)


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    """A reference-style checkpoint: JAX-initialised weights with randomised
    BN statistics in the reference torch keys, ``module.``-prefixed, with a
    MANO layer buffer the port has no module for, and an ``opt.pkl``."""
    from obman_train_tpu.config import AtlasConfig as JAtlas
    from obman_train_tpu.config import ExperimentConfig as JExperiment
    from obman_train_tpu.config import ModelConfig as JModel
    from obman_train_tpu.demo import DemoModel as JDemoModel
    from obman_train_tpu_torch.weights import state_dict_from_jax
    from tests.test_torch_demo import SIZE, _randomize_stats

    jm = JDemoModel(config=JExperiment(model=JModel(atlas=JAtlas(
        predict_trans=True, predict_scale=True))), mano_assets="synthetic", image_size=SIZE)
    variables = _randomize_stats(jm._variables, 3)
    sd = {"module." + k: v for k, v in state_dict_from_jax(variables).items()}
    sd["module.mano_branch.mano_layer_right.th_betas"] = torch.zeros(1, 10)
    d = tmp_path_factory.mktemp("reference")
    torch.save({"epoch": 11, "state_dict": sd}, d / "checkpoint.pth.tar")
    with open(d / "opt.pkl", "wb") as f:
        pickle.dump(argparse.Namespace(resnet_version=18, mano_comps=6,
                                       hidden_neurons=[1024, 256], atlas_predict_trans=True,
                                       atlas_predict_scale=True, use_shape=False), f)
    return str(d / "checkpoint.pth.tar"), variables


def test_import_torch_serves_the_source_net(reference_checkpoint, tmp_path, cpu):
    from obman_train_tpu.cli import import_torch as jimport
    from obman_train_tpu.demo import DemoModel as JDemoModel
    from obman_train_tpu_torch.cli import import_torch
    from obman_train_tpu_torch.demo import DemoModel
    from tests.test_torch_demo import SIZE, _port_model

    ckpt, variables = reference_checkpoint
    exp = str(tmp_path / "port")
    state = import_torch.main(["--torch_checkpoint", ckpt, "--exp_id", exp,
                               "--mano_assets", "synthetic"])
    cfg = json.load(open(os.path.join(exp, "opt.json")))
    assert cfg["model"]["mano"]["ncomps"] == 6
    assert cfg["model"]["atlas"]["predict_scale"] is True
    assert state.step == 0
    model = DemoModel(exp_dir=exp, image_size=SIZE, device="cpu")
    assert model.epoch == 11
    source = _port_model(variables)
    frame = np.random.default_rng(1).integers(0, 256, (72, 80, 3)).astype(np.uint8)
    got = model.predict_dual(frame, "right")
    want = source.predict_dual(frame, "right")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the JAX package's importer on the same file
    jexp = str(tmp_path / "jax")
    jimport.main(["--torch_checkpoint", ckpt, "--exp_id", jexp, "--mano_assets", "synthetic"])
    jgot = JDemoModel(exp_dir=jexp, image_size=SIZE).predict_dual(frame, "right")
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(jgot[k]), rtol=1e-4, atol=1e-4, err_msg=k)


def test_import_torch_flags_and_errors(reference_checkpoint, tmp_path, cpu, capsys):
    from obman_train_tpu_torch.cli import import_torch

    ckpt, _ = reference_checkpoint
    # an explicit flag wins over opt.pkl: 6 components in the pkl, 30 here,
    # so the checkpoint's pose head does not fit
    with pytest.raises(ValueError, match="pose_reg"):
        import_torch.main(["--torch_checkpoint", ckpt, "--exp_id", str(tmp_path / "x"),
                           "--mano_assets", "synthetic", "--mano_comps", "30"])
    with pytest.raises(SystemExit):
        import_torch.main(["--torch_checkpoint", ckpt, "--exp_id", str(tmp_path / "y"),
                           "--imagenet_encoder", "--validate"])
    # --validate without the reference repo: the import stands, the check skips
    os.environ.pop("OBMAN_REFERENCE", None)
    import_torch.main(["--torch_checkpoint", ckpt, "--exp_id", str(tmp_path / "z"),
                       "--mano_assets", "synthetic", "--validate"])
    assert "--validate skipped" in capsys.readouterr().out


def test_import_torch_imagenet_encoder(reference_checkpoint, tmp_path, cpu):
    """A bare torchvision-layout encoder file fills the encoder only."""
    from obman_train_tpu_torch.cli import import_torch
    from obman_train_tpu_torch.train.checkpoint import CHECKPOINT_NAME

    ckpt, _ = reference_checkpoint
    sd = torch.load(ckpt, weights_only=False)["state_dict"]
    bare = {k[len("module.base_net."):]: v for k, v in sd.items()
            if k.startswith("module.base_net.")}
    bare["fc.weight"] = torch.zeros(1000, 512)
    path = str(tmp_path / "resnet18.pth")
    torch.save(bare, path)
    exp = str(tmp_path / "boot")
    import_torch.main(["--torch_checkpoint", path, "--exp_id", exp, "--mano_assets",
                       "synthetic", "--imagenet_encoder", "--atlas_predict_trans"])
    saved = torch.load(os.path.join(exp, CHECKPOINT_NAME), weights_only=True)
    assert saved["epoch"] == 0
    for k, v in bare.items():
        if k != "fc.weight":
            torch.testing.assert_close(saved["state_dict"]["base_net." + k], v, rtol=0, atol=0)
    assert not torch.equal(saved["state_dict"]["mano_branch.pose_reg.weight"],
                           sd["module.mano_branch.pose_reg.weight"])


def test_cli_simulate_writes_every_file(experiments, tmp_path, cpu, monkeypatch, capsys):
    results = str(tmp_path / "results")
    shutil.copytree(experiments[2], results)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    summary = simulate.main(["--exp_id", results, "--intersect", "--save_gifs",
                             "--workers", "2"])
    assert summary["sample_nb"] == 8 and summary["backend"] == "native"
    out = capsys.readouterr().out
    assert "simulation:" in out and "intersection:" in out
    with open(os.path.join(results, "simulation_results", "results.json")) as f:
        assert len(json.load(f)["per_sample"]) == 8
    with open(os.path.join(results, "intersect_results", "results.json")) as f:
        assert json.load(f)["sample_nb"] == 8
    samples = os.path.join(results, "simulation_results", "samples")
    for i in range(8):
        for suffix in (".json", "_hand.obj", "_obj.obj", "_traj.npy", ".gif", ".mp4"):
            assert os.path.exists(os.path.join(samples, f"{i:06d}{suffix}")), (i, suffix)
