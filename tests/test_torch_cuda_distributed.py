"""Data-parallel training on the card (``cuda`` tests; JAX-free, run as
tests/test_torch_cuda.py says). Each rank is a child process with
torchrun's environment; this process holds the rendezvous store, as
torchrun's agent does, and stops every child before a test returns.

- An NCCL world of one (the port's only NCCL path a one-card machine can
  run): the contact train step at B=256, 3 steps from seeded weights,
  deterministic algorithms, run twice without a process group (a control:
  the step repeats bit for bit) and then as rank 0 of the world: frozen BN
  (PyTorch's default TF32) bit for bit the plain step's state (weights,
  statistics, Adam's moments), unfrozen BN with dropout 0.3 (TF32 off)
  within 1e-5 of each tensor's update; ``TRAIN_LAUNCHES`` a step, and
  ``UNFOLDED_TRAIN_LAUNCHES`` with unfrozen BN.
- ``python -m obman_train_tpu_torch.cli.traineval --distributed`` as two
  ranks sharing the card over gloo (NCCL refuses two ranks on one device),
  against the same argv in one process (unfrozen BN, dropout 0.3, the
  contact losses, ``--save_results``, sgd as tests/test_torch_distributed.py,
  TF32 off, deterministic algorithms): AUC bit for bit, also recomputed
  from the result pickles; the other metrics rel 2e-3 / abs 1e-4; the
  checkpoint's parameters rtol 5e-3 / atol 5e-4; the rank pickles' GT
  joints exactly and their predictions rtol 5e-3 / atol 5e-3; rank 0 alone
  writing the logs, metrics and checkpoint; each rank's launches a train
  step and a val forward. At 64 px and B=16 (8 a rank): the step's width is
  held by the world of one and tests/test_torch_cuda.py.
"""

import datetime
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.test_torch_cuda import EVAL_LAUNCHES, TRAIN_LAUNCHES, UNFOLDED_TRAIN_LAUNCHES
from tests.test_torch_cuda_cli import ARGV, card  # noqa: F401

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                 "LOCAL_WORLD_SIZE")
TIMEOUT_S = 300  # a child's wall-clock limit: a hung collective fails the test
STEPS = 3
CLI_ARGV = ARGV + ["--contact_lambda", "0.167", "--collision_lambda", "0.167",
                   "--epochs", "1", "--no_freeze_batchnorm", "--fc_dropout", "0.3",
                   "--save_results", "--no_simulate", "--manual_seed", "3",
                   "--optimizer", "sgd", "--lr", "1e-8"]
for _flag, _value in (("--train_batch", "16"), ("--test_batch", "16"),
                      ("--synthetic_size", "32")):
    CLI_ARGV[CLI_ARGV.index(_flag) + 1] = _value


def _run(target, args, tmp_path, ranks=None):
    """``target(*args)`` of this module in one child process a rank (with
    torchrun's environment; ``{rank}`` in an argument is the rank), or in
    one process without it (``ranks=None``); each must exit 0 within
    ``TIMEOUT_S``. Returns their outputs."""
    store = dist.TCPStore("127.0.0.1", 0, None, True,
                          timeout=datetime.timedelta(seconds=TIMEOUT_S),
                          wait_for_workers=False)
    base = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
    base.update(CUBLAS_WORKSPACE_CONFIG=":4096:8",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    base.pop("OBMAN_PLATFORM", None)
    code = f"import sys; from tests.test_torch_cuda_distributed import {target}; " \
           f"{target}(*sys.argv[1:])"
    procs = []
    try:
        for r in range(ranks or 1):
            env = dict(base)
            if ranks:
                env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store.port), RANK=str(r),
                           WORLD_SIZE=str(ranks), LOCAL_RANK=str(r),
                           LOCAL_WORLD_SIZE=str(ranks), TORCHELASTIC_USE_AGENT_STORE="True")
            log = open(tmp_path / f"{target}_{r if ranks else 'single'}.log", "w+")
            procs.append((subprocess.Popen(
                [sys.executable, "-u", "-c", code, *(str(a).replace("{rank}", str(r))
                                                     for a in args)],
                env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT), log))
        deadline = time.monotonic() + TIMEOUT_S
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        outs = []
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.seek(0)
            outs.append(log.read())
            log.close()
        del store
    for (p, _), out in zip(procs, outs):
        assert p.returncode == 0, out[-6000:]
    return outs


def world_of_one(out_path):
    """The NCCL world of one (see the module docstring), in its own
    process: writes ``{case: {equal, control_equal, worst, launches}}``
    and the group's backend, world and device to ``out_path``."""
    from obman_train_tpu_torch import parallel, train
    from obman_train_tpu_torch.config import TrainConfig
    from obman_train_tpu_torch.models import BatchSpec
    from obman_train_tpu_torch.ops.kernels import LAUNCHES
    from tests.test_torch_cuda import CONTACT, _gt_batch, _seeded

    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device("cuda", 0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in _gt_batch(256, 256, 1).items()}
    cases = (("frozen", False, CONTACT, True),
             ("unfrozen_dropout", True, CONTACT.replace(fc_dropout=0.3), False))

    def run(net, init, train_bn, cudnn_tf32):
        """``STEPS`` steps from ``init`` with a step built now: the state
        after them (weights, statistics, moments) and the launches a step."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        net.load_state_dict(init)
        tcfg = TrainConfig()
        opt = train.make_optimizer(tcfg, net)
        state = train.create_train_state(net, opt, tcfg)
        step = train.make_train_step(net, opt, BatchSpec(), train_bn=train_bn, device=dev)
        LAUNCHES.clear()
        for _ in range(STEPS):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        snap = {k: v.clone() for k, v in net.state_dict().items()}
        for i, st in opt.state_dict()["state"].items():
            snap.update({f"optimizer/{i}/{k}": v.clone() for k, v in st.items()
                         if torch.is_tensor(v)})
        return snap, {k: v / STEPS for k, v in LAUNCHES.items() if v}

    plain = {}
    for label, train_bn, cfg, tf32 in cases:
        net = _seeded(cfg, dev)
        init = {k: v.clone() for k, v in net.state_dict().items()}
        plain[label] = (net, init, run(net, init, train_bn, tf32)[0],
                        run(net, init, train_bn, tf32)[0])
    info = parallel.init_distributed(timeout_s=TIMEOUT_S)
    result = {"backend": info.backend, "world": info.world, "device": str(info.device)}
    for label, train_bn, _, tf32 in cases:
        net, init, ref, control = plain[label]
        got, launches = run(net, init, train_bn, tf32)
        worst = max(float((got[k].double() - v.double()).abs().max())
                    / (float((v.double() - init[k].double()).abs().max()) or 1.0)
                    for k, v in ref.items() if k in init and v.is_floating_point())
        result[label] = {"equal": all(torch.equal(got[k], v) for k, v in ref.items()),
                         "control_equal": all(torch.equal(control[k], v)
                                              for k, v in ref.items()),
                         "worst": worst, "launches": launches}
    parallel.destroy_distributed()
    with open(out_path, "w") as f:
        json.dump(result, f)


def test_nccl_world_of_one_steps_as_one_process(card, tmp_path):
    out = tmp_path / "world_of_one.json"
    _run("world_of_one", [out], tmp_path, ranks=1)
    with open(out) as f:
        result = json.load(f)
    assert (result["backend"], result["world"], result["device"]) == ("nccl", 1, "cuda:0")
    for label in ("frozen", "unfrozen_dropout"):
        r = result[label]
        assert r["control_equal"], label  # else no bitwise check can hold
        assert r["launches"] == (TRAIN_LAUNCHES if label == "frozen"
                                 else UNFOLDED_TRAIN_LAUNCHES), label
    assert result["frozen"]["equal"], result["frozen"]["worst"]
    assert result["unfrozen_dropout"]["worst"] <= 1e-5


def traineval_child(record, *argv):
    """``python -m obman_train_tpu_torch.cli.traineval *argv`` (by ``runpy``)
    with TF32 off and deterministic algorithms, recording the files it
    writes and each epoch pass's launches a step in ``record``."""
    import builtins
    import runpy

    from obman_train_tpu_torch.train import loop
    from tests.test_torch_cuda_cli import counting

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    passes, written = [], set()
    real_open, real_save = builtins.open, torch.save

    def note(f):
        if isinstance(f, (str, bytes, os.PathLike)):
            written.add(os.path.abspath(os.fsdecode(f)))

    def recording_open(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            note(file)
        return real_open(file, mode, *a, **k)

    def recording_save(obj, f, *a, **k):
        note(f)
        return real_save(obj, f, *a, **k)

    loop.epoch_pass = counting(passes, {"name": "cli"})
    builtins.open, torch.save = recording_open, recording_save
    sys.argv = ["traineval", *argv]
    try:
        runpy.run_module("obman_train_tpu_torch.cli.traineval", run_name="__main__",
                         alter_sys=True)
    finally:
        builtins.open, torch.save = real_open, real_save
    with open(record, "w") as f:
        json.dump({"passes": passes, "written": sorted(written)}, f)


def _pickled(res_dir, names, suffixes):
    """The val AUC of the loop's evaluator recomputed from the result
    pickles (each batch's rows in global order, the ranks' in rank order),
    and each batch's (GT joints, predicted joints)."""
    from obman_train_tpu_torch.train.metrics import EvalUtil

    ev, joints = EvalUtil(), []
    for name in names:
        parts = []
        for suffix in suffixes:
            with open(os.path.join(res_dir, name.replace(".pkl", f"{suffix}.pkl")), "rb") as f:
                parts.append(pickle.load(f))
        gt = np.concatenate([p["batch"]["joints3d"] for p in parts])
        pred = np.concatenate([p["results"]["joints"] for p in parts])
        ev.feed(gt, pred)
        joints.append((gt, pred))
    return ev.get_measures(0, 50, 20)[3], joints


def test_two_gloo_ranks_of_the_cli_match_one_process(card, tmp_path):
    sp, mp = str(tmp_path / "single"), str(tmp_path / "ranks")
    outs = _run("traineval_child", [tmp_path / "rank{rank}.json", *CLI_ARGV, "--exp_id", mp,
                                    "--distributed"], tmp_path, ranks=2)
    for r, out in enumerate(outs):
        assert f"rank {r} of 2, local rank {r}, backend gloo" in out
    _run("traineval_child", [tmp_path / "single.json", *CLI_ARGV, "--exp_id", sp], tmp_path)

    metrics = []
    for d in (sp, mp):
        with open(os.path.join(d, "metrics.json")) as f:
            metrics.append(json.load(f))
    m_sp, m_mp = metrics
    assert set(m_sp) == set(m_mp) and "auc" in m_sp
    for split in m_sp["auc"]:
        assert m_sp["auc"][split]["1"] == m_mp["auc"][split]["1"], split
    for key, splits in m_sp.items():
        if key in ("batch_time", "data_time", "auc"):
            continue
        for split, series in splits.items():
            v, w = series["1"], m_mp[key][split]["1"]
            assert abs(v - w) <= 1e-4 + 2e-3 * abs(w), (key, split, v, w)
    ck = [torch.load(os.path.join(d, "checkpoint.pth.tar"), map_location="cpu",
                     weights_only=True)["state_dict"] for d in (sp, mp)]
    for k, v in ck[0].items():
        if v.is_floating_point():
            np.testing.assert_allclose(ck[1][k].numpy(), v.numpy(), rtol=5e-3, atol=5e-4,
                                       err_msg=k)
    res_sp = os.path.join(sp, "save_results", "val", "epoch_0")
    res_mp = os.path.join(mp, "save_results", "val", "epoch_0")
    files = sorted(os.listdir(res_sp))
    assert len(os.listdir(res_mp)) == 2 * len(files)
    auc_sp, joints_sp = _pickled(res_sp, files, [""])
    auc_mp, joints_mp = _pickled(res_mp, files, ["_rank0", "_rank1"])
    assert [auc_sp, auc_mp] == [m_sp["auc"]["val"]["1"], m_mp["auc"]["val"]["1"]]
    for (gt_sp, p_sp), (gt_mp, p_mp) in zip(joints_sp, joints_mp):
        np.testing.assert_array_equal(gt_mp, gt_sp)
        np.testing.assert_allclose(p_mp, p_sp, rtol=5e-3, atol=5e-3)

    written = {}
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as f:
            rec = json.load(f)
        train_pass = next(p for p in rec["passes"] if p["train"])
        val_pass = next(p for p in rec["passes"] if not p["train"])
        assert train_pass["launches"] == UNFOLDED_TRAIN_LAUNCHES, (r, train_pass)
        assert val_pass["launches"] == EVAL_LAUNCHES, (r, val_pass)
        written[r] = [os.path.relpath(p, mp) for p in rec["written"]
                      if p.startswith(mp + os.sep)]
    assert written[1] and all(p.endswith("_rank1.pkl") for p in written[1]), written[1]
    assert {"metrics.json", "opt.json", "checkpoint.pth.tar.tmp",
            os.path.join("logs", "train.txt"), os.path.join("logs", "val.txt")} \
        <= set(written[0])
