"""Data-parallel training in the port (``parallel/``, the distributed train
and eval steps, the process-sliced loader, the PCK pool merge,
``cli.traineval --distributed``) on the CPU: ranks are real processes
(``subprocess``, torchrun's environment, a rendezvous store that the test
holds as torchrun's agent does, gloo), as
``tests/test_distributed.py`` spawns the JAX package's.

- (i) Two ranks of ``cli.traineval --distributed`` against the same argv
  in one process, with the JAX test's tolerances: ``metrics.json`` AUC bit
  for bit, every other metric rel 2e-3 / abs 1e-4, checkpoint parameters
  rtol 5e-3 / atol 5e-4, the rank-suffixed pickles' GT joints exactly, and
  logs, checkpoint and figures written by rank 0 alone (every batch draws
  a figure: its eval forward holds collectives, so every rank runs it);
  unfrozen BN, dropout 0.3 and the contact losses on. The optimizer is sgd (lr 1e-8):
  adam's first updates are +-lr on every weight whose gradient sign the
  rounding decides, so after two adam steps at these toy sizes the val
  contact terms moved by more than JAX's tolerance between two ONE-process
  runs of the port on 1 and 4 CPU threads (penetration_loss 3.5e-2
  relative, max_penetr 1.0e-2), and adam's update is blind to a gradient's
  scale; sgd's is linear in the gradients, so a wrong average shows and
  rounding stays rounding.
- (ii) One 2-rank step against the JAX package's ``make_train_step`` on a
  2-device CPU mesh, the same weights (``weights.py``) and batch, dropout 0,
  frozen and unfrozen BN, sgd: the updated parameters to 1e-3 (frozen) /
  2e-3 (unfrozen) of each tensor's update scale, the losses to rtol 1e-4
  (the unfrozen contact terms against the JAX contact functions on the
  port's own geometry, as ``test_torch_train_bn.py`` holds them), the
  running statistics to rtol 1e-4 / atol 1e-6; the tolerances of
  ``test_torch_train_step.py`` and ``test_torch_train_bn.py``. Both ranks'
  parameters bit for bit equal; a 2-rank ``accum_steps=2`` step against the
  one-process port's.
- (iii) A batch whose halves hold different contact-mask counts: the
  2-rank global masked mean equals one process's within 1e-6 relative and
  its gradient the one process's, while the mean of the per-rank means is
  off by more than 1e-3.
- (iv) ``BatchLoader(process_rank=r, process_count=2)`` slices equal to the
  JAX loader's for the same seed, on threads; process workers slice the
  same batches.
- (v) ``EvalUtil.merge_distributed`` over 2 ranks: the merged measures
  (AUC, EPE mean and median, the PCK curve) bit for bit those of one
  ``EvalUtil`` on the global pools, and the ragged branch's rank-ordered
  pool.
"""

import datetime
import json
import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from obman_train_tpu.config import TrainConfig as JTrain
from obman_train_tpu.data import loader as jloader
from obman_train_tpu.models import BatchSpec as JSpec
from obman_train_tpu.parallel import make_mesh
from obman_train_tpu.parallel import shard_batch as jax_shard_batch
from obman_train_tpu.train import steps as jsteps
from obman_train_tpu_torch import parallel, train
from obman_train_tpu_torch.config import TrainConfig
from obman_train_tpu_torch.data import factory, loader
from obman_train_tpu_torch.data.queries import TransQueries
from obman_train_tpu_torch.models import BatchSpec
from obman_train_tpu_torch.weights import state_dict_from_jax
from tests.test_torch_handnet import CONTACT
from tests.test_torch_losses import loss_pair
from tests.test_torch_train_bn import BEFORE_BN, _contact_terms_on_port_geometry

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")
SGD = dict(optimizer="sgd", lr=1e-3, momentum=0.9)
UPDATE_ATOL = {"frozen": 1e-3, "unfrozen": 2e-3}  # of each tensor's update scale
CONTACT_KEYS = ("attraction_loss", "penetration_loss", "contact_loss", "max_penetr",
                "mean_penetr", "contact_auc")


def _env(threads=2, **extra):
    """The test's environment without torchrun's variables, plus ``extra``."""
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
    env.update(OBMAN_PLATFORM="cpu", OMP_NUM_THREADS=str(threads),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), **extra)
    return env


def start(code, args, log_path, env):
    """``python -c code *args`` with its output in ``log_path`` (a file, not
    a pipe: a full pipe would stall a rank inside a collective)."""
    log = open(log_path, "w+")
    proc = subprocess.Popen([sys.executable, "-u", "-c", code, *map(str, args)], env=env,
                            cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    return proc, log


# rank 0's process -> the rendezvous store its ranks connect to, held by
# this process until finish() has waited for them
_STORES = {}


def start_ranks(code, args, logdir, world=2, threads=2):
    """``world`` ranks of ``python -c code *args`` with torchrun's
    environment, on the CPU; ``{rank}`` in an argument is the rank.

    As torchrun's agent does, this process hosts the rendezvous store
    (``TORCHELASTIC_USE_AGENT_STORE``): it binds the store's port itself and
    keeps it bound until :func:`finish`, and every rank only connects to it.
    A port probed free and released before the ranks start (as this helper
    did before) can be bound by another process before rank 0 binds it,
    and the rendezvous then fails."""
    store = dist.TCPStore("127.0.0.1", 0, None, True,
                          timeout=datetime.timedelta(seconds=600), wait_for_workers=False)
    started = [start(code, [str(a).replace("{rank}", str(r)) for a in args],
                     os.path.join(logdir, f"rank{r}.log"),
                     _env(threads, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store.port),
                          TORCHELASTIC_USE_AGENT_STORE="True", RANK=str(r),
                          WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                          LOCAL_WORLD_SIZE=str(world)))
               for r in range(world)]
    _STORES[started[0][0]] = store
    return started


def finish(started, timeout=300):
    """Wait for the processes; each must exit 0. Returns their outputs.

    They are polled together: the first one to fail stops the others and
    fails the caller at once with its output, and past ``timeout`` seconds
    the error names the processes still running, with their output."""
    procs = [p for p, _ in started]
    deadline = time.monotonic() + timeout
    codes, failed, running = [None] * len(procs), None, list(range(len(procs)))
    try:
        while running and failed is None and time.monotonic() < deadline:
            time.sleep(0.2)
            codes = [p.poll() for p in procs]
            failed = next((i for i, c in enumerate(codes) if c not in (None, 0)), None)
            running = [i for i, c in enumerate(codes) if c is None]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            _STORES.pop(p, None)
        outs = []
        for _, f in started:
            f.seek(0)
            outs.append(f.read())
            f.close()
    if failed is not None:
        raise AssertionError(f"process {failed} (pid {procs[failed].pid}) exited "
                             f"{codes[failed]}:\n{outs[failed][-6000:]}")
    if running:
        raise AssertionError(f"timed out after {timeout} s waiting for " + "; ".join(
            f"process {i} (pid {procs[i].pid}):\n{outs[i][-3000:]}" for i in running))
    return outs


# ---------------------------------------------------------------------------
# (i) cli.traineval --distributed
# ---------------------------------------------------------------------------

# runs the CLI as `python -m` does, recording the files the process writes
CLI_RUNNER = r"""
import builtins, json, os, runpy, sys
import torch
record, argv = sys.argv[1], sys.argv[2:]
written = set()
_open, _save = builtins.open, torch.save

def _note(f):
    if isinstance(f, (str, bytes, os.PathLike)):
        written.add(os.path.abspath(os.fsdecode(f)))

def recording_open(file, mode="r", *a, **k):
    if any(c in mode for c in "wax+"):
        _note(file)
    return _open(file, mode, *a, **k)

def recording_save(obj, f, *a, **k):
    _note(f)
    return _save(obj, f, *a, **k)

builtins.open, torch.save = recording_open, recording_save
sys.argv = ["traineval"] + argv
try:
    runpy.run_module("obman_train_tpu_torch.cli.traineval", run_name="__main__",
                     alter_sys=True)
finally:
    builtins.open, torch.save = _open, _save
    with open(record, "w") as f:
        json.dump(sorted(written), f)
"""

CLI_ARGV = [
    "--train_datasets", "synthetic", "--val_datasets", "synthetic",
    "--mano_assets", "synthetic", "--synthetic_size", "16", "--image_size", "64",
    "--epochs", "1", "--train_batch", "8", "--test_batch", "8", "--workers", "1",
    "--manual_seed", "3", "--epoch_display_freq", "1", "--display_freq", "1",
    "--save_results", "--no_simulate",
    "--no_freeze_batchnorm", "--fc_dropout", "0.3", "--contact_lambda", "0.167",
    "--collision_lambda", "0.167", "--atlas_predict_trans", "--atlas_predict_scale",
    "--optimizer", "sgd", "--lr", "1e-8",
]


def test_two_ranks_of_the_cli_match_one_process(tmp_path):
    sp, mp = str(tmp_path / "sp"), str(tmp_path / "mp")
    single = start(CLI_RUNNER, [tmp_path / "writes_single.json", *CLI_ARGV, "--exp_id", sp],
                   tmp_path / "single.log", _env())
    ranks = start_ranks(CLI_RUNNER, [tmp_path / "writes_rank{rank}.json", *CLI_ARGV,
                                     "--exp_id", mp, "--distributed"], tmp_path)
    outs = finish(ranks + [single])
    for r in range(2):
        assert f"rank {r} of 2, local rank {r}, backend gloo (CPU ranks)" in outs[r]

    # metrics.json (rank 0 alone writes it): the PCK pools merge in global
    # row order, so AUC is bit for bit; the rest within JAX's tolerances
    with open(os.path.join(sp, "metrics.json")) as f:
        m_sp = json.load(f)
    with open(os.path.join(mp, "metrics.json")) as f:
        m_mp = json.load(f)
    assert set(m_sp) == set(m_mp)
    assert {"penetration_loss", "attraction_loss", "auc"} <= set(m_sp)
    for split in ("train", "val"):
        assert m_sp["auc"][split] == m_mp["auc"][split], split
    for key, splits in m_sp.items():
        if key in ("batch_time", "data_time"):
            continue  # wall-clock meters
        for split, series in splits.items():
            for epoch, v in series.items():
                w = m_mp[key][split][epoch]
                assert v == pytest.approx(w, rel=2e-3, abs=1e-4), (key, split, v, w)

    # the checkpoint: rank 0 wrote it; parameters from the same global stream
    ck_sp = torch.load(os.path.join(sp, "checkpoint.pth.tar"), weights_only=True)
    ck_mp = torch.load(os.path.join(mp, "checkpoint.pth.tar"), weights_only=True)
    assert ck_sp["epoch"] == ck_mp["epoch"] == 1 and ck_sp["step"] == ck_mp["step"] == 2
    assert set(ck_sp["state_dict"]) == set(ck_mp["state_dict"])
    for k, v in ck_sp["state_dict"].items():
        np.testing.assert_allclose(ck_mp["state_dict"][k].numpy(), v.numpy(), rtol=5e-3,
                                   atol=5e-4, err_msg=k)

    # each rank dumped its contiguous rows of every val batch
    res_sp = os.path.join(sp, "save_results", "val", "epoch_0")
    res_mp = os.path.join(mp, "save_results", "val", "epoch_0")
    sp_files, mp_files = sorted(os.listdir(res_sp)), sorted(os.listdir(res_mp))
    assert len(sp_files) == 2 and len(mp_files) == 4 and all("_rank" in f for f in mp_files)
    for f_sp in sp_files:
        with open(os.path.join(res_sp, f_sp), "rb") as f:
            full = pickle.load(f)
        parts = []
        for r in range(2):
            with open(os.path.join(res_mp, f_sp.replace(".pkl", f"_rank{r}.pkl")), "rb") as f:
                parts.append(pickle.load(f))
        np.testing.assert_array_equal(np.concatenate([p["batch"]["joints3d"] for p in parts]),
                                      full["batch"]["joints3d"])
        np.testing.assert_allclose(np.concatenate([p["results"]["joints"] for p in parts]),
                                   full["results"]["joints"], rtol=5e-3, atol=5e-3)

    # rank 0 alone wrote the logs, metrics, figures, checkpoint and config;
    # rank 1 only its own result pickles
    writes = []
    for r in range(2):
        with open(tmp_path / f"writes_rank{r}.json") as f:
            writes.append([os.path.relpath(p, mp) for p in json.load(f)
                           if p.startswith(os.path.abspath(mp))])
    assert writes[1] and all(p.endswith("_rank1.pkl") for p in writes[1]), writes[1]
    rank0 = set(writes[0])
    assert {"metrics.json", "opt.json", "opt.txt", "checkpoint.pth.tar.tmp",
            os.path.join("logs", "train.txt"), os.path.join("logs", "val.txt")} <= rank0
    assert not any(p.endswith("_rank1.pkl") for p in rank0)
    assert any(p.startswith("images") for p in rank0)  # the figures
    assert any(p.startswith("pcks") for p in rank0)  # the PCK curve


# ---------------------------------------------------------------------------
# (ii) the 2-rank step against the JAX step on a 2-device mesh
# ---------------------------------------------------------------------------

# each rank: the net of `inputs.pt`, one step of each case on its rows of
# the global batch, the losses and the state dict after the step
STEP_WORKER = r"""
import os, sys
import torch
torch.set_num_threads(2)
from obman_train_tpu_torch import parallel, train
from obman_train_tpu_torch.assets import synthetic_mano_assets
from obman_train_tpu_torch.config import ModelConfig, TrainConfig
from obman_train_tpu_torch.models import BatchSpec, build_handnet
work = sys.argv[1]
info = parallel.init_distributed(device="cpu")
inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
net = build_handnet(ModelConfig.from_json(inp["config"]), synthetic_mano_assets("right"),
                    synthetic_mano_assets("left"), device="cpu")
out = {}
for case in inp["cases"]:
    net.load_state_dict(inp["state_dict"])
    cfg = TrainConfig(**inp["train"])
    opt = train.make_optimizer(cfg, net)
    state = train.create_train_state(net, opt, cfg)
    if case.get("syncbn"):
        step = train.make_train_step_syncbn(net, opt, BatchSpec(), device="cpu")
    else:
        step = train.make_train_step(net, opt, BatchSpec(), train_bn=case["train_bn"],
                                     accum_steps=case.get("accum", 1), device="cpu")
    state, losses = step(state, parallel.shard_batch(inp["batch"], device="cpu"))
    out[case["name"]] = {"losses": {k: float(v) for k, v in losses.items()},
                         "state_dict": {k: v.clone() for k, v in net.state_dict().items()}}
torch.save(out, os.path.join(work, f"out_rank{info.rank}.pt"))
parallel.destroy_distributed()
"""


def run_step_ranks(tmp_path, pnet, batch, cases, train_kw):
    """Start the 2 ranks of :data:`STEP_WORKER`; returns a function that
    waits for them and loads both ranks' outputs."""
    torch.save({"config": pnet.cfg.to_json(), "state_dict": pnet.state_dict(),
                "batch": batch, "cases": cases, "train": train_kw},
               tmp_path / "inputs.pt")
    started = start_ranks(STEP_WORKER, [tmp_path], tmp_path)

    def wait():
        finish(started)
        return [torch.load(tmp_path / f"out_rank{r}.pt", weights_only=False) for r in range(2)]

    return wait


def jax_mesh_step(jnet, variables, batch, train_bn, kw=SGD, syncbn=False):
    """The JAX package's step on a 2-device CPU mesh (the batch data-sharded
    by its ``shard_batch``): ``(new state, losses)``."""
    mesh = make_mesh(devices=jax.devices()[:2])
    tx = jsteps.make_optimizer(JTrain(**kw))
    params = variables["params"]
    jstate = jsteps.TrainState(params=params, batch_stats=variables["batch_stats"],
                               opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                               regul_scale=jnp.ones((), jnp.float32))
    if syncbn:
        step = jsteps.make_train_step_syncbn(jnet, tx, JSpec(), mesh)
    else:
        step = jsteps.make_train_step(jnet, tx, JSpec(), train_bn=train_bn, mesh=mesh,
                                      donate=False)
    return step(jstate, jax_shard_batch(batch, mesh), jax.random.PRNGKey(0))


def assert_updates_match(got_sd, want_params, old_params, atol_of_scale, label,
                         train_bn=True):
    """Parameters after one sgd update, held as the gradients are: each
    tensor within ``atol_of_scale`` of its update's largest entry; with
    training-mode BN the conv biases right before a BN (exact gradient 0)
    only as rounding noise, under 1e-4 of the layer weight's update."""
    for name, w in want_params.items():
        upd = w - old_params[name]
        if name in BEFORE_BN and train_bn:
            layer = (want_params[name.replace(".bias", ".weight")]
                     - old_params[name.replace(".bias", ".weight")]).abs().max()
            assert upd.abs().max() <= 1e-4 * layer, (label, name)
            assert (got_sd[name] - old_params[name]).abs().max() <= 1e-4 * layer, (label, name)
            continue
        torch.testing.assert_close(got_sd[name], w, rtol=0,
                                   atol=atol_of_scale * float(upd.abs().max()) + 1e-7,
                                   msg=f"{label}: {name}")


@pytest.fixture(scope="module")
def mesh_steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_steps")
    jnet, variables, pnet, batch = loss_pair(CONTACT, 4, 64, 3)
    cases = [{"name": "frozen", "train_bn": False}, {"name": "unfrozen", "train_bn": True},
             {"name": "accum2", "train_bn": True, "accum": 2}]
    wait = run_step_ranks(tmp, pnet, batch, cases, SGD)
    # meanwhile, in this process: the JAX mesh steps, and the one-process
    # port's accum step and unfrozen forward geometry
    jax_out = {name: jax_mesh_step(jnet, variables, batch, tb)
               for name, tb in (("frozen", False), ("unfrozen", True))}
    contact = _contact_terms_on_port_geometry(pnet, batch, 1)
    old = {k: v.clone() for k, v in pnet.state_dict().items()}
    opt = train.make_optimizer(TrainConfig(**SGD), pnet)
    state = train.create_train_state(pnet, opt, TrainConfig(**SGD))
    step = train.make_train_step(pnet, opt, BatchSpec(), train_bn=True, accum_steps=2,
                                 device="cpu")
    _, accum_losses = step(state, batch)
    accum_sd = {k: v.clone() for k, v in pnet.state_dict().items()}
    return dict(ranks=wait(), jax=jax_out, contact=contact, old=old, variables=variables,
                accum_losses=accum_losses, accum_sd=accum_sd)


@pytest.mark.parametrize("case", ["frozen", "unfrozen"])
def test_two_rank_step_matches_jax_mesh_step(mesh_steps, case):
    ranks = mesh_steps["ranks"]
    jnew, jl = mesh_steps["jax"][case]
    got = ranks[0][case]
    for k, v in got["state_dict"].items():  # the ranks agree bit for bit
        assert torch.equal(v, ranks[1][case]["state_dict"][k]), k
    assert ranks[0][case]["losses"] == ranks[1][case]["losses"]
    assert set(got["losses"]) == set(jl)
    for k in jl:
        want = float(jl[k])
        if case == "unfrozen" and k in CONTACT_KEYS:
            want = mesh_steps["contact"][k]
        np.testing.assert_allclose(got["losses"][k], want, rtol=1e-4, atol=1e-6,
                                   err_msg=f"{case}: {k}")
    old = state_dict_from_jax(mesh_steps["variables"])
    want_params = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray,
                                                                        jnew.params)})
    assert_updates_match(got["state_dict"], want_params, old, UPDATE_ATOL[case], case,
                         train_bn=case == "unfrozen")
    want_stats = state_dict_from_jax({"params": jnew.params, "batch_stats": jnew.batch_stats})
    stats = [k for k in want_stats if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 23
    for k in stats:
        if case == "frozen":
            assert torch.equal(got["state_dict"][k], old[k]), k
        else:
            assert not torch.equal(got["state_dict"][k], old[k]), k
            torch.testing.assert_close(got["state_dict"][k], want_stats[k], rtol=1e-4,
                                       atol=1e-6, msg=k)


def test_two_rank_accum_step_matches_one_process(mesh_steps):
    """``accum_steps=2`` with unfrozen BN on 2 ranks: rank r's rows ``i::2``
    are global microbatch i, so the step is the one-process accumulated
    step (BN statistics per global microbatch of 2 rows, one a rank).
    Tolerances of ``test_torch_train_bn.py`` for two microbatches of 2: the
    parameters to 1e-2 of each tensor's update scale (measured: 3.3e-3, on
    the atlas decoder's first conv, whose BN backward cancels), the losses
    to rtol 1e-4 and the contact terms to 1e-3 (the penetration masks
    amplify the vertices' rounding; measured 3.9e-4 on ``max_penetr``)."""
    got = mesh_steps["ranks"][0]["accum2"]
    for k, v in mesh_steps["accum_losses"].items():
        np.testing.assert_allclose(got["losses"][k], float(v),
                                   rtol=1e-3 if k in CONTACT_KEYS else 1e-4, atol=1e-6,
                                   err_msg=k)
    old = mesh_steps["old"]
    for k, want in mesh_steps["accum_sd"].items():
        if k in BEFORE_BN or not want.is_floating_point():
            continue
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(got["state_dict"][k], want, rtol=1e-4, atol=1e-5, msg=k)
            continue
        scale = float((want - old[k]).abs().max())
        torch.testing.assert_close(got["state_dict"][k], want, rtol=0,
                                   atol=1e-2 * scale + 1e-7, msg=k)


# ---------------------------------------------------------------------------
# (iii) the global masked mean, (v) the PCK pool merge
# ---------------------------------------------------------------------------

COLLECTIVES_WORKER = r"""
import json, sys
import numpy as np
import torch
from obman_train_tpu_torch import parallel
from obman_train_tpu_torch.ops.contact import masked_mean_loss
from obman_train_tpu_torch.train.metrics import EvalUtil
out = sys.argv[1]
info = parallel.init_distributed(device="cpu")
r, w = info.rank, info.world
res = {}

# (iii) 8 rows of 778 values; rows 0-3 (rank 0) hold ~60 % of the mask,
# rows 4-7 (rank 1) ~5 %
rng = np.random.default_rng(11)
vals = torch.from_numpy(rng.gamma(2.0, 3.0, (8, 778)).astype(np.float32))
dens = np.repeat([0.6, 0.05], 4)[:, None]
mask = torch.from_numpy(rng.random((8, 778)) < dens)
one = vals.clone().requires_grad_()
single = masked_mean_loss(one, mask)
single.backward()
rows = slice(4 * r, 4 * r + 4)
mine = vals[rows].clone().requires_grad_()
with parallel.data_parallel(parallel.world_axis()):
    glob = masked_mean_loss(mine, mask[rows])
glob.backward()
local = [float(masked_mean_loss(vals[4 * q:4 * q + 4], mask[4 * q:4 * q + 4]))
         for q in range(w)]
res["masked"] = {"single": float(single), "global": float(glob),
                 "per_rank_average": sum(local) / w, "counts": [int(mask[4 * q:4 * q + 4].sum())
                                                              for q in range(w)],
                 # the step averages the ranks' gradients: 1/W of this rank's
                 "grad_err": float((mine.grad / w - one.grad[rows]).abs().max()),
                 "grad_scale": float(one.grad.abs().max())}

# (v) deterministic pools per (rank, feed), as tests/test_distributed.py's
def batch(p, i, b=4, k=21):
    g = np.random.default_rng((7, p, i))
    gt = g.normal(0, 30, (b, k, 3))
    return gt, gt + g.normal(0, 2, (b, k, 3))

def measures(ev):
    epe, _, med, auc, curve, _ = ev.get_measures(0, 50, 20)
    return [epe, med, auc, curve.tolist()]

ev = EvalUtil()
for i in range(3):
    ev.feed(*batch(r, i))
ev.merge_distributed()
ref = EvalUtil()
for i in range(3):
    parts = [batch(p, i) for p in range(w)]
    ref.feed(np.concatenate([a for a, _ in parts]), np.concatenate([b for _, b in parts]))
res["uniform"] = {"merged": measures(ev), "single": measures(ref),
                  "rows_equal": bool((np.concatenate(ev._dists)
                                      == np.concatenate(ref._dists)).all())}
ev = EvalUtil()
for i in range(3 - r):  # rank 0 feeds 3 batches, rank 1 two: the ragged branch
    ev.feed(*batch(r, i))
ev.merge_distributed()
ref = EvalUtil()
for p in range(w):
    for i in range(3 - p):
        ref.feed(*batch(p, i))
res["ragged"] = {"merged": measures(ev), "single": measures(ref),
                 "rows_equal": bool((np.concatenate(ev._dists)
                                     == np.concatenate(ref._dists)).all())}
with open(out.format(rank=r), "w") as f:
    json.dump(res, f)
parallel.destroy_distributed()
"""


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    finish(start_ranks(COLLECTIVES_WORKER, [str(tmp / "out_rank{rank}.json")], tmp))
    out = []
    for r in range(2):
        with open(tmp / f"out_rank{r}.json") as f:
            out.append(json.load(f))
    return out


def test_global_masked_mean_is_one_process_mean(collectives):
    for res in collectives:
        m = res["masked"]
        assert m["counts"][0] > 5 * m["counts"][1]  # the halves' masks differ
        assert m["global"] == pytest.approx(m["single"], rel=1e-6)
        # the teeth: averaging the ranks' own masked means is another loss
        assert abs(m["per_rank_average"] - m["single"]) > 1e-3 * abs(m["single"])
        assert m["grad_err"] <= 1e-6 * m["grad_scale"]
    assert collectives[0]["masked"]["global"] == collectives[1]["masked"]["global"]


@pytest.mark.parametrize("branch", ["uniform", "ragged"])
def test_merged_pools_measure_as_one_process(collectives, branch):
    for res in collectives:
        got = res[branch]
        assert got["rows_equal"]
        assert got["merged"] == got["single"]  # AUC, EPE mean, median, curve: bit for bit


# ---------------------------------------------------------------------------
# (iv) the process-sliced loader
# ---------------------------------------------------------------------------


class IndexDataset:
    """Samples that carry their index (as joints), for both loaders."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return {TransQueries.joints3d: np.full((21, 3), idx, np.float32)}


@pytest.mark.parametrize("seed", [0, 5])
def test_process_slices_equal_jax_loader(seed):
    ds = IndexDataset(37)
    for epoch in range(2):
        for r in range(2):
            port = loader.BatchLoader(ds, batch_size=8, seed=seed, num_workers=2,
                                      process_rank=r, process_count=2)
            jax_loader = jloader.BatchLoader(ds, batch_size=8, seed=seed, num_workers=2,
                                             process_rank=r, process_count=2)
            port.set_epoch(epoch)
            jax_loader._epoch = epoch  # the JAX loader's count of iterations so far
            got = [b["joints3d"][:, 0, 0].astype(int).tolist() for b in port]
            want = [b["joints3d"][:, 0, 0].astype(int).tolist() for b in jax_loader]
            assert len(got) == len(port) == 4 and got == want, (seed, epoch, r)
            # rank r's contiguous half of each global batch
            order = np.arange(37)
            np.random.default_rng(seed + epoch).shuffle(order)
            assert got == [order[8 * i + 4 * r: 8 * i + 4 * r + 4].tolist() for i in range(4)]


def test_process_workers_slice_as_threads():
    ds = factory.get_dataset("synthetic", "train", meta={"size": 12, "img_res": 32})
    for r in range(2):
        threads = list(loader.BatchLoader(ds, batch_size=4, num_workers=1, process_rank=r,
                                          process_count=2))
        procs = loader.BatchLoader(ds, batch_size=4, num_workers=1, process_rank=r,
                                   process_count=2, use_processes=True)
        try:
            got = list(procs)
        finally:
            procs.close()
        assert len(got) == len(threads) == 3
        for a, b in zip(threads, got):
            assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a), r
            assert a["images"].shape[0] == 2


# ---------------------------------------------------------------------------
# the launch environment and the shard helper, in this process
# ---------------------------------------------------------------------------


def test_launch_environment_errors(monkeypatch):
    for v in TORCHRUN_VARS:
        monkeypatch.delenv(v, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        parallel.init_distributed(device="cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="MASTER_ADDR, MASTER_PORT, LOCAL_RANK are not"):
        parallel.init_distributed(device="cpu")
    assert not parallel.is_distributed()
    assert parallel.process_index() == 0 and parallel.process_count() == 1


def test_one_card_notice_without_torchrun():
    """Several CUDA cards and none of torchrun's variables: ``cli.traineval``
    says that it trains on one card and names the torchrun launch (the JAX
    CLI would build a mesh over all of them in one process)."""
    from obman_train_tpu_torch.cli.traineval import one_card_notice

    line = one_card_notice("cuda", 8, {"PATH": "/bin"})
    assert "8 CUDA cards" in line and "trains on one" in line
    assert "torch.distributed.run --nproc_per_node 8" in line and "--distributed" in line
    assert "\n" not in line
    assert one_card_notice("cuda", 1, {}) is None
    assert one_card_notice("cpu", 8, {}) is None
    for v in TORCHRUN_VARS:
        assert one_card_notice("cuda", 8, {v: "0"}) is None


def test_shard_batch_and_local_shard():
    batch = {"images": np.arange(6 * 2, dtype=np.float32).reshape(6, 2),
             "aug_order": np.asarray(3, np.int32)}
    part = parallel.shard_batch(batch, device="cpu", rank=1, world=3)
    assert part["images"].tolist() == [[4.0, 5.0], [6.0, 7.0]]
    assert int(part["aug_order"]) == 3
    with pytest.raises(ValueError, match="not divisible"):
        parallel.shard_batch(batch, device="cpu", rank=0, world=4)
    assert np.array_equal(parallel.local_shard(part["images"]), part["images"].numpy())
    assert parallel.infer_batch_size({"a": np.zeros((3, 2)), "b": np.zeros((5,))}) == 5
