"""Epoch engine and the training run (the JAX package's ``train/loop.py``:
``epoch_pass`` :89-311 and ``fit`` :344-504; reference
mano_train/netscripts/epochpass3d.py:17-215 and traineval.py:281-404).

Per batch: the train or eval step, the loss meters, PCK/EPE/AUC over the
(0, 50, 20) thresholds on ``EVAL_JOINT_IDXS``, and every ``display_freq``
batches a figure (``visualize/displaymano.visualize_batch``): on a train
pass from an eval forward on the weights before that batch's update (the
train step returns only the joints), on a val pass from the val forward;
in the contact configuration it draws the attraction and repulsion
segments. Per epoch: text/jsonl logs with the lr actually applied and the
regul scale, the PCK curve image and pickle, the checkpoint, best by val
AUC (else by minimum ``total_loss``), and the regul decay at ``epoch %
regul_decay_step == 0``.

Host-device overlap: the host reads a step's results one batch behind the
step it has just queued, so the GPU is not idle while the host reads
losses. At dispatch, a step's loss scalars are stacked into one tensor and
copied with the predicted joints into pinned host memory without blocking
(one device-to-host copy of the losses, not one ``.item()`` per key); the
host waits on that copy's event only one batch later. A figure's tensors
(its first ``FIGURE_SAMPLES`` rows) travel in the same copy.

Distributed (after ``parallel.init_distributed``; JAX :100-130, :187,
:365-395): every rank runs the same device work in the same order, figure
forwards included (they hold collectives: a rank that skipped one would
stall the others); rank 0 alone writes the monitor's logs, the figures,
the PCK curve and the checkpoint; each rank dumps its own rows of a val
batch as ``batch_<i>_rank<r>.pkl``; the PCK pools are merged over the
ranks at the end of each pass, and the meters read the step's losses,
already averaged over the ranks, so every rank holds the same metrics.

Two departures from the JAX loop keep a resumed run on the path of one
that never stopped: the train loader is set to the epoch being run (the
JAX loader restarts its seeded order at 0 on resume), and the regul decay
is applied before the checkpoint is written, so a checkpoint holds the
scale its next epoch trains with.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, Optional

import numpy as np
import torch

from obman_train_tpu_torch.assets.contact_zones import DATA_PATH
from obman_train_tpu_torch.config import ExperimentConfig
from obman_train_tpu_torch.data.loader import derive_spec
from obman_train_tpu_torch.parallel import mesh as parallel
from obman_train_tpu_torch.train.checkpoint import save_checkpoint
from obman_train_tpu_torch.train.metrics import AverageMeters, EvalUtil
from obman_train_tpu_torch.train.steps import (
    EVAL_KEYS,
    HOST_KEYS,
    TrainState,
    lr_schedule,
    make_eval_step,
    make_train_step,
)
from obman_train_tpu_torch.utils.logging import Monitor
from obman_train_tpu_torch.utils.tracing import span

EVAL_JOINT_IDXS = list(range(21))  # joints used for evaluation (epochpass3d.py:37)
FIGURE_KEYS = EVAL_KEYS + ("contact_info",)
FIGURE_SAMPLES = 5  # the samples visualize_batch draws (its max_samples)


def _to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device`` (string metadata is
    dropped): on CUDA through pinned host memory and ``non_blocking``
    copies; the host-read keys stay on the CPU."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            continue
        t = torch.from_numpy(v)
        if device.type == "cuda" and k not in HOST_KEYS:
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class _HostCopy:
    """Device-to-host copies of a step's outputs, started at dispatch and
    read one step later: the loss scalars stacked into one tensor (one
    copy), the named result tensors, and a figure's results (nested dicts
    flattened to ``figure/<key>[/<key>]`` names)."""

    def __init__(self, losses: Dict, results: Dict[str, torch.Tensor],
                 figure: Optional[Dict] = None):
        self.loss_keys = [k for k, v in losses.items() if v is not None]
        tensors = dict(results)
        for k, v in (figure or {}).items():
            for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
                tensors["/".join(["figure", k] + ([kk] if kk else []))] = vv[:FIGURE_SAMPLES]
        self.has_figure = figure is not None
        if self.loss_keys:
            tensors["__losses__"] = torch.stack(
                [losses[k].detach().reshape(()).to(torch.float32) for k in self.loss_keys])
        self.event = None
        self.host = {}
        for name, t in tensors.items():
            t = t.detach()
            if t.is_cuda:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                t = buf
                if self.event is None:
                    self.event = torch.cuda.Event()
            self.host[name] = t
        if self.event is not None:
            self.event.record()

    def get(self):
        """``(losses as floats, results as numpy, figure results as numpy
        or None)``, waiting for the copies."""
        if self.event is not None:
            self.event.synchronize()
        host = dict(self.host)
        packed = host.pop("__losses__", None)
        losses = {}
        if packed is not None:
            losses = dict(zip(self.loss_keys, packed.tolist()))
        results, figure = {}, {} if self.has_figure else None
        for name, t in host.items():
            parts = name.split("/")
            if parts[0] != "figure":
                results[name] = t.numpy()
            elif len(parts) == 2:
                figure[parts[1]] = t.numpy()
            else:
                figure.setdefault(parts[1], {})[parts[2]] = t.numpy()
        return losses, results, figure


def _draw_figure(display_dir: str, batch_idx: int, batch: Dict, figure: Dict,
                 obj_faces: np.ndarray) -> None:
    """``img_<batch_idx>.png`` in ``display_dir``; host-side drawing, so a
    figure that fails to draw is reported and the run goes on."""
    try:
        from obman_train_tpu_torch.visualize.displaymano import visualize_batch

        os.makedirs(display_dir, exist_ok=True)
        visualize_batch(
            os.path.join(display_dir, f"img_{batch_idx:06d}.png"),
            {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}, figure,
            np.load(DATA_PATH)["faces"].astype(np.int32), obj_faces=obj_faces)
    except Exception as e:  # matplotlib missing or a drawing error
        print(f"visualize_batch skipped: {type(e).__name__}: {e}")


def epoch_pass(
    loader,
    state: TrainState,
    epoch: int,
    train: bool = True,
    save_results_dir: Optional[str] = None,
    accum_steps: int = 1,
    train_bn: bool = False,
    display_dir: Optional[str] = None,
    display_freq: int = 500,
):
    """One pass over ``loader``; returns ``(state, avg_meters, pck_info)``.
    Steps are built once per :class:`BatchSpec` met in the pass. With a
    ``display_dir``, every ``display_freq``-th batch (0 disables) draws a
    figure there."""
    net = state.net
    device = next(net.parameters()).device
    avg_meters = AverageMeters()
    time_meters = AverageMeters()
    evaluator = EvalUtil()
    train_steps, eval_steps = {}, {}
    rank, multiproc = parallel.process_index(), parallel.process_count() > 1

    def train_step_for(spec):
        if spec not in train_steps:
            train_steps[spec] = make_train_step(
                net, state.optimizer, spec, train_bn=train_bn,
                accum_steps=accum_steps, device=device,
                return_joints=spec.has_joints3d)
        return train_steps[spec]

    def eval_step_for(spec):
        if spec not in eval_steps:
            eval_steps[spec] = make_eval_step(net, spec, device=device, keys=FIGURE_KEYS)
        return eval_steps[spec]

    def process_host(pending):
        """Host work of a finished step: loss meters (this waits for the
        step's copies), the evaluator feed, the figure, the result dumps."""
        with span("loop.host"):
            batch_idx, batch, root, copy = pending
            losses, results, figure = copy.get()
            if figure is not None and rank == 0:
                _draw_figure(display_dir, batch_idx, batch, figure, net.ico_faces_np)
            for key, v in losses.items():
                avg_meters.add_loss_value(key, v)
                if v > 1e5 and key == "total_loss":
                    print(f"loss explosion? {key}={v} at batch {batch_idx}")
            if "joints" in results and "joints3d" in batch:
                # GT joints from the host batch: no device round trip
                evaluator.feed(np.asarray(batch["joints3d"])[:, EVAL_JOINT_IDXS],
                               results["joints"][:, EVAL_JOINT_IDXS])
            if not train and save_results_dir is not None and results:
                os.makedirs(save_results_dir, exist_ok=True)
                payload = {
                    "batch": {k: np.asarray(v) for k, v in batch.items()
                              if isinstance(v, np.ndarray)},
                    "results": results,
                    "root": root,
                }
                # each rank dumps its own rows (together, every sample once)
                suffix = f"_rank{rank}" if multiproc else ""
                with open(os.path.join(save_results_dir, f"batch_{batch_idx:06d}{suffix}.pkl"),
                          "wb") as f:
                    pickle.dump(payload, f)

    end = time.time()
    pending = None
    for batch_idx, batch in enumerate(_fetched(loader)):
        time_meters.add_loss_value("data_time", time.time() - end)
        root = batch.get("root", "wrist")
        device_batch = _to_device(batch, device)
        spec = derive_spec(device_batch, root=root)
        display_step = display_dir is not None and display_freq > 0 \
            and batch_idx % display_freq == 0
        figure = None
        if train:
            if display_step:
                # before the update: the figure shows the weights this
                # batch's loss was computed with
                _, figure = eval_step_for(spec)(device_batch)
            out = train_step_for(spec)(state, device_batch)
            state, losses = out[0], out[1]
            results = {"joints": out[2]} if len(out) == 3 else {}
        else:
            losses, results = eval_step_for(spec)(device_batch)
            if display_step:
                figure = results
        # copy back only what process_host reads: the losses, the joints,
        # the figure's rows, and the whole results (without contact_info,
        # as the JAX eval step returns them) only when they are dumped
        if train or save_results_dir is None:
            results = {k: v for k, v in results.items() if k == "joints"}
        else:
            results = {k: v for k, v in results.items() if k in EVAL_KEYS}
        copy = _HostCopy(losses, results, figure)
        if pending is not None:
            process_host(pending)
        pending = (batch_idx, batch, root, copy)
        time_meters.add_loss_value("batch_time", time.time() - end)
        end = time.time()
    if pending is not None:
        process_host(pending)

    # loader and step timings in the logs (epochpass3d.py:153-166)
    for key, meter in time_meters.average_meters.items():
        avg_meters.add_loss_value(key, meter.avg)

    pck_info = {}
    evaluator.merge_distributed()
    epe_mean, _, epe_median, auc, pck_curve, thresholds = evaluator.get_measures(0, 50, 20)
    if np.isfinite(auc):
        pck_info = {
            "auc": auc,
            "epe_mean": epe_mean,
            "epe_median": epe_median,
            "pck_curve": pck_curve,
            "thres": thresholds,
        }
    return state, avg_meters, pck_info


def _fetched(loader):
    """``loader``'s batches, each fetch inside the span ``loop.data_wait``."""
    batches = iter(loader)
    while True:
        with span("loop.data_wait"):
            batch = next(batches, None)
        if batch is None:
            return
        yield batch


def _save_pck_artifacts(cfg: ExperimentConfig, epoch: int, pck_info: Dict,
                        val_loader) -> str:
    """The per-epoch PCK curve image and pickle (epochpass3d.py:176-209),
    the image with the literature curves of the StereoHands protocols when
    that dataset is evaluated."""
    pck_dir = os.path.join(cfg.exp_id, "pcks", "val")
    os.makedirs(pck_dir, exist_ok=True)
    overlay = None
    metas = getattr(val_loader, "metas", None)
    if metas and metas[0].get("dataset") == "stereohands":
        overlay = "stereo_test" if metas[0].get("split") == "test" else "stereo_all"
    try:
        from obman_train_tpu_torch.visualize.displaymano import save_pck_img

        save_pck_img(pck_info["thres"], pck_info["pck_curve"], pck_info["auc"],
                     os.path.join(pck_dir, f"epoch_{epoch}.png"), overlay=overlay)
    except Exception as e:  # matplotlib missing or a drawing error
        print(f"pck plot skipped: {type(e).__name__}: {e}")
    path = os.path.join(pck_dir, f"epoch_{epoch}.pkl")
    with open(path, "wb") as f:
        pickle.dump(pck_info, f)
    return path


def _profiled(profile_dir: str, epoch: int, fn):
    """``fn()`` under torch.profiler, its trace written to ``profile_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        out = fn()
    path = os.path.join(profile_dir, f"train_epoch_{epoch}.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace of train epoch {epoch}: {path}")
    return out


def fit(
    cfg: ExperimentConfig,
    state: TrainState,
    train_loader,
    val_loader,
    start_epoch: int = 0,
    profile_dir: Optional[str] = None,
):
    """The training run (traineval.py:281-404); with ``cfg.evaluate`` one
    val pass. Returns ``(state, metrics)``: the val dict when evaluating,
    else the monitor's per-metric history. Train passes run the step in
    ``train()`` unless ``cfg.train.freeze_batchnorm``; val passes and
    figure forwards run in ``eval()``. The loaders' process pools are shut
    down when the run ends, also on an error."""
    try:
        return _fit(cfg, state, train_loader, val_loader, start_epoch, profile_dir)
    finally:
        for ld in (train_loader, val_loader):
            if ld is not None and hasattr(ld, "close"):
                ld.close()


def _fit(cfg, state, train_loader, val_loader, start_epoch, profile_dir):
    hosting = (
        os.path.join(cfg.host_folder, os.path.basename(os.path.normpath(cfg.exp_id)))
        if cfg.host_folder else None
    )
    # rank 0 writes the logs, figures, PCK artifacts and checkpoints; the
    # metrics are the same on every rank
    is_main = parallel.process_index() == 0
    monitor = Monitor(cfg.exp_id, hosting_folder=hosting) if is_main else None
    best_score = None

    for epoch in range(start_epoch, cfg.train.epochs):
        display = bool(cfg.epoch_display_freq) and epoch % cfg.epoch_display_freq == 0

        def display_dir(split, epoch=epoch):
            return os.path.join(cfg.exp_id, "images", split, f"epoch_{epoch}") \
                if display else None

        if not cfg.evaluate:
            train_loader.set_epoch(epoch)

            def run_train(epoch=epoch):
                return epoch_pass(
                    train_loader, state, epoch, train=True,
                    accum_steps=cfg.train.grad_accum,
                    train_bn=not cfg.train.freeze_batchnorm,
                    display_dir=display_dir("train"), display_freq=cfg.display_freq)

            if profile_dir and epoch == start_epoch and is_main:
                state, train_meters, train_pck = _profiled(profile_dir, epoch, run_train)
            else:
                state, train_meters, train_pck = run_train()
            train_dict = train_meters.averages()
            for k in ("auc", "epe_mean", "epe_median"):
                if k in train_pck:
                    train_dict[k] = train_pck[k]
            # the lr and regul scale this epoch's updates used
            schedule = lr_schedule(cfg.train, steps_per_epoch=max(len(train_loader), 1))
            train_dict["lr"] = float(schedule(max(state.step - 1, 0)))
            train_dict["regul_scale"] = float(state.regul_scale)
            if is_main:
                monitor.log_train(epoch + 1, train_dict)

        save_dir = None
        if cfg.save_results:
            save_dir = os.path.join(cfg.exp_id, "save_results", "val", f"epoch_{epoch}")
        state, val_meters, pck_info = epoch_pass(
            val_loader, state, epoch, train=False, save_results_dir=save_dir,
            display_dir=display_dir("val"), display_freq=cfg.display_freq)
        val_dict = val_meters.averages()
        for k in ("auc", "epe_mean", "epe_median"):
            if k in pck_info:
                val_dict[k] = pck_info[k]
        if is_main:
            monitor.log_val(epoch + 1, val_dict)
            if pck_info:
                _save_pck_artifacts(cfg, epoch, pck_info, val_loader)
            monitor.save_metrics()
            monitor.plot_metrics()

        if cfg.evaluate:
            return state, val_dict

        # best-checkpoint rule (traineval.py:377-400)
        if "auc" in val_dict:
            score, is_better = val_dict["auc"], lambda s, b: s > b
        else:
            score, is_better = val_dict["total_loss"], lambda s, b: s < b
        is_best = best_score is None or is_better(score, best_score)
        best_score = score if is_best else best_score
        # regul decay (traineval.py:403-404), before the checkpoint: it
        # holds the scale the next epoch trains with
        if cfg.train.regul_decay_gamma != 1.0 and epoch % cfg.train.regul_decay_step == 0:
            state.regul_scale = float(
                np.float32(state.regul_scale) * np.float32(cfg.train.regul_decay_gamma))
        save_checkpoint(cfg.exp_id, state, epoch + 1, config=cfg, is_best=is_best,
                        snapshot=cfg.train.snapshot)
    return state, monitor.metrics if is_main else {}
