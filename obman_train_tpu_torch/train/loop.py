"""Epoch engine and the training run (the JAX package's ``train/loop.py``:
``epoch_pass`` :89-311 and ``fit`` :344-504; reference
mano_train/netscripts/epochpass3d.py:17-215 and traineval.py:281-404).

Per batch: the train or eval step, the loss meters, PCK/EPE/AUC over the
(0, 50, 20) thresholds on ``EVAL_JOINT_IDXS``; per epoch: text/jsonl logs
with the lr actually applied and the regul scale, the PCK pickle, the
checkpoint, best by val AUC (else by minimum ``total_loss``), and the regul
decay at ``epoch % regul_decay_step == 0``.

Host-device overlap: the host reads a step's results one batch behind the
step it has just queued, so the GPU is not idle while the host reads
losses. At dispatch, a step's loss scalars are stacked into one tensor and
copied with the predicted joints into pinned host memory without blocking
(one device-to-host copy of the losses, not one ``.item()`` per key); the
host waits on that copy's event only one batch later.

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

from obman_train_tpu_torch.config import ExperimentConfig
from obman_train_tpu_torch.data.loader import derive_spec
from obman_train_tpu_torch.train.checkpoint import save_checkpoint
from obman_train_tpu_torch.train.metrics import AverageMeters, EvalUtil
from obman_train_tpu_torch.train.steps import (
    HOST_KEYS,
    TrainState,
    lr_schedule,
    make_eval_step,
    make_train_step,
)
from obman_train_tpu_torch.utils.logging import Monitor

EVAL_JOINT_IDXS = list(range(21))  # joints used for evaluation (epochpass3d.py:37)


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
    copy), and the named result tensors."""

    def __init__(self, losses: Dict, results: Dict[str, torch.Tensor]):
        self.loss_keys = [k for k, v in losses.items() if v is not None]
        tensors = dict(results)
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
        """``(losses as floats, results as numpy)``, waiting for the copies."""
        if self.event is not None:
            self.event.synchronize()
        host = dict(self.host)
        packed = host.pop("__losses__", None)
        losses = {}
        if packed is not None:
            losses = dict(zip(self.loss_keys, packed.tolist()))
        return losses, {k: v.numpy() for k, v in host.items()}


def epoch_pass(
    loader,
    state: TrainState,
    epoch: int,
    train: bool = True,
    save_results_dir: Optional[str] = None,
    accum_steps: int = 1,
    train_bn: bool = False,
):
    """One pass over ``loader``; returns ``(state, avg_meters, pck_info)``.
    Steps are built once per :class:`BatchSpec` met in the pass."""
    net = state.net
    device = next(net.parameters()).device
    avg_meters = AverageMeters()
    time_meters = AverageMeters()
    evaluator = EvalUtil()
    steps = {}

    def step_for(spec):
        if spec not in steps:
            if train:
                steps[spec] = make_train_step(
                    net, state.optimizer, spec, train_bn=train_bn,
                    accum_steps=accum_steps, device=device,
                    return_joints=spec.has_joints3d)
            else:
                steps[spec] = make_eval_step(net, spec, device=device)
        return steps[spec]

    def process_host(pending):
        """Host work of a finished step: loss meters (this waits for the
        step's copies), the evaluator feed, the result dumps."""
        batch_idx, batch, root, copy = pending
        losses, results = copy.get()
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
            with open(os.path.join(save_results_dir, f"batch_{batch_idx:06d}.pkl"), "wb") as f:
                pickle.dump(payload, f)

    end = time.time()
    pending = None
    for batch_idx, batch in enumerate(loader):
        time_meters.add_loss_value("data_time", time.time() - end)
        root = batch.get("root", "wrist")
        device_batch = _to_device(batch, device)
        spec = derive_spec(device_batch, root=root)
        if train:
            out = step_for(spec)(state, device_batch)
            state, losses = out[0], out[1]
            results = {"joints": out[2]} if len(out) == 3 else {}
        else:
            losses, results = step_for(spec)(device_batch)
        # copy back only what process_host reads: the losses, the joints,
        # and the whole results only when they are dumped
        if train or save_results_dir is None:
            results = {k: v for k, v in results.items() if k == "joints"}
        copy = _HostCopy(losses, results)
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


def _save_pck_artifacts(cfg: ExperimentConfig, epoch: int, pck_info: Dict) -> str:
    """The per-epoch PCK pickle (epochpass3d.py:176-209); the curve image
    waits for the port of ``visualize/``."""
    pck_dir = os.path.join(cfg.exp_id, "pcks", "val")
    os.makedirs(pck_dir, exist_ok=True)
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
    else the monitor's per-metric history."""
    hosting = (
        os.path.join(cfg.host_folder, os.path.basename(os.path.normpath(cfg.exp_id)))
        if cfg.host_folder else None
    )
    monitor = Monitor(cfg.exp_id, hosting_folder=hosting)
    if cfg.display_freq > 0 and cfg.epoch_display_freq:
        print("display_freq > 0: the qualitative figures (visualize/displaymano) "
              "are not ported yet, so none are drawn")
    best_score = None

    for epoch in range(start_epoch, cfg.train.epochs):
        if not cfg.evaluate:
            train_loader.set_epoch(epoch)

            def run_train(epoch=epoch):
                return epoch_pass(
                    train_loader, state, epoch, train=True,
                    accum_steps=cfg.train.grad_accum,
                    train_bn=not cfg.train.freeze_batchnorm)

            if profile_dir and epoch == start_epoch:
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
            monitor.log_train(epoch + 1, train_dict)

        save_dir = None
        if cfg.save_results:
            save_dir = os.path.join(cfg.exp_id, "save_results", "val", f"epoch_{epoch}")
        state, val_meters, pck_info = epoch_pass(
            val_loader, state, epoch, train=False, save_results_dir=save_dir)
        val_dict = val_meters.averages()
        for k in ("auc", "epe_mean", "epe_median"):
            if k in pck_info:
                val_dict[k] = pck_info[k]
        monitor.log_val(epoch + 1, val_dict)
        if pck_info:
            _save_pck_artifacts(cfg, epoch, pck_info)
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
    return state, monitor.metrics
