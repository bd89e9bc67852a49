"""What a training driver needs besides its batches: the program's model,
optimizer and state built from the benchmark's weights and MANO files, the
snapshots the check needs (each checked step's losses, the first gradient from the
optimizer's state, the parameters after the third update), and the
reference's follow-up once the window has closed."""

from __future__ import annotations

import gc
import os
import shutil
from typing import Dict, List

import numpy as np
import torch

from portbench import checks, core, program
from portbench.reference import handnet as ref
from portbench.traffic import mano_files, weights

CHECKED_STEPS = 3
MANO_STREAM = 31


class TrainingDriver:
    """Subclasses make the batches and drive the step; this class holds the
    program's state and the check."""

    def __init__(self, run: core.Run):
        self.run = run
        self.traffic = run.traffic
        self.device = run.device
        self.batch_size = int(self.traffic["batch"])
        self.tmp = core.scratch_dir(run.cell)
        self.mano = mano_files.write(os.path.join(self.tmp, "mano"), core.sub_seed(run.seed, MANO_STREAM))
        self.cfg_overrides = dict(self.traffic.get("model_override", {}))
        self.losses: List[Dict[str, float]] = []
        self.first = None
        self.after = None
        self.checked_batches: List[Dict[str, np.ndarray]] = []
        self.first_joints = None  # the first step's predicted joints, where the step returns them

    def build(self):
        cfg = program.model_config(self.run.config, **self.cfg_overrides)
        self.specs = ref.param_specs(self.run.config["model"])
        w = weights.make(self.specs, self.run.seed, self.device)
        self.net = program.handnet(cfg, os.path.dirname(self.mano["right"]), w, self.device)
        del w
        self.state, self.opt = program.train_state(self.net, self.run.config)
        self.names = program.param_names(self.net)

    def record_step(self, losses: Dict[str, float], joints=None):
        """After each checked step: its losses; after the first, the
        gradient from Adam's state and the predicted joints; after the
        third, the parameters."""
        self.losses.append({k: float(v) for k, v in losses.items()})
        if len(self.losses) == 1:
            self.first = program.adam_first_gradient(self.opt, self.names)
            if joints is not None:
                self.first_joints = joints.detach().cpu()
        if len(self.losses) == CHECKED_STEPS:
            self.after = {n: p.detach().cpu().clone() for n, p in self.net.named_parameters()}

    def free(self):
        """Drop the program's state before the reference runs."""
        for name in ("net", "opt", "state", "step"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        model = ref.Model(self.run.config["model"], self.mano, self.device)
        w = weights.make(self.specs, self.run.seed, self.device)
        batches = [checks.to_device(b, self.device) for b in self.checked_batches]
        lr = float(self.run.config["train"]["lr"])
        ref_losses, ref_first, ref_change, ref_joints = checks.follow_training(model, w, batches, lr)
        w_host = {k: v.cpu() for k, v in w.items()}
        prog_change = {k: v - w_host[k] for k, v in (self.after or {}).items()}
        numbers = checks.train_numbers(self.losses, self.first or {}, prog_change,
                                       ref_losses, ref_first, ref_change)
        if self.first_joints is not None:
            numbers["joints"] = checks.output_gap({"joints": self.first_joints.numpy()},
                                                  {"joints": ref_joints})
        return numbers

    def cleanup(self):
        shutil.rmtree(self.tmp, ignore_errors=True)


def losses_to_host(losses: Dict[str, torch.Tensor]):
    """Start one non-blocking copy of a step's loss scalars into pinned
    memory; returns ``(keys, host tensor, event)`` to read a step later."""
    keys = [k for k, v in losses.items() if v is not None]
    packed = torch.stack([losses[k].detach().reshape(()).float() for k in keys])
    if not packed.is_cuda:
        return keys, packed, None
    host = torch.empty(packed.shape, dtype=torch.float32, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return keys, host, event


def read_losses(pending) -> Dict[str, float]:
    keys, host, event = pending
    if event is not None:
        event.synchronize()
    return dict(zip(keys, host.tolist()))
