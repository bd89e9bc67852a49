"""``train_step``'s closed loop on device-resident batches (the same tree,
pool, warm-up and losses read one step behind) for the separate-encoder
ResNet-50 network trained with the contact losses: the weights are made
from ``reference/handnet_sep_train.py``'s parameter list, and the first
three updates are held to that reference by ``checks_sep_train`` (the
four numbers of ``checks.py``, with the shape term among the terms).
"""

from __future__ import annotations

import os
from typing import Dict

from portbench import checks, checks_sep_train, program
from portbench.drivers.train_step import Driver as StepDriver
from portbench.reference import handnet_sep_train as ref
from portbench.traffic import weights


class Driver(StepDriver):
    def build(self):
        cfg = program.model_config(self.run.config, **self.cfg_overrides)
        self.specs = ref.param_specs(self.run.config["model"])
        w = weights.make(self.specs, self.run.seed, self.device)
        self.net = program.handnet(cfg, os.path.dirname(self.mano["right"]), w, self.device)
        del w
        self.state, self.opt = program.train_state(self.net, self.run.config)
        self.names = program.param_names(self.net)

    def check(self) -> Dict[str, float]:
        model = ref.Model(self.run.config["model"], self.mano, self.device)
        w = weights.make(self.specs, self.run.seed, self.device)
        batches = [checks.to_device(b, self.device) for b in self.checked_batches]
        lr = float(self.run.config["train"]["lr"])
        ref_losses, ref_first, ref_change, ref_joints = checks_sep_train.follow_training(
            model, w, batches, lr)
        w_host = {k: v.cpu() for k, v in w.items()}
        prog_change = {k: v - w_host[k] for k, v in (self.after or {}).items()}
        numbers = checks_sep_train.train_numbers(self.losses, self.first or {}, prog_change,
                                                 ref_losses, ref_first, ref_change)
        if self.first_joints is not None:
            numbers["joints"] = checks.output_gap({"joints": self.first_joints.numpy()},
                                                  {"joints": ref_joints})
        return numbers
