"""``serve_batch``'s offline inference (the same pool, loop, reservoir and
``checks.serve_reference``) for the separate-encoder ResNet-50 network:
the weights are made from, and the kept calls held to,
``reference/handnet_sep.py``.

Besides ``outputs``, the worst gap over every output, the check returns
the same gap of each output alone (``verts``, ``joints``,
``objpoints3d``, ``objtrans``, ``objscale``), each with its own limit in
the workload file.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from portbench import checks, program
from portbench.drivers.serve_batch import Driver as BatchDriver
from portbench.reference import handnet_sep as ref
from portbench.traffic import weights


class Driver(BatchDriver):
    def build(self):
        self.specs = ref.param_specs(self.run.config["model"])
        w = weights.make(self.specs, self.run.seed, self.device)
        override = dict(self.traffic.get("model_override", {}))
        self.model, self.image_size = program.demo_model(
            self.run.config, os.path.dirname(self.mano["right"]), w, self.device, **override)

    def check(self) -> Dict[str, float]:
        model = ref.Model(self.run.config["model"], self.mano, self.device)
        w = weights.make(self.specs, self.run.seed, self.device)
        items = self.checked()
        frames = np.concatenate([f for f, _, _ in items])
        sides = np.concatenate([s for _, s, _ in items])
        prog = {k: np.concatenate([o[k] for _, _, o in items]) for k in checks.SERVE_KEYS}
        refs = checks.serve_reference(model, w, frames, sides, self.image_size, self.device)
        gaps = {k: checks.output_gap({k: prog[k]}, {k: refs[k]}) for k in checks.SERVE_KEYS}
        return {"outputs": max(gaps.values()), **gaps}
