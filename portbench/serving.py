"""What a serving driver needs besides its traffic: the program's
``demo.DemoModel`` fed the benchmark's weights and MANO files, the calls
kept for the check (drawn from the seed by reservoir sampling over every
call of the window), and the reference's predictions for them."""

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

MANO_STREAM, KEEP_STREAM = 31, 61


class Reservoir:
    """A uniform sample of ``size`` items from a stream of unknown length."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen, self.items = int(size), 0, []
        self.rng = np.random.default_rng(seed)

    def offer(self, make):
        """Count one item; keep ``make()`` if the draw says so."""
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.size:
                self.items[j] = make()


class ServingDriver:
    def __init__(self, run: core.Run):
        self.run, self.traffic, self.device = run, run.traffic, run.device
        self.tmp = core.scratch_dir(run.cell)
        self.mano = mano_files.write(os.path.join(self.tmp, "mano"), core.sub_seed(run.seed, MANO_STREAM))
        self.kept = Reservoir(int(self.traffic["checked_calls"]), core.sub_seed(run.seed, KEEP_STREAM))

    def build(self):
        self.specs = ref.param_specs(self.run.config["model"])
        w = weights.make(self.specs, self.run.seed, self.device)
        override = dict(self.traffic.get("model_override", {}))
        self.model, self.image_size = program.demo_model(
            self.run.config, os.path.dirname(self.mano["right"]), w, self.device, **override)

    def finish(self):
        del self.model
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def checked(self) -> List:
        """``[(frames, sides, outputs)]`` of the kept calls."""
        raise NotImplementedError

    def check(self) -> Dict[str, float]:
        model = ref.Model(self.run.config["model"], self.mano, self.device)
        w = weights.make(self.specs, self.run.seed, self.device)
        items = self.checked()
        frames = np.concatenate([f for f, _, _ in items])
        sides = np.concatenate([s for _, s, _ in items])
        prog = {k: np.concatenate([o[k] for _, _, o in items]) for k in checks.SERVE_KEYS}
        refs = checks.serve_reference(model, w, frames, sides, self.image_size, self.device)
        return {"outputs": checks.output_gap(prog, refs)}

    def cleanup(self):
        shutil.rmtree(self.tmp, ignore_errors=True)
