"""Offline inference over a test set: B=256 uint8 256x256 crops from a
pool of pre-stacked seeded batches, each through the program's
``DemoModel._infer`` (its preprocessing and the model) -> ``HostCopy``,
one batch in flight as ``cli/video_demo.py``'s dispatch/collect keep it:
the next batch is dispatched before the last one's results are read back.

The mix's ``frames`` says where the pool is held: ``"device"`` on the
card, so each batch is read there as a pipeline that decodes on the card
would hand it over; ``"host"`` in host memory, each batch then going
through the program's ``demo.inference.to_device`` first (its pinned
packing and copy)."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.serving import ServingDriver
from portbench.trace import Window
from portbench.traffic import frames


class Driver(ServingDriver):
    def setup(self):
        from obman_train_tpu_torch.demo.inference import HostCopy, to_device

        self._to_device, self._copy = to_device, HostCopy
        t = self.traffic
        b, size = int(t["batch"]), int(t["crop"])
        pool = frames.pool(self.run.seed, int(t["pool_batches"]) * b, size, size)
        self.batches = pool.reshape(int(t["pool_batches"]), b, size, size, 3)
        self.sides = frames.sides(b)
        self.flips = np.zeros(b, bool)
        self.build()
        self.on_device = t["frames"] == "device"
        if self.on_device:
            dev = self.model.device
            self.resident = [torch.from_numpy(x).to(dev) for x in self.batches]
            self.sides_t = torch.from_numpy(self.sides).to(dev)
            self.flips_t = torch.from_numpy(self.flips).to(dev)
        pending = None
        for i in range(int(t["warmup_batches"])):
            copy = self._dispatch(i)
            if pending is not None:
                pending.get()
            pending = copy
        pending.get()

    def _dispatch(self, i: int):
        k = i % len(self.batches)
        if self.on_device:
            frames_t, sides_t, flips_t = self.resident[k], self.sides_t, self.flips_t
        else:
            frames_t, sides_t, flips_t = self._to_device(
                self.model.device, self.batches[k], self.sides, self.flips)
        return self._copy(self.model._infer(self.model._variables, frames_t, sides_t, flips_t))

    def window(self):
        run = self.run
        done, pending = 0, None
        with Window(run, float(run.workload.get("trace_seconds", run.seconds))) as win:
            i = int(self.traffic["warmup_batches"])
            while win.open():
                with run.spans("dispatch"):
                    copy = self._dispatch(i)
                if pending is not None:
                    self._collect(*pending)
                    done += 1
                pending = (i, copy)
                i += 1
            self._collect(*pending)
            done += 1
            win.close(time.perf_counter())
        b = int(self.traffic["batch"])
        run.attempted, run.failed = done, 0
        run.work["frames"] = done * b

    def _collect(self, i, copy):
        with self.run.spans("host_copy.get"):
            out = copy.get()
        self.kept.offer(lambda: (i, out))

    def finish(self):
        self.resident = None
        super().finish()

    def checked(self):
        return [(self.batches[i % len(self.batches)], self.sides, out) for i, out in self.kept.items]
