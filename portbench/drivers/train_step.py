"""The train step in a closed loop on device-resident batches: the
program's ``train.make_train_step`` at the mix's batch (returning the
predicted joints, as the epoch loop builds it), fed a pool of distinct
batches made in set-up from an ObMan-layout tree by the benchmark's own
copy of the augmentation chain, cycled; each step's losses are read back
one step behind, as the program's epoch loop reads them.

Set-up makes the tree, the pool and the model, then drives the step on
the pool's first three batches (the checked steps) and a few more.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from portbench import core
from portbench.trace import Window
from portbench.traffic import obman_chain, obman_tree
from portbench.training import TrainingDriver, losses_to_host, read_losses

TREE_STREAM, ORDER_STREAM = 41, 42


class Driver(TrainingDriver):
    def setup(self):
        t = self.traffic
        root = os.path.join(self.tmp, "tree")
        tree_seed = core.sub_seed(self.run.seed, TREE_STREAM)
        tree = obman_chain.Tree(*obman_tree.write_tree(root, int(t["tree_samples"]), tree_seed,
                                                       img_size=int(t["tree_image_size"])))
        rng = np.random.default_rng(core.sub_seed(self.run.seed, ORDER_STREAM))
        host_pool = []
        for k in range(int(t["pool_batches"])):
            idxs = rng.choice(len(tree), self.batch_size, replace=len(tree) < self.batch_size)
            host_pool.append(obman_chain.batch(tree, idxs, epoch=k + 1, seed=tree_seed,
                                               threads=int(t["threads"]), res=int(t["res"])))
        self.checked_batches = host_pool[:3]
        self.pool = [{k: torch.from_numpy(v).to(self.device) for k, v in b.items()}
                     for b in host_pool]
        self.build()
        from obman_train_tpu_torch.data.loader import derive_spec
        from obman_train_tpu_torch.train import make_train_step

        # the step returns its predicted joints, as the epoch loop builds it
        self.step = make_train_step(self.net, self.opt, derive_spec(self.pool[0]),
                                    device=self.device, return_joints=True)
        for i in range(int(t["warmup_steps"])):
            self.state, losses, joints = self.step(self.state, self.pool[i % len(self.pool)])
            if i < 3:
                self.record_step({k: float(v) for k, v in losses.items()}, joints)
        if self.device == "cuda":
            torch.cuda.synchronize()

    def window(self):
        run = self.run
        steps, failed, pending = 0, 0, None
        with Window(run, float(run.workload.get("trace_seconds", run.seconds))) as win:
            i = int(self.traffic["warmup_steps"])
            while win.open():
                with run.spans("step"):
                    self.state, losses, _ = self.step(self.state, self.pool[i % len(self.pool)])
                copy = losses_to_host(losses)
                if pending is not None:
                    with run.spans("host_copy.get"):
                        failed += not np.isfinite(read_losses(pending)["total_loss"])
                    steps += 1
                pending = copy
                i += 1
            failed += not np.isfinite(read_losses(pending)["total_loss"])
            steps += 1
            win.close(time.perf_counter())
        run.attempted, run.failed = steps, failed
        run.work["samples"] = steps * self.batch_size

    def finish(self):
        del self.pool
        self.free()
