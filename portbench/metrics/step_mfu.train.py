"""The train step's share (%) of the card's dense TF32 peak (the precision
of the cells' convolutions): the model's operations per sample
(``counts/flops.py``), times the samples of the steps run in the traced
window, over that window."""

from portbench.counts import flops
from portbench.metrics_util import steps_traced


def read(run):
    steps, secs = steps_traced(run)
    if not steps or secs <= 0:
        return None
    cfg = run.config["model"]
    ops = steps * int(run.traffic["batch"]) * flops.train_flops(cfg, int(run.traffic["res"]))
    return 100.0 * ops / (secs * flops.peaks()["tf32_flops"])
