"""The separate-encoder ResNet-50 train step's share (%) of the card's
dense TF32 peak (the precision of its convolutions and matmuls): its
operations per sample (``counts/flops_sep_train.py``: three forwards and
the losses' geometry), times the samples of the steps run in the traced
window, over that window."""

from portbench.counts import flops, flops_sep_train
from portbench.metrics_util import steps_traced


def read(run):
    steps, secs = steps_traced(run)
    if not steps or secs <= 0:
        return None
    cfg = run.config["model"]
    ops = steps * int(run.traffic["batch"]) * flops_sep_train.train_flops(cfg, int(run.traffic["res"]))
    return 100.0 * ops / (secs * flops.peaks()["tf32_flops"])
