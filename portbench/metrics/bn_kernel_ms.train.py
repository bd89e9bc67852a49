"""Frozen BatchNorm on the card: device ms per train step traced of the
kernels whose names hold ``bn_fw`` (cuDNN's inference-mode forward) or
``batch_norm`` (ATen's BatchNorm kernels: the eval-mode backward's
elementwise pass and its reductions), summed over the traced window. No
kernel name holds both. None without a trace, a traced step or such a
kernel."""

from portbench.metrics_util import steps_traced
from portbench.trace import kernel_time

NEEDLES = ("bn_fw", "batch_norm")


def read(run):
    if run.traced is None:
        return None
    steps, _ = steps_traced(run)
    found = [kernel_time(run.traced, needle) for needle in NEEDLES]
    if not steps or not sum(n for _, n in found):
        return None
    return 1e3 * sum(s for s, _ in found) / steps
