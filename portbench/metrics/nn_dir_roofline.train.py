"""``nn_dir``, the nearest-neighbour sweeps: the least time the traced
steps' nearest-neighbour queries could take on the card (operations at
the float32 peak, or bytes at the memory bandwidth) as a share (%) of the
device time of every ``nn_dir`` and slice-merge kernel in the traced
window."""

from portbench.metrics_util import roofline


def read(run):
    return roofline(run, "nn")
