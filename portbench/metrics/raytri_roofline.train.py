"""K1, the inside test: the least time the traced steps' inside tests
could take on the card (their operations at the float32 peak, or their
bytes at the memory bandwidth, whichever is longer) as a share (%) of
the device time of every ``raytri_count`` kernel in the traced window."""

from portbench.metrics_util import roofline


def read(run):
    return roofline(run, "raytri")
