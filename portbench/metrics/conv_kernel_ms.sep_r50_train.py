"""The two encoders' convolutions on the card: device ms per train step
traced of the kernels whose names hold ``fprop``, ``dgrad`` or ``wgrad``
(cuDNN's forward, data-gradient and weight-gradient convolutions), summed
over the traced window, each kernel counted once. A time and not a share:
some convolution work may run under other names. None without a trace, a
traced step or such a kernel."""

from portbench.metrics_util import steps_traced

NEEDLES = ("fprop", "dgrad", "wgrad")


def read(run):
    if run.traced is None:
        return None
    steps, _ = steps_traced(run)
    secs = [s for name, s in run.traced["device_time"].items()
            if any(needle in name for needle in NEEDLES)]
    if not steps or not secs:
        return None
    return 1e3 * sum(secs) / steps
