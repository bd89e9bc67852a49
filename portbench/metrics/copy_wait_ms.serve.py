"""The host blocked on a batch's outputs: the median duration of the
program's ``serve.copy_wait`` spans (``HostCopy.get`` waiting on the
copy's event) in the traced window (profiler trace)."""

from portbench.program_trace import median_ms


def read(run):
    return median_ms(run, "serve.copy_wait")
