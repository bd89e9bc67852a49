"""The host's time in one train step: the median duration of the
program's ``train.step`` spans in the traced window (profiler trace).
Near the step's share of the window (~136 ms at B=512) the host, not the
card, sets the pace."""

from portbench.program_trace import median_ms


def read(run):
    return median_ms(run, "train.step")
