"""Device idle time per train step inside the program's ``train.forward``
spans: the milliseconds a step in which the host was in this phase and
no kernel, copy or memset ran on the card, over the traced window's
``train.step`` spans (profiler trace)."""

from portbench.program_trace import idle_ms_per


def read(run):
    return idle_ms_per(run, "train.forward", "train.step")
