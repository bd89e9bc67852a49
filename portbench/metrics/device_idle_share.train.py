"""Share (%) of the traced window in which no kernel, copy or memset ran
on the card (profiler trace)."""

from portbench.metrics_util import idle_share


def read(run):
    return idle_share(run)
