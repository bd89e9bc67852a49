"""The host's time in one served batch's forward: the median duration of
the program's ``serve.infer`` spans (``DemoModel._infer``) in the traced
window (profiler trace)."""

from portbench.program_trace import median_ms


def read(run):
    return median_ms(run, "serve.infer")
