"""Kernel launch calls (``cudaLaunch*``, ``cuLaunch*``) of the CUDA runtime
and driver that start inside the program's ``train.step`` spans, on any
thread, per step (profiler trace)."""

from portbench.program_trace import calls_per, is_launch


def read(run):
    return calls_per(run, is_launch, ["train.step"], "train.step")
