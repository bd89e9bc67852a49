"""Calls that block the host on the card (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, ``cudaMemcpy``) that
start inside the program's ``train.step`` spans, per step (profiler
trace). A step that reads nothing back makes none."""

from portbench.program_trace import calls_per, is_sync


def read(run):
    return calls_per(run, is_sync, ["train.step"], "train.step")
