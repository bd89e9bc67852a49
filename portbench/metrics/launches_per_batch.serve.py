"""Kernel launch calls (``cudaLaunch*``, ``cuLaunch*``) that start inside
the program's ``serve.infer`` and ``serve.copy_pack`` spans, per batch
(``serve.infer`` spans; profiler trace)."""

from portbench.program_trace import calls_per, is_launch


def read(run):
    return calls_per(run, is_launch, ["serve.infer", "serve.copy_pack"], "serve.infer")
