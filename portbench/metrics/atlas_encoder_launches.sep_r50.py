"""Kernel launch calls (``cudaLaunch*``, ``cuLaunch*``) that start inside
the program's ``handnet.atlas_encoder`` spans (the object encoder's call),
per served batch (``serve.infer`` spans; profiler trace): ~53 where the
object encoder takes the folded, fused route, ~170 where it runs
``ResNet.forward``. Silent where the trace holds no such span."""

from portbench.program_trace import calls_per, is_launch, reduced


def read(run):
    trace = reduced(run)
    if trace is None or not trace["spans"].get("handnet.atlas_encoder"):
        return None
    return calls_per(run, is_launch, ["handnet.atlas_encoder"], "serve.infer")
