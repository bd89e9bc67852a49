"""Kernel launch calls (``cudaLaunch*``, ``cuLaunch*``) that start inside
the program's ``handnet.atlas_encoder`` spans (the object encoder's
forward in the train step: its fold under autograd and its fused
convolutions), per train step (``train.step`` spans; profiler trace).
Silent where the trace holds no such span."""

from portbench.program_trace import calls_per, is_launch, reduced


def read(run):
    trace = reduced(run)
    if trace is None or not trace["spans"].get("handnet.atlas_encoder"):
        return None
    return calls_per(run, is_launch, ["handnet.atlas_encoder"], "train.step")
