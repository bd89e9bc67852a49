"""Folds of the serving encoder's BatchNorms into its convolutions (the
program's ``serve.fold`` spans, ``ServeNet._folded``) per batch
(``serve.infer`` spans) in the traced window: 0 while the fold made in
set-up stays valid, 1 where every batch folds again (profiler trace)."""

from portbench.program_trace import reduced


def read(run):
    trace = reduced(run)
    if trace is None:
        return None
    batches = len(trace["spans"].get("serve.infer", []))
    if not batches:
        return None
    return len(trace["spans"].get("serve.fold", [])) / batches
