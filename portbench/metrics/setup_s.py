"""Seconds from the start of the harness's entry module, before torch or
numpy is imported, to the first timed call: imports, the CUDA probe,
inputs and weights made, the model built, kernels built or loaded, and the
cell's shapes warmed up (host clock)."""


def read(run):
    return run.setup_s
