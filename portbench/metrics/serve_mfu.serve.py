"""The served forward's share (%) of the card's dense TF32 peak: the
model's forward operations per frame (``counts/flops.py``), times the
frames of the batches dispatched in the traced window, over that window."""

from portbench.counts import flops


def read(run):
    t0, t1 = run.trace_window
    batches = run.spans.count("dispatch", t0, t1)
    if not batches or t1 <= t0:
        return None
    ops = batches * int(run.traffic["batch"]) * flops.forward_flops(run.config["model"], int(run.config["model"]["image_size"]))
    return 100.0 * ops / ((t1 - t0) * flops.peaks()["tf32_flops"])
