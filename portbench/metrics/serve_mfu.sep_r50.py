"""The separate-encoder ResNet-50 network's served forward as a share (%)
of the card's dense TF32 peak: its operations per frame
(``counts/flops_sep.py``), times the frames of the batches dispatched in
the traced window, over that window."""

from portbench.counts import flops, flops_sep


def read(run):
    t0, t1 = run.trace_window
    batches = run.spans.count("dispatch", t0, t1)
    if not batches or t1 <= t0:
        return None
    cfg = run.config["model"]
    ops = batches * int(run.traffic["batch"]) * flops_sep.forward_flops(cfg, int(cfg["image_size"]))
    return 100.0 * ops / ((t1 - t0) * flops.peaks()["tf32_flops"])
