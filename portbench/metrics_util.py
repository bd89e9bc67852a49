"""Arithmetic the per-layer readers share: the steps of the traced window,
a kernel family's roofline share, and the device's idle share."""

from __future__ import annotations

from typing import Optional, Tuple

from portbench.counts import flops
from portbench.trace import kernel_time

# kernel families, by the names of their kernels in the device trace
KERNELS = {"raytri": ("raytri_count",), "nn": ("nn_dir_kernel", "nn_merge_slices")}


def steps_traced(run) -> Tuple[int, float]:
    """Train steps dispatched in the traced window, and its seconds."""
    t0, t1 = run.trace_window
    return run.spans.count("step", t0, t1), t1 - t0


def roofline(run, family: str) -> Optional[float]:
    """Bound time of the traced steps' work of ``family`` over its kernels'
    device time, in %; None where no such kernel ran."""
    if run.traced is None:
        return None
    secs = launches = 0
    for needle in KERNELS[family]:
        s, n = kernel_time(run.traced, needle)
        secs, launches = secs + s, launches + n
    steps, _ = steps_traced(run)
    if not launches or secs <= 0 or not steps:
        return None
    geo = flops.train_geometry(run.config["model"])
    rows = steps * int(run.traffic["batch"])
    if family == "raytri":
        ops = sum(flops.raytri_ops(rows, p, t) for p, t in geo["raytri"])
        nbytes = sum(flops.raytri_bytes(rows, p, t) for p, t in geo["raytri"])
    else:
        ops = sum(flops.nn_ops(rows, q, p) for q, p, _ in geo["nn"])
        nbytes = sum(flops.nn_bytes(rows, q, p, a) for q, p, a in geo["nn"])
    if not ops:
        return None
    peak = flops.peaks()
    bound = max(ops / peak["fp32_flops"], nbytes / peak["hbm_bytes_per_s"])
    return 100.0 * bound / secs


def idle_share(run) -> Optional[float]:
    if run.traced is None or run.traced["window_s"] <= 0:
        return None
    t = run.traced
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
