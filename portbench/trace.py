"""The traced part of a ``--trace 1`` window: ``torch.profiler`` over the
device and the host, written as a Chrome trace under ``TMPDIR``, and
reduced to what the per-layer readers take.

Times in the trace are microseconds on the profiler's clock; the window is
the ``portbench.window`` range that the driver opens around the traced
calls. A device event is a kernel, a copy or a memset.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Tuple

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160  # device-op names are cut to this length in the breakdown


class Window:
    """The measured window of ``run.seconds`` on the host clock. In a
    ``--trace 1`` run its first ``trace_seconds`` are profiled (device and
    host), the run's spans annotated in the trace, and the trace reduced
    into ``run.traced`` when that part closes; ``run.trace_window`` is the
    traced part on the host clock."""

    def __init__(self, run, trace_seconds: float):
        self.run = run
        self.trace_seconds = min(float(trace_seconds), float(run.seconds))
        self._prof = self._range = None

    def __enter__(self):
        import torch

        run = self.run
        if run.device == "cuda":
            torch.cuda.synchronize()
        if run.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if run.device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._range = torch.profiler.record_function(WINDOW)
            self._range.__enter__()
            run.spans.annotate = True
        self.t0 = time.perf_counter()
        run.setup_s = self.t0 - run.t_start
        self.deadline = self.t0 + run.seconds
        return self

    def open(self) -> bool:
        """True while the window lasts; closes the traced part when due."""
        now = time.perf_counter()
        if self._prof is not None and now >= self.t0 + self.trace_seconds:
            self._stop_trace()
        return now < self.deadline

    def _stop_trace(self):
        import torch

        run = self.run
        if run.device == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        self._range.__exit__(None, None, None)
        run.spans.annotate = False
        self._prof.__exit__(None, None, None)
        prof, self._prof = self._prof, None
        path = write_path(run)
        prof.export_chrome_trace(path)
        run.trace_window = (self.t0, t1)
        run.traced = summarize(path)
        run.traced["path"] = path

    def close(self, t_end: float):
        """End the window at ``t_end``, once the work dispatched in it has
        finished."""
        self.run.window = (self.t0, t_end)
        if self._prof is not None:
            self._stop_trace()

    def __exit__(self, *exc):
        if self._prof is not None:
            self._range.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            self._prof = None
        return False


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(path: str) -> Dict:
    """``busy_s``, ``window_s``, device time and launches by kernel name,
    the longest idle gaps named by the host span around them, and the
    device operations that took most time."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    window = None
    host: List[Tuple[float, float, str]] = []
    device: List[Dict] = []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        if cat == "user_annotation":
            if ev["name"] == WINDOW:
                window = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
            else:
                host.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev["name"]))
        elif cat in DEVICE_CATS:
            device.append(ev)
    if window is None:
        raise RuntimeError(f"the trace {path} has no {WINDOW} range")
    w0, w1 = window
    by_name: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    intervals = []
    for ev in device:
        a = max(float(ev["ts"]), w0)
        b = min(float(ev["ts"]) + float(ev["dur"]), w1)
        if b <= a:
            continue
        intervals.append((a, b))
        by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + (b - a) * 1e-6
        if ev.get("cat") == "kernel":
            launches[ev["name"]] = launches.get(ev["name"], 0) + 1
    busy = _union(intervals)
    gaps = []
    cursor = w0
    for a, b in busy + [(w1, w1)]:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    named = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        around = [h for h in host if h[0] <= mid <= h[1]]
        # the innermost span, the one that started last, names the gap
        label = max(around)[2] if around else "outside_spans"
        named.append([label, (b - a) * 1e-6])
    named.sort(key=lambda g: -g[1])
    ops = sorted(([n[:NAME_CHARS], s] for n, s in by_name.items()), key=lambda o: -o[1])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "device_time": by_name,
        "launches": launches,
        "breakdown": {"device_ops": ops[:10], "idle_gaps": named[:10]},
        "spans": host,
    }


def kernel_time(traced: Dict, needle: str) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds ``needle``."""
    secs = sum(s for n, s in traced["device_time"].items() if needle in n)
    count = sum(c for n, c in traced["launches"].items() if needle in n)
    return secs, count


def write_path(run) -> str:
    base = os.environ.get("TMPDIR") or "/tmp"
    os.makedirs(os.path.join(base, "portbench"), exist_ok=True)
    return os.path.join(base, "portbench", f"trace-{run.cell}-{run.seed}-{os.getpid()}.json")
