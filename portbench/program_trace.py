"""The program's own spans in a ``--trace 1`` run's Chrome trace, and what
the device and the CUDA runtime did inside them.

The port opens ``record_function`` ranges at its layer boundaries while a
profiler records (``obman_train_tpu_torch/utils/tracing.py``): ``train.*``,
``handnet.*`` and ``serve.*``. They lie on the trace's one clock with the
device's kernels, copies and memsets and with the host's CUDA runtime and
driver calls, so a phase's share of either is found by time containment,
on any thread: the backward's kernels are launched from autograd's thread
while the calling thread sits in ``train.backward``.

The trace at ``run.traced["path"]`` is read once, reduced to what lies in
the ``portbench.window`` range, and kept in ``run.traced``. Every reader
returns None where the trace holds no span of its phase (a tree without
the program's spans), and a device reader where the trace holds no device
or runtime record at all (a run on the CPU).
"""

from __future__ import annotations

import bisect
import json
import statistics
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from portbench.trace import DEVICE_CATS, WINDOW, _union

PREFIXES = ("train.", "handnet.", "serve.")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
LAUNCHES = ("cudaLaunch", "cuLaunch")  # name prefixes of a kernel launch call
# calls that block the host until the device has caught up (cudaMemcpy,
# not cudaMemcpyAsync)
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")
KEY = "program"  # where the reduced trace is kept in run.traced

Interval = Tuple[float, float]


def reduce(path: str) -> Dict:
    """``spans`` ({name: [(start, end)]}, the program's spans wholly in the
    window), ``busy`` (the union of the device's intervals, clipped to the
    window) and ``calls`` ([(ts, name)] of the runtime and driver calls
    that start in the window), times in trace microseconds."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    events = [ev for ev in events if ev.get("ph") == "X" and "dur" in ev]
    window = next(((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])) for ev in events
                   if ev.get("cat") == "user_annotation" and ev["name"] == WINDOW), None)
    if window is None:
        raise RuntimeError(f"the trace {path} has no {WINDOW} range")
    w0, w1 = window
    spans: Dict[str, List[Interval]] = {}
    device: List[Interval] = []
    calls: List[Tuple[float, str]] = []
    for ev in events:
        cat, a = ev.get("cat", ""), float(ev["ts"])
        b = a + float(ev["dur"])
        if cat == "user_annotation" and ev["name"].startswith(PREFIXES):
            if w0 <= a and b <= w1:
                spans.setdefault(ev["name"], []).append((a, b))
        elif cat in DEVICE_CATS:
            if min(b, w1) > max(a, w0):
                device.append((max(a, w0), min(b, w1)))
        elif cat in RUNTIME_CATS and w0 <= a <= w1:
            calls.append((a, ev["name"]))
    busy = _union(device)
    return {"spans": spans, "busy": busy, "busy_starts": [a for a, _ in busy],
            "calls": sorted(calls)}


def reduced(run) -> Optional[Dict]:
    """The run's reduced trace, read at the first call; None untraced."""
    if run.traced is None:
        return None
    if KEY not in run.traced:
        run.traced[KEY] = reduce(run.traced["path"])
    return run.traced[KEY]


def _phase(trace: Dict, names: Iterable[str]) -> List[Interval]:
    return _union([s for n in names for s in trace["spans"].get(n, [])])


def _count(trace: Dict, name: str) -> int:
    return len(trace["spans"].get(name, []))


def median_ms(run, name: str) -> Optional[float]:
    """Median duration (ms) of the spans called ``name``."""
    trace = reduced(run)
    if trace is None or not _count(trace, name):
        return None
    return statistics.median(b - a for a, b in trace["spans"][name]) * 1e-3


def _busy_inside(trace: Dict, a: float, b: float) -> float:
    busy = trace["busy"]
    i = max(bisect.bisect_right(trace["busy_starts"], a) - 1, 0)
    total = 0.0
    while i < len(busy) and busy[i][0] < b:
        total += max(0.0, min(busy[i][1], b) - max(busy[i][0], a))
        i += 1
    return total


def idle_ms_per(run, phase: str, per: str) -> Optional[float]:
    """Device idle time (ms) inside the spans ``phase`` over the count of
    the spans ``per``."""
    trace = reduced(run)
    if trace is None or not trace["busy"] or not _count(trace, phase) or not _count(trace, per):
        return None
    idle = sum((b - a) - _busy_inside(trace, a, b) for a, b in _phase(trace, [phase]))
    return idle * 1e-3 / _count(trace, per)


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCHES)


def is_sync(name: str) -> bool:
    return name in SYNCS


def calls_per(run, match: Callable[[str], bool], phases: Iterable[str],
              per: str) -> Optional[float]:
    """Runtime and driver calls whose name ``match``es that start inside
    the spans ``phases``, over the count of the spans ``per``."""
    trace = reduced(run)
    if trace is None or not trace["calls"] or not _count(trace, per):
        return None
    inside = _phase(trace, phases)
    starts = [a for a, _ in inside]
    n = 0
    for ts, name in trace["calls"]:
        i = bisect.bisect_right(starts, ts) - 1
        n += i >= 0 and ts <= inside[i][1] and match(name)
    return n / _count(trace, per)
