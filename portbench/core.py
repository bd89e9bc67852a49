"""What every cell shares: finding files by name, seeds, spans, the
no-JAX check and the device record.

Everything a configuration, a traffic mix, a driver or a metric owns sits
in a file of its own under this folder, found by the name that
``BENCHMARK.json`` and the workload files give:

- ``configs/<config>.json``: the model configuration as it is run;
- ``workloads/<cell>.json``: the cell's configuration, traffic and limits;
- ``traffic/mixes/<traffic>.json``: the traffic's parameters and driver;
- ``drivers/<driver>.py``: one module per kind of traffic;
- ``metrics/<metric>.py``: one reader per metric.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# top-level module names that must not be loaded: JAX, its libraries, and
# the JAX package the port was made from (compared whole: the port's name
# begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "obman_train_tpu")


def load_json(kind: str, name: str) -> Dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (a metric's name may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: Dict, cell: str) -> Tuple[List[Dict], List[Dict]]:
    """``(end_to_end, per_layer)`` entries that ``cell`` reports: those whose
    ``workloads`` list names it, and those without one (``setup_s``, and a
    per-layer metric of an end-to-end metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m["workloads"] or ("workloads" not in m and m["moves"] in names)]
    return e2e, layer


def sub_seed(seed: int, *purpose: int) -> int:
    """A 63-bit seed of its own for each purpose, from the run's seed."""
    return int(np.random.SeedSequence([int(seed) & (2**64 - 1), *purpose])
               .generate_state(1, np.uint64)[0] >> 1)


def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN_MODULES})


def point_caches_inside(root: str = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so only
    the first run of a checkout builds (the port's own nvcc and g++
    outputs already go to its git-ignored ``ops/kernels/build/`` and
    ``native/lib/``)."""
    cache = os.path.join(root, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv_compute")


def scratch_dir(name: str) -> str:
    """A directory of this run under ``TMPDIR`` (the driver gives each side
    its own)."""
    base = os.environ.get("TMPDIR") or "/tmp"
    path = os.path.join(base, "portbench", f"{name}-{os.getpid()}")
    os.makedirs(path, exist_ok=True)
    return path


class Spans:
    """Host-clock spans of the benchmark's own calls into the program,
    kept in memory. With a profiler on, each span is also a
    ``record_function`` range, so the device trace can name what the host
    was doing in an idle gap."""

    def __init__(self):
        self.spans: List[Tuple[str, float, float]] = []
        self.annotate = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.annotate:
            import torch

            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.spans.append((name, t0, time.perf_counter()))

    def total(self, name: str, t0: float = float("-inf"), t1: float = float("inf")) -> float:
        """Seconds spent in spans called ``name`` inside [t0, t1]."""
        return sum(max(0.0, min(b, t1) - max(a, t0))
                   for n, a, b in self.spans if n == name)

    def count(self, name: str, t0: float = float("-inf"), t1: float = float("inf")) -> int:
        return sum(1 for n, a, b in self.spans if n == name and a >= t0 and b <= t1)


class Run:
    """What a driver hands to the metric readers: times, work done, the
    traced window and the numbers compared."""

    def __init__(self, cell: str, workload: Dict, config: Dict, traffic: Dict,
                 seed: int, seconds: float, trace: bool, device: str,
                 t_start: Optional[float] = None):
        self.cell, self.workload, self.config, self.traffic = cell, workload, config, traffic
        self.seed, self.seconds, self.trace, self.device = int(seed), seconds, trace, device
        self.spans = Spans()
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.setup_s: Optional[float] = None
        self.window: Tuple[float, float] = (0.0, 0.0)    # host clock, whole window
        self.attempted = 0
        self.failed = 0
        self.work: Dict = {}          # driver's counts: samples, frames, latencies
        self.traced: Optional[Dict] = None   # trace.summarize() of the traced part
        self.trace_window: Tuple[float, float] = (0.0, 0.0)  # its host-clock bounds
        self.checks: Dict[str, Dict[str, float]] = {}
        self.memory_peak_bytes = 0

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def device_record(run: Run, chips: int) -> Dict:
    import torch

    if run.device == "cuda":
        kind = torch.cuda.get_device_name(0)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    rec = {"platform": platform, "kind": kind, "count": chips,
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace and run.traced is not None:
        rec["busy_s"] = run.traced["busy_s"]
        rec["window_s"] = run.traced["window_s"]
    return rec
