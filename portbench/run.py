"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files (``workloads/<cell>.json``, its configuration, traffic
mix, driver and metric readers) are found by name. Set-up makes the
inputs and weights from ``--seed``, builds the program and warms up the
cell's shapes; the window then measures for ``--seconds``; afterwards the
program's state is freed and the plain reference checks what the timed
path produced. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also end standard error.

It exits with a code other than 0 and prints no result without a CUDA
card (or fewer cards than the cell asks for), and when JAX, its
libraries or the JAX package are loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here, before any other import

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

from portbench import core  # noqa: E402


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: Optional[Dict] = None, t_start: Optional[float] = None) -> Dict:
    """One run of ``cell``; ``overrides`` replace traffic parameters (the
    CPU tests run tiny sizes with ``device="cpu"``); set-up is timed from
    ``t_start`` (default: now)."""
    import torch

    bench = core.benchmark()
    workload = core.load_json("workloads", cell)
    config = core.load_json("configs", workload["config"])
    traffic = core.load_json("traffic/mixes", workload["traffic"])
    traffic.update(overrides or {})
    run = core.Run(cell, workload, config, traffic, seed, seconds, trace, device, t_start)
    driver = core.load_module("drivers", traffic["driver"]).Driver(run)
    try:
        driver.setup()
        driver.window()
        if device == "cuda":
            torch.cuda.synchronize()
            run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        driver.finish()
        numbers = driver.check()
    finally:
        driver.cleanup()
    limits = workload["limits"]
    run.checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in run.checks.values())
    e2e, layer = core.cell_metrics(bench, cell)
    metrics = {}
    for entry in (layer if trace else e2e):
        value = core.load_module("metrics", entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    result = {"correct": bool(correct), "attempted": int(run.attempted), "failed": int(run.failed),
              "metrics": metrics, "device": core.device_record(run, int(workload["chips"]))}
    if trace and run.traced is not None:
        result["breakdown"] = run.traced["breakdown"]
        result["trace_file"] = run.traced["path"]
    result["checks"] = run.checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    core.point_caches_inside()
    import torch

    chips = int(core.load_json("workloads", args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    # the last step before the result: whatever the window, the check or a
    # reader loaded counts
    found = core.forbidden_loaded()
    if found:
        print(f"portbench: loaded once the window had closed: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
