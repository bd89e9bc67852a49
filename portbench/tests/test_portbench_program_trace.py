"""The readers of the program's spans (``program_trace.py`` and its nine
metrics) on a hand-built Chrome trace whose every value is known; their
silence on a trace without the program's spans or without a device; and a
tiny traced run of each cell on the CPU."""

import json
import types

import pytest

from portbench import core
from portbench.tests.tiny import run_tiny
from portbench.trace import WINDOW

MAIN, AUTOGRAD = 1, 2  # thread ids

# the program's spans (µs): two train steps with their phases, one span
# outside the window (left out), and three served batches
SPANS = [
    ("train.step", 100, 1100), ("train.forward", 150, 550), ("train.backward", 600, 900),
    ("train.optimizer", 950, 1050),
    ("train.step", 2000, 3200), ("train.forward", 2050, 2450), ("train.backward", 2500, 2800),
    ("train.optimizer", 2850, 2950),
    ("train.step", -500, -100), ("train.forward", -450, -300),
    ("serve.infer", 4000, 4500), ("serve.copy_pack", 4500, 4600), ("serve.copy_wait", 4700, 4900),
    ("serve.infer", 5000, 5300), ("serve.copy_pack", 5300, 5350), ("serve.copy_wait", 5400, 5450),
    ("serve.infer", 6000, 6100),
]
# the benchmark's own spans around them: not the program's
BENCH_SPANS = [("step", 90, 1110), ("step", 1990, 3210), ("dispatch", 3990, 4610)]
DEVICE = [
    ("kernel", 200, 500),                         # forward 1: idle 100 of 400
    ("kernel", 600, 700), ("kernel", 650, 720),   # backward 1, two streams: busy 270,
    ("kernel", 750, 900),                         # idle 30 of 300
    ("gpu_memcpy", 950, 1000),                    # optimizer 1: idle 50 of 100
    ("kernel", 2400, 2700),                       # forward 2 idle 350, backward 2 idle 100
    ("gpu_memset", 2850, 2950),                   # optimizer 2: idle 0
    ("kernel", 9000, 11000),                      # clipped at the window's end
]
RUNTIME = [  # (ts, name, category, thread)
    (210, "cudaLaunchKernel", "cuda_runtime", MAIN),
    (610, "cudaLaunchKernel", "cuda_runtime", AUTOGRAD),  # the backward's thread
    (620, "cuLaunchKernel", "cuda_driver", AUTOGRAD),
    (960, "cudaMemcpyAsync", "cuda_runtime", MAIN),
    (970, "cudaLaunchKernelExC", "cuda_runtime", MAIN),
    (1060, "cudaStreamSynchronize", "cuda_runtime", MAIN),
    (1500, "cudaLaunchKernel", "cuda_runtime", MAIN),        # between steps
    (1600, "cudaStreamSynchronize", "cuda_runtime", MAIN),   # between steps
    (2060, "cudaLaunchKernel", "cuda_runtime", MAIN),
    (2860, "cudaMemcpy", "cuda_runtime", MAIN),
    (3100, "cudaEventSynchronize", "cuda_runtime", MAIN),
    (4010, "cudaLaunchKernel", "cuda_runtime", MAIN),
    (4020, "cudaLaunchKernel", "cuda_runtime", MAIN),
    (4550, "cudaLaunchKernel", "cuda_runtime", MAIN),        # in copy_pack
    (4950, "cudaLaunchKernel", "cuda_runtime", MAIN),        # between batches
    (5010, "cudaLaunchKernel", "cuda_runtime", MAIN),
    (5320, "cudaLaunchKernel", "cuda_runtime", MAIN),        # in copy_pack
    (-200, "cudaLaunchKernel", "cuda_runtime", MAIN),        # before the window
]
EXPECTED = {
    "step_host_ms.train": 1.1,                    # median of 1000 and 1200 µs
    "forward_idle_ms.train": (100 + 350) / 2e3,
    "backward_idle_ms.train": (30 + 100) / 2e3,
    "optimizer_idle_ms.train": (50 + 0) / 2e3,
    "launches_per_step.train": 5 / 2,
    "host_syncs_per_step.train": 3 / 2,
    "infer_host_ms.serve": 0.3,                   # median of 500, 300, 100 µs
    "copy_wait_ms.serve": 0.125,                  # median of 200, 50 µs
    "launches_per_batch.serve": 5 / 3,
}
HOST_TIMES = {"step_host_ms.train", "infer_host_ms.serve", "copy_wait_ms.serve"}


def _trace(tmp_path, spans=SPANS, device=DEVICE, runtime=RUNTIME):
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0, "dur": 10000,
               "pid": 1, "tid": MAIN}]
    events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a,
                "pid": 1, "tid": MAIN} for n, a, b in list(spans) + BENCH_SPANS]
    events += [{"ph": "X", "cat": c, "name": "k", "ts": a, "dur": b - a, "pid": 0, "tid": 7}
               for c, a, b in device]
    events += [{"ph": "X", "cat": c, "name": n, "ts": ts, "dur": 5, "pid": 1, "tid": t}
               for ts, n, c, t in runtime]
    events.append({"ph": "i", "cat": "kernel", "name": "marker", "ts": 3000, "pid": 0})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return types.SimpleNamespace(traced={"path": str(path)})


def _read(name, run):
    return core.load_module("metrics", name).read(run)


def test_every_reader_is_in_the_benchmark_for_its_cell():
    bench = core.benchmark()
    for name in EXPECTED:
        cell = "contact_train_step" if name.endswith(".train") else "hand_object_batch_b256"
        assert name in {m["name"] for m in core.cell_metrics(bench, cell)[1]}, name


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_its_exact_value(name, tmp_path):
    assert _read(name, _trace(tmp_path)) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_is_silent_without_program_spans(name, tmp_path):
    assert _read(name, _trace(tmp_path, spans=[])) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_cpu_trace_gives_host_times_only(name, tmp_path):
    """No device or runtime record (a run on the CPU): no device number."""
    value = _read(name, _trace(tmp_path, device=[], runtime=[]))
    assert (value == pytest.approx(EXPECTED[name])) if name in HOST_TIMES else value is None


def test_the_trace_is_read_once(tmp_path):
    run = _trace(tmp_path)
    first = _read("step_host_ms.train", run)
    (tmp_path / "trace.json").unlink()
    assert [_read(n, run) for n in ("step_host_ms.train", "launches_per_batch.serve")] == [
        first, pytest.approx(EXPECTED["launches_per_batch.serve"])]


@pytest.mark.parametrize("cell,metric", [("contact_train_step", "step_host_ms.train"),
                                         ("hand_object_batch_b256", "infer_host_ms.serve")])
def test_a_tiny_traced_run_reads_the_programs_spans(cell, metric):
    result = run_tiny(cell, trace=True)
    assert result["correct"], result["checks"]
    assert result["metrics"][metric]["value"] > 0
    # no device number from the CPU
    assert not set(result["metrics"]) & (set(EXPECTED) - HOST_TIMES)
