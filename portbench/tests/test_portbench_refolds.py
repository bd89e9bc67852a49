"""``refolds_per_batch.serve`` on hand-built Chrome traces: 0 with no
``serve.fold`` span, k/N with k of them in N served batches, the spans
outside the window left out, and silence without ``serve.infer`` spans or
untraced."""

import json
import types

import pytest

from portbench import core
from portbench.trace import WINDOW

# three served batches (µs), each with its encoder span
BATCHES = [("serve.infer", a, a + 400) for a in (1000, 2000, 3000)]
ENCODER = [("handnet.encoder", a + 50, a + 200) for a in (1000, 2000, 3000)]


def _run(tmp_path, spans):
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0, "dur": 10000,
               "pid": 1, "tid": 1}]
    events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a,
                "pid": 1, "tid": 1} for n, a, b in spans]
    events += [{"ph": "X", "cat": "kernel", "name": "k", "ts": a + 60, "dur": 100,
                "pid": 0, "tid": 7} for _, a, _ in BATCHES]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return types.SimpleNamespace(traced={"path": str(path)})


def _read(run):
    return core.load_module("metrics", "refolds_per_batch.serve").read(run)


def test_in_the_benchmark_for_the_serving_cell():
    names = {m["name"] for m in core.cell_metrics(core.benchmark(), "hand_object_batch_b256")[1]}
    assert "refolds_per_batch.serve" in names


@pytest.mark.parametrize("folds", [0, 1, 2, 3])
def test_folds_over_batches(folds, tmp_path):
    spans = BATCHES + ENCODER + [("serve.fold", a + 60, a + 90) for _, a, _ in BATCHES[:folds]]
    spans.append(("serve.fold", -300, -200))  # in set-up, before the window
    assert _read(_run(tmp_path, spans)) == pytest.approx(folds / 3, rel=1e-12)


def test_zero_is_a_reading_not_silence(tmp_path):
    value = _read(_run(tmp_path, BATCHES + ENCODER))
    assert value == 0 and value is not None


def test_silent_without_served_batches_or_a_trace(tmp_path):
    assert _read(_run(tmp_path, [("serve.fold", 100, 200)])) is None
    assert _read(types.SimpleNamespace(traced=None)) is None
