"""Each driver end to end on the CPU at a tiny size: the program against
the plain reference (they agree), and the measurement path without a
card (it refuses and prints no result)."""

import json
import subprocess
import sys
import time

import pytest

from portbench import core
from portbench.tests.tiny import TINY, run_tiny


@pytest.mark.parametrize("cell", sorted(TINY))
def test_driver_runs_and_agrees_with_the_reference(cell):
    result = run_tiny(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert "setup_s" in result["metrics"]
    if cell in {w["name"] for w in core.benchmark()["workloads"]}:
        assert len(result["metrics"]) >= 2
    assert list(result)[-1] == "checks"


def test_the_batch_driver_also_takes_frames_from_host_memory():
    """``"frames": "host"``: each batch through the program's ``to_device``."""
    result = run_tiny("hand_object_batch_b256", frames="host")
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0


@pytest.mark.parametrize("cell", ["contact_train_step", "hand_object_batch_b256"])
def test_traced_run_reports_its_layer_metrics(cell):
    result = run_tiny(cell, trace=True)
    assert result["correct"], result["checks"]
    assert "breakdown" in result and len(result["breakdown"]["idle_gaps"]) <= 10
    assert result["device"]["window_s"] > 0
    _, layer = core.cell_metrics(core.benchmark(), cell)
    assert set(result["metrics"]) <= {m["name"] for m in layer}


def test_setup_is_timed_from_the_start_it_is_given():
    """``main`` passes the time its module started, before torch was
    imported; set-up runs from there to the window."""
    from portbench.run import run_cell

    t_start = time.perf_counter() - 100.0
    result = run_cell("hand_object_batch_b256", 3, 0.5, False, device="cpu",
                      overrides=TINY["hand_object_batch_b256"], t_start=t_start)
    assert 100.0 < result["metrics"]["setup_s"]["value"] < 100.0 + (time.perf_counter() - t_start)


def test_measurement_without_a_card_refuses(tmp_path):
    code = ("import torch, sys; torch.cuda.is_available = lambda: False;"
            "from portbench.run import main; sys.exit(main(['--workload', 'contact_train_step',"
            " '--seed', '1', '--seconds', '1', '--trace', '0']))")
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_cell_on_the_card(cuda_card):
    """The smallest cell at its own size on the card (run there with
    ``python3 -m pytest -m cuda portbench/tests``)."""
    from portbench.run import run_cell

    result = run_cell("hand_object_batch_b256", 5, 2.0, False)
    assert result["correct"], result["checks"]
    json.dumps(result)


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
