"""The harness finds every file by name, and a new cell is a new file and
an entry, with no existing file edited."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import core

KINDS = ("configs", "workloads", "traffic/mixes")


@pytest.mark.parametrize("kind", KINDS)
def test_every_data_file_loads_by_name(kind):
    names = [f[:-5] for f in os.listdir(os.path.join(core.HERE, kind)) if f.endswith(".json")]
    assert names
    for name in names:
        assert isinstance(core.load_json(kind, name), dict)


def test_every_metric_reader_loads_by_name():
    names = [f[:-3] for f in os.listdir(os.path.join(core.HERE, "metrics"))
             if f.endswith(".py") and f != "__init__.py"]
    assert names
    for name in names:
        assert callable(core.load_module("metrics", name).read)


def test_benchmark_entries_have_their_files():
    bench = core.benchmark()
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(core.ROOT, c["file"]))
    for w in bench["workloads"]:
        wl = core.load_json("workloads", w["name"])
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert wl["chips"] == w["chips"]
        core.load_module("drivers", core.load_json("traffic/mixes", wl["traffic"])["driver"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        core.load_module("metrics", m["name"])


def test_each_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    bench = core.benchmark()
    for w in bench["workloads"]:
        e2e, layer = core.cell_metrics(bench, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer


def test_a_new_cell_is_a_file_and_an_entry(tmp_path):
    """A copy of the benchmark with one more workload file and its entry
    runs that cell with no other file changed."""
    root = tmp_path / "checkout"
    shutil.copytree(core.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = core.benchmark()
    bench["workloads"].append({"name": "probe_step_b4", "config": "obman_contact",
                               "traffic": "obman_pool_b512", "chips": 1, "why": "probe"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "contact_train_step" in m.get("workloads", []):
            m["workloads"].append("probe_step_b4")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    wl = core.load_json("workloads", "contact_train_step")
    (root / "portbench" / "workloads" / "probe_step_b4.json").write_text(json.dumps(wl))
    code = ("import json; from portbench.tests.tiny import TINY; from portbench.run import run_cell;"
            "r = run_cell('probe_step_b4', 7, 0.5, False, device='cpu',"
            " overrides=TINY['contact_train_step']); print(json.dumps(r))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), core.ROOT]))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and "train_samples_per_s" in result["metrics"]
