"""Nothing the benchmark runs may load JAX, its libraries or the JAX
package; the port's name begins with the JAX package's, so names are
compared whole, by their top-level part."""

import ast
import json
import os
import sys
import types

import pytest

from portbench import core

FORBIDDEN = set(core.FORBIDDEN_MODULES)


def test_top_level_names_are_compared_whole():
    mods = {"obman_train_tpu_torch": 1, "obman_train_tpu_torch.ops.raytri": 1,
            "jaxtyping": 1, "flaxen": 1, "numpy": 1}
    assert core.forbidden_loaded(mods) == []
    mods.update({"obman_train_tpu.ops": 1, "jax.numpy": 1, "jaxlib": 1, "optax": 1, "orbax.checkpoint": 1})
    assert core.forbidden_loaded(mods) == ["jax.numpy", "jaxlib", "obman_train_tpu.ops",
                                           "optax", "orbax.checkpoint"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(core.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_no_benchmark_file_reads_bench_py():
    for path in _sources():
        assert "bench.py" not in open(path).read() or path.endswith(os.path.basename(__file__)), path


def test_the_reference_and_traffic_import_nothing_of_the_program():
    for sub in ("reference", "traffic", "counts"):
        for path in _sources(sub):
            for name in _imports(path):
                assert not name.startswith("obman_train_tpu"), (path, name)
                assert name.split(".")[0] in ("numpy", "torch", "portbench", "os", "pickle",
                                              "math", "typing", "json", "cv2", "concurrent",
                                              "__future__"), (path, name)


@pytest.mark.parametrize("loader", [None, "check", "reader"])
def test_a_forbidden_module_loaded_after_the_window_stops_the_result(loader, monkeypatch, capsys):
    """``main`` looks at ``sys.modules`` as its last step before the result
    line: a stub ``jax`` put there by the reference's check or by a metric
    reader stops the line and the exit code says so."""
    import torch

    from portbench import run as entry
    from portbench import serving
    from portbench.tests.tiny import TINY

    def load_jax():
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))

    if loader == "check":
        checked = serving.ServingDriver.check
        monkeypatch.setattr(serving.ServingDriver, "check",
                            lambda self: (load_jax(), checked(self))[1])
    elif loader == "reader":
        load_module = core.load_module

        def reader_loading_jax(kind, name):
            module = load_module(kind, name)
            if kind == "metrics":
                read = module.read
                module.read = lambda run: (load_jax(), read(run))[1]
            return module

        monkeypatch.setattr(core, "load_module", reader_loading_jax)
    monkeypatch.setattr(core, "point_caches_inside", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    run_cell = entry.run_cell
    cell = "hand_object_batch_b256"
    monkeypatch.setattr(entry, "run_cell", lambda *a, **k: run_cell(
        *a[:4], device="cpu", overrides=TINY[cell], t_start=k.get("t_start")))
    rc = entry.main(["--workload", cell, "--seed", "11", "--seconds", "0.5", "--trace", "0"])
    out = capsys.readouterr()
    if loader is None:
        assert rc == 0 and json.loads(out.out.strip().splitlines()[-1])["correct"]
    else:
        assert rc != 0 and out.out.strip() == "", out.out[-500:]
        assert "jax" in out.err
