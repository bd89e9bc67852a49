"""The port package stands alone: it imports neither JAX (nor flax, optax,
orbax) nor anything of the JAX package ``obman_train_tpu``."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "obman_train_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "obman_train_tpu")


def _modules():
    for root, _, files in os.walk(PACKAGE):
        for name in sorted(files):
            if name.endswith(".py"):
                path = os.path.join(root, name)
                rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
                yield path, rel[: -len(".__init__")] if rel.endswith("__init__") else rel


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", [p for p, _ in _modules()],
                         ids=[m for _, m in _modules()])
def test_source_imports_nothing_forbidden(path):
    for name in _imported_roots(path):
        assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_every_module_imports_without_jax():
    modules = [m for _, m in _modules()]
    code = "\n".join([
        "import sys",
        # a None entry makes any import of these modules raise ImportError
        *[f"sys.modules[{name!r}] = None" for name in ("jax", "jaxlib", "flax",
                                                       "optax", "orbax")],
        "import importlib",
        f"for m in {modules!r}:",
        "    importlib.import_module(m)",
        "bad = sorted(m for m in sys.modules",
        "             if m == 'obman_train_tpu' or m.startswith('obman_train_tpu.'))",
        "assert not bad, bad",
        "print('ok', len(" + repr(modules) + "))",
    ])
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_walk_covers_every_slice_module():
    """The checks above walk the package; the modules of both slices are
    among what they walk."""
    walked = {m for _, m in _modules()}
    for name in (
        "obman_train_tpu_torch.infer", "obman_train_tpu_torch.ops.raytri",
        "obman_train_tpu_torch.ops.nnsqdist", "obman_train_tpu_torch.ops.chamfer",
        "obman_train_tpu_torch.ops.mesh", "obman_train_tpu_torch.assets.laplacian",
        "obman_train_tpu_torch.models.losses", "obman_train_tpu_torch.train",
        "obman_train_tpu_torch.train.steps",
    ):
        assert name in walked, name
