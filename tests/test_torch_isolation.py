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
    """The checks above walk the package; the modules of every slice are
    among what they walk."""
    walked = {m for _, m in _modules()}
    for name in (
        "obman_train_tpu_torch.infer", "obman_train_tpu_torch.ops.raytri",
        "obman_train_tpu_torch.ops.nnsqdist", "obman_train_tpu_torch.ops.chamfer",
        "obman_train_tpu_torch.ops.mesh", "obman_train_tpu_torch.assets.laplacian",
        "obman_train_tpu_torch.models.losses", "obman_train_tpu_torch.train",
        "obman_train_tpu_torch.train.steps",
        # the training entry point and what it runs
        "obman_train_tpu_torch.config", "obman_train_tpu_torch.data",
        "obman_train_tpu_torch.data.queries", "obman_train_tpu_torch.data.transforms",
        "obman_train_tpu_torch.data.synthetic", "obman_train_tpu_torch.data.dataset",
        "obman_train_tpu_torch.data.factory", "obman_train_tpu_torch.data.loader",
        "obman_train_tpu_torch.native", "obman_train_tpu_torch.native.build",
        "obman_train_tpu_torch.ops.image", "obman_train_tpu_torch.train.metrics",
        "obman_train_tpu_torch.train.checkpoint", "obman_train_tpu_torch.train.loop",
        "obman_train_tpu_torch.utils", "obman_train_tpu_torch.utils.logging",
        "obman_train_tpu_torch.cli", "obman_train_tpu_torch.cli.traineval",
        # the serving entry points and the figures
        "obman_train_tpu_torch.demo", "obman_train_tpu_torch.demo.inference",
        "obman_train_tpu_torch.demo.export", "obman_train_tpu_torch.demo.preprocess",
        "obman_train_tpu_torch.demo.attention", "obman_train_tpu_torch.cli.image_demo",
        "obman_train_tpu_torch.cli.video_demo", "obman_train_tpu_torch.cli.export",
        "obman_train_tpu_torch.visualize", "obman_train_tpu_torch.visualize.displaymano",
        "obman_train_tpu_torch.visualize.viz2d", "obman_train_tpu_torch.visualize.viz3d",
        "obman_train_tpu_torch.visualize.html_mesh",
        # the training recipe: the uint8 chain, process workers, unfrozen BN
        "obman_train_tpu_torch.models.resnet", "obman_train_tpu_torch.models.branches",
        "obman_train_tpu_torch.models.handnet",
    ):
        assert name in walked, name


SCRIPTS = ["chip_smoke.py"] + sorted(
    os.path.join("tools", n) for n in os.listdir(os.path.join(REPO, "tools"))
    if n.startswith("torch_") and n.endswith(".py"))


@pytest.mark.parametrize("rel", SCRIPTS)
def test_port_scripts_import_nothing_forbidden(rel):
    """``chip_smoke.py`` and the port's tools run where JAX is absent."""
    assert "tools/torch_convergence_run.py" in SCRIPTS
    for name in _imported_roots(os.path.join(REPO, rel)):
        assert name.split(".")[0] not in FORBIDDEN, f"{rel} imports {name}"
