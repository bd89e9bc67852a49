"""Export parity: every public name of the JAX package has its counterpart
in the port under the same module path, or stands on the list of names
that have none on purpose (ROADMAP.md section 1), each with its reason.

Both packages are read by AST, nothing is imported: the names each
``__init__`` lists in ``__all__``, and the top-level public functions and
classes of each module. The list is exact: every entry must be missing
from the port, so an entry that gains a counterpart has to leave it.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "obman_train_tpu", "obman_train_tpu_torch"

# "module (JAX path, dotted under the package): name" -> why the port has none
NO_COUNTERPART = {
    "utils.compcache:enable_persistent_cache":
        "eager PyTorch compiles nothing; ops/kernels/build/ keeps the kernels",
    "ops.maxpool:maxpool_3x3s2": "an XLA custom backward, off by default, same numbers",
    "ops.maxpool:maxpool_3x3s2_applicable": "the same module's gate",
    "ops.stemconv:stem_conv7x7": "an XLA custom backward, off by default, same numbers",
    "ops.stemconv:stem_conv_applicable": "the same module's gate",
    "models.resnet:StemConv": "the stem_conv7x7 module's wrapper; the port's stem is nn.Conv2d",
    "ops.pallas.chamfer_kernel:pallas_chamfer_min_sqdist":
        "the Pallas kernels K2-K5; ported as ops/nnsqdist.py on ops/kernels/nnsqdist.cu",
    "ops.pallas.raytri_kernel:pallas_mesh_contains_points":
        "the Pallas kernel K1; ported as ops/raytri.py on ops/kernels/raytri.cu",
    "parallel.mesh:make_mesh": "the process group is the port's mesh",
    "parallel.mesh:batch_sharding": "the process group is the port's mesh",
    "parallel.mesh:replicated": "the process group is the port's mesh",
    "train.loop:StepCache": "one jit per BatchSpec; eager steps need no cache",
    "models.resnet:import_torch_state_dict":
        "the port's modules carry the torch names; cli/import_torch.py reads them",
    "train.checkpoint:import_torch_handnet":
        "the port's modules carry the torch names; cli/import_torch.py reads them",
    "models.mano:ManoParams": "the port's models/mano.py ManoLayer(assets) holds them",
    "models.mano:mano_params_from_assets": "the port's ManoLayer(assets) builds them",
    "models.branches:MLP": "inlined as ManoBranch.base_layer",
    "data.dataset:PoseDatasetProtocol": "a typing Protocol only",
}


def _files(pkg):
    """``{dotted module under pkg ('' for the package): path}``."""
    out = {}
    for root, _, files in os.walk(os.path.join(REPO, pkg)):
        for name in files:
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, name), os.path.join(REPO, pkg))
                mod = rel[:-3].replace(os.sep, ".")
                out[mod[: -len("__init__")].rstrip(".") if mod.endswith("__init__") else mod] = \
                    os.path.join(root, name)
    return out


JAX_FILES, PORT_FILES = _files(JAX_PKG), _files(PORT_PKG)
JAX_INITS = sorted(m for m, p in JAX_FILES.items() if p.endswith("__init__.py"))


def _tree(path):
    return ast.parse(open(path).read(), path)


def _all(path):
    for node in _tree(path).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return [e.value for e in node.value.elts]
    return None


def _defined(path):
    return {n.name for n in _tree(path).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


def _sources(path, pkg):
    """``{name: defining module}`` of an ``__init__``'s absolute imports."""
    out = {}
    for node in _tree(path).body:
        if isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for alias in node.names:
                out[alias.asname or alias.name] = node.module[len(pkg) + 1:]
    return out


def _missing_in_port():
    """``{"module:name"}`` public names of JAX modules that the port's module
    of the same path does not define."""
    missing = set()
    for mod, path in JAX_FILES.items():
        if path.endswith("__init__.py"):
            continue
        own = _defined(PORT_FILES[mod]) if mod in PORT_FILES else set()
        missing |= {f"{mod}:{n}" for n in _defined(path) - own}
    return missing


@pytest.mark.parametrize("init", JAX_INITS, ids=[m or JAX_PKG for m in JAX_INITS])
def test_port_init_exports_what_jax_init_exports(init):
    names = _all(JAX_FILES[init])
    if names is None:
        return  # the JAX __init__ lists no names (the package root, cli)
    sources = _sources(JAX_FILES[init], JAX_PKG)
    exempt = {n for n in names if f"{sources[n]}:{n}" in NO_COUNTERPART}
    if exempt == set(names):
        return  # every name it exports has no counterpart on purpose
    port = _all(PORT_FILES[init])
    assert port is not None, f"{PORT_PKG}.{init} lists no __all__"
    assert set(names) - exempt <= set(port), sorted(set(names) - exempt - set(port))


def test_every_public_module_name_has_a_counterpart():
    unlisted = sorted(_missing_in_port() - set(NO_COUNTERPART))
    assert not unlisted, unlisted


def test_no_counterpart_list_is_exact():
    """Each listed name is still missing from the port, and exists in JAX."""
    stale = sorted(set(NO_COUNTERPART) - _missing_in_port())
    assert not stale, stale
