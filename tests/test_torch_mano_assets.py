"""Real MANO files in the port (``assets/mano_assets.py``) against the JAX
package's loader, on a MANO pkl that the test writes in the official
layout: chumpy ``Ch`` arrays (a stand-in ``chumpy`` module, registered only
while pickling, so the loaders must do without chumpy), a scipy sparse
``J_regressor``, uint32 faces, a (2, 16) kinematic tree, Python-2 style
latin-1 pickling.

- ``load_mano_pkl``: every table equal to the JAX package's, exactly;
- the ``.npz`` cache round trip, and ``load_mano_assets`` preferring it;
- ``fix_left_shapedirs``, and ``FileNotFoundError`` naming both file names.
"""

import os
import pickle
import sys
import types
from dataclasses import fields

import numpy as np
import pytest
import scipy.sparse

from obman_train_tpu.assets import mano_assets as jmano
from obman_train_tpu_torch.assets import mano_assets as pmano
from obman_train_tpu_torch.assets import synthetic_mano_assets

TABLES = ("v_template", "shapedirs", "posedirs", "J_regressor", "weights",
          "hands_components", "hands_mean", "faces", "parents")


class _Ch:
    """What a pickled ``chumpy.ch.Ch`` carries: its array under ``x``."""

    def __init__(self, x):
        self.x = x


def write_mano_dir(root, seed: int = 0, sides=("right", "left")) -> str:
    """``MANO_{RIGHT,LEFT}.pkl`` under ``root`` in the official layout, with
    tables drawn from the synthetic hand perturbed by ``seed``."""
    rng = np.random.default_rng(seed)
    chumpy = types.ModuleType("chumpy")
    ch = types.ModuleType("chumpy.ch")
    _Ch.__module__, _Ch.__qualname__ = "chumpy.ch", "Ch"
    ch.Ch = _Ch
    chumpy.ch = ch
    saved = {k: sys.modules.get(k) for k in ("chumpy", "chumpy.ch")}
    sys.modules.update({"chumpy": chumpy, "chumpy.ch": ch})
    try:
        for side in sides:
            a = synthetic_mano_assets(side, seed=seed)
            jreg = np.where(a.J_regressor > 1e-3, a.J_regressor, 0.0)  # sparse, as MANO's
            data = {
                "v_template": _Ch(a.v_template.astype(np.float64)
                                  + rng.normal(0, 1e-4, a.v_template.shape)),
                "shapedirs": _Ch(a.shapedirs.astype(np.float64)),
                "posedirs": a.posedirs.astype(np.float64),
                "J_regressor": scipy.sparse.csc_matrix(jreg.astype(np.float64)),
                "weights": a.weights.astype(np.float64),
                "hands_components": a.hands_components.astype(np.float64),
                "hands_mean": a.hands_mean.astype(np.float64),
                "hands_coeffs": rng.normal(0, 1, (1554, 45)),
                "f": a.faces.astype(np.uint32),
                "kintree_table": np.stack([
                    np.r_[np.int64(4294967295), a.parents[1:].astype(np.int64)],
                    np.arange(16, dtype=np.int64)]),
                "J": rng.normal(0, 0.05, (16, 3)),
                "bs_style": "lbs",
                "bs_type": "lrotmin",
            }
            with open(os.path.join(root, f"MANO_{side.upper()}.pkl"), "wb") as f:
                pickle.dump(data, f, protocol=2)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    return str(root)


@pytest.fixture(scope="module")
def mano_dir(tmp_path_factory):
    return write_mano_dir(tmp_path_factory.mktemp("mano"))


def _assert_tables_equal(p, j):
    for name in TABLES:
        a, b = getattr(p, name), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert p.side == j.side


@pytest.mark.parametrize("side", ["right", "left"])
def test_load_mano_pkl_equals_jax(mano_dir, side):
    assert "chumpy" not in sys.modules  # the loaders do without it
    path = os.path.join(mano_dir, f"MANO_{side.upper()}.pkl")
    p, j = pmano.load_mano_pkl(path, side), jmano.load_mano_pkl(path, side)
    _assert_tables_equal(p, j)
    assert p.v_template.dtype == np.float32 and p.faces.dtype == np.int32
    assert p.parents[0] == -1 and list(p.parents[1:]) == list(pmano.MANO_PARENTS[1:])
    # the sparse regressor came through dense
    assert p.J_regressor.shape == (16, 778) and (p.J_regressor == 0).any()


def test_npz_round_trip_and_preference(mano_dir, tmp_path):
    a = pmano.load_mano_pkl(os.path.join(mano_dir, "MANO_LEFT.pkl"), "left")
    npz_dir = tmp_path / "npz"
    npz_dir.mkdir()
    a.save_npz(str(npz_dir / "MANO_LEFT.npz"))
    b = pmano.ManoAssets.load_npz(str(npz_dir / "MANO_LEFT.npz"))
    assert {f.name for f in fields(b)} >= set(TABLES) | {"side"}
    _assert_tables_equal(b, a)
    # the JAX package reads the port's cache, and the port the JAX one's
    _assert_tables_equal(b, jmano.ManoAssets.load_npz(str(npz_dir / "MANO_LEFT.npz")))
    jmano.load_mano_assets(mano_dir, "left").save_npz(str(tmp_path / "jax.npz"))
    _assert_tables_equal(pmano.ManoAssets.load_npz(str(tmp_path / "jax.npz")), a)
    # with both files present the npz wins
    os.symlink(os.path.join(mano_dir, "MANO_LEFT.pkl"), npz_dir / "MANO_LEFT.pkl")
    np.savez(str(npz_dir / "MANO_LEFT.npz"), side=np.array("left"),
             **{t: getattr(a, t) * (2 if t == "v_template" else 1) for t in TABLES})
    got = pmano.load_mano_assets(str(npz_dir), "left")
    np.testing.assert_array_equal(got.v_template, 2 * a.v_template)


@pytest.mark.parametrize("side,fix", [("left", True), ("left", False), ("right", True)])
def test_load_mano_assets_fix_left_shapedirs_as_jax(mano_dir, side, fix):
    p = pmano.load_mano_assets(mano_dir, side, fix_left_shapedirs=fix)
    j = jmano.load_mano_assets(mano_dir, side, fix_left_shapedirs=fix)
    _assert_tables_equal(p, j)
    raw = pmano.load_mano_pkl(os.path.join(mano_dir, f"MANO_{side.upper()}.pkl"), side)
    flipped = fix and side == "left"
    np.testing.assert_array_equal(p.shapedirs[:, 0], -raw.shapedirs[:, 0] if flipped
                                  else raw.shapedirs[:, 0])
    np.testing.assert_array_equal(p.shapedirs[:, 1:], raw.shapedirs[:, 1:])


def test_missing_dir_raises_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError, match=r"MANO_RIGHT\.npz or MANO_RIGHT\.pkl"):
        pmano.load_mano_assets(str(tmp_path / "nowhere"), "right")


def test_bad_tables_raise(tmp_path):
    a = synthetic_mano_assets("right")
    np.savez(str(tmp_path / "MANO_RIGHT.npz"), side=np.array("right"),
             **{t: getattr(a, t) for t in TABLES if t != "weights"},
             weights=a.weights[:, :15])
    with pytest.raises(ValueError, match="weights"):
        pmano.load_mano_assets(str(tmp_path), "right")


def test_load_mano_pair_reads_the_directory(mano_dir):
    from obman_train_tpu.cli.traineval import load_mano_pair as jpair
    from obman_train_tpu_torch.cli.traineval import load_mano_pair as ppair

    right, left = ppair(mano_dir, fix_left_shapedirs=True)
    jright, jleft = jpair(mano_dir, fix_left_shapedirs=True)  # MANO params (JAX)
    for p, j in ((right, jright), (left, jleft)):
        np.testing.assert_array_equal(p.v_template, np.asarray(j.v_template))
        np.testing.assert_array_equal(p.shapedirs, np.asarray(j.shapedirs))
        np.testing.assert_array_equal(p.J_regressor, np.asarray(j.J_regressor))
