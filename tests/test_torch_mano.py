"""The port's MANO layer and synthetic assets against the JAX package.

float32: atol 2e-3 mm, the f32 floor PARITY.md measured for ~100 mm
outputs. float64: the same math to 1e-6 mm, and the committed golden
(captured from the f32 JAX layer) to its own 1e-3 mm.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obman_train_tpu.assets import synthetic_mano_assets as jax_synthetic
from obman_train_tpu.models.mano import mano_forward as jax_mano
from obman_train_tpu.models.mano import mano_params_from_assets
from obman_train_tpu.ops.rotations import rodrigues as jax_rodrigues
from obman_train_tpu_torch.assets import (
    JOINT_REORDER,
    MANO_PARENTS,
    PALM_VERT_IDS,
    TIPS,
    synthetic_mano_assets,
)
from obman_train_tpu_torch.models.mano import ManoLayer, mano_forward
from obman_train_tpu_torch.ops.rotations import rodrigues

torch.set_num_threads(2)

F32_ATOL = 2e-3  # mm

_FIELDS = ("v_template", "shapedirs", "posedirs", "J_regressor", "weights",
           "hands_components", "hands_mean", "faces", "parents")


@pytest.fixture(scope="module")
def sides():
    out = {}
    for side in ("right", "left"):
        assets = synthetic_mano_assets(side)
        out[side] = (assets, ManoLayer(assets), mano_params_from_assets(jax_synthetic(side)))
    return out


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_assets_bit_identical(side, seed):
    ours, theirs = synthetic_mano_assets(side, seed), jax_synthetic(side, seed)
    for name in _FIELDS:
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_constant_tables_match_jax():
    from obman_train_tpu.assets import mano_assets as jm

    np.testing.assert_array_equal(TIPS, jm.TIPS)
    np.testing.assert_array_equal(JOINT_REORDER, jm.JOINT_REORDER)
    np.testing.assert_array_equal(MANO_PARENTS, jm.MANO_PARENTS)
    assert PALM_VERT_IDS == jm.PALM_VERT_IDS


def test_rodrigues_matches_jax():
    aa = np.random.default_rng(0).normal(0, 1.0, (64, 3)).astype(np.float32)
    aa[0] = 0.0  # the exponential map at the origin
    np.testing.assert_allclose(
        rodrigues(torch.from_numpy(aa)).numpy(),
        np.asarray(jax_rodrigues(jnp.asarray(aa))), atol=1e-6,
    )


def _both(sides, side, pose, betas=None, trans=None, **kw):
    _, layer, params = sides[side]
    t = lambda a: None if a is None else torch.from_numpy(a)
    j = lambda a: None if a is None else jnp.asarray(a)
    v, jt = mano_forward(layer, t(pose), t(betas), t(trans), **kw)
    jv, jj = jax_mano(params, j(pose), j(betas), j(trans), **kw)
    return (v.numpy(), jt.numpy()), (np.asarray(jv), np.asarray(jj))


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("ncomps", [6, 30, 45])
def test_pca_pose_matches_jax(sides, side, ncomps):
    rng = np.random.default_rng(ncomps)
    pose = rng.normal(0, 0.5, (4, ncomps + 3)).astype(np.float32)
    betas = rng.normal(0, 1.0, (4, 10)).astype(np.float32)
    (v, j), (jv, jj) = _both(sides, side, pose, betas, ncomps=ncomps)
    assert v.shape == (4, 778, 3) and j.shape == (4, 21, 3)
    np.testing.assert_allclose(v, jv, atol=F32_ATOL)
    np.testing.assert_allclose(j, jj, atol=F32_ATOL)


@pytest.mark.parametrize(
    "kw",
    [
        dict(center_idx=9),
        dict(center_idx=0, root_palm=True),
        dict(center_idx=None),
        dict(use_trans=True),
        dict(use_trans=True, root_palm=True),
        dict(no_betas=True),
        dict(use_pca=False),
    ],
    ids=["center9", "center0_palm", "no_center", "trans", "trans_palm",
         "no_betas", "axisangle"],
)
def test_mano_options_match_jax(sides, kw):
    rng = np.random.default_rng(1)
    kw = dict(kw)
    use_trans = kw.pop("use_trans", False)
    no_betas = kw.pop("no_betas", False)
    use_pca = kw.get("use_pca", True)
    pose = rng.normal(0, 0.5, (3, 9 if use_pca else 48)).astype(np.float32)
    betas = None if no_betas else rng.normal(0, 1.0, (3, 10)).astype(np.float32)
    trans = rng.normal(0, 0.1, (3, 3)).astype(np.float32) if use_trans else None
    (v, j), (jv, jj) = _both(sides, "right", pose, betas, trans, **kw)
    np.testing.assert_allclose(v, jv, atol=F32_ATOL)
    np.testing.assert_allclose(j, jj, atol=F32_ATOL)


@pytest.mark.parametrize("side", ["right", "left"])
def test_rotmat_pose_matches_jax(sides, side):
    rng = np.random.default_rng(2)
    aa = rng.normal(0, 0.4, (3, 16, 3)).astype(np.float32)
    rots = np.array(jax_rodrigues(jnp.asarray(aa)))  # (3, 16, 3, 3)
    betas = rng.normal(0, 1.0, (3, 10)).astype(np.float32)
    (v, j), (jv, jj) = _both(sides, side, rots, betas)
    np.testing.assert_allclose(v, jv, atol=F32_ATOL)
    np.testing.assert_allclose(j, jj, atol=F32_ATOL)


@pytest.mark.parametrize("ncomps", [6, 45])
def test_float64_math_matches_jax_x64(sides, ncomps):
    """In float64 both layers compute the same math to 1e-6 mm."""
    rng = np.random.default_rng(5)
    assets, _, _ = sides["right"]
    pose = rng.normal(0, 0.5, (3, ncomps + 3))
    betas = rng.normal(0, 1.0, (3, 10))
    layer64 = ManoLayer(assets).double()
    v, j = mano_forward(layer64, torch.from_numpy(pose), torch.from_numpy(betas),
                        ncomps=ncomps)
    with jax.enable_x64(True):
        params64 = mano_params_from_assets(jax_synthetic("right"), dtype=jnp.float64)
        jv, jj = jax_mano(params64, jnp.asarray(pose), jnp.asarray(betas),
                          ncomps=ncomps)
        jv, jj = np.asarray(jv), np.asarray(jj)
    assert v.dtype == torch.float64
    np.testing.assert_allclose(v.numpy(), jv, atol=1e-6)
    np.testing.assert_allclose(j.numpy(), jj, atol=1e-6)


def test_golden_in_float64(sides):
    golden = np.load(
        os.path.join(os.path.dirname(__file__), "goldens", "mano_golden.npz")
    )
    layer64 = ManoLayer(sides["right"][0]).double()
    v, j = mano_forward(
        layer64, torch.from_numpy(golden["pose"].astype(np.float64)),
        torch.from_numpy(golden["betas"].astype(np.float64)), ncomps=6,
    )
    np.testing.assert_allclose(v.numpy(), golden["verts"], atol=1e-3)
    np.testing.assert_allclose(j.numpy(), golden["joints"], atol=1e-3)
