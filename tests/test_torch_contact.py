"""The port's contact forward against the JAX ``compute_contact_loss`` on
identical hand/object inputs, and against the reference goldens in float64.

The scene puts a MANO hand half inside an icosphere(3) object of radius
~50 mm, so both the interior and the exterior class occur. Masks must be
exactly equal; nearest-point indices equal except at near-ties (a
different index is accepted only where its distance ties the minimum to
the plane's float32 resolution); ``min_dists`` and ``contact_points``
rtol 1e-4, atol 1e-2 mm^2 (mm for points).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obman_train_tpu.ops.contact import compute_contact_loss as jax_contact
from obman_train_tpu_torch.assets import icosphere, synthetic_mano_assets
from obman_train_tpu_torch.ops.chamfer import batch_pairwise_sqdist
from obman_train_tpu_torch.ops.contact import compute_contact_loss, masked_mean_loss

torch.set_num_threads(2)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "reference_goldens.npz")


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    hand = synthetic_mano_assets("right").v_template * 1000.0  # mm
    hand = hand[None] + rng.normal(0, 2.0, (2, 778, 3))
    verts, faces = icosphere(3)
    center = hand.mean(axis=1, keepdims=True)
    obj = np.stack([
        verts * 50.0 + center[0] + np.array([40.0, 0.0, 0.0]),
        verts * 45.0 + center[1] + np.array([0.0, 30.0, 10.0]),
    ])
    return hand.astype(np.float32), obj.astype(np.float32), np.array(faces)


def _run_both(scene, **kw):
    hand, obj, faces = scene
    want = jax_contact(jnp.asarray(hand), jnp.asarray(obj), jnp.asarray(faces), **kw)
    got = compute_contact_loss(torch.from_numpy(hand), torch.from_numpy(obj),
                               torch.from_numpy(faces), **kw)
    return got, want


def _check_nearest(scene, got_pts, want_pts):
    """Nearest object points agree except at documented near-ties."""
    hand, obj, _ = scene
    differ = np.any(got_pts != want_pts, axis=-1)
    assert differ.mean() < 0.01
    if differ.any():
        d = batch_pairwise_sqdist(torch.from_numpy(hand), torch.from_numpy(obj)).numpy()
        dmin = d.min(axis=2)
        got_d = ((hand - got_pts) ** 2).sum(-1)
        np.testing.assert_allclose(got_d[differ], dmin[differ], rtol=1e-4, atol=1e-2)


def test_scene_has_both_classes(scene):
    (_, _, info, _), _ = _run_both(scene, contact_zones="all")
    rep = info["repulsion_masks"].numpy()
    assert 0 < rep.sum() < rep.size


@pytest.mark.parametrize("zones", ["all", "tips", "zones"])
@pytest.mark.parametrize("mode", ["dist_sq", "dist", "dist_tanh"])
@pytest.mark.parametrize("sym", [False, True])
def test_contact_matches_jax(scene, mode, zones, sym):
    kw = dict(contact_thresh=10.0, contact_mode=mode, collision_thresh=20.0,
              collision_mode=mode, contact_target="all", contact_sym=sym,
              contact_zones=zones)
    (attr, penetr, info, metrics), (jattr, jpenetr, jinfo, jmetrics) = _run_both(
        scene, **kw
    )
    for key in ("attraction_masks", "repulsion_masks"):
        np.testing.assert_array_equal(info[key].numpy(), np.asarray(jinfo[key]),
                                      err_msg=key)
    np.testing.assert_allclose(info["min_dists"].numpy(), np.asarray(jinfo["min_dists"]),
                               rtol=1e-4, atol=1e-2)
    _check_nearest(scene, info["contact_points"].numpy(),
                   np.asarray(jinfo["contact_points"]))
    np.testing.assert_allclose(float(attr), float(jattr), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(penetr), float(jpenetr), rtol=1e-4, atol=1e-4)
    for key in ("max_penetr", "mean_penetr"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    if zones == "zones":
        assert info["attraction_masks"].sum(dim=1).max() <= 6


@pytest.mark.parametrize("target", ["obj", "hand"])
def test_contact_targets_match_jax_forward(scene, target):
    kw = dict(contact_thresh=10.0, contact_mode="dist_tanh", collision_thresh=20.0,
              collision_mode="dist_tanh", contact_target=target,
              contact_zones="zones")
    (attr, penetr, info, _), (jattr, jpenetr, jinfo, _) = _run_both(scene, **kw)
    np.testing.assert_array_equal(info["attraction_masks"].numpy(),
                                  np.asarray(jinfo["attraction_masks"]))
    np.testing.assert_allclose(float(attr), float(jattr), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(penetr), float(jpenetr), rtol=1e-4, atol=1e-4)


def test_invalid_modes_raise(scene):
    hand, obj, faces = (torch.from_numpy(a) for a in scene)
    with pytest.raises(ValueError):
        compute_contact_loss(hand, obj, faces, contact_zones="palm")
    with pytest.raises(ValueError):
        compute_contact_loss(hand, obj, faces, contact_mode="l1")
    with pytest.raises(ValueError):
        compute_contact_loss(hand, obj, faces, contact_target="both")


def test_masked_mean_loss():
    vals = torch.tensor([[1.0, 2.0, 3.0]])
    mask = torch.tensor([[True, False, True]])
    assert float(masked_mean_loss(vals, mask)) == pytest.approx(2.0)
    assert float(masked_mean_loss(vals, torch.zeros_like(mask))) == 0.0


@pytest.mark.parametrize("zones", ["all", "tips", "zones"])
@pytest.mark.parametrize("mode", ["dist_sq", "dist", "dist_tanh"])
def test_contact_matches_reference_goldens_f64(mode, zones):
    g = np.load(GOLDENS)
    missed, penetr, _, metrics = compute_contact_loss(
        torch.from_numpy(g["contact_hand"]), torch.from_numpy(g["contact_obj"]),
        torch.from_numpy(g["ico_faces"]), contact_thresh=10.0, contact_mode=mode,
        collision_thresh=20.0, collision_mode=mode, contact_target="all",
        contact_zones=zones,
    )
    pre = f"contact/{mode}/{zones}"
    np.testing.assert_allclose(float(missed), g[f"{pre}/missed"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(penetr), g[f"{pre}/penetr"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(metrics["max_penetr"]), g[f"{pre}/max_penetr"],
                               rtol=1e-6)
    np.testing.assert_allclose(float(metrics["mean_penetr"]), g[f"{pre}/mean_penetr"],
                               rtol=1e-6)


@pytest.mark.parametrize("target", ["all", "obj", "hand"])
def test_detach_placement_matches_reference_gradients_f64(target):
    """``detach`` where JAX stops gradients == the reference's ``.detach()``."""
    g = np.load(GOLDENS)
    hand = torch.from_numpy(g["contact_hand"]).requires_grad_(True)
    obj = torch.from_numpy(g["contact_obj"]).requires_grad_(True)
    missed, penetr, _, _ = compute_contact_loss(
        hand, obj, torch.from_numpy(g["ico_faces"]), contact_thresh=10.0,
        contact_mode="dist_tanh", collision_thresh=20.0, collision_mode="dist_tanh",
        contact_target=target, contact_zones="all",
    )
    (missed + penetr).backward()
    for leaf, name in ((hand, "grad_hand"), (obj, "grad_obj")):
        grad = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        np.testing.assert_allclose(grad.numpy(), g[f"contact_grad/{target}/{name}"],
                                   rtol=1e-6, atol=1e-12, err_msg=name)
