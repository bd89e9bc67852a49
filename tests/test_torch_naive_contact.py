"""The port's ``thres_loss`` and ``compute_naive_contact_loss`` against the
JAX functions (``ops/contact.py:71-87``) on the same seeded inputs, on the
CPU, where both take the dense plane ``rx + ry - 2 x.y`` reduced by a min.

- ``thres_loss``: equal to float32 rounding (rtol 1e-6), 0 on an empty
  mask;
- ``compute_naive_contact_loss`` (B=4, 64 x 48 points): value and
  gradients within 1e-6 relative, the gradients relative to each tensor's
  largest entry, on coordinates of a 1/8 mm grid, where every plane entry
  is exact in float32 in both packages (the plane's cancellation otherwise
  rounds differently with the two summation orders, ~1e-4 mm^2 at these
  magnitudes); on continuous coordinates the value within 1e-5 relative
  and against a float64 reference of the reference's formula;
- an exact tie (a duplicated ``points_2`` point nearest to some
  ``points_1`` points): ``torch.amin`` splits the tied gradient evenly
  between the copies, as ``jnp.min`` does; the kernel route on the card
  gives it to the first copy (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obman_train_tpu.ops.contact import compute_naive_contact_loss as jax_naive
from obman_train_tpu.ops.contact import thres_loss as jax_thres_loss
from obman_train_tpu_torch.ops import compute_naive_contact_loss, thres_loss

torch.set_num_threads(2)


def _clouds(seed, B=4, N=64, M=48, grid=True):
    """Two clouds in a 25 mm cube centred on the origin: a share of each
    direction's squared minima lies under the 25 mm^2 threshold, the rest
    above it. On the 1/8 mm grid every square, product and sum of the
    plane is exact in float32."""
    rng = np.random.default_rng(seed)
    p1, p2 = (rng.uniform(-12.5, 12.5, (B, n, 3)) for n in (N, M))
    if grid:
        p1, p2 = np.round(p1 * 8) / 8, np.round(p2 * 8) / 8
    return p1.astype(np.float32), p2.astype(np.float32)


@pytest.mark.parametrize("thres", [25.0, 4.0, 1e9])
def test_thres_loss_matches_jax(thres):
    vals = np.random.default_rng(0).uniform(0, 50, (4, 37)).astype(np.float32)
    got = thres_loss(torch.from_numpy(vals), thres)
    want = np.asarray(jax_thres_loss(jnp.asarray(vals), thres))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    mask = vals < thres
    np.testing.assert_allclose(got.numpy(), vals[mask].mean(), rtol=1e-6)


def test_thres_loss_empty_mask_is_zero():
    vals = torch.full((3, 5), 30.0, requires_grad=True)
    got = thres_loss(vals)
    assert float(got.detach()) == 0.0 == float(jax_thres_loss(jnp.full((3, 5), 30.0)))
    got.backward()
    assert torch.equal(vals.grad, torch.zeros_like(vals))


def _both(p1, p2, thres=25.0):
    t1 = torch.from_numpy(p1).requires_grad_(True)
    t2 = torch.from_numpy(p2).requires_grad_(True)
    loss = compute_naive_contact_loss(t1, t2, thres)
    loss.backward()
    jloss, (jg1, jg2) = jax.value_and_grad(
        lambda a, b: jax_naive(a, b, thres), argnums=(0, 1))(jnp.asarray(p1), jnp.asarray(p2))
    return (loss.detach(), t1.grad, t2.grad), (np.asarray(jloss), np.asarray(jg1), np.asarray(jg2))


def _close(got, want, rel=1e-6):
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("seed,thres", [(0, 25.0), (1, 25.0), (2, 9.0)])
def test_naive_contact_loss_matches_jax(seed, thres):
    p1, p2 = _clouds(seed)
    d = ((p1[:, :, None] - p2[:, None]) ** 2).sum(-1)
    for mins in (d.min(2), d.min(1)):  # both masks are mixed
        assert 0.05 < (mins < thres).mean() < 0.95
    (loss, g1, g2), (jloss, jg1, jg2) = _both(p1, p2, thres)
    np.testing.assert_allclose(loss.numpy(), jloss, rtol=1e-6)
    _close(g1, jg1)
    _close(g2, jg2)


def test_naive_contact_loss_continuous_coordinates():
    """Off the grid the two planes round differently: the value within
    1e-5 relative of JAX's and of the float64 reference formula (the
    masked means over the whole batch of the (B, M) and (B, N) minima)."""
    p1, p2 = _clouds(3, grid=False)
    got = compute_naive_contact_loss(torch.from_numpy(p1), torch.from_numpy(p2))
    want = np.asarray(jax_naive(jnp.asarray(p1), jnp.asarray(p2)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    d = ((p1[:, :, None].astype(np.float64) - p2[:, None]) ** 2).sum(-1)
    mins12, mins21 = d.min(1), d.min(2)
    ref = (mins12[mins12 < 25].mean() + mins21[mins21 < 25].mean()) / 2
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def test_exact_tie_splits_the_gradient_as_jnp_min():
    p1, p2 = _clouds(4, B=2, N=16, M=8)
    p2[:, 5] = p2[:, 2]  # a duplicated point: bitwise equal plane columns
    p1[:, 0] = p2[:, 2] + np.float32(0.5)  # nearest to the two copies
    d = ((p1[:, :, None] - p2[:, None]) ** 2).sum(-1)
    assert (d[:, 0, 2] == d[:, 0].min()).all() and (d[:, 0, 5] == d[:, 0, 2]).all()
    (loss, g1, g2), (jloss, jg1, jg2) = _both(p1, p2)
    np.testing.assert_allclose(loss.numpy(), jloss, rtol=1e-6)
    _close(g1, jg1)
    _close(g2, jg2)
    # the copies' own minima (over points_1) are equal too, so every term
    # reaches them alike: their gradients are equal, in both packages
    np.testing.assert_array_equal(g2[:, 5].numpy(), g2[:, 2].numpy())
    np.testing.assert_array_equal(jg2[:, 5], jg2[:, 2])
