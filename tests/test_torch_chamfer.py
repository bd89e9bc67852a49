"""The port's ``ops/chamfer.py`` against the JAX package's ``ops/chamfer.py``
on the CPU, from the same seeded numpy clouds.

- Kernel route: the port's autograd Functions (on the CPU they run the
  plain nearest-neighbour version) against the JAX custom VJPs with the
  Pallas kernels in interpret mode, as tests/test_pallas_kernels.py runs
  them: values to 2 ulp (see test_torch_nnsqdist.py), argmins exactly,
  gradients to rtol 1e-5, atol 1e-6.
- Plane route (``use_kernel=False``, the CPU default): against JAX
  ``use_pallas=False``, values to rtol 1e-5 / atol 1e-3 mm^2 (the two
  libraries' float32 products of rx + ry - 2xy round differently),
  gradients through the plane to rtol 1e-5, atol 1e-6; and in float64
  against the executed-reference goldens to rtol 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import obman_train_tpu.ops.pallas.chamfer_kernel as ck
from obman_train_tpu.ops import chamfer as jchamfer
from obman_train_tpu_torch.ops import chamfer

GOLDENS = "tests/goldens/reference_goldens.npz"


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode on the CPU."""
    orig = ck.pallas_chamfer_min_sqdist
    monkeypatch.setattr(
        ck, "pallas_chamfer_min_sqdist",
        lambda x, y, **kw: orig(x, y, **{**kw, "interpret": True}),
    )


def _clouds(seed, B=2, N=300, M=257):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 40, (B, N, 3)).astype(np.float32),
            rng.normal(0, 40, (B, M, 3)).astype(np.float32))


def _close_ulps(got, want, ulps=2):
    got, want = np.asarray(got), np.asarray(want)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= ulps * ulp)


def _loss_pair(l1, l2):
    return l1.sum() + 2.0 * l2.sum()


@pytest.mark.parametrize("N,M", [(300, 257), (129, 700)])
def test_kernel_route_chamfer_loss_values_and_grads(interpret, N, M):
    x, y = _clouds(N + M, N=N, M=M)
    jl = jchamfer.chamfer_loss(jnp.asarray(x), jnp.asarray(y), use_pallas=True)
    jg = jax.grad(lambda a, b: _loss_pair(*jchamfer.chamfer_loss(a, b, use_pallas=True)),
                  argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))

    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    tl = chamfer.chamfer_loss(tx, ty, use_kernel=True)
    _loss_pair(*tl).backward()
    for got, want in zip(tl, jl):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6)
    for got, want in zip((tx.grad, ty.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_kernel_route_min_sqdist_with_argmins_and_grads(interpret):
    x, y = _clouds(1)
    rng = np.random.default_rng(2)
    wx = rng.normal(size=(2, 300)).astype(np.float32)
    wy = rng.normal(size=(2, 257)).astype(np.float32)

    def jloss(a, b):
        mx, _, my, _ = jchamfer.chamfer_min_sqdist(a, b, use_pallas=True)
        return jnp.sum(mx * wx) + jnp.sum(my * wy)

    jout = jchamfer.chamfer_min_sqdist(jnp.asarray(x), jnp.asarray(y), use_pallas=True)
    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))

    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    mx, ax, my, ay = chamfer.chamfer_min_sqdist(tx, ty, use_kernel=True)
    assert not ax.requires_grad and not ay.requires_grad
    (torch.sum(mx * torch.from_numpy(wx)) + torch.sum(my * torch.from_numpy(wy))).backward()
    _close_ulps(mx.detach().numpy(), jout[0])
    _close_ulps(my.detach().numpy(), jout[2])
    np.testing.assert_array_equal(ax.numpy(), np.asarray(jout[1]))
    np.testing.assert_array_equal(ay.numpy(), np.asarray(jout[3]))
    for got, want in zip((tx.grad, ty.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_kernel_route_without_grad_and_min_sqdist_to(interpret):
    """Without a gradient the kernel route runs min-only sweeps (K2's
    role), and ``min_sqdist_to`` one sweep x->y, same values as JAX."""
    x, y = _clouds(3)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    with torch.no_grad():
        l1, l2 = chamfer.chamfer_loss(tx.requires_grad_(True), ty, use_kernel=True)
    j1, j2 = jchamfer.chamfer_loss(jx, jy, use_pallas=True)
    np.testing.assert_allclose(l1.numpy(), np.asarray(j1), rtol=1e-6)
    np.testing.assert_allclose(l2.numpy(), np.asarray(j2), rtol=1e-6)
    got = chamfer.min_sqdist_to(tx, ty, use_kernel=True)
    assert not got.requires_grad
    _close_ulps(got.numpy(), jchamfer.min_sqdist_to(jx, jy, use_pallas=True))


def test_kernel_route_float64_inputs_give_float64_grads(interpret):
    """The kernel computes in float32 (the Pallas wrapper casts too); the
    VJP accumulates in the inputs' wider type and returns their dtype."""
    x, y = _clouds(4, N=40, M=30)
    tx = torch.from_numpy(x.astype(np.float64)).requires_grad_(True)
    ty = torch.from_numpy(y.astype(np.float64)).requires_grad_(True)
    l1, l2 = chamfer.chamfer_loss(tx, ty, use_kernel=True)
    assert l1.dtype == torch.float32
    _loss_pair(l1, l2).backward()
    assert tx.grad.dtype == ty.grad.dtype == torch.float64
    with jax.enable_x64(True):
        jg = jax.grad(lambda a, b: _loss_pair(*jchamfer.chamfer_loss(a, b, use_pallas=True)),
                      argnums=(0, 1))(jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64))
    for got, want in zip((tx.grad, ty.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_plane_route_matches_jax(interpret):
    x, y = _clouds(5)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    jout = jchamfer.chamfer_min_sqdist(jx, jy, use_pallas=False)
    tout = chamfer.chamfer_min_sqdist(torch.from_numpy(x), torch.from_numpy(y),
                                      use_kernel=False)
    for i in (0, 2):
        np.testing.assert_allclose(tout[i].numpy(), np.asarray(jout[i]), rtol=1e-5, atol=1e-3)
    for i in (1, 3):
        np.testing.assert_array_equal(tout[i].numpy(), np.asarray(jout[i]))
    np.testing.assert_allclose(
        chamfer.min_sqdist_to(torch.from_numpy(x), torch.from_numpy(y), use_kernel=False),
        np.asarray(jchamfer.min_sqdist_to(jx, jy, use_pallas=False)), rtol=1e-5, atol=1e-3)

    jg = jax.grad(lambda a, b: _loss_pair(*jchamfer.chamfer_loss(a, b, use_pallas=False)),
                  argnums=(0, 1))(jx, jy)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    _loss_pair(*chamfer.chamfer_loss(tx, ty, use_kernel=False)).backward()
    for got, want in zip((tx.grad, ty.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_plane_route_matches_reference_goldens_in_float64():
    g = np.load(GOLDENS)
    l1, l2 = chamfer.chamfer_loss(torch.from_numpy(g["chamfer_preds"]),
                                  torch.from_numpy(g["chamfer_gts"]))
    assert l1.dtype == torch.float64
    np.testing.assert_allclose(l1.numpy(), g["chamfer_loss1"], rtol=1e-9)
    np.testing.assert_allclose(l2.numpy(), g["chamfer_loss2"], rtol=1e-9)
    # the scalar symmetric form
    np.testing.assert_allclose(
        float(chamfer.chamfer_sym(torch.from_numpy(g["chamfer_preds"]),
                                  torch.from_numpy(g["chamfer_gts"]))),
        float(np.mean(g["chamfer_loss1"] + g["chamfer_loss2"])), rtol=1e-9)


def test_use_kernel_rule_on_cpu_tensors(monkeypatch):
    x = torch.zeros((2, 5, 3))
    assert chamfer._use_kernel(x, x, "auto") is False
    assert chamfer._use_kernel(x, x, True) is True
    assert chamfer._use_kernel(x, x, False) is False
    # the JAX rule on the CPU keeps the plane at any size, as the port's does
    big = torch.zeros((1, 16384, 3))
    assert chamfer._use_kernel(big, big, "auto") is False
    assert jchamfer._use_pallas(np.zeros((1, 16384, 3)), np.zeros((1, 16384, 3)), "auto") is False
    with pytest.raises(ValueError):
        chamfer._use_kernel(x, x, "always")


def test_unported_options_raise(monkeypatch):
    """The selection planes and the scatter backward run since they were
    ported (parity: test_torch_geometry_dtype.py): a rung's values are the
    exact distances of its selected pairs, and OBMAN_SCATTER_BWD is read at
    import (the module constant), not at the call."""
    x, y = (torch.from_numpy(a) for a in _clouds(9, B=1, N=40, M=30))
    for dt in (torch.float32, torch.bfloat16):
        minx, argx, miny, argy = chamfer.chamfer_min_sqdist(x, y, plane_dtype=dt)
        torch.testing.assert_close(minx, ((x - y[:, argx[0]]) ** 2).sum(-1))
        torch.testing.assert_close(miny, ((y - x[:, argy[0]]) ** 2).sum(-1))
        l1, l2 = chamfer.chamfer_loss(x, y, plane_dtype=dt)
        torch.testing.assert_close(l1, minx.mean(1))
        torch.testing.assert_close(l2, miny.mean(1))
        assert torch.equal(chamfer.min_sqdist_to(x, y, plane_dtype=dt), minx)
    monkeypatch.setenv("OBMAN_SCATTER_BWD", "1")
    assert chamfer._SCATTER_BWD is False
