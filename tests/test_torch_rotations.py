"""The port's ``rotmat_to_axis_angle`` against the JAX function on the same
seeded matrices: float32 within 1e-6, float64 (JAX under ``enable_x64``)
within 1e-12; random rotations, angles near 0 and near pi, the identity;
the round trip through the port's ``rodrigues`` within 1e-4 (the twin of
``tests/test_rotations.py::test_roundtrip``); the gradient against
``jax.grad`` away from the clamp, float32 within 1e-5 of its largest entry.

Near pi the skew part vanishes in both packages: the port is held against
JAX there, not against the true axis. In float32 the clamp maps the
identity to a 4.9e-4 rad angle times a zero axis in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obman_train_tpu.ops.rotations import rodrigues as jax_rodrigues
from obman_train_tpu.ops.rotations import rotmat_to_axis_angle as jax_rotmat_to_aa
from obman_train_tpu_torch.ops import rodrigues, rotmat_to_axis_angle

torch.set_num_threads(2)


def _axis_angles(kind, rng):
    """(32, 3) float64 axis-angles of one kind."""
    axes = rng.normal(0, 1, (32, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angles = {
        "random": rng.uniform(0.05, 3.0, 32),
        "near_zero": 10.0 ** rng.uniform(-6, -2, 32),
        "near_pi": np.pi - 10.0 ** rng.uniform(-6, -2, 32),
    }[kind]
    return axes * angles[:, None]


def _rotations(kind, rng):
    """(32, 3, 3) float64 rotation matrices (classic Rodrigues formula)."""
    if kind == "identity":
        return np.broadcast_to(np.eye(3), (32, 3, 3)).copy()
    aa = _axis_angles(kind, rng)
    t = np.linalg.norm(aa, axis=-1)[:, None, None]
    k = aa / t[..., 0]
    K = np.zeros((32, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(0, 2, 1)
    return np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * (K @ K)


KINDS = ["random", "near_zero", "near_pi", "identity"]


@pytest.mark.parametrize("kind", KINDS)
def test_float32_matches_jax(kind):
    rot = _rotations(kind, np.random.default_rng(KINDS.index(kind))).astype(np.float32)
    got = rotmat_to_axis_angle(torch.from_numpy(rot))
    want = np.asarray(jax_rotmat_to_aa(jnp.asarray(rot)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_float64_matches_jax_x64(kind):
    rot = _rotations(kind, np.random.default_rng(10 + KINDS.index(kind)))
    got = rotmat_to_axis_angle(torch.from_numpy(rot))
    with jax.enable_x64(True):
        want = np.asarray(jax_rotmat_to_aa(jnp.asarray(rot)))
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_identity_keeps_the_clamp_in_float32():
    """The clamp at ``1 - eps`` rounds to ``1 - 2**-23`` in float32: a
    ~4.9e-4 rad angle times a zero skew vector, a zero axis-angle."""
    eye = torch.eye(3).expand(4, 3, 3)
    np.testing.assert_array_equal(rotmat_to_axis_angle(eye).numpy(), np.zeros((4, 3)))
    cos = torch.clamp((eye[0].trace() - 1.0) * 0.5, -1 + 1e-7, 1 - 1e-7)
    assert abs(float(torch.arccos(cos)) - 4.8828e-4) < 1e-7


def test_roundtrip():
    aa = np.random.default_rng(0).normal(0, 0.8, (16, 3)).astype(np.float32)
    back = rotmat_to_axis_angle(rodrigues(torch.from_numpy(aa)))
    np.testing.assert_allclose(back.numpy(), aa, atol=1e-4)
    jback = jax_rotmat_to_aa(jax_rodrigues(jnp.asarray(aa)))
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), atol=1e-6)


def test_gradient_matches_jax():
    """Away from the clamp (angles in [0.3, 2.8]) the gradient of a
    weighted sum of the outputs is JAX's."""
    rng = np.random.default_rng(3)
    aa = _axis_angles("random", rng)
    aa *= (rng.uniform(0.3, 2.8, 32) / np.linalg.norm(aa, axis=-1))[:, None]
    rot = np.asarray(jax_rodrigues(jnp.asarray(aa.astype(np.float32))))
    w = rng.normal(0, 1, (32, 3)).astype(np.float32)

    r = torch.from_numpy(rot.copy()).requires_grad_(True)
    (rotmat_to_axis_angle(r) * torch.from_numpy(w)).sum().backward()
    want = np.asarray(jax.grad(lambda m: jnp.sum(jax_rotmat_to_aa(m) * w))(jnp.asarray(rot)))
    np.testing.assert_allclose(r.grad.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
