"""The plain nearest-neighbour versions of the port (``ops/nnsqdist.py``,
the arithmetic of ``kernels/nnsqdist.cu``) against the JAX package's Pallas
kernels K2-K5 (``pallas_chamfer_min_sqdist``) in interpret mode on the CPU.

Inputs are seeded numpy clouds with planted exact ties (repeated search
points, query points on search points). Argmins must be equal exactly
(first occurrence). Values agree to 2 ulp, not bitwise: XLA on the CPU
evaluates the Pallas kernel's ``d0*d0 + d1*d1 + d2*d2`` with its own
rounding (not one rounding per operation), which this file measured as at
most 2 ulp; the port rounds every operation, as the CUDA kernel does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obman_train_tpu.ops.pallas.chamfer_kernel import pallas_chamfer_min_sqdist
from obman_train_tpu_torch.ops import nnsqdist

ULPS = 2


def _clouds(seed, B, N, M):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 40, (B, N, 3)).astype(np.float32)
    y = rng.normal(0, 40, (B, M, 3)).astype(np.float32)
    dup = np.arange(M)[7::8]
    y[:, dup] = y[:, rng.integers(0, 7, len(dup))]
    x[:, ::16] = y[:, rng.integers(0, M, len(x[0, ::16]))]
    return x, y


def _assert_ulps(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= ULPS * ulp), err_msg


# (B, N, M, tile_m): tile_m=None is the fused layout (K2/K3), an explicit
# tile_m forces the split layout (K4/K5) over several search tiles
CASES = [
    (2, 300, 257, None),
    (3, 100, 77, None),
    (1, 1, 1, None),
    (2, 129, 700, None),
    (2, 300, 700, 256),
    (3, 129, 600, 256),
    (1, 1, 300, 256),
]


@pytest.mark.parametrize("B,N,M,tile_m", CASES)
def test_plain_matches_pallas_interpret(B, N, M, tile_m):
    x, y = _clouds(B * 1000 + N + M, B, N, M)
    kw = dict(tile_n=128, interpret=True)
    if tile_m is not None:
        kw["tile_m"] = tile_m
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    mx, my = pallas_chamfer_min_sqdist(jnp.asarray(x), jnp.asarray(y), **kw)
    gx, gy = nnsqdist.nn_min_sqdist(tx, ty)
    _assert_ulps(gx.numpy(), mx, "min x->y")
    _assert_ulps(gy.numpy(), my, "min y->x")

    mx, ax, my, ay = pallas_chamfer_min_sqdist(
        jnp.asarray(x), jnp.asarray(y), with_argmin=True, **kw)
    gx, gax, gy, gay = nnsqdist.nn_min_sqdist(tx, ty, with_argmin=True)
    assert gax.dtype == gay.dtype == torch.int64
    _assert_ulps(gx.numpy(), mx, "argmin-variant min x->y")
    _assert_ulps(gy.numpy(), my, "argmin-variant min y->x")
    np.testing.assert_array_equal(gax.numpy(), np.asarray(ax))
    np.testing.assert_array_equal(gay.numpy(), np.asarray(ay))


def test_ties_resolve_to_the_first_index():
    """Every search point repeated: the argmin is the first copy."""
    rng = np.random.default_rng(3)
    y = rng.normal(0, 10, (2, 50, 3)).astype(np.float32)
    y = np.concatenate([y, y, y], axis=1)  # index j, j+50, j+100 tie
    x = y[:, rng.integers(0, 150, 40)] + rng.normal(0, 0.01, (2, 40, 3)).astype(np.float32)
    mins, args = nnsqdist.nn_dir(torch.from_numpy(x), torch.from_numpy(y), with_argmin=True)
    assert (args < 50).all()
    d = ((x[:, :, None] - y[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(args.numpy(), d.argmin(-1))


@pytest.mark.parametrize("budget", [40 * 7, 90 * 40 * 2])
def test_plain_is_chunked_within_its_budget(monkeypatch, budget):
    """Above the temporary's budget the plain version steps over query
    rows of one example, or over batch elements; the chunks stitch to the
    unchunked result."""
    x, y = _clouds(7, 3, 90, 40)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    want = nnsqdist.nn_dir_plain(tx, ty, with_argmin=True)
    monkeypatch.setattr(nnsqdist, "_PLAIN_PAIRS", budget)
    got = nnsqdist.nn_dir_plain(tx, ty, with_argmin=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wrapper_checks_its_inputs():
    x = torch.zeros((2, 5, 3))
    with pytest.raises(TypeError):
        nnsqdist.nn_dir(x.double(), x)
    with pytest.raises(ValueError):
        nnsqdist.nn_dir(x, torch.zeros((3, 5, 3)))
    with pytest.raises(ValueError, match="empty"):
        nnsqdist.nn_dir(x, torch.zeros((2, 0, 3)))
    before = dict(nnsqdist.LAUNCHES)
    mins, args = nnsqdist.nn_dir(x, x)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert args is None and mins.shape == (2, 5) and dict(nnsqdist.LAUNCHES) == before
