"""The plain nearest-neighbour versions of the port (``ops/nnsqdist.py``,
the arithmetic of ``kernels/nnsqdist.cu``) against the JAX package's Pallas
kernels K2-K5 (``pallas_chamfer_min_sqdist``) in interpret mode on the CPU.

Inputs are seeded numpy clouds with planted exact ties (repeated search
points, query points on search points). Argmins must be equal exactly
(first occurrence). Values agree to 2 ulp, not bitwise: XLA on the CPU
evaluates the Pallas kernel's ``d0*d0 + d1*d1 + d2*d2`` with its own
rounding (not one rounding per operation), which this file measured as at
most 2 ulp; the port rounds every operation, as the CUDA kernel does.

The kernel's launch plan (``_launch_plan``: query tiles, slices of the
search set, blocks) is host code and is tested here as well; the kernel
itself runs in ``test_torch_cuda.py`` on the card.
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


TRAIN_POINTS = (600, 642, 778)


@pytest.mark.parametrize("N", TRAIN_POINTS)
@pytest.mark.parametrize("M", TRAIN_POINTS)
def test_launch_plan_keeps_training_shapes_whole(N, M):
    """At B=256 the query tiles fill the card: one slice, no merge pass."""
    rows, slices, slice_len, blocks = nnsqdist._launch_plan(256, N, M)
    assert rows == nnsqdist.ROWS
    assert (slices, slice_len) == (1, M)
    assert blocks == 256 * -(-N // (32 * rows)) >= nnsqdist._SPLIT_BELOW * nnsqdist.H100_SMS


@pytest.mark.parametrize("N", [16384, 20000])
def test_launch_plan_splits_one_large_cloud(N):
    rows, slices, slice_len, blocks = nnsqdist._launch_plan(1, N, N)
    tiles = -(-N // (32 * rows))
    assert slices > 1 and blocks == tiles * slices
    assert blocks >= nnsqdist._BLOCKS_PER_SM * nnsqdist.H100_SMS
    assert slice_len >= nnsqdist._MIN_SLICE and slice_len % 32 == 0


@pytest.mark.parametrize("B,N,M", [(1, 1, 1), (1, 1, 77), (1, 1, 512), (1, 1, 513),
                                   (1, 4097, 20000), (2, 129, 70000), (1, 1, 50000),
                                   (1, 16384, 16384), (8, 600, 642)])
def test_launch_plan_slices_cover_the_search_set(B, N, M):
    """The slices [s * slice_len, min(M, (s + 1) * slice_len)) are all
    non-empty and cover [0, M) exactly once; only the last may be short."""
    _, slices, slice_len, _ = nnsqdist._launch_plan(B, N, M)
    bounds = [(s * slice_len, min(M, (s + 1) * slice_len)) for s in range(slices)]
    assert bounds[0][0] == 0 and bounds[-1][1] == M
    assert all(a < b for a, b in bounds)
    assert all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))
    assert all(b - a == slice_len for a, b in bounds[:-1])
    if slices > 1 and M % slice_len:
        assert bounds[-1][1] - bounds[-1][0] < slice_len  # the ragged tail


def test_launch_plan_adapts_to_the_card():
    """A card with fewer SMs is filled by fewer slices, one with more SMs
    by more; a batch that fills either card stays whole."""
    plan = lambda sms, B=1: nnsqdist._launch_plan(B, 16384, 16384, sms)  # noqa: E731
    assert plan(66)[1] < plan(nnsqdist.H100_SMS)[1] < plan(264)[1]
    assert plan(66, B=256)[1] == plan(264, B=256)[1] == 1


@pytest.mark.parametrize("B,N,M", [(1, 4097, 20000), (2, 129, 70000), (1, 1, 50000),
                                   (1, 16384, 16384), (8, 600, 642)])
def test_tie_across_slices_plants_a_first_occurrence_in_a_middle_slice(B, N, M):
    """The test scene of the split shapes: query 0's minimum, first found in
    a middle slice, repeats in every later slice; the plain argmin keeps
    the first."""
    gen = torch.Generator().manual_seed(B + N + M)
    q, s = (torch.randn(B, n, 3, generator=gen) * 40 for n in (N, M))
    q0, s0 = q.clone(), s.clone()
    nnsqdist.tie_across_slices(q, s)
    _, slices, slice_len, _ = nnsqdist._launch_plan(B, N, M)
    if slices < 3:
        assert torch.equal(q, q0) and torch.equal(s, s0)
        return
    first = (slices // 2) * slice_len + 5
    mins, args = nnsqdist.nn_dir_plain(q[:, :1], s, with_argmin=True)
    assert (args == first).all() and 0 < first // slice_len < slices - 1
    d = ((s - q[:, :1]) ** 2).sum(-1)
    hits = (d == d[:, first:first + 1]).nonzero()[:, 1].unique()
    later = {int(j) // slice_len for j in hits if j > first}
    assert later == set(range(first // slice_len + 1, slices))


def test_launch_plan_refuses_what_the_kernel_cannot_index():
    with pytest.raises(ValueError, match="z limit"):
        nnsqdist._launch_plan(65536, 10, 10)
    with pytest.raises(ValueError, match="int32 index"):
        nnsqdist._launch_plan(1, 2**31 // 3, 10)
    with pytest.raises(ValueError, match="int32 index"):
        nnsqdist._launch_plan(1, 10, 2**31 // 3)
    nnsqdist._launch_plan(65535, 10, 2**31 // 3 - 1)  # at the limits
