"""The card-free parts of ``tools/kernel_ab.py`` on the CPU: its scenes have
the shapes of PERF.md's kernel table, with the planted ties the exactness
checks rely on, and its bound is the benchmark's yardstick
(``portbench/counts/flops.py`` over ``peaks()``)."""

import pytest
import torch

from obman_train_tpu_torch.ops import nnsqdist
from portbench.counts import flops
from tests.test_torch_cuda import kernel_ab


def test_scenes_have_the_table_shapes_and_planted_ties():
    pts, tris = kernel_ab.raytri_scene(256, 778, 1280, seed=0, device="cpu")
    assert pts.shape == (256, 778, 3) and tris.shape == (256, 1280, 3, 3)
    assert [(n, tuple(p.shape), tuple(t.shape)) for n, p, t in kernel_ab.voxel_scenes("cpu")] \
        == [("raytri_count_voxel_hand", (1, 32768, 3), (1, 1538, 3, 3)),
            ("raytri_count_voxel_object", (1, 4096, 3), (1, 1280, 3, 3))]
    assert [r[1:] for r in kernel_ab.RAYTRI_ROWS[:1]] == [(256, 778, 1280)]
    assert {r[:3] for r in kernel_ab.NN_ROWS} >= {(256, 778, 600), (256, 600, 642),
                                                  (1, 20000, 20000), (1, 16384, 16384)}
    # a plan that cuts the search set into 3 or more slices on an H100
    B, N, M = 1, 4097, 20000
    _, slices, slice_len, _ = nnsqdist._launch_plan(B, N, M, nnsqdist.H100_SMS)
    assert slices >= 3
    q, s = kernel_ab.nn_scene(B, N, M, 3, nnsqdist.H100_SMS, device="cpu")
    assert q.shape == (B, N, 3) and s.shape == (B, M, 3)
    mins, args = nnsqdist.nn_dir_plain(q, s, True)
    # query 0: first occurrence in a middle slice, the same minimum in
    # every later slice
    first = int(args[0, 0])
    assert 0 < first // slice_len < slices - 1
    d = ((s[0] - q[0, 0]) ** 2).sum(-1)
    ties = torch.nonzero(d == d[first]).flatten()
    assert len(ties) >= slices - first // slice_len and int(ties[0]) == first
    assert {int(t) // slice_len for t in ties} == set(range(first // slice_len, slices))
    # at the K3 row (one slice): every 16th query sits on a search point,
    # and every 8th search point repeats one of the first seven
    q, s = kernel_ab.nn_scene(256, 600, 642, 1, nnsqdist.H100_SMS, device="cpu")
    assert q.shape == (256, 600, 3) and s.shape == (256, 642, 3)
    assert torch.all(nnsqdist.nn_dir_plain(q, s)[0][:, ::16] == 0)
    assert s[:, 7::8, None].eq(s[:, None, :7]).all(-1).any(-1).all()


@pytest.mark.parametrize("kernel,shape,argmin", [("raytri", (256, 778, 1280), False),
                                                  ("nn", (256, 600, 642), True)])
def test_bound_is_the_benchmark_count_over_the_peak(kernel, shape, argmin):
    ops = flops.raytri_ops(*shape) if kernel == "raytri" else flops.nn_ops(*shape)
    got = kernel_ab.bound_ms(kernel, *shape, argmin)
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == ops / flops.peaks()["fp32_flops"] * 1e3
