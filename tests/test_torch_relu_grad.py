"""``ops.relu_grad`` on the CPU: the plain version of ``relu_bias_grad`` and
the kernel's launch plan (the kernel itself runs only on the card:
``tests/test_torch_cuda_train_fold.py``).

- ``g`` is bit for bit ``threshold_backward(a + b, y, 0)`` (``a`` alone
  without ``b``), written over ``out`` where given; ``db`` is its sum over
  N, H and W to float32's rounding.
- CPU tensors never reach the kernel's library.
- The plan's constants mirror ``relu_grad.cu``; at every shape of the two
  towers' training steps the grid is one round of the SMs and its row
  groups cover each row once.

This file imports no JAX.
"""

import os

import pytest
import torch

from obman_train_tpu_torch.ops import relu_grad


def _tensors(shape, seed, two):
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = shape

    def t():
        return torch.randn(n, h, w, c, generator=g).permute(0, 3, 1, 2)

    y = torch.relu(t())  # the saved ReLU output: exact zeros where masked
    return t(), (t() if two else None), y


@pytest.mark.parametrize("two", [False, True], ids=["one", "two"])
@pytest.mark.parametrize("shape", [(2, 8, 5, 7), (3, 64, 4, 4), (1, 12, 1, 1)])
def test_plain_is_threshold_backward_of_the_sum(shape, two):
    a, b, y = _tensors(shape, sum(shape), two)
    want = torch.ops.aten.threshold_backward(a if b is None else a + b, y, 0)
    g, db = relu_grad.relu_bias_grad(a, b, y)
    assert torch.equal(g, want)
    assert bool((g[y <= 0] == 0).all()) and bool((want != 0).any())
    ref = want.double().sum(dim=(0, 2, 3))
    scale = want.double().abs().sum(dim=(0, 2, 3))
    assert db.dtype == torch.float32 and db.shape == (shape[1],)
    assert float(((db.double() - ref).abs() - 2e-7 * scale).max()) <= 0


def test_out_takes_the_result():
    a, b, y = _tensors((2, 8, 3, 3), 1, True)
    want = torch.ops.aten.threshold_backward(a + b, y, 0)
    ptr = a.data_ptr()
    g, _ = relu_grad.relu_bias_grad(a, b, y, out=a)
    assert g.data_ptr() == ptr and torch.equal(g, want) and torch.equal(a, want)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    def refuse():
        raise AssertionError("the kernel's library was loaded for CPU tensors")

    monkeypatch.setattr(relu_grad, "_library", refuse)
    relu_grad.relu_bias_grad(*_tensors((2, 8, 3, 3), 2, True))


def test_plan_constants_mirror_the_kernel_source():
    from obman_train_tpu_torch.ops.kernels import build

    with open(os.path.join(build.KERNEL_DIR, "relu_grad.cu")) as f:
        text = f.read()
    for name, value in (("kThreads", relu_grad.THREADS), ("kMinBlocks", relu_grad.MIN_BLOCKS),
                        ("kStrip", relu_grad.STRIP)):
        assert f"constexpr int {name} = {value};" in text, name


# (rows, C) of every ReLU'd tensor shape of the two training steps: the
# ResNet-18 at B=512 and the ResNet-50s at B=256, 256x256 images
TOWER_SHAPES = sorted({(512 * 128 * 128, 64), *((512 * s * s, c) for s, c in
                                               ((64, 64), (32, 128), (16, 256), (8, 512))),
                       (256 * 128 * 128, 64),
                       *((256 * s * s, c) for s, w in ((64, 64), (32, 128), (16, 256), (8, 512))
                         for c in (w, 4 * w))})


@pytest.mark.parametrize("rows,C", TOWER_SHAPES)
def test_plan_fills_the_sms_once_at_the_towers_shapes(rows, C):
    sms = 132
    groups, group_rows = relu_grad._launch_plan(rows, C, sms)
    strips = -(-(C // 4) // min(C // 4, relu_grad.STRIP))
    blocks = strips * groups
    assert 0.95 * relu_grad.MIN_BLOCKS * sms <= blocks <= relu_grad.MIN_BLOCKS * sms
    assert (groups - 1) * group_rows < rows <= groups * group_rows


@pytest.mark.parametrize("rows,C", [(1, 4), (3, 64), (100, 2048), (5000, 12)])
def test_plan_covers_small_shapes(rows, C):
    groups, group_rows = relu_grad._launch_plan(rows, C, 132)
    assert 1 <= groups <= 65535 and group_rows >= 1
    assert (groups - 1) * group_rows < rows <= groups * group_rows
