"""The frozen-BN train step's folded encoder on the CPU: ``resnet_fold.fold``
under autograd, the op of ``resnet_fold.TRAIN`` (``ConvBiasReLU``) and who
takes them (``train.steps.fold_encoder``).

- Parity: in float64 a ResNet-18 and a ResNet-50 with downsample blocks,
  through the training route (the plain forward, the hand-written
  backward), give ``ResNet.forward``'s features in ``eval()`` and the same
  gradients of the images, of each convolution's weight and of each
  BatchNorm's scale and shift, to 1e-10; the running statistics stay as
  they were.
- ``gradcheck`` of the op with and without a residual, strided or not.
- Gate: a float32 encoder in ``eval()`` given images on the card (a tensor
  that says it is on CUDA) folds; the CPU, a bf16 encoder and an encoder
  in ``train()`` (``train_bn=True``) run ``ResNet.forward``.
- The step: a frozen-BN step on the card's route folds each encoder once a
  microbatch forward (the ``train.fold`` span names it), leaves the running
  statistics as they were, and gives the losses and gradients of the
  unfolded step to float32's rounding.

This file imports no JAX.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch
from torch import nn

from obman_train_tpu_torch import train
from obman_train_tpu_torch.assets import synthetic_mano_assets
from obman_train_tpu_torch.config import AtlasConfig, ModelConfig, TrainConfig
from obman_train_tpu_torch.models import BatchSpec, build_handnet, resnet_fold
from obman_train_tpu_torch.models.resnet import resnet18, resnet50
from obman_train_tpu_torch.train import steps
from obman_train_tpu_torch.weights import init_weights
from tests.test_torch_serve_fold import _OnCard, _randomize

SIZE = 64


def _images(seed: int, b: int = 2, dtype=torch.float32) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    # NHWC frames viewed as NCHW, as HandNet hands them to its encoder
    return torch.randn(b, SIZE, SIZE, 3, generator=g, dtype=dtype).permute(0, 3, 1, 2)


def _grads(net: nn.Module, x: torch.Tensor, features, probe: torch.Tensor):
    net.zero_grad(set_to_none=True)
    x = x.detach().requires_grad_()
    out, _ = features(x)
    (out * probe).sum().backward()
    grads = {n: p.grad for n, p in net.named_parameters()}
    return out.detach(), x.grad, grads


@pytest.mark.parametrize("make", [resnet18, resnet50], ids=["resnet18", "resnet50"])
def test_training_route_equals_resnet_forward(make):
    torch.manual_seed(0)
    net = _randomize(make().double(), 1)
    x = _images(2, dtype=torch.float64)
    stats = {k: v.clone() for k, v in net.state_dict().items() if "running_" in k}
    width = 512 if make is resnet18 else 2048
    probe = torch.randn(x.shape[0], width, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(3))
    want, want_dx, want_grads = _grads(net, x, net, probe)
    got, dx, grads = _grads(
        net, x, lambda im: resnet_fold.features(resnet_fold.fold(net), im, resnet_fold.TRAIN),
        probe)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10)
    assert float(want.abs().max()) > 0.1  # the statistics moved the features
    torch.testing.assert_close(dx, want_dx, rtol=0, atol=1e-10)
    assert set(grads) == set(want_grads)
    for name, g in want_grads.items():
        assert g is not None and float(g.abs().max()) > 0, name
        torch.testing.assert_close(grads[name], g, rtol=0, atol=1e-10 * float(g.abs().max()),
                                   msg=name)
    for k, v in net.state_dict().items():
        if "running_" in k:
            assert torch.equal(v, stats[k]), k


@pytest.mark.parametrize("residual,stride", [(False, 1), (True, 1), (False, 2)],
                         ids=["relu", "add_relu", "strided"])
def test_the_op_passes_gradcheck(residual, stride):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 5, 7, 3, generator=g, dtype=torch.float64).permute(0, 3, 1, 2)
    w = torch.randn(4, 3, 3, 3, generator=g, dtype=torch.float64)
    b = torch.randn(4, generator=g, dtype=torch.float64)
    z = torch.randn(2, 4, 5, 7, generator=g, dtype=torch.float64) if residual else None
    inputs = [t.requires_grad_() for t in (x, w, b) + ((z,) if residual else ())]

    def op(x, w, b, z=None):
        return resnet_fold.ConvBiasReLU.apply(x, w, b, z, (stride, stride), (1, 1))

    assert torch.autograd.gradcheck(op, inputs)


@pytest.fixture
def route(monkeypatch):
    """Counts the folds and records the spans of ``train/steps.py``; the
    folded encoder runs the training ops on plain CPU tensors (the CPU has
    no cuDNN, so the op's plain forward)."""
    real_fold, real_features = resnet_fold.fold, resnet_fold.features
    seen = {"fold": [], "spans": []}

    def fold(net):
        seen["fold"].append(net)
        return real_fold(net)

    def features(folded, x, ops):
        assert ops is resnet_fold.TRAIN
        return real_features(folded, x.as_subclass(torch.Tensor), ops)

    def span(name, args=None):
        seen["spans"].append((name, args))
        return contextlib.nullcontext()

    monkeypatch.setattr(resnet_fold, "fold", fold)
    monkeypatch.setattr(resnet_fold, "features", features)
    monkeypatch.setattr(steps, "span", span)
    return seen


class _Net(nn.Module):
    def __init__(self, base_net):
        super().__init__()
        self.base_net = base_net


@pytest.mark.parametrize("case", ["card", "cpu", "bf16", "train_bn"])
def test_who_takes_the_folded_route(case, route):
    torch.manual_seed(0)
    enc = _randomize(resnet18(torch.bfloat16 if case == "bf16" else None), 1)
    enc.train(case == "train_bn")  # the step's net.train(train_bn)
    encode = steps.fold_encoder(_Net(enc))
    x = _images(5)
    with torch.no_grad():
        want, _ = copy.deepcopy(enc)(x)
    got, _ = encode(enc, x if case == "cpu" else x.as_subclass(_OnCard))
    got = got.detach().as_subclass(torch.Tensor)
    if case == "card":
        assert route["fold"] == [enc] and route["spans"] == [("train.fold", "base_net")]
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert route["fold"] == [] and route["spans"] == []
        assert torch.equal(got, want.as_subclass(torch.Tensor))


SEPARATE = ModelConfig(atlas=AtlasConfig(predict_trans=True, predict_scale=True,
                                         separate_encoder=True))


def _batch(b: int, seed: int):
    rng = np.random.default_rng(seed)
    return {
        "images": torch.from_numpy(rng.normal(0, 0.3, (b, SIZE, SIZE, 3)).astype(np.float32)),
        "sides": rng.integers(0, 2, (b,)).astype(np.int32),
        "joints3d": rng.normal(0, 30, (b, 21, 3)).astype(np.float32),
        "verts3d": rng.normal(0, 30, (b, 778, 3)).astype(np.float32),
        "objpoints3d": rng.normal(0, 50, (b, 600, 3)).astype(np.float32),
    }


def _step(net, accum_steps, batch):
    cfg = TrainConfig(optimizer="sgd", lr=0.0, momentum=0.0)
    opt = train.make_optimizer(cfg, net)
    step = train.make_train_step(net, opt, BatchSpec(), accum_steps=accum_steps, device="cpu")
    _, losses = step(train.create_train_state(net, opt, cfg), batch)
    return losses, {n: p.grad for n, p in net.named_parameters()}


@pytest.mark.parametrize("case,accum_steps", [("card", 1), ("card", 2), ("cpu", 1)],
                         ids=["card", "card_accum2", "cpu"])
def test_a_frozen_step_folds_each_encoder_once_a_forward(case, accum_steps, route):
    """float32 on both routes: the fold changes the order of rounding
    only, so the losses and each gradient agree to 1e-4 of their largest
    magnitude (~10^3 float32 ulps through the encoders and heads)."""
    torch.manual_seed(0)
    net = init_weights(build_handnet(SEPARATE, synthetic_mano_assets("right"),
                                     synthetic_mano_assets("left"), device="cpu"), seed=0)
    for enc, seed in ((net.base_net, 1), (net.atlas_base_net, 2)):
        _randomize(enc, seed)
    ref = copy.deepcopy(net)
    stats = {k: v.clone() for k, v in net.state_dict().items() if "running_" in k}
    batch = _batch(4, 0)
    images = batch["images"]
    if case == "card":
        batch = dict(batch, images=images.as_subclass(_OnCard))
    losses, grads = _step(net, accum_steps, batch)
    folds = [net.base_net, net.atlas_base_net] * accum_steps if case == "card" else []
    assert route["fold"] == folds
    assert [s for s in route["spans"] if s[0] == "train.fold"] == [
        ("train.fold", "base_net"), ("train.fold", "atlas_base_net")] * len(folds[::2])
    for k, v in net.state_dict().items():
        if "running_" in k:
            assert torch.equal(v, stats[k]), k
    want_losses, want_grads = _step(ref, accum_steps, dict(batch, images=images))
    for k, v in want_losses.items():
        torch.testing.assert_close(losses[k].as_subclass(torch.Tensor), v,
                                   rtol=1e-4, atol=1e-4 * float(v.abs().max()) + 1e-12, msg=k)
    for name, g in want_grads.items():
        if g is None:
            assert grads[name] is None, name
            continue
        scale = float(g.abs().max())
        torch.testing.assert_close(grads[name].as_subclass(torch.Tensor), g, rtol=0,
                                   atol=1e-4 * scale + 1e-12, msg=name)
