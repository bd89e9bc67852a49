"""The serving encoder folded (``models/resnet_fold.py``) and who takes it
(``demo.inference.ServeNet.encode``).

- Parity: in float64 the fold plus the plain chain (``F.conv2d`` + bias +
  residual + ReLU) equals ``ResNet.forward``'s features to 1e-10, for
  ResNet-18 and ResNet-50 with non-trivial running statistics and affine
  parameters.
- Gate: the CPU, a bf16 net, a net in ``train()``, autograd recording and
  a compiling context (``torch.export``'s trace) each take
  ``ResNet.forward``; a float32 net in
  ``eval()`` on the card (a tensor that says it is on CUDA) takes the fold.
- Cache: a second call does not fold again; an in-place change to a
  BatchNorm's running variance or to a convolution's weight,
  ``load_state_dict`` and ``functional_call`` with other variables each
  fold once more.
- On the card (``-m cuda``; skipped without one), for a ResNet-18 and a
  ResNet-50 encoder: the fused route's outputs against
  ``ResNet.forward``'s at B=8, 256 px, and a profiler run in which the
  encoder launches no BatchNorm, clamp or add kernel.

This file imports no JAX: on the card run it with ``python3 -m pytest
--noconftest -m cuda tests/test_torch_serve_fold.py``.
"""

import numpy as np
import pytest
import torch
from torch import nn

from obman_train_tpu_torch.config import AtlasConfig, ExperimentConfig, ModelConfig
from obman_train_tpu_torch.demo.inference import DemoModel, ServeNet
from obman_train_tpu_torch.models import resnet_fold
from obman_train_tpu_torch.models.resnet import resnet18, resnet50

SIZE = 64


def _randomize(net: nn.Module, seed: int) -> nn.Module:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.2)
    return net.eval()


def _images(seed: int, b: int = 2, dtype=torch.float32) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    # NHWC frames viewed as NCHW, as HandNet hands them to its encoder
    return torch.randn(b, SIZE, SIZE, 3, generator=g, dtype=dtype).permute(0, 3, 1, 2)


@pytest.mark.parametrize("make", [resnet18, resnet50], ids=["resnet18", "resnet50"])
def test_folded_chain_equals_resnet_forward(make):
    torch.manual_seed(0)
    net = _randomize(make().double(), 1)
    x = _images(2, dtype=torch.float64)
    with torch.no_grad():
        want, _ = net(x)
        folded = resnet_fold.fold(net)
        got, inters = resnet_fold.features(folded, x, resnet_fold.PLAIN)
    assert inters is None and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10)
    assert float(want.abs().max()) > 0.1  # the statistics moved the features
    convs = [folded.stem] + [c for b in folded.blocks
                             for c in (*b.relu_convs, b.last, *([b.down] if b.down else []))]
    assert len(convs) == len(resnet_fold.layers(net))
    assert all(c.weight.is_contiguous(memory_format=torch.channels_last) for c in convs)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on CUDA: the gate's one condition that
    a CPU run cannot meet, so that each other condition is tested alone."""

    @property
    def is_cuda(self):
        return True


class _Encoder(nn.Module):
    """``ServeNet.encode`` as a module's forward, for ``functional_call``."""

    def __init__(self, serve: ServeNet):
        super().__init__()
        self.serve = serve

    def forward(self, image):
        return self.serve.encode(self.serve.net.base_net, image)


class _Net(nn.Module):
    def __init__(self, base_net):
        super().__init__()
        self.base_net = base_net


def _serve(dtype=None, seed=0) -> ServeNet:
    torch.manual_seed(seed)
    return ServeNet(_Net(_randomize(resnet18(dtype), seed + 1)), SIZE).eval()


@pytest.fixture
def folds(monkeypatch):
    """Counts the folds; the fused entry runs the plain chain (the CPU has
    no cuDNN) and records its calls."""
    real_fold, real_features = resnet_fold.fold, resnet_fold.features
    counts = {"fold": 0, "fused": 0}

    def fold(net):
        counts["fold"] += 1
        return real_fold(net)

    def features(folded, x):
        counts["fused"] += 1
        return real_features(folded, x.as_subclass(torch.Tensor), resnet_fold.PLAIN)

    monkeypatch.setattr(resnet_fold, "fold", fold)
    monkeypatch.setattr(resnet_fold, "features", features)
    return counts


def test_the_card_takes_the_fold(folds):
    serve = _serve()
    x = _images(3)
    with torch.inference_mode():
        got, _ = serve.encode(serve.net.base_net, x.as_subclass(_OnCard))
        want, _ = serve.net.base_net(x)
    assert folds == {"fold": 1, "fused": 1}
    torch.testing.assert_close(got.as_subclass(torch.Tensor), want, rtol=1e-4, atol=1e-5)


def _no_fused(*args, **kwargs):
    raise AssertionError("the fused route was taken")


@pytest.mark.parametrize("case", ["cpu", "bf16", "train", "grad", "compiling"])
def test_other_routes_take_resnet_forward(case, monkeypatch):
    monkeypatch.setattr(resnet_fold, "features", _no_fused)
    monkeypatch.setattr(resnet_fold, "fold", _no_fused)
    serve = _serve(torch.bfloat16 if case == "bf16" else None)
    x = _images(4)
    if case != "cpu":
        x = x.as_subclass(_OnCard)
    if case == "train":
        serve.train()
    if case == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with torch.set_grad_enabled(case == "grad"):
        got, _ = serve.encode(serve.net.base_net, x)
        want, _ = serve.net.base_net(x)
    assert torch.equal(got.as_subclass(torch.Tensor), want.as_subclass(torch.Tensor))


def _encode(serve, x, variables=None):
    with torch.inference_mode():
        if variables is None:
            return serve.encode(serve.net.base_net, x)[0]
        return torch.func.functional_call(_Encoder(serve), variables, (x,))[0]


def test_the_fold_is_kept_until_a_source_changes(folds):
    serve = _serve()
    x = _images(6).as_subclass(_OnCard)
    base = serve.net.base_net
    first = _encode(serve, x)
    assert _encode(serve, x).equal(first) and folds["fold"] == 1

    with torch.no_grad():
        base.layer2[0].bn1.running_var.mul_(1.5)  # in place, a version bump
    changed = _encode(serve, x)
    assert folds["fold"] == 2 and not changed.equal(first)
    _encode(serve, x)
    assert folds["fold"] == 2

    with torch.no_grad():
        base.layer3[1].conv2.weight.mul_(0.5)
    _encode(serve, x)
    assert folds["fold"] == 3
    _encode(serve, x)
    assert folds["fold"] == 3

    state = {k: v.clone() for k, v in _serve(seed=7).state_dict().items()}
    serve.load_state_dict(state)
    loaded = _encode(serve, x)
    assert folds["fold"] == 4
    _encode(serve, x)
    assert folds["fold"] == 4
    with torch.no_grad():
        want, _ = base(x.as_subclass(torch.Tensor))
    torch.testing.assert_close(loaded.as_subclass(torch.Tensor), want, rtol=1e-4, atol=1e-5)


def test_functional_call_folds_its_variables(folds):
    serve = _serve()
    x = _images(8).as_subclass(_OnCard)
    live = _encode(serve, x)
    assert folds["fold"] == 1
    variables = {f"serve.{k}": v for k, v in serve.state_dict(keep_vars=True).items()}
    name = "serve.net.base_net.layer4.1.bn2.bias"
    other = dict(variables, **{name: variables[name] + 1.0})
    shifted = _encode(serve, x, other)
    assert folds["fold"] == 2 and not shifted.equal(live)
    _encode(serve, x, other)  # the same variables: the fold is kept
    assert folds["fold"] == 2
    again = _encode(serve, x)  # the live weights again
    assert folds["fold"] == 3 and again.equal(live)


def test_a_data_swap_folds_again(folds):
    serve = _serve()
    x = _images(9).as_subclass(_OnCard)
    _encode(serve, x)
    w = serve.net.base_net.conv1.weight
    version = w._version
    w.data = w.data * 2.0  # keeps the tensor and its version
    assert w._version == version
    _encode(serve, x)
    assert folds["fold"] == 2


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN's fused convolutions have no CPU mode")


def _card_model(size, resnet_version=18):
    cfg = ExperimentConfig(mano_assets="synthetic", model=ModelConfig(
        resnet_version=resnet_version,
        atlas=AtlasConfig(predict_trans=True, predict_scale=True)))
    return DemoModel(config=cfg, image_size=size, device="cuda")


def _card_inputs(b, size, seed=0):
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8))
    sides = torch.from_numpy((np.arange(b) % 2).astype(np.int32))
    return frames.cuda(), sides.cuda(), torch.zeros(b, dtype=torch.bool, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("resnet_version", [18, 50])
def test_fused_outputs_match_resnet_forward_on_the_card(cuda_card, resnet_version):
    model = _card_model(256, resnet_version)
    frames, sides, flip = _card_inputs(8, 256)
    got = model._infer(model._variables, frames, sides, flip)
    assert list(model._serve._folds) == [model.net.base_net]  # the fused route ran
    with torch.enable_grad():  # autograd records: ResNet.forward
        want = model._serve(frames, sides, flip)
    assert set(got) == set(want)
    for k in want:
        ref = want[k].detach().float()
        gap = float((got[k].float() - ref).abs().max() / ref.abs().max())
        assert gap < 7.5e-3, (k, gap)


def _encoder_kernels(model, frames, sides, flip, grad: bool):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if grad:
            with torch.enable_grad():
                model._serve(frames, sides, flip)
        else:
            model._infer(model._variables, frames, sides, flip)
        torch.cuda.synchronize()

    def walk(ev):
        yield from (k.name for k in ev.kernels)
        for child in ev.cpu_children:
            yield from walk(child)

    return [k for ev in prof.events() if ev.name == "handnet.encoder" for k in walk(ev)]


@pytest.mark.cuda
@pytest.mark.parametrize("resnet_version", [18, 50])
def test_the_encoder_launches_no_bn_clamp_or_add_kernel(cuda_card, resnet_version):
    model = _card_model(256, resnet_version)
    inputs = _card_inputs(8, 256, seed=1)
    model._infer(model._variables, *inputs)  # fold and plan outside the profile
    fused = _encoder_kernels(model, *inputs, grad=False)
    today = _encoder_kernels(model, *inputs, grad=True)
    # the walk sees today's chain's passes, so its silence on the fold counts
    for kind in ("bn", "clamp", "add"):
        assert any(_is(kind, k) for k in today), (kind, today)
    assert any("fprop" in k for k in fused), fused
    banned = [k for k in fused if any(_is(kind, k) for kind in ("bn", "clamp", "add"))]
    assert not banned, banned


def _is(kind: str, kernel: str) -> bool:
    if kind == "bn":
        return "bn_fw_inf" in kernel
    # ReLU (clamp_min) and the residual add are ATen's elementwise kernels
    return "elementwise" in kernel and ("clamp" in kernel if kind == "clamp"
                                        else "_add" in kernel)
