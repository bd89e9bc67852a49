"""The frozen-BN train step's folded encoder on the card (``-m cuda``;
skipped without one): ``train.steps.fold_encoder`` with cuDNN's fused
convolution epilogue forward and the hand-written backwards of
``resnet_fold.FoldedStem`` and ``FoldedBlockOp``.

- ``relu_bias_grad`` (``ops/relu_grad.py`` on ``kernels/relu_grad.cu``)
  against its plain version at the towers' shapes (the stem, layer1 and
  layer4 of the ResNet-18 at B=512 and of the ResNet-50 at B=256) and at
  ragged ones: ``g`` bit for bit, in place or not; ``db`` to float32's
  rounding of its float64 sum, and the same bits over two runs.
- One contact-config step folds its encoder once (one ``train.fold``
  span), launches ``relu_bias_grad`` once per ReLU'd convolution (17) and
  leaves the running statistics as they were.
- With TF32 off the folded encoder (cuDNN's fused forward, the
  hand-written backward) gives ``ResNet.forward``'s features and
  gradients of the images, weights and BatchNorm scales and shifts to
  float32's rounding.
- The step's losses and gradients against the unfolded step's
  (``ResNet.forward`` with torch's BatchNorm): with TF32 off, the losses to
  float32's rounding; with cuDNN's TF32 on, as the benchmark runs it, no
  farther from the TF32-off unfolded step than 3x the unfolded TF32 step
  is. (The step's float32 gradients are not held tighter: the atlas
  decoder's eval-mode BatchNorm1d, whose channels' std is small against
  their mean, amplifies the features' last bits to ~1e-4 of its biases'
  gradients on either route.)
- The encoder's forward launches no BatchNorm, clamp (ReLU) or add kernel
  outside the fold's own per-channel ops (``train.fold``); its backward
  (its nodes' ``...Backward`` events) launches ``relu_bias_grad`` and no
  ``threshold_backward``, no ATen reduction (the bias sums) and one add
  (the max-pool output's two gradients, which no ReLU follows).

The encoders' BatchNorms carry moved statistics and affine parameters, so
the fold is not an identity. This file imports no JAX: on the card run it
with ``python3 -m pytest --noconftest -m cuda tests/test_torch_cuda_train_fold.py``.
"""

import numpy as np
import pytest
import torch

from obman_train_tpu_torch import train
from obman_train_tpu_torch.assets import synthetic_mano_assets
from obman_train_tpu_torch.config import AtlasConfig, ContactConfig, ModelConfig, TrainConfig
from obman_train_tpu_torch.models import BatchSpec, build_handnet
from obman_train_tpu_torch.ops import relu_grad
from obman_train_tpu_torch.ops.kernels import LAUNCHES
from obman_train_tpu_torch.train import steps
from obman_train_tpu_torch.weights import init_weights
from tests.test_torch_serve_fold import _is, _randomize

pytestmark = pytest.mark.cuda

CONTACT = ModelConfig(
    atlas=AtlasConfig(predict_trans=True, predict_scale=True),
    contact=ContactConfig(contact_lambda=0.167, collision_lambda=0.167),
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN's fused convolutions have no CPU mode")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _net(device):
    net = init_weights(build_handnet(CONTACT, synthetic_mano_assets("right"),
                                     synthetic_mano_assets("left"), device="cpu"), seed=0)
    _randomize(net.base_net, 1)
    return net.to(device)


def _batch(device, b=8, size=128, seed=0):
    rng = np.random.default_rng(seed)
    arrays = {
        # float frames: the encoder's span then holds the encoder alone
        "images": rng.normal(0, 0.3, (b, size, size, 3)).astype(np.float32),
        "sides": rng.integers(0, 2, (b,)).astype(np.int32),
        "joints3d": rng.normal(0, 30, (b, 21, 3)).astype(np.float32),
        "verts3d": rng.normal(0, 30, (b, 778, 3)).astype(np.float32),
        "objpoints3d": rng.normal(0, 50, (b, 600, 3)).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _unfolded(monkeypatch):
    """Steps built inside run ``ResNet.forward``: the hook calls the encoder."""
    monkeypatch.setattr(steps, "fold_encoder", lambda handnet: lambda net, image: net(image))


def _step(net, batch, tf32: bool):
    """One sgd step at lr 0 (the parameters stay): its losses and gradients."""
    torch.backends.cudnn.allow_tf32 = tf32
    cfg = TrainConfig(optimizer="sgd", lr=0.0, momentum=0.0)
    opt = train.make_optimizer(cfg, net)
    step = train.make_train_step(net, opt, BatchSpec())
    _, losses = step(train.create_train_state(net, opt, cfg), batch)
    torch.cuda.synchronize()
    return ({k: float(v) for k, v in losses.items()},
            {n: p.grad.detach().clone() for n, p in net.named_parameters() if p.grad is not None})


def _grad_gap(got, want):
    """The worst leaf's largest gap over the larger of its reference's
    largest entry and the median leaf's."""
    scales = {n: float(g.abs().max()) for n, g in want.items()}
    median = float(np.median(list(scales.values())))
    assert set(got) == set(want)
    return max(float((got[n] - g).abs().max()) / max(scales[n], median) for n, g in want.items())


def _loss_gap(got, want):
    return max(abs(got[k] - v) / max(abs(v), 1e-6) for k, v in want.items())


# (N, C, H, W): the stem, layer1 and layer4 of each tower at its step's
# batch, then ragged widths (a strip of 3 float4 columns; 16 full strips
# and one of a single column) and a lone row
KERNEL_SHAPES = [(512, 64, 128, 128), (512, 64, 64, 64), (512, 512, 8, 8),
                 (256, 64, 128, 128), (256, 64, 64, 64), (256, 256, 64, 64),
                 (256, 512, 8, 8), (256, 2048, 8, 8),
                 (3, 12, 5, 7), (3, 2052, 5, 7), (1, 64, 1, 1)]


@pytest.mark.parametrize("two", [False, True], ids=["one", "two"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_relu_bias_grad_matches_its_plain_version(cuda, shape, two):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + two)
    n, c, h, w = shape

    def t():
        return torch.randn(n, h, w, c, generator=gen, device=cuda).permute(0, 3, 1, 2)

    a, b, y = t(), (t() if two else None), torch.relu(t())
    want, _ = relu_grad.relu_bias_grad_plain(a, b, y)
    before = LAUNCHES[relu_grad.KERNEL]
    g, db = relu_grad.relu_bias_grad(a, b, y)
    g2, db2 = relu_grad.relu_bias_grad(a.clone(memory_format=torch.channels_last), b, y,
                                       out=None)
    torch.cuda.synchronize()
    assert LAUNCHES[relu_grad.KERNEL] - before == 2
    assert g.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(g, want) and torch.equal(g2, want)
    assert torch.equal(db, db2)  # a fixed order: the same bits every run
    ref = want.double().sum(dim=(0, 2, 3))
    scale = want.double().abs().sum(dim=(0, 2, 3))
    assert float(((db.double() - ref).abs() - 1e-5 * scale).max()) <= 0
    ptr = a.data_ptr()
    g3, db3 = relu_grad.relu_bias_grad(a, b, y, out=a)  # in place over a
    torch.cuda.synchronize()
    assert g3.data_ptr() == ptr and torch.equal(g3, want) and torch.equal(db3, db)


def test_relu_bias_grad_refuses_what_it_cannot_take(cuda):
    a = torch.randn(2, 8, 3, 3, device=cuda).contiguous(memory_format=torch.channels_last)
    for args, error in (((a.double(), None, a.double()), TypeError),
                        ((a.contiguous(), None, a.contiguous()), ValueError),
                        ((a, None, a[:1]), ValueError),
                        ((a[:, :6], None, a[:, :6]), ValueError),
                        ((a[:, :6].contiguous(memory_format=torch.channels_last), None,
                          a[:, :6].contiguous(memory_format=torch.channels_last)), ValueError)):
        with pytest.raises(error):
            relu_grad.relu_bias_grad(*args)


def test_a_frozen_step_folds_its_encoder_once(cuda):
    from torch.profiler import ProfilerActivity, profile

    net = _net(cuda)
    batch = _batch(cuda)
    stats = {k: v.clone() for k, v in net.state_dict().items() if "running_" in k}
    _step(net, batch, tf32=True)  # plans and builds outside the profile
    before = LAUNCHES[relu_grad.KERNEL]
    with profile(activities=[ProfilerActivity.CPU]) as prof:  # the host's spans
        _step(net, batch, tf32=True)
    assert [ev.name for ev in prof.events()].count("train.fold") == 1
    assert LAUNCHES[relu_grad.KERNEL] - before == 17  # the stem and 2 x 8 blocks
    for k, v in net.state_dict().items():
        if "running_" in k:
            assert torch.equal(v, stats[k]), k


def test_folded_encoder_in_float32_equals_resnet_forward(cuda):
    """The fold changes the order of rounding only: each tensor to 1e-4 of
    its largest entry (~10^3 float32 ulps through 20 convolutions)."""
    from obman_train_tpu_torch.models import resnet_fold

    torch.backends.cudnn.allow_tf32 = False
    enc = _net(cuda).base_net
    images = _batch(cuda, seed=3)["images"].permute(0, 3, 1, 2)
    probe = torch.randn(images.shape[0], 512, generator=torch.Generator().manual_seed(0))

    def run(features):
        enc.zero_grad(set_to_none=True)
        x = images.detach().requires_grad_()
        out, _ = features(x)
        (out * probe.to(cuda)).sum().backward()
        grads = {n: p.grad for n, p in enc.named_parameters()}
        return dict(grads, features=out.detach(), images=x.grad)

    want = run(enc)
    got = run(lambda x: resnet_fold.train_features(resnet_fold.fold(enc), x))
    assert set(got) == set(want)
    for name, ref in want.items():
        scale = float(ref.abs().max())
        assert scale > 0, name
        assert float((got[name] - ref).abs().max()) <= 1e-4 * scale, name


def test_folded_step_is_within_the_tf32_gap(cuda, monkeypatch):
    net = _net(cuda)
    batch = _batch(cuda, seed=1)
    fold32 = _step(net, batch, tf32=False)
    fold_tf32 = _step(net, batch, tf32=True)
    _unfolded(monkeypatch)
    ref = _step(net, batch, tf32=False)
    unfold_tf32 = _step(net, batch, tf32=True)
    # float32 both ways: the fold changes the order of rounding only
    assert _loss_gap(fold32[0], ref[0]) <= 1e-4
    tf32_loss, tf32_grad = _loss_gap(unfold_tf32[0], ref[0]), _grad_gap(unfold_tf32[1], ref[1])
    assert tf32_grad > 0  # TF32 moved the unfolded step: the gap is a gap
    assert _loss_gap(fold_tf32[0], ref[0]) <= 3 * tf32_loss + 1e-6, tf32_loss
    assert _grad_gap(fold_tf32[1], ref[1]) <= 3 * tf32_grad, tf32_grad


def _encoder_kernels(net, batch):
    """The kernels of the encoders' forward (``handnet.encoder`` less the
    fold) and of the folded encoders' backward (the events of their nodes,
    ``FoldedStemBackward`` and ``FoldedBlockOpBackward``)."""
    from torch.profiler import ProfilerActivity, profile

    _step(net, batch, tf32=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _step(net, batch, tf32=True)

    def walk(ev):
        yield from (k.name for k in ev.kernels)
        for child in ev.cpu_children:
            if child.name != "train.fold":  # the fold's per-channel ops
                yield from walk(child)

    events = prof.events()
    forward = [k for ev in events if ev.name == "handnet.encoder" for k in walk(ev)]
    def node(ev):
        return ev is not None and ("FoldedStemBackward" in ev.name
                                   or "FoldedBlockOpBackward" in ev.name)

    # each backward node's outermost event on the autograd thread
    backward = [k for ev in events if node(ev) and not node(ev.cpu_parent) for k in walk(ev)]
    return forward, backward


def test_the_training_encoder_launches_no_bn_clamp_or_add_kernel(cuda, monkeypatch):
    net = _net(cuda)
    batch = _batch(cuda, seed=2)
    fused, fused_back = _encoder_kernels(net, batch)
    _unfolded(monkeypatch)
    today, today_back = _encoder_kernels(net, batch)
    # the walk sees the unfolded chain's passes, so its silence on the fold counts
    for kind in ("bn", "clamp", "add"):
        assert any(_is(kind, k) for k in today), (kind, today)
    assert any("fprop" in k for k in fused), fused
    banned = [k for k in fused if any(_is(kind, k) for kind in ("bn", "clamp", "add"))]
    assert not banned, banned
    assert not today_back  # the unfolded route has no such node
    assert sum(relu_grad.KERNEL in k for k in fused_back) == 2 * 17, fused_back  # rows + sum
    assert any("dgrad" in k for k in fused_back) and any("wgrad" in k for k in fused_back)
    banned = [k for k in fused_back if "threshold" in k
              or ("at::native" in k and "reduce_kernel" in k)]
    assert not banned, banned
    assert sum(_is("add", k) for k in fused_back) == 1, fused_back
