"""The frozen-BN train step of the two-encoder ResNet-50 network on the card
(``-m cuda``; skipped without one): ``atlas.separate_encoder``, MANO's
shape head and the contact losses, as ``portbench``'s
``obman_sep_r50_contact`` trains it, both encoders folded
(``train.steps.fold_encoder``) against ``ResNet.forward``'s unfolded step,
at the tolerances of ``tests/test_torch_cuda_train_fold.py``:

- one step folds each encoder once (two ``train.fold`` spans, one per
  encoder) and leaves the running statistics as they were;
- with TF32 off, the losses to 1e-4 of the unfolded step's;
- with cuDNN's TF32 on, as the benchmark runs it, the losses and the
  gradients of each encoder no farther from the TF32-off unfolded step
  than 3x the unfolded TF32 step is.

Both encoders' BatchNorms carry moved statistics and affine parameters,
so the fold is not an identity. This file imports no JAX: on the card run
it with ``python3 -m pytest --noconftest -m cuda tests/test_torch_cuda_train_fold_r50.py``.
"""

import pytest
import torch

from obman_train_tpu_torch.assets import synthetic_mano_assets
from obman_train_tpu_torch.config import AtlasConfig, ContactConfig, ManoConfig, ModelConfig
from obman_train_tpu_torch.models import build_handnet
from obman_train_tpu_torch.weights import init_weights
from tests.test_torch_cuda_train_fold import (  # noqa: F401  (cuda is a fixture)
    _batch,
    _grad_gap,
    _loss_gap,
    _step,
    _unfolded,
    cuda,
)
from tests.test_torch_serve_fold import _randomize

pytestmark = pytest.mark.cuda

SEP_R50 = ModelConfig(
    resnet_version=50,
    mano=ManoConfig(use_shape=True),
    atlas=AtlasConfig(predict_trans=True, predict_scale=True, separate_encoder=True),
    contact=ContactConfig(contact_lambda=0.167, collision_lambda=0.167),
)
ENCODERS = ("base_net", "atlas_base_net")


def _net(device):
    net = init_weights(build_handnet(SEP_R50, synthetic_mano_assets("right"),
                                     synthetic_mano_assets("left"), device="cpu"), seed=0)
    _randomize(net.base_net, 1)
    _randomize(net.atlas_base_net, 2)
    return net.to(device)


def _encoder(grads, prefix):
    return {n: g for n, g in grads.items() if n.startswith(prefix + ".")}


def test_a_step_folds_each_encoder_once(cuda):
    from torch.profiler import ProfilerActivity, profile

    net = _net(cuda)
    batch = _batch(cuda, b=4)
    stats = {k: v.clone() for k, v in net.state_dict().items() if "running_" in k}
    _step(net, batch, tf32=True)  # plans and builds outside the profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(net, batch, tf32=True)
    assert [ev.name for ev in prof.events()].count("train.fold") == 2
    for k, v in net.state_dict().items():
        if "running_" in k:
            assert torch.equal(v, stats[k]), k


def test_the_folded_two_encoder_step_is_within_the_tf32_gap(cuda, monkeypatch):
    net = _net(cuda)
    batch = _batch(cuda, b=4, seed=1)
    fold32 = _step(net, batch, tf32=False)
    fold_tf32 = _step(net, batch, tf32=True)
    _unfolded(monkeypatch)
    ref = _step(net, batch, tf32=False)
    unfold_tf32 = _step(net, batch, tf32=True)
    assert "mano_shape" in ref[0] and "attraction_loss" in ref[0]
    # float32 both ways: the fold changes the order of rounding only
    assert _loss_gap(fold32[0], ref[0]) <= 1e-4
    tf32_loss = _loss_gap(unfold_tf32[0], ref[0])
    assert _loss_gap(fold_tf32[0], ref[0]) <= 3 * tf32_loss + 1e-6, tf32_loss
    for prefix in ENCODERS:
        want = _encoder(ref[1], prefix)
        assert len(want) == 159, prefix  # 53 convolutions and 53 BNs' scale and shift
        tf32_grad = _grad_gap(_encoder(unfold_tf32[1], prefix), want)
        assert tf32_grad > 0, prefix  # TF32 moved the unfolded step: the gap is a gap
        assert _grad_gap(_encoder(fold_tf32[1], prefix), want) <= 3 * tf32_grad, (prefix, tf32_grad)
