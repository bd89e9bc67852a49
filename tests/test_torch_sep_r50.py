"""The separate-encoder ResNet-50 network (the benchmark's ``obman_sep_r50``:
two ResNet-50 encoders, MANO's shape head, the object decoder on the
object encoder's features) on the port's serving path.

- Parity: ``DemoModel`` at the configuration's widths (64 px, B=4, both
  sides) against the plain reference ``portbench/reference/handnet_sep.py``
  on the reference's seeded weights, loaded strictly.
- The hook: ``HandNet.forward`` hands both encoders to ``encoder=``, the
  object encoder's inside ``handnet.atlas_encoder``; the object encoder's
  fold with the plain chain equals ``atlas_base_net(x)`` (float64, moved
  BatchNorm statistics).
- The cache: ``ServeNet`` keeps one fold per encoder; a second call folds
  neither again, and a ``load_state_dict`` of the object encoder alone
  folds only it again.
- On the card (``-m cuda``; skipped without one): the served call with
  both encoders folded against ``ResNet.forward``'s route, TF32 off.

This file imports no JAX: on the card run it with ``python3 -m pytest
--noconftest -m cuda tests/test_torch_sep_r50.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from obman_train_tpu_torch.config import ExperimentConfig, ModelConfig
from obman_train_tpu_torch.demo.inference import DemoModel, ServeNet
from obman_train_tpu_torch.models import INFER_SPEC, build_handnet, resnet_fold
from obman_train_tpu_torch.models.handnet import HandNet
from portbench.reference import handnet as ref18
from portbench.reference import handnet_sep as ref
from portbench.traffic import mano_files, weights
from tests.test_torch_serve_fold import _OnCard, _randomize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "portbench", "configs", "obman_sep_r50.json")
KEYS = ("verts", "joints", "objpoints3d", "objtrans", "objscale")
SIZE = 64
# Each output's largest gap over its largest reference magnitude. The two
# sides run every convolution and linear layer as the same ATen calls on
# the same float32 tensors, which give the same bits on the CPU; they can
# part only in MANO, whose kinematic chain and skinning the port and the
# reference write out differently, both in float32: 0 to 1.8e-7 of the
# largest joint here, about float32's ulp (6e-8) times a few of the
# chain's 16 products. The limit leaves 10x room.
TOLERANCE = 2e-6


def _cfg(**override) -> dict:
    with open(CONFIG) as f:
        cfg = json.load(f)["model"]
    cfg.update(override)
    return cfg


def _frames(seed: int, b: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (b, SIZE, SIZE, 3), dtype=np.uint8)


def test_demo_model_agrees_with_the_reference(tmp_path):
    cfg = _cfg()
    mano = mano_files.write(str(tmp_path), 5)
    w = weights.make(ref.param_specs(cfg), 5, "cpu")
    exp = ExperimentConfig(model=ModelConfig.from_json(json.dumps(cfg)), mano_assets=str(tmp_path))
    model = DemoModel(config=exp, image_size=SIZE, device="cpu")
    model.net.load_state_dict(w, strict=True)
    assert model.net.atlas_base_net is not None and model.net.mano_branch.shape_reg is not None

    frames, sides = _frames(6), (np.arange(4) % 2).astype(np.int32)
    with torch.inference_mode():
        got = model._infer(model._variables, torch.from_numpy(frames), torch.from_numpy(sides),
                           torch.zeros(4, dtype=torch.bool))
        want = ref.Model(cfg, mano, "cpu").forward(
            w, ref18.preprocess(torch.from_numpy(frames), SIZE), torch.from_numpy(sides))
    for k in KEYS:
        r = want[k].double()
        gap = float((got[k].double() - r).abs().max() / r.abs().max())
        assert gap <= TOLERANCE, (k, gap)
    # the shape blend moved the hand: betas of zero would be far off
    zero_shape = {k: v * 0 if k.startswith("mano_branch.shape_reg.") else v for k, v in w.items()}
    with torch.inference_mode():
        flat = ref.Model(cfg, mano, "cpu").forward(
            zero_shape, ref18.preprocess(torch.from_numpy(frames), SIZE), torch.from_numpy(sides))
    assert float((flat["verts"] - want["verts"]).abs().max() / want["verts"].abs().max()) > 1e-2


def _handnet(resnet_version: int = 50, seed: int = 0) -> HandNet:
    from obman_train_tpu_torch.assets import synthetic_mano_assets

    torch.manual_seed(seed)
    cfg = ModelConfig.from_json(json.dumps(_cfg(resnet_version=resnet_version)))
    return build_handnet(cfg, synthetic_mano_assets("right"), synthetic_mano_assets("left"),
                         device="cpu")


def _images(seed: int, b: int = 2, dtype=torch.float32) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    # NHWC frames viewed as NCHW, as HandNet hands them to its encoders
    return torch.randn(b, SIZE, SIZE, 3, generator=g, dtype=dtype).permute(0, 3, 1, 2)


def test_the_object_encoders_fold_equals_its_forward():
    net = _handnet()
    enc = _randomize(net.atlas_base_net.double(), 1)
    x = _images(2, dtype=torch.float64)
    with torch.no_grad():
        want, _ = enc(x)
        got, _ = resnet_fold.features(resnet_fold.fold(enc), x, resnet_fold.PLAIN)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10)
    assert float(want.abs().max()) > 0.1  # the statistics moved the features


def test_handnet_hands_both_encoders_to_the_hook():
    from torch.profiler import ProfilerActivity, profile

    net = _handnet(resnet_version=18)
    batch = {"images": torch.rand(2, SIZE, SIZE, 3) - 0.5, "sides": torch.tensor([0, 1])}
    called = []

    def hook(enc, image):
        called.append(enc)
        return enc(image)

    kw = dict(no_loss=True, force_hand=True, force_objects=True, contact=False)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        _, hooked, _ = net(batch, INFER_SPEC, encoder=hook, **kw)
    _, plain, _ = net(batch, INFER_SPEC, **kw)
    assert called == [net.base_net, net.atlas_base_net]
    for k in KEYS:
        assert torch.equal(hooked[k], plain[k]), k
    spans = {e.name: e for e in prof.events() if e.name.startswith("handnet.")}
    outer, inner = spans["handnet.encoder"].time_range, spans["handnet.atlas_encoder"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end


@pytest.fixture
def folds(monkeypatch):
    """The folds made, by encoder; the fused entry runs the plain chain
    (the CPU has no cuDNN)."""
    real_fold, real_features = resnet_fold.fold, resnet_fold.features
    made = []

    def fold(net):
        made.append(net)
        return real_fold(net)

    def features(folded, x):
        return real_features(folded, x.as_subclass(torch.Tensor), resnet_fold.PLAIN)

    monkeypatch.setattr(resnet_fold, "fold", fold)
    monkeypatch.setattr(resnet_fold, "features", features)
    return made


def test_servenet_keeps_one_fold_per_encoder(folds, monkeypatch):
    import contextlib

    from obman_train_tpu_torch.demo import inference

    spans = []
    monkeypatch.setattr(inference, "span",
                        lambda name, args=None: spans.append((name, args)) or contextlib.nullcontext())
    net = _handnet(resnet_version=18)
    for enc, seed in ((net.base_net, 1), (net.atlas_base_net, 2)):
        _randomize(enc, seed)
    serve = ServeNet(net, SIZE).eval()
    hand, obj = net.base_net, net.atlas_base_net
    x = _images(3).as_subclass(_OnCard)

    def call():
        with torch.inference_mode():
            return [serve.encode(enc, x)[0].as_subclass(torch.Tensor) for enc in (hand, obj)]

    first = call()
    assert folds == [hand, obj]
    assert spans == [("serve.fold", "base_net"), ("serve.fold", "atlas_base_net")]
    again = call()
    assert folds == [hand, obj] and all(a.equal(b) for a, b in zip(first, again))
    with torch.no_grad():
        want = [enc(x.as_subclass(torch.Tensor))[0] for enc in (hand, obj)]
    for got, ref_ in zip(first, want):
        torch.testing.assert_close(got, ref_, rtol=1e-4, atol=1e-5)

    state = {k: v.clone() for k, v in _randomize(_handnet(18, seed=7).atlas_base_net, 8)
             .state_dict().items()}
    obj.load_state_dict(state)
    loaded = call()
    assert folds == [hand, obj, obj]  # the object encoder alone folds again
    assert loaded[0].equal(first[0]) and not loaded[1].equal(first[1])
    call()
    assert folds == [hand, obj, obj]
    assert set(serve._folds) == {hand, obj}


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN's fused convolutions have no CPU mode")


@pytest.mark.cuda
def test_both_encoders_fused_match_resnet_forward_on_the_card(cuda_card, tmp_path):
    cfg = _cfg()
    mano_files.write(str(tmp_path), 9)
    exp = ExperimentConfig(model=ModelConfig.from_json(json.dumps(cfg)), mano_assets=str(tmp_path))
    model = DemoModel(config=exp, device="cuda")
    model.net.load_state_dict(weights.make(ref.param_specs(cfg), 9, "cuda"), strict=True)
    rng = np.random.default_rng(10)
    frames = torch.from_numpy(rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)).cuda()
    sides = torch.from_numpy((np.arange(8) % 2).astype(np.int32)).cuda()
    flip = torch.zeros(8, dtype=torch.bool, device="cuda")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        got = model._infer(model._variables, frames, sides, flip)
        assert set(model._serve._folds) == {model.net.base_net, model.net.atlas_base_net}
        with torch.enable_grad():  # autograd records: ResNet.forward
            want = model._serve(frames, sides, flip)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    for k in KEYS:
        r = want[k].detach().double()
        gap = float((got[k].double() - r).abs().max() / r.abs().max())
        assert gap < 1e-5, (k, gap)
