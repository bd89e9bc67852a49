"""The port's spans (``utils/tracing.py``) on the CPU: a shared no-op when
no profiler records; under ``torch.profiler`` the train step's and the
serving call's phases as ``user_annotation`` ranges, nested by time on the
calling thread; and the same numbers, kernel launches and exported
program with the profiler on as with it off."""

import collections
import copy
import io
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from obman_train_tpu_torch import train
from obman_train_tpu_torch.config import (
    AtlasConfig,
    ContactConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from obman_train_tpu_torch.demo import DemoModel
from obman_train_tpu_torch.demo.export import _export
from obman_train_tpu_torch.models import BatchSpec
from obman_train_tpu_torch.ops.kernels import LAUNCHES
from obman_train_tpu_torch.utils import tracing

torch.set_num_threads(2)

SIZE = 64
CONFIG = ExperimentConfig(mano_assets="synthetic", model=ModelConfig(
    image_size=SIZE, atlas=AtlasConfig(predict_trans=True, predict_scale=True),
    contact=ContactConfig(contact_lambda=0.167, collision_lambda=0.167)))
HANDNET = ("handnet.encoder", "handnet.mano", "handnet.atlas", "handnet.contact")


@pytest.fixture(scope="module")
def model():
    return DemoModel(config=CONFIG, device="cpu")


def _batch(B=2, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "images": rng.integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8),
        "sides": rng.integers(0, 2, (B,)).astype(np.int32),
        "joints3d": rng.normal(0, 30, (B, 21, 3)).astype(np.float32),
        "verts3d": rng.normal(0, 30, (B, 778, 3)).astype(np.float32),
        "objpoints3d": rng.normal(0, 50, (B, 600, 3)).astype(np.float32),
    }


def _serve_inputs(B=2, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8)),
            torch.from_numpy(rng.integers(0, 2, (B,)).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 2, (B,)).astype(bool)))


def _train_once(model, traced, tmp_path=None):
    """One train step of a copy of ``model``'s net, under a CPU profiler when
    ``traced``: ``(losses, gradients, parameters after, launches, spans)``."""
    net = copy.deepcopy(model.net)
    opt = train.make_optimizer(TrainConfig(), net)
    state = train.create_train_state(net, opt, TrainConfig())
    step = train.make_train_step(net, opt, BatchSpec(), device="cpu")
    before = collections.Counter(LAUNCHES)
    spans = []
    if traced:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            state, losses = step(state, _batch())
        spans = _spans(prof, tmp_path / "train.json")
    else:
        state, losses = step(state, _batch())
    launches = collections.Counter(LAUNCHES)
    launches.subtract(before)
    grads = {n: p.grad.clone() for n, p in net.named_parameters() if p.grad is not None}
    params = {n: p.detach().clone() for n, p in net.named_parameters()}
    return losses, grads, params, launches, spans


def _serve_once(model, traced, tmp_path=None):
    spans = []
    if traced:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = model._infer(model._variables, *_serve_inputs())
        spans = _spans(prof, tmp_path / "serve.json")
    else:
        out = model._infer(model._variables, *_serve_inputs())
    return out, spans


def _spans(prof, path):
    """The program's ranges in the profiler's Chrome trace:
    ``[(name, start, end, thread)]`` in order of start."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"])
                  for e in events
                  if e.get("cat") == "user_annotation" and e.get("ph") == "X"
                  and e["name"].split(".")[0] in ("train", "handnet", "serve"))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2] and inner[3] == outer[3]


def _only(spans, name):
    found = [s for s in spans if s[0] == name]
    assert len(found) == 1, (name, found)
    return found[0]


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    s = tracing.span("train.step", "7")
    assert s is tracing._NULL and tracing.span("serve.infer") is s
    with s:
        pass


def test_span_under_a_profiler_is_a_range():
    with profile(activities=[ProfilerActivity.CPU]):
        s = tracing.span("serve.infer")
        assert s is not tracing._NULL
        with s:
            pass
    assert tracing.span("serve.infer") is tracing._NULL


def test_train_step_phases_nest_by_time_on_one_thread(model, tmp_path):
    spans = _train_once(model, True, tmp_path)[4]
    step = _only(spans, "train.step")
    fwd, bwd, opt = (_only(spans, n) for n in ("train.forward", "train.backward",
                                                 "train.optimizer"))
    for phase in (fwd, bwd, opt):
        assert _inside(phase, step), phase
    assert fwd[2] <= bwd[1] and bwd[2] <= opt[1]
    for name in HANDNET:
        found = [s for s in spans if s[0] == name]
        assert found, name
        assert all(_inside(s, fwd) for s in found), found
    # the atlas branch is entered twice: its decoder before the contact
    # block, its losses after
    atlas = [s for s in spans if s[0] == "handnet.atlas"]
    contact = _only(spans, "handnet.contact")
    assert len(atlas) == 2 and atlas[0][2] <= contact[1] and contact[2] <= atlas[1][1]


def test_serving_call_phases_nest_by_time_on_one_thread(model, tmp_path):
    spans = _serve_once(model, True, tmp_path)[1]
    infer = _only(spans, "serve.infer")
    pre = _only(spans, "serve.preprocess")
    assert _inside(pre, infer)
    for name in ("handnet.encoder", "handnet.mano", "handnet.atlas"):
        s = _only(spans, name)
        assert _inside(s, infer) and pre[2] <= s[1], s
    # the demo path leaves out the contact block; on the CPU no copy spans
    assert not [s for s in spans if s[0] in ("handnet.contact", "serve.copy_pack",
                                             "serve.copy_wait")]


def test_train_step_is_bit_identical_with_the_profiler_on(model, tmp_path):
    off = _train_once(model, False)
    on = _train_once(model, True, tmp_path)
    for a, b in zip(off[:3], on[:3]):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert off[3] == on[3]


def test_served_outputs_are_bit_identical_with_the_profiler_on(model, tmp_path):
    before = collections.Counter(LAUNCHES)
    off = _serve_once(model, False)[0]
    mid = collections.Counter(LAUNCHES)
    on = _serve_once(model, True, tmp_path)[0]
    assert sorted(off) == sorted(on)
    for k in off:
        assert torch.equal(off[k], on[k]), k
    assert mid - before == collections.Counter(LAUNCHES) - mid


def test_export_under_a_profiler_is_the_same_program(model):
    plain = torch.export.load(io.BytesIO(_export(model._serve, model.device, SIZE, None)))
    with profile(activities=[ProfilerActivity.CPU]):
        traced = torch.export.load(io.BytesIO(_export(model._serve, model.device, SIZE, None)))
    assert "record_function" not in str(traced.graph)
    assert str(traced.graph) == str(plain.graph)
    assert str(traced.range_constraints) == str(plain.range_constraints)
