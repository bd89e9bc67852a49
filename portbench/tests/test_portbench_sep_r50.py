"""The cell ``sep_r50_batch_b256`` (the separate-encoder ResNet-50
network) on the CPU at a tiny size: it agrees with its plain reference
(``reference/handnet_sep.py``), a traced run reports its layer metrics,
``counts/flops_sep.py`` agrees with PyTorch's own count of the program's
forward, and the control and three planted faults are not ``correct``.
The limits are the cell's own (``workloads/sep_r50_batch_b256.json``)."""

import json
import types

import numpy as np
import pytest
import torch

from portbench import core
from portbench.counts import flops_sep
from portbench.tests.tiny import SEED, SECONDS
from portbench.trace import WINDOW

CELL = "sep_r50_batch_b256"
# the batch cell's tiny size (tests/tiny.py), for this cell
TINY = {"batch": 4, "crop": 64, "pool_batches": 2, "warmup_batches": 2, "checked_calls": 2,
        "model_override": {"image_size": 64}}


def run_tiny(trace: bool = False, **extra):
    from portbench.run import run_cell

    overrides = dict(TINY)
    overrides.update(extra)
    return run_cell(CELL, SEED, SECONDS, trace, device="cpu", overrides=overrides)


def test_the_cell_runs_and_agrees_with_its_reference():
    result = run_tiny()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"setup_s", "serve_frames_per_s"} <= set(result["metrics"])
    assert set(result["checks"]) == {"outputs", "verts", "joints", "objpoints3d", "objtrans",
                                     "objscale"}
    assert list(result)[-1] == "checks"


def test_a_traced_run_reports_its_layer_metrics():
    from portbench.program_trace import reduce

    result = run_tiny(trace=True)
    assert result["correct"], result["checks"]
    _, layer = core.cell_metrics(core.benchmark(), CELL)
    assert {"serve_mfu.sep_r50", "atlas_encoder_launches.sep_r50"} <= {m["name"] for m in layer}
    assert "serve_mfu.serve" not in {m["name"] for m in layer}  # ResNet-18's count
    assert result["metrics"]["serve_mfu.sep_r50"]["value"] > 0
    # the CPU makes no launch call: the launch reader is silent, but the
    # object encoder's span lies inside every served batch's
    assert "atlas_encoder_launches.sep_r50" not in result["metrics"]
    spans = reduce(result["trace_file"])["spans"]
    infer, atlas = spans["serve.infer"], spans["handnet.atlas_encoder"]
    assert len(atlas) == len(infer) > 0
    assert all(a <= c and d <= b for (a, b), (c, d) in zip(infer, atlas))


def _trace(tmp_path, spans, launches):
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0, "dur": 10000,
               "pid": 1, "tid": 1}]
    events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a,
                "pid": 1, "tid": 1} for n, a, b in spans]
    events += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2,
                "pid": 1, "tid": 1} for ts in launches]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return types.SimpleNamespace(traced={"path": str(path)})


def test_the_launch_reader_counts_inside_the_object_encoder(tmp_path):
    read = core.load_module("metrics", "atlas_encoder_launches.sep_r50").read
    batches = [("serve.infer", a, a + 900) for a in (1000, 3000)]
    atlas = [("handnet.atlas_encoder", a + 100, a + 300) for _, a, _ in batches]
    # 3 and 1 launches inside the object encoder, the rest outside it
    launches = [1150, 1200, 1250, 1400, 3150, 3500, 500]
    assert read(_trace(tmp_path, batches + atlas, launches)) == pytest.approx(2.0, rel=1e-12)
    # a program without the span (the parent's) leaves the metric out
    assert read(_trace(tmp_path, batches, launches)) is None
    assert read(types.SimpleNamespace(traced=None)) is None


@pytest.mark.parametrize("size", [64, 224])
def test_resnet50_count_is_pytorchs(size):
    from torch.utils.flop_counter import FlopCounterMode

    from obman_train_tpu_torch.models.resnet import resnet50

    net = resnet50().eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        net(torch.zeros(1, 3, size, size))
    assert counter.get_total_flops() == 2 * flops_sep.resnet50_macs(size)
    if size == 224:
        assert flops_sep.resnet50_macs(224) / 1e9 == pytest.approx(4.09, abs=0.01)


def test_forward_count_agrees_with_pytorchs_within_1_percent(tmp_path):
    """The program's served forward at 64² (PyTorch's count of every
    convolution, linear layer and batched product) against the frozen
    count; the elementwise work neither counts is under 1 %."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench import program
    from portbench.reference import handnet_sep as ref
    from portbench.traffic import mano_files, weights

    config = core.load_json("configs", "obman_sep_r50")
    mano_files.write(str(tmp_path), 3)
    w = weights.make(ref.param_specs(config["model"]), 3, "cpu")
    model, size = program.demo_model(config, str(tmp_path), w, "cpu", image_size=64)
    frames = torch.zeros(2, size, size, 3, dtype=torch.uint8)
    sides = torch.tensor([0, 1], dtype=torch.int32)
    flip = torch.zeros(2, dtype=torch.bool)
    with FlopCounterMode(display=False) as counter:
        model._infer(model._variables, frames, sides, flip)
    want = 2 * flops_sep.forward_flops(config["model"], size)
    assert counter.get_total_flops() == pytest.approx(want, rel=0.01)


def test_control_in_bfloat16_is_not_correct():
    result = run_tiny(model_override={"image_size": 64, "compute_dtype": "bfloat16"})
    assert not result["correct"], result["checks"]


def test_half_the_frames_left_out(monkeypatch):
    from obman_train_tpu_torch.demo import inference

    made = inference.DemoModel._infer

    def half(self, variables, frames, sides, flip):
        n = frames.shape[0] // 2
        out = made(self, variables, frames[:n], sides[:n], flip[:n])
        return {k: torch.cat([v, v]) for k, v in out.items()}

    monkeypatch.setattr(inference.DemoModel, "_infer", half)
    assert not run_tiny()["correct"]


def test_the_object_decoder_fed_the_hand_encoders_features(monkeypatch):
    from obman_train_tpu_torch.models.branches import AtlasBranch

    made = AtlasBranch.forward_inference
    monkeypatch.setattr(AtlasBranch, "forward_inference",
                        lambda self, feats, separate_encoder_features=None: made(self, feats, feats))
    result = run_tiny()
    assert not result["correct"], result["checks"]
    assert result["checks"]["objpoints3d"]["value"] > result["checks"]["objpoints3d"]["limit"]


def test_the_shape_blend_dropped(monkeypatch):
    """Betas zero: MANO on the template alone."""
    from obman_train_tpu_torch.models import branches

    made = branches.mano_forward
    monkeypatch.setattr(branches, "mano_forward",
                        lambda layer, pose, betas=None, *a, **k: made(layer, pose, None, *a, **k))
    result = run_tiny()
    assert not result["correct"], result["checks"]
    assert result["checks"]["verts"]["value"] > result["checks"]["verts"]["limit"]
    assert np.isfinite(result["checks"]["outputs"]["value"])
