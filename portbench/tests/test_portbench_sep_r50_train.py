"""The cell ``sep_r50_train_step`` (the separate-encoder ResNet-50 network
trained with the contact losses) on the CPU at a tiny size: it agrees
with its plain training reference (``reference/handnet_sep_train.py``),
the reference's checkpointed encoder blocks change no value, the count
is three forwards and the geometry, a traced run reports the layer
metrics the cell lists, and the control and three planted faults are not
``correct``. The limits are the cell's own
(``workloads/sep_r50_train_step.json``)."""

import json
import types

import numpy as np
import pytest
import torch

from portbench import checks_sep_train, core
from portbench.counts import flops, flops_sep, flops_sep_train
from portbench.tests.tiny import SECONDS, SEED
from portbench.trace import WINDOW

CELL = "sep_r50_train_step"
# the ResNet-50 widths at a tiny batch and crop
TINY = {"batch": 2, "res": 64, "tree_samples": 8, "tree_image_size": 128, "pool_batches": 3,
        "threads": 2, "warmup_steps": 3}


def run_tiny(trace: bool = False, **extra):
    from portbench.run import run_cell

    overrides = dict(TINY)
    overrides.update(extra)
    return run_cell(CELL, SEED, SECONDS, trace, device="cpu", overrides=overrides)


def test_the_cell_runs_and_agrees_with_its_reference(monkeypatch):
    compared = []
    numbers = checks_sep_train.train_numbers

    def keep(prog_losses, *rest):
        compared.append((prog_losses[0], rest[2][0]))
        return numbers(prog_losses, *rest)

    monkeypatch.setattr(checks_sep_train, "train_numbers", keep)
    result = run_tiny()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert {"setup_s", "train_samples_per_s"} <= set(result["metrics"])
    assert set(result["checks"]) == {"terms", "joints", "grad", "change"}
    assert list(result)[-1] == "checks"
    (prog, ref1), = compared
    assert "mano_shape" in prog and "mano_shape" in ref1 and ref1["mano_shape"] > 0


def test_the_shape_term_is_compared():
    first = {"total_loss": 100.0, "mano_verts3d": 10.0, "mano_shape": 0.05}
    ref_losses = [dict(first)]
    grads = {"a": torch.ones(3), "b": torch.ones(2)}

    def terms(prog):
        return checks_sep_train.train_numbers([prog] * 3, grads, grads, ref_losses * 3,
                                              grads, grads)["terms"]

    assert terms(first) == 0.0
    assert terms(dict(first, mano_shape=0.06)) == pytest.approx(0.2)
    without = {k: v for k, v in first.items() if k != "mano_shape"}
    assert terms(without) == float("inf")


def _tables_in_float64(model):
    model.mano = {side: {k: v.double() for k, v in t.items()} for side, t in model.mano.items()}
    model.template = model.template.double()
    return model


def test_the_blocked_reference_equals_the_unblocked_one(tmp_path, monkeypatch):
    """Float64, 3 samples in blocks of 2: every loss term and every leaf's
    gradient to float64's rounding. (The inside test's ray is float32: it
    gets float32 points and returns a mask, which carries no gradient.)"""
    from portbench.reference import handnet
    from portbench.reference import handnet_sep_train as ref
    from portbench.traffic import mano_files, weights

    outside = handnet.outside
    monkeypatch.setattr(handnet, "outside", lambda p, t: outside(p.float(), t.float()))
    torch.set_default_dtype(torch.float64)
    try:
        cfg = core.load_json("configs", "obman_sep_r50_contact")["model"]
        files = mano_files.write(str(tmp_path), 3)
        w = weights.make(ref.param_specs(cfg), 5, "cpu")
        g = torch.Generator().manual_seed(0)
        for k in w:  # batch norms that are not the identity
            if k.endswith("running_mean"):
                w[k] = 0.2 * torch.randn(w[k].shape, generator=g)
            elif k.endswith("running_var"):
                w[k] = 0.5 + torch.rand(w[k].shape, generator=g)
        rng = np.random.default_rng(0)
        batch = {"images": torch.from_numpy(rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)),
                 "sides": torch.tensor([0, 1, 0]),
                 "joints3d": torch.from_numpy(rng.normal(0, 30, (3, 21, 3))),
                 "verts3d": torch.from_numpy(rng.normal(0, 30, (3, 778, 3))),
                 "objpoints3d": torch.from_numpy(rng.normal(0, 50, (3, 600, 3)))}
        leaves = [k for k in w if ref.trainable(k)]

        def run(block):
            model = _tables_in_float64(ref.Model(cfg, files, "cpu", block=block))
            p = {k: v.clone().requires_grad_(ref.trainable(k)) for k, v in w.items()}
            out = model.forward(p, ref.normalize(batch["images"]).double(), batch["sides"])
            L = model.losses(out, batch)
            grads = torch.autograd.grad(L["total_loss"], [p[k] for k in leaves])
            return {k: float(v.detach()) for k, v in L.items()}, dict(zip(leaves, grads))

        (want, want_g), (got, got_g) = run(None), run(2)
    finally:
        torch.set_default_dtype(torch.float32)
    assert set(got) == set(want) >= set(ref.LOSS_TERMS)
    assert want["mano_shape"] > 0 and want["attraction_loss"] > 0
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12, abs=1e-12 * abs(want["total_loss"])), k
    for k, g_ref in want_g.items():
        scale = float(g_ref.abs().max())
        assert scale > 0, k
        assert float((got_g[k] - g_ref).abs().max()) <= 1e-10 * scale, k


def test_the_count_is_three_forwards_and_the_geometry():
    cfg = core.load_json("configs", "obman_sep_r50_contact")["model"]
    geo = 4 * 600 * 642 * 9 + 2 * 778 * 642 * 9 + 778 * 600 * 9 + 778 * 1280 * 36 + 1280 * 23
    want = 3 * flops_sep.forward_flops(cfg, 256) + geo
    assert flops_sep_train.train_flops(cfg, 256) == pytest.approx(want, rel=1e-15)
    assert flops_sep_train.train_flops(cfg, 256) / 1e9 == pytest.approx(90.5, abs=0.05)
    # the ResNet-18 step's own count stays its own
    assert flops.train_flops(cfg, 256) < flops_sep_train.train_flops(cfg, 256) / 5


def test_a_traced_run_reports_its_layer_metrics():
    from portbench.program_trace import reduce

    result = run_tiny(trace=True)
    assert result["correct"], result["checks"]
    _, layer = core.cell_metrics(core.benchmark(), CELL)
    names = {m["name"] for m in layer}
    assert {"step_mfu.sep_r50_train", "atlas_encoder_launches.sep_r50_train",
            "conv_kernel_ms.sep_r50_train", "step_host_ms.train", "launches_per_step.train",
            "raytri_roofline.train", "nn_dir_roofline.train", "bn_kernel_ms.train"} <= names
    assert "step_mfu.train" not in names  # ResNet-18's count
    assert set(result["metrics"]) <= names
    assert result["metrics"]["step_mfu.sep_r50_train"]["value"] > 0
    assert result["metrics"]["step_host_ms.train"]["value"] > 0
    # the CPU makes no launch call and runs no cuDNN kernel: those readers
    # are silent, but the object encoder's span lies inside every step's
    assert "atlas_encoder_launches.sep_r50_train" not in result["metrics"]
    assert "conv_kernel_ms.sep_r50_train" not in result["metrics"]
    spans = reduce(result["trace_file"])["spans"]
    steps, atlas = spans["train.step"], spans["handnet.atlas_encoder"]
    assert len(atlas) == len(steps) > 0
    assert all(a <= c and d <= b for (a, b), (c, d) in zip(steps, atlas))


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


def test_the_launch_reader_counts_inside_the_object_encoder_per_step(tmp_path):
    read = core.load_module("metrics", "atlas_encoder_launches.sep_r50_train").read
    step_spans = [("train.step", a, a + 900) for a in (1000, 3000)]
    atlas = [("handnet.atlas_encoder", a + 100, a + 300) for _, a, _ in step_spans]
    # 3 and 1 launches inside the object encoder, the rest outside it
    launches = [1150, 1200, 1250, 1400, 3150, 3500, 500]
    assert read(_trace(tmp_path, step_spans + atlas, launches)) == pytest.approx(2.0, rel=1e-12)
    # a program without the span leaves the metric out
    assert read(_trace(tmp_path, step_spans, launches)) is None
    assert read(types.SimpleNamespace(traced=None)) is None


def test_the_convolution_reader_sums_each_kernel_once_per_step():
    read = core.load_module("metrics", "conv_kernel_ms.sep_r50_train").read
    spans = core.Spans()
    spans.spans = [("step", 1.0, 1.1), ("step", 1.2, 1.3), ("step", 9.0, 9.1)]
    device = {"sm90_xmma_fprop_implicit_gemm": 0.010, "sm90_xmma_dgrad_implicit_gemm": 0.004,
              "sm90_xmma_wgrad_indexed_implicit_gemm": 0.006, "cutlass_gemm_128x128": 0.5}
    run = types.SimpleNamespace(traced={"device_time": device}, spans=spans,
                                trace_window=(0.5, 2.0))
    # two steps in the traced window; the GEMM is not a convolution
    assert read(run) == pytest.approx(1e3 * 0.020 / 2, rel=1e-12)
    run.traced = {"device_time": {"cutlass_gemm_128x128": 0.5}}
    assert read(run) is None
    run.traced = None
    assert read(run) is None


def test_control_in_bfloat16_is_not_correct():
    result = run_tiny(model_override={"compute_dtype": "bfloat16"})
    assert not result["correct"], result["checks"]


def test_half_the_batch_left_out(monkeypatch):
    from obman_train_tpu_torch.train import steps

    whole = steps._to_device

    def half(batch, device):
        out = whole(batch, device)
        return {k: v[: v.shape[0] // 2] if v.ndim else v for k, v in out.items()}

    monkeypatch.setattr(steps, "_to_device", half)
    assert not run_tiny()["correct"]


def test_the_shape_term_dropped(monkeypatch):
    """The program's MANO losses without ``lambda_shape * mano_shape``."""
    from obman_train_tpu_torch.models import handnet

    made = handnet.compute_mano_loss

    def dropped(preds, batch, cfg, **k):
        total, losses = made(preds, batch, cfg, **k)
        return total - cfg.lambda_shape * losses.pop("mano_shape"), losses

    monkeypatch.setattr(handnet, "compute_mano_loss", dropped)
    result = run_tiny()
    assert not result["correct"], result["checks"]
    assert result["checks"]["terms"]["value"] > result["checks"]["terms"]["limit"]


def test_the_object_encoders_gradient_zeroed(monkeypatch):
    """``atlas_freeze_encoder``'s effect: the object encoder out of the
    optimizer."""
    from obman_train_tpu_torch.train import steps

    frozen = steps._frozen
    monkeypatch.setattr(steps, "_frozen",
                        lambda name, cfg: name.startswith("atlas_base_net.") or frozen(name, cfg))
    result = run_tiny()
    assert not result["correct"], result["checks"]
    assert result["checks"]["grad"]["value"] > result["checks"]["grad"]["limit"]
