"""``bn_kernel_ms.train`` on a hand-built Chrome trace: the device time of
the kernels whose names hold ``bn_fw`` or ``batch_norm``, clipped to the
traced window, per train step traced; silence untraced, without a step or
without such a kernel (a CPU trace)."""

import json
import types

import pytest

from portbench import core
from portbench.trace import WINDOW, summarize

NAME = "bn_kernel_ms.train"
# (name, start µs, duration µs) on the card; the window is [0, 10000]
KERNELS = [
    ("void cudnn::bn_fw_inf_1C11_kernel_NHWC<float, float, true, true>(...)", 100, 300),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
     "at::native::batch_norm_elementwise_backward_eval(...)::{lambda(float, float)#1}>>(...)",
     1000, 500),
    ("void at::native::batch_norm_backward_reduce_channels_last_kernel<4, float, float, float>(...)",
     2000, 200),
    ("void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, false>(...)", 9900, 400),  # clipped
    ("void cudnn::bn_fw_inf_1C11_kernel_NHWC<float, float, true, true>(...)", -800, 300),  # before
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc(...)", 3000, 900),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>(...)",
     4000, 100),
]
EXPECTED_US = 300 + 500 + 200 + 100


def _run(tmp_path, kernels=KERNELS, steps=2):
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 0, "dur": 10000,
               "pid": 1, "tid": 1}]
    events += [{"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": d, "pid": 0, "tid": 7}
               for n, a, d in kernels]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    spans = core.Spans()
    spans.spans = [("step", 1.0 + i, 1.5 + i) for i in range(steps)] + [("step", 20.0, 20.5)]
    return types.SimpleNamespace(traced=summarize(str(path)), trace_window=(0.0, 10.0),
                                 spans=spans)


def _read(run):
    return core.load_module("metrics", NAME).read(run)


def test_in_the_benchmark_for_the_train_cell():
    names = {m["name"] for m in core.cell_metrics(core.benchmark(), "contact_train_step")[1]}
    assert NAME in names


@pytest.mark.parametrize("steps", [1, 2, 4])
def test_sums_the_named_kernels_per_step(steps, tmp_path):
    assert _read(_run(tmp_path, steps=steps)) == pytest.approx(EXPECTED_US * 1e-3 / steps,
                                                               rel=1e-12)


@pytest.mark.parametrize("case", ["untraced", "no_step", "no_bn_kernel"])
def test_silent_without_a_trace_a_step_or_a_kernel(case, tmp_path):
    if case == "untraced":
        run = types.SimpleNamespace(traced=None)
    elif case == "no_step":
        run = _run(tmp_path, steps=0)
    else:
        run = _run(tmp_path, kernels=[k for k in KERNELS if "bn_fw" not in k[0]
                                      and "batch_norm" not in k[0]])
    assert _read(run) is None
