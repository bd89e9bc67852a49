"""``relu_grad_ms.train`` on a hand-built Chrome trace: the device time of
the kernels whose names hold ``threshold``, ``CUDAFunctor_add``,
``reduce_kernel`` or ``relu_bias_grad``, clipped to the traced window, per
train step traced; silence untraced, without a step or without such a
kernel (a CPU trace)."""

import json
import types

import pytest

from portbench import core
from portbench.trace import WINDOW, summarize

NAME = "relu_grad_ms.train"
# (name, start µs, duration µs) on the card; the window is [0, 10000]
KERNELS = [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float, float, "
     "float, at::native::(anonymous namespace)::threshold_kernel_impl<float>(at::"
     "TensorIteratorBase&, float, float)::{lambda(float, float)#1}>, std::array<char*, 3ul> >"
     "(int, ...)", 100, 300),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "std::array<char*, 3ul> >(int, ...)", 1000, 500),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, at::native::"
     "func_wrapper_t<float, at::native::sum_functor<float, float, float>::operator()(at::"
     "TensorIterator&)::{lambda(float, float)#1}>, unsigned int, float, 4, 4> >(...)", 2000, 200),
    ("void (anonymous namespace)::relu_bias_grad_rows<true>(float4 const*, ...)", 2500, 150),
    ("void (anonymous namespace)::relu_bias_grad_sum(float const*, int, int, float*)", 2700, 10),
    ("void (anonymous namespace)::relu_bias_grad_rows<false>(float4 const*, ...)", 9950, 400),
    ("void (anonymous namespace)::relu_bias_grad_rows<false>(float4 const*, ...)", -800, 300),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc(...)", 3000, 900),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float, float, "
     "float, at::native::binary_internal::MulFunctor<float> >, std::array<char*, 3ul> >(...)",
     4000, 100),
]
EXPECTED_US = 300 + 500 + 200 + 150 + 10 + 50  # the last relu_bias_grad clipped


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


@pytest.mark.parametrize("cell", ["contact_train_step", "sep_r50_train_step"])
def test_in_the_benchmark_for_the_train_cells(cell):
    names = {m["name"] for m in core.cell_metrics(core.benchmark(), cell)[1]}
    assert NAME in names


def test_not_in_the_serving_cells():
    for cell in ("hand_object_batch_b256", "sep_r50_batch_b256"):
        assert NAME not in {m["name"] for m in core.cell_metrics(core.benchmark(), cell)[1]}


@pytest.mark.parametrize("steps", [1, 2, 4])
def test_sums_the_named_kernels_per_step(steps, tmp_path):
    assert _read(_run(tmp_path, steps=steps)) == pytest.approx(EXPECTED_US * 1e-3 / steps,
                                                               rel=1e-12)


@pytest.mark.parametrize("case", ["untraced", "no_step", "no_such_kernel"])
def test_silent_without_a_trace_a_step_or_a_kernel(case, tmp_path):
    if case == "untraced":
        run = types.SimpleNamespace(traced=None)
    elif case == "no_step":
        run = _run(tmp_path, steps=0)
    else:
        run = _run(tmp_path, kernels=KERNELS[-2:])
    assert _read(run) is None
