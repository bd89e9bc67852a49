"""The backward epilogue of the encoders' ReLU convolutions on the card:
device ms per train step traced of the kernels whose names hold
``threshold``, ``CUDAFunctor_add``, ``reduce_kernel`` or
``relu_bias_grad``, summed over the traced window, each kernel counted
once. On an H100 trace of the two-encoder step (torch 2.11) they are:

- ``threshold``: ATen's ReLU backward, ``vectorized_elementwise_kernel<4,
  BinaryFunctor<..., threshold_kernel_impl<float>...>>`` (and its
  ``elementwise_kernel`` form);
- ``CUDAFunctor_add``: ATen's add, autograd summing a tensor's two
  gradients (``vectorized_elementwise_kernel`` and ``elementwise_kernel``
  forms; ``CUDAFunctorOnSelf_add``, the in-place add, too);
- ``reduce_kernel``: ATen's reductions, ``at::native::reduce_kernel<...,
  sum_functor...>`` (the bias sums of ``convolution_backward``, the
  fold's per-channel sums) and ``MeanOps``; also cuBLASLt's
  ``splitKreduce_kernel`` of the decoder's GEMMs (~0.2 ms a step);
- ``relu_bias_grad``: the port's kernel that does the add, the mask and the
  bias sum in one pass (``relu_bias_grad_rows``, ``relu_bias_grad_sum``).

A time and not a share: the adds and reductions of other layers (the
decoder, the losses, the fold, the optimizer) are in it too. None without
a trace, a traced step or such a kernel."""

from portbench.metrics_util import steps_traced

NEEDLES = ("threshold", "CUDAFunctor_add", "reduce_kernel", "relu_bias_grad")


def read(run):
    if run.traced is None:
        return None
    steps, _ = steps_traced(run)
    secs = [s for name, s in run.traced["device_time"].items()
            if any(needle in name for needle in NEEDLES)]
    if not steps or not secs:
        return None
    return 1e3 * sum(secs) / steps
