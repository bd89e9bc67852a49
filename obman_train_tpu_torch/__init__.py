"""PyTorch/CUDA port of obman_train_tpu for NVIDIA Hopper.

Module paths mirror the JAX package (``obman_train_tpu``) so each port
module sits beside its counterpart's name: ``models/handnet.py``,
``ops/contact.py`` and so on. The port imports ``torch`` and numpy only,
never JAX and nothing of the JAX package.

Entry points (:func:`models.handnet.build_handnet`, :func:`infer.make_infer`,
:class:`demo.DemoModel`, the ``cli`` modules) run on the GPU unless the
caller passes ``device="cpu"`` (the CLIs: ``OBMAN_PLATFORM=cpu``); without a
GPU they raise instead of falling back to the CPU (see :mod:`device`).
"""

from obman_train_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
