"""GT-free inference entry point (mirrors the JAX package's bench.py:384-393
``make_infer``, demo/inference.py:80-99 and ``__graft_entry__.entry``).

``make_infer(net)`` returns ``fn(frames_u8 (B,H,W,3), sides (B,))`` that
runs ``HandNet`` with ``no_loss=True, force_hand=True, force_objects=True``
on the net's device and returns a dict with ``verts`` (B,778,3), ``joints``
(B,21,3), ``objpoints3d`` (B,642,3) and, when the config has contact or
collision weights, ``contact_info``, in the JAX package's dtypes: with
``compute_dtype="bfloat16"`` the MANO outputs are float32 and
``objpoints3d`` is bf16.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from obman_train_tpu_torch.models.handnet import INFER_SPEC, HandNet

_KEEP = ("verts", "joints", "objpoints3d", "contact_info")


def make_infer(net: HandNet) -> Callable[..., Dict]:
    net.eval()
    device = next(net.parameters()).device

    @torch.inference_mode()
    def fn(frames_u8, sides) -> Dict:
        frames = torch.as_tensor(frames_u8).to(device, non_blocking=True)
        sides = torch.as_tensor(sides).to(device, non_blocking=True)
        _, res, _ = net(
            {"images": frames, "sides": sides}, INFER_SPEC,
            no_loss=True, force_hand=True, force_objects=True,
        )
        return {k: res[k] for k in _KEEP if k in res}

    return fn
