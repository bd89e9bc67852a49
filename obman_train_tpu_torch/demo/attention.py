"""Activation attention maps for the demos (the JAX package's
``demo/attention.py``; reference AttentionHook, mano_train/demo/
attention.py:13-57): the mean squared activation of each ResNet stage,
resized bilinearly to the frame, multiplied over the stages, normalised per
sample, then colour-mapped and blended over the frame. The encoder returns
its stage outputs itself (``ResNet(..., return_inter=True)``), so no hooks;
the colour map is matplotlib's jet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def stage_attention(inters: Sequence[torch.Tensor], frame_hw) -> np.ndarray:
    """Per-stage mean-squared activation maps -> their product in [0, 1].

    Args:
      inters: the (B, C, h, w) stage activations (NCHW, the port's layout),
        tensors on any device or numpy arrays; a bf16 encoder's are squared
        and averaged in float32.
      frame_hw: (H, W) of the target frame.
    Returns a (B, H, W) float32 numpy map, normalised per sample.
    """
    H, W = frame_hw
    prod = None
    for act in inters:
        amap = torch.mean(torch.as_tensor(act, dtype=torch.float32) ** 2, dim=1, keepdim=True)
        amap = F.interpolate(amap, size=(H, W), mode="bilinear", align_corners=False,
                             antialias=True)[:, 0]
        prod = amap if prod is None else prod * amap
    prod = prod.cpu().numpy()
    mins = prod.min(axis=(1, 2), keepdims=True)
    maxs = prod.max(axis=(1, 2), keepdims=True)
    return (prod - mins) / np.maximum(maxs - mins, 1e-12)


def attention_overlay(frame: np.ndarray, attention: np.ndarray,
                      alpha: float = 0.5) -> np.ndarray:
    """A jet-coloured attention map blended over a uint8 RGB frame; without
    matplotlib, red for high attention and blue for low."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        from matplotlib import cm

        heat = (cm.jet(attention)[:, :, :3] * 255).astype(np.uint8)
    except ImportError:
        heat = np.stack([
            (attention * 255).astype(np.uint8),
            np.zeros_like(attention, np.uint8),
            ((1 - attention) * 255).astype(np.uint8),
        ], axis=-1)
    return (alpha * heat + (1 - alpha) * frame).astype(np.uint8)
