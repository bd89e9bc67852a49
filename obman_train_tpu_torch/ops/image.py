"""Device-side image operations on batches of NHWC tensors (the JAX
package's ``ops/image.py``). Plain PyTorch: the JAX package has no Pallas
kernel here.

- The demo chain (:20-68, reference demo/preprocess.py:8-39): a raw frame
  goes to the device as uint8 and is cropped, resized, flipped and
  normalised there. ``resize_bilinear`` antialiases when it shrinks, as
  ``jax.image.resize`` does: without ``antialias=True``, ``F.interpolate``
  differs from it by up to ~136 on the 0-255 scale at 480 -> 256.
- The colour jitter (:80-166): the float ``adjust_*`` operations of
  ``data/transforms.py`` on images in [0, 1], per-sample factors drawn on
  the host, one of the 24 operation orders per batch (the reference
  shuffles per sample, imgtrans.py:48; one order per batch keeps the cost
  at one pass). The order index is read on the host, where it selects the
  branch as ``lax.switch`` does on the TPU; the train and eval steps keep
  ``aug_order`` on the CPU for that.
- ``affine_warp`` (:168-214): the inverse-mapped bilinear warp of
  ``data/transforms.transform_img`` with per-sample matrices.
"""

from __future__ import annotations

import itertools
from typing import Optional

import torch
import torch.nn.functional as F

from obman_train_tpu_torch.device import full_fp32


def normalize_frames(frames: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> float32 x/255 - 0.5 (preprocess.py:30-38)."""
    return frames.to(torch.float32) / 255.0 - 0.5


def bgr_to_rgb(frames: torch.Tensor) -> torch.Tensor:
    return frames.flip(-1)


def flip_horizontal(frames: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Mirror the frames whose entry of the (B,) bool mask ``flip`` is set."""
    return torch.where(flip[:, None, None, None], frames.flip(2), frames)


def center_crop_square(frames: torch.Tensor) -> torch.Tensor:
    """The central square of each frame (preprocess.py:8-17)."""
    H, W = frames.shape[1:3]
    s = min(H, W)
    top, left = (H - s) // 2, (W - s) // 2
    return frames[:, top:top + s, left:left + s]


def resize_bilinear(frames: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, C) -> float32 (B, size, size, C), bilinear, antialiased
    when shrinking (``jax.image.resize(..., "bilinear")``)."""
    x = frames.to(torch.float32).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=True)
    return x.permute(0, 2, 3, 1)


def preprocess_frames(
    frames: torch.Tensor,
    size: int = 256,
    flip: Optional[torch.Tensor] = None,
    bgr: bool = False,
) -> torch.Tensor:
    """The demo chain in the JAX package's order: [BGR -> RGB] -> centre
    square crop -> resize -> [flip] -> x/255 - 0.5. Returns float32 NHWC."""
    if bgr:
        frames = bgr_to_rgb(frames)
    frames = resize_bilinear(center_crop_square(frames), size)
    if flip is not None:
        frames = flip_horizontal(frames, flip)
    return frames / 255.0 - 0.5


# column i of the factors feeds operation i; neutral factors are [1, 1, 0, 1]
PERMUTATIONS = tuple(itertools.permutations(range(4)))


def _rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])[..., None]


def adjust_brightness_batch(img, factor):
    return torch.clamp(img * factor[:, None, None, None], 0.0, 1.0)


def adjust_contrast_batch(img, factor):
    mean = torch.mean(_rgb_to_gray(img), dim=(1, 2, 3), keepdim=True)
    f = factor[:, None, None, None]
    return torch.clamp(f * img + (1 - f) * mean, 0.0, 1.0)


def adjust_saturation_batch(img, factor):
    gray = _rgb_to_gray(img)
    f = factor[:, None, None, None]
    return torch.clamp(f * img + (1 - f) * gray, 0.0, 1.0)


def adjust_hue_batch(img, factor):
    """Hue shift by ``factor`` turns, through a vectorized HSV round trip."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.amax(img, dim=-1)
    minc = torch.amin(img, dim=-1)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe = torch.clamp(delta, min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = (h + factor[:, None, None]) % 1.0
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6

    def select(choices):
        out = choices[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    r_out = select([v, q, p, p, t, v])
    g_out = select([t, v, v, q, p, p])
    b_out = select([p, p, t, v, v, q])
    return torch.clamp(torch.stack([r_out, g_out, b_out], dim=-1), 0.0, 1.0)


_JITTER_OPS = (
    adjust_brightness_batch,   # factor column 0
    adjust_saturation_batch,   # column 1
    adjust_hue_batch,          # column 2
    adjust_contrast_batch,     # column 3
)


def batched_color_jitter(images: torch.Tensor, factors: torch.Tensor,
                         order_idx) -> torch.Tensor:
    """The four jitter operations in permutation ``order_idx`` of the 24.

    Args:
      images: (B, H, W, 3) float in [0, 1].
      factors: (B, 4) per-sample [brightness, saturation, hue, contrast].
      order_idx: an int in [0, 24), or a 0-d tensor holding one (read on the
        host).
    """
    idx = int(order_idx)
    if not 0 <= idx < len(PERMUTATIONS):
        raise ValueError(f"aug_order {idx} not in [0, 24)")
    factors = factors.to(images.dtype)
    for op_i in PERMUTATIONS[idx]:
        images = _JITTER_OPS[op_i](images, factors[:, op_i])
    return images


def affine_warp(images: torch.Tensor, affine: torch.Tensor, out_size: int) -> torch.Tensor:
    """Batched inverse-mapped bilinear affine warp.

    Args:
      images: (B, H, W, C) float.
      affine: (B, 3, 3) forward transforms (original -> crop pixels), the
        convention of ``data/transforms.get_affine_transform``; inverted in
        float32, as the JAX package does.
      out_size: output height and width.
    Returns (B, out_size, out_size, C); taps outside the image read 0.
    """
    B, H, W, C = images.shape
    inv = torch.linalg.inv(affine.to(device=images.device, dtype=torch.float32))
    ys, xs = torch.meshgrid(
        torch.arange(out_size, dtype=torch.float32, device=images.device),
        torch.arange(out_size, dtype=torch.float32, device=images.device),
        indexing="ij",
    )
    grid = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(-1, 3)  # (P, 3)
    with full_fp32(images.device):  # pixel coordinates: no TF32
        src = torch.einsum("bij,pj->bpi", inv, grid)  # (B, P, 3)
    sx, sy = src[..., 0], src[..., 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    flat = images.reshape(B, H * W, C)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).to(torch.int64)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        return vals * valid[..., None]

    out = (gather(y0, x0) * (1 - wx) * (1 - wy)
           + gather(y0, x0 + 1) * wx * (1 - wy)
           + gather(y0 + 1, x0) * (1 - wx) * wy
           + gather(y0 + 1, x0 + 1) * wx * wy)
    return out.reshape(B, out_size, out_size, C)
