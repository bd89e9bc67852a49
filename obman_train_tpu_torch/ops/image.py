"""Device-side colour jitter (the JAX package's ``ops/image.py:80-166``):
the float ``adjust_*`` operations of ``data/transforms.py`` on a batch of
NHWC tensors in [0, 1], per-sample factors drawn on the host, one of the 24
operation orders per batch (the reference shuffles per sample,
imgtrans.py:48; one order per batch keeps the cost at one pass).

Plain PyTorch: the JAX package has no Pallas kernel here. The order index is
read on the host, where it selects the branch as ``lax.switch`` does on the
TPU; the train and eval steps keep ``aug_order`` on the CPU for that.
``preprocess_frames`` and ``affine_warp`` come with the demo slice.
"""

from __future__ import annotations

import itertools

import torch

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
