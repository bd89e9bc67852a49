"""Host-side frame preprocessing (the JAX package's ``demo/preprocess.py``;
reference mano_train/demo/preprocess.py).

The demos preprocess on the device (``ops/image.preprocess_frames``); these
numpy versions serve host-side tools and tests. ``preprocess_frame``
centre-crops to a square and resizes (preprocess.py:8-17);
``prepare_input`` converts BGR to RGB, optionally flips, and normalises
x/255 - 0.5 (preprocess.py:20-39), returned NHWC float32 with a batch axis.
"""

from __future__ import annotations

import numpy as np


def squarify(frame: np.ndarray) -> np.ndarray:
    h, w = frame.shape[:2]
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    return frame[top:top + s, left:left + s]


def resize(frame: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize through the host warp of ``data/transforms``."""
    from obman_train_tpu_torch.data.transforms import transform_img

    h, w = frame.shape[:2]
    aff = np.array([[size / w, 0, 0], [0, size / h, 0], [0, 0, 1]], dtype=np.float64)
    out = transform_img(frame, aff, (size, size))
    if np.issubdtype(frame.dtype, np.integer):
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out


def preprocess_frame(frame: np.ndarray, size: int = 256) -> np.ndarray:
    return resize(squarify(frame), size)


def prepare_input(frame: np.ndarray, flip_left_right: bool = False,
                  bgr: bool = True) -> np.ndarray:
    if bgr:
        frame = frame[:, :, ::-1]
    if flip_left_right:
        frame = frame[:, ::-1]
    return (frame.astype(np.float32) / 255.0 - 0.5)[None]
