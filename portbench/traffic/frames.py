"""Camera frames for the serving cells, from the run's seed: photographic-
like uint8 RGB (a smooth low-frequency field plus fine noise), held in
host memory as a demo's capture buffer would hold them."""

from __future__ import annotations

import numpy as np

from portbench.core import sub_seed
from portbench.traffic.obman_tree import smooth_image

FRAME_STREAM = 21


def pool(seed: int, count: int, height: int, width: int) -> np.ndarray:
    """(count, height, width, 3) uint8 frames."""
    rng = np.random.default_rng(sub_seed(seed, FRAME_STREAM))
    return np.stack([smooth_image(rng, height, width) for _ in range(count)])


def sides(count: int) -> np.ndarray:
    """Alternating sides, right (0) then left (1)."""
    return (np.arange(count) % 2).astype(np.int32)
