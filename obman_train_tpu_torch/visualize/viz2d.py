"""2D joint-skeleton drawing (the JAX package's ``visualize/viz2d.py``;
reference mano_train/visualize/viz2d.py). numpy and matplotlib only."""

from __future__ import annotations

import numpy as np

# Five finger chains from the wrist (shared across the reference datasets).
LINKS = [
    (0, 1, 2, 3, 4),
    (0, 5, 6, 7, 8),
    (0, 9, 10, 11, 12),
    (0, 13, 14, 15, 16),
    (0, 17, 18, 19, 20),
]
LINK_COLORS = ["r", "m", "b", "c", "g"]


def visualize_joints_2d(
    ax, joints, joint_idxs: bool = False, links=None, alpha: float = 1.0
):
    """Draw a 21-joint hand skeleton on a matplotlib axis."""
    links = links or LINKS
    x, y = joints[:, 0], joints[:, 1]
    ax.scatter(x, y, 3, "r")
    if joint_idxs:
        for i, (xx, yy) in enumerate(zip(x, y)):
            ax.annotate(str(i), (xx, yy))
    for color, link in zip(LINK_COLORS, links):
        for a, b in zip(link[:-1], link[1:]):
            ax.plot(
                [joints[a, 0], joints[b, 0]],
                [joints[a, 1], joints[b, 1]],
                color, alpha=alpha, linewidth=1.5,
            )


def draw_joints_on_image(
    img: np.ndarray, joints: np.ndarray, color=(0, 255, 0)
) -> np.ndarray:
    """cv2-free raster skeleton drawing onto a uint8 HWC image copy."""
    out = np.ascontiguousarray(img).copy()
    H, W = out.shape[:2]

    def dot(x, y):
        xi, yi = int(round(x)), int(round(y))
        if 1 <= xi < W - 1 and 1 <= yi < H - 1:
            out[yi - 1 : yi + 2, xi - 1 : xi + 2] = color

    def line(p, q):
        n = int(max(abs(q[0] - p[0]), abs(q[1] - p[1]))) + 1
        for t in np.linspace(0, 1, n):
            dot(p[0] + t * (q[0] - p[0]), p[1] + t * (q[1] - p[1]))

    for link in LINKS:
        for a, b in zip(link[:-1], link[1:]):
            line(joints[a], joints[b])
    for j in joints:
        dot(j[0], j[1])
    return out
