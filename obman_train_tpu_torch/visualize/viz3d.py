"""3D skeleton and point-cloud plotting (the JAX package's
``visualize/viz3d.py``; reference mano_train/visualize/viz3d.py)."""

from __future__ import annotations

import numpy as np

from obman_train_tpu_torch.visualize.viz2d import LINK_COLORS, LINKS


def visualize_joints_3d(ax, joints: np.ndarray, joint_idxs: bool = False,
                        links=None, alpha: float = 1.0):
    """Draw a 21-joint skeleton on a 3D matplotlib axis."""
    links = links or LINKS
    ax.scatter(joints[:, 0], joints[:, 1], joints[:, 2], s=4, c="r")
    if joint_idxs:
        for i, (x, y, z) in enumerate(joints):
            ax.text(x, y, z, str(i))
    for color, link in zip(LINK_COLORS, links):
        for a, b in zip(link[:-1], link[1:]):
            ax.plot(
                [joints[a, 0], joints[b, 0]],
                [joints[a, 1], joints[b, 1]],
                [joints[a, 2], joints[b, 2]],
                color, alpha=alpha,
            )


def equal_aspect_3d(ax, pts: np.ndarray):
    """Cube the axis limits around the points (mpl 3D has no equal aspect)."""
    c = (pts.max(0) + pts.min(0)) / 2
    r = (pts.max(0) - pts.min(0)).max() / 2
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)
