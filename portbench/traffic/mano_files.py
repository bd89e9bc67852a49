"""MANO hand tables written as raw files that the program and the
reference both read.

The MANO release is not redistributable, so the tables are synthetic but
structurally the model: the 778-vertex, 1538-face template of the
contact-zone file (a real MANO mesh, in metres), a 16-joint regressor and
skinning weights by proximity to 16 anchor vertices, shape and pose
blend shapes, and a 45x45 PCA pose basis. A frozen copy of the port's
``assets.synthetic_mano_assets``, drawn here from the run's seed and
written as ``MANO_RIGHT.npz`` / ``MANO_LEFT.npz`` in the layout of the
port's ``ManoAssets.save_npz``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ZONES = os.path.join(os.path.dirname(HERE), "reference", "contact_zones.npz")
PARENTS = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14], np.int32)


def tables(side: str, seed: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng((seed, 1 if side == "left" else 0))
    zones = np.load(ZONES)
    v_template = zones["verts"].astype(np.float32)
    if side == "left":
        v_template = v_template * np.array([-1.0, 1.0, 1.0], np.float32)
    anchors = v_template[rng.choice(778, size=16, replace=False)]
    d = np.linalg.norm(v_template[None, :, :] - anchors[:, None, :], axis=-1)
    j_reg = np.exp(-d / (d.mean() * 0.05))
    j_reg /= j_reg.sum(axis=1, keepdims=True)
    w = np.exp(-(d.T) / (d.mean() * 0.15))
    q, _ = np.linalg.qr(rng.normal(0, 1, (45, 45)))
    shapedirs = rng.normal(0, 0.002, (778, 3, 10))
    posedirs = rng.normal(0, 0.0005, (778, 3, 135))
    return {
        "v_template": v_template,
        "shapedirs": shapedirs.astype(np.float32),
        "posedirs": posedirs.astype(np.float32),
        "J_regressor": j_reg.astype(np.float32),
        "weights": (w / w.sum(axis=1, keepdims=True)).astype(np.float32),
        "hands_components": (q * rng.uniform(0.5, 2.0, (45, 1))).astype(np.float32),
        "hands_mean": rng.normal(0, 0.1, (45,)).astype(np.float32),
        "faces": zones["faces"].astype(np.int32),
        "parents": PARENTS.copy(),
    }


def write(directory: str, seed: int) -> Dict[str, str]:
    """Both sides' files under ``directory``; returns ``{side: path}``."""
    os.makedirs(directory, exist_ok=True)
    paths = {}
    for side in ("right", "left"):
        path = os.path.join(directory, f"MANO_{side.upper()}.npz")
        np.savez(path, side=np.array(side), **tables(side, seed))
        paths[side] = path
    return paths
