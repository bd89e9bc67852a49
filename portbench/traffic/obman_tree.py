"""An ObMan-layout tree on disk, made from a seed: per-sample meta pickles,
JPEG frames of photographic-like content (a smooth low-frequency field
plus fine noise, so decoding costs what a photograph costs), and one
ShapeNet-style object with its surface points. A frozen copy of the
port's ``data/fabricate.py`` ``fabricate_obman`` (segmentation maps left
out: no cell reads them), so the traffic does not move when the port's
copy does.
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np

CLASS_ID, SAMPLE_ID = "02880940", "fab0001"


def smooth_image(rng: np.random.Generator, height: int, width: int) -> np.ndarray:
    """uint8 RGB: 16-cell low-resolution noise upsampled, plus fine noise."""
    import cv2

    low = rng.integers(0, 255, (max(2, height * 16 // max(height, width)),
                                max(2, width * 16 // max(height, width)), 3), np.uint8)
    img = cv2.resize(low, (width, height), interpolation=cv2.INTER_CUBIC)
    return cv2.add(img, rng.integers(0, 24, (height, width, 3), np.uint8))


def write_tree(root_dir: str, n_samples: int, seed: int, split: str = "train",
               img_size: int = 256) -> Tuple[str, str]:
    """Write ``n_samples`` samples under ``root_dir``; returns
    ``(obman_root, shapenet_root)`` as the port's ObMan adapter takes them."""
    import cv2

    rng = np.random.default_rng(seed)
    obman_root = os.path.join(root_dir, "obman")
    shapenet_root = os.path.join(root_dir, "shapenet")
    split_dir = os.path.join(obman_root, split)
    meta_dir, rgb_dir = os.path.join(split_dir, "meta"), os.path.join(split_dir, "rgb")
    for d in (meta_dir, rgb_dir):
        os.makedirs(d, exist_ok=True)
    model_dir = os.path.join(shapenet_root, CLASS_ID, SAMPLE_ID, "models")
    os.makedirs(model_dir, exist_ok=True)
    verts = rng.random((60, 3)) - 0.5
    faces = rng.integers(0, 60, (96, 3))
    with open(os.path.join(model_dir, "model_normalized.pkl"), "wb") as f:
        pickle.dump({"vertices": verts, "faces": faces}, f)
    with open(os.path.join(model_dir, "surface_points.pkl"), "wb") as f:
        pickle.dump(rng.random((800, 3)) - 0.5, f)
    for i in range(n_samples):
        prefix = f"{i:08d}"
        meta = {
            "coords_2d": rng.uniform(40, img_size - 56, (21, 2)),
            "coords_3d": rng.normal(0, 0.1, (21, 3)) + [0, 0, 0.5],
            "verts_3d": rng.normal(0, 0.1, (778, 3)) + [0, 0, 0.5],
            "side": "left" if i % 2 else "right",
            "hand_pose": rng.normal(0, 1, 45),
            "pca_pose": rng.normal(0, 1, 30),
            "depth_min": 0.3, "depth_max": 0.9,
            "hand_depth_min": 0.3, "hand_depth_max": 0.8,
            "obj_depth_min": 0.4, "obj_depth_max": 0.9,
            "class_id": CLASS_ID, "sample_id": SAMPLE_ID,
            "affine_transform": np.eye(4),
            "obj_scale": 0.2,
        }
        with open(os.path.join(meta_dir, f"{prefix}.pkl"), "wb") as f:
            pickle.dump(meta, f)
        img = smooth_image(rng, img_size, img_size)
        cv2.imwrite(os.path.join(rgb_dir, f"{prefix}.jpg"), img[:, :, ::-1],
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
    return obman_root, shapenet_root
