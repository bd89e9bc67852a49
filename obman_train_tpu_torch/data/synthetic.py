"""Procedural synthetic dataset for hermetic runs (the JAX package's
``data/synthetic.py``, on the port's own synthetic MANO assets).

Per-index deterministic RNG generates a camera-space hand whose 2D joints
are the exact pinhole projection. The hand is kinematically consistent:
verts/joints are a rigid transform (+ shape blendshapes) of the synthetic
MANO template, so the model's own MANO layer can reach the GT. Non-train
splits draw from a disjoint per-split scene stream, so val curves measure
generalization. The same seed, split and index give the same arrays as the
JAX package.
"""

from __future__ import annotations

import zlib

import numpy as np

from obman_train_tpu_torch.data.queries import BaseQueries, get_trans_queries


class SyntheticDataset:
    name = "synthetic"

    def __init__(
        self,
        size: int = 64,
        img_res: int = 256,
        split: str = "train",
        seed: int = 17,
        side: str = "left",
    ):
        self._size = size
        self.img_res = img_res
        self.split = split
        if split != "train":
            seed = seed + 1_000_003 * (zlib.crc32(split.encode()) & 0xFFFF)
        self._seed = seed
        self._side = side
        # ObMan-like fixed intrinsics (obman.py:104-106)
        f = 480.0 * img_res / 256.0
        c = img_res / 2.0
        self.cam_intr = np.array([[f, 0, c], [0, f, c], [0, 0, 1]], dtype=np.float32)
        self.all_queries = [
            BaseQueries.images,
            BaseQueries.joints2d,
            BaseQueries.joints3d,
            BaseQueries.verts3d,
            BaseQueries.objpoints3d,
            BaseQueries.sides,
            BaseQueries.camintrs,
            BaseQueries.meta,
        ]
        self.all_queries += get_trans_queries(self.all_queries)
        self._template_memo = None
        self._scene_memo = {}

    def __len__(self):
        return self._size

    def _rng(self, idx):
        return np.random.default_rng(self._seed * 100003 + idx)

    def _template(self):
        """Synthetic-MANO template tables for this side (mm), built once."""
        if self._template_memo is None:
            from obman_train_tpu_torch.assets.mano_assets import (
                JOINT_REORDER,
                TIPS,
                synthetic_mano_assets,
            )

            a = synthetic_mano_assets(self._side)
            self._template_memo = {
                "v_template_mm": a.v_template * 1000.0,   # metres -> mm
                "shapedirs_mm": a.shapedirs * 1000.0,     # (778, 3, 10)
                "J_regressor": a.J_regressor,             # (16, 778)
                "tips": TIPS,
                "reorder": JOINT_REORDER,
            }
        return self._template_memo

    def _scene(self, idx):
        # memoized: each sample calls several accessors; scenes are
        # deterministic per (seed, idx), and a dict get/set is atomic under
        # the GIL, so loader threads may share the memo
        hit = self._scene_memo.get(idx)
        if hit is not None:
            return hit
        rng = self._rng(idx)
        t = self._template()
        betas = rng.normal(0, 1.5, 10)
        verts3d = t["v_template_mm"] + t["shapedirs_mm"] @ betas  # (778, 3)
        axis = rng.normal(0, 1, 3)
        axis /= np.linalg.norm(axis) + 1e-12
        angle = rng.uniform(0.0, np.pi)
        K = np.array(
            [[0, -axis[2], axis[1]],
             [axis[2], 0, -axis[0]],
             [-axis[1], axis[0], 0]]
        )
        R = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)
        root = np.array([0.0, 0.0, 500.0]) + rng.normal(0, 40, 3)
        verts3d = verts3d @ R.T + root
        # kinematic-chain joints from the regressor + fingertip verts,
        # reordered into the 21-joint output convention (models/mano.py)
        joints16 = t["J_regressor"] @ verts3d                     # (16, 3)
        joints21 = np.concatenate([joints16, verts3d[t["tips"]]])
        joints3d = joints21[t["reorder"]]
        obj_center = root + R @ np.array([30.0, 0.0, 20.0])
        objpoints3d = obj_center + rng.normal(0, 25, (2048, 3))
        out = (
            joints3d.astype(np.float32),
            verts3d.astype(np.float32),
            objpoints3d.astype(np.float32),
        )
        self._scene_memo[idx] = out
        return out

    def _project(self, pts3d):
        p = pts3d @ self.cam_intr.T
        return (p[:, :2] / p[:, 2:3]).astype(np.float32)

    # -- adapter contract ----------------------------------------------------

    def get_image(self, idx):
        rng = self._rng(idx)
        # raw bytes shifted to dark noise in 0..63, with the joints as dots
        img = (
            np.frombuffer(rng.bytes(self.img_res * self.img_res * 3), np.uint8)
            .reshape(self.img_res, self.img_res, 3)
            >> 2
        )
        joints2d = self.get_joints2d(idx)
        for x, y in joints2d.astype(int):
            if 1 <= x < self.img_res - 1 and 1 <= y < self.img_res - 1:
                img[y - 1: y + 2, x - 1: x + 2] = 255
        return img

    def get_joints3d(self, idx):
        return self._scene(idx)[0]

    def get_verts3d(self, idx):
        return self._scene(idx)[1]

    def get_objpoints3d(self, idx, point_nb=600):
        pts = self._scene(idx)[2]
        ids = self._rng(idx ^ 0x5EED).choice(len(pts), point_nb, replace=False)
        return pts[ids]

    def get_joints2d(self, idx):
        return self._project(self.get_joints3d(idx))

    def get_camintr(self, idx):
        return self.cam_intr

    def get_sides(self, idx):
        return self._side

    def get_center_scale(self, idx):
        j2d = self.get_joints2d(idx)
        mins, maxs = j2d.min(0), j2d.max(0)
        center = ((mins + maxs) / 2).astype(int).astype(np.float64)
        scale = float(max(maxs - mins) * 2.2)
        return center, scale

    def get_meta(self, idx):
        return {"objname": f"synth_{idx}"}
