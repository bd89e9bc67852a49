"""The ObMan training sample, derived from the tree's files and a seed: a
frozen plain copy of the reference recipe's host chain as the port runs it
(reference handataset.py:104-423 and obman.py:324-566; the port's
``data/obman.py`` and ``data/dataset.py`` with the uint8 cv2 chain).

For sample ``idx`` of epoch ``epoch`` every draw comes from
``default_rng((seed, epoch, idx))`` in the recipe's order: the centre
offset, the scale jitter, the rotation, the blur radius, then the colour
jitter's four factors and its order. Right hands are mirrored to left
(``sides="left"``). The 600 object points are a subsample of the
object's surface points, drawn from a generator of the sample's own.

It makes the train-step cell's batches.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

CAM_INTR = np.array([[480.0, 0.0, 128.0], [0.0, 480.0, 128.0], [0.0, 0.0, 1.0]], np.float32)
CAM_EXTR_ROT = np.array([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]], np.float32)
CENTER_IDX = 9


class Tree:
    """The tree's annotations, read once."""

    def __init__(self, obman_root: str, shapenet_root: str, split: str = "train"):
        base = os.path.join(obman_root, split)
        names = sorted(os.listdir(os.path.join(base, "meta")))
        self.metas, self.images = [], []
        for name in names:
            with open(os.path.join(base, "meta", name), "rb") as f:
                self.metas.append(pickle.load(f))
            self.images.append(os.path.join(base, "rgb", name.replace(".pkl", ".jpg")))
        self.shapenet_root = shapenet_root
        self._points: Dict[str, np.ndarray] = {}

    def __len__(self):
        return len(self.metas)

    def surface_points(self, idx: int) -> np.ndarray:
        meta = self.metas[idx]
        path = os.path.join(self.shapenet_root, meta["class_id"], meta["sample_id"],
                            "models", "surface_points.pkl")
        if path not in self._points:
            with open(path, "rb") as f:
                pts = np.asarray(pickle.load(f))
            norms = np.linalg.norm(pts, axis=1)
            self._points[path] = pts[norms < 20 * np.median(norms)]  # outlier filter
        return self._points[path]


def _affine_no_rot(center, scale, res):
    a = np.zeros((3, 3))
    a[0, 0] = float(res[1]) / scale
    a[1, 1] = float(res[0]) / scale
    a[0, 2] = res[1] * (-float(center[0]) / scale + 0.5)
    a[1, 2] = res[0] * (-float(center[1]) / scale + 0.5)
    a[2, 2] = 1
    return a


def affine_transform(center, scale, res, rot):
    """``(crop transform, no-rotation crop about the rotated centre)``
    (handutils.py:63-101)."""
    rot_mat = np.zeros((3, 3))
    sn, cs = np.sin(rot), np.cos(rot)
    rot_mat[0, :2] = [cs, -sn]
    rot_mat[1, :2] = [sn, cs]
    rot_mat[2, 2] = 1
    center_h = np.array([center[0], center[1], 1.0])
    origin_rot_center = rot_mat.dot(center_h)[:2]
    t_mat = np.eye(3)
    t_mat[0, 2] = -res[1] / 2
    t_mat[1, 2] = -res[0] / 2
    t_inv = t_mat.copy()
    t_inv[:2, 2] *= -1
    transformed_center = t_inv.dot(rot_mat).dot(t_mat).dot(center_h)
    post = _affine_no_rot(origin_rot_center, scale, res)
    total = post.dot(rot_mat)
    return total.astype(np.float32), _affine_no_rot(transformed_center[:2], scale, res).astype(np.float32)


def _jitter(img, rng, brightness=0.5, contrast=0.5, saturation=0.5, hue=0.15):
    """uint8 colour jitter: four factors drawn in order, applied in a
    drawn order, each quantized to uint8 (torchvision semantics)."""
    import cv2

    def bright(im, f):
        return cv2.LUT(im, np.clip(np.round(np.arange(256) * f), 0, 255).astype(np.uint8))

    def sat(im, f):
        gray = cv2.cvtColor(cv2.cvtColor(im, cv2.COLOR_RGB2GRAY), cv2.COLOR_GRAY2RGB)
        return cv2.addWeighted(im, f, gray, 1.0 - f, 0.0)

    def hue_shift(im, f):
        hsv = cv2.cvtColor(im, cv2.COLOR_RGB2HSV_FULL)
        hsv[..., 0] = hsv[..., 0] + np.uint8(int(round(f * 255.0)) % 256)
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB_FULL)

    def contr(im, f):
        mean = float(cv2.mean(cv2.cvtColor(im, cv2.COLOR_RGB2GRAY))[0])
        lut = np.clip(np.round(np.arange(256) * f + (1 - f) * mean), 0, 255).astype(np.uint8)
        return cv2.LUT(im, lut)

    ops = [(bright, rng.uniform(max(0, 1 - brightness), 1 + brightness)),
           (sat, rng.uniform(max(0, 1 - saturation), 1 + saturation)),
           (hue_shift, rng.uniform(-hue, hue)),
           (contr, rng.uniform(max(0, 1 - contrast), 1 + contrast))]
    for k in rng.permutation(len(ops)):
        fn, f = ops[k]
        img = fn(img, f)
    return img


def sample(tree: Tree, idx: int, epoch: int, seed: int = 0, res: int = 256,
           max_rot: float = np.pi, scale_jittering: float = 0.3,
           center_jittering: float = 0.2, point_nb: int = 600) -> Dict[str, np.ndarray]:
    """The model batch row of sample ``idx``: ``images`` (res, res, 3)
    uint8, ``joints3d``, ``verts3d``, ``camintrs``, ``center3d``,
    ``sides``, and ``objpoints3d``: ``point_nb`` surface points drawn from
    ``default_rng((seed, epoch, idx, 1))``."""
    import cv2

    rng = np.random.default_rng((seed, epoch, int(idx)))
    meta = tree.metas[idx]
    joints2d = np.asarray(meta["coords_2d"], np.float32)
    lo, hi = joints2d.min(0), joints2d.max(0)
    center = ((hi + lo) / 2).astype(int).astype(np.float64)
    scale = float(max(hi[0] - lo[0], hi[1] - lo[1]) * 2.2)
    flip = meta["side"] == "right"
    img = cv2.imread(tree.images[idx], cv2.IMREAD_COLOR)[:, :, ::-1]
    if flip:
        img = img[:, ::-1]
        center[0] = img.shape[1] - center[0]
    center = center + (center_jittering * scale * rng.uniform(low=-1, high=1, size=2)).astype(int)
    scale = scale * np.clip(scale_jittering * rng.standard_normal() + 1,
                            1 - scale_jittering, 1 + scale_jittering)
    rot = rng.uniform(-max_rot, max_rot)
    rot_mat = np.array([[np.cos(rot), -np.sin(rot), 0], [np.sin(rot), np.cos(rot), 0], [0, 0, 1]],
                       dtype=np.float32)
    affinetrans, post_rot = affine_transform(center, scale, (res, res), rot)
    out = {"camintrs": post_rot.dot(CAM_INTR).astype(np.float32)}

    joints3d = (1000 * CAM_EXTR_ROT.dot(np.asarray(meta["coords_3d"], np.float64).T).T).astype(np.float32)
    if flip:
        joints3d[:, 0] = -joints3d[:, 0]
    joints3d = rot_mat.dot(joints3d.T).T
    center3d = joints3d[CENTER_IDX].copy()
    out["joints3d"] = (joints3d - center3d).astype(np.float32)
    verts3d = (1000 * CAM_EXTR_ROT.dot(np.asarray(meta["verts_3d"]).T).T).astype(np.float32)
    if flip:
        verts3d[:, 0] = -verts3d[:, 0]
    out["verts3d"] = (rot_mat.dot(verts3d.T).T - center3d).astype(np.float32)
    out["center3d"] = np.asarray(center3d, np.float32)
    out["sides"] = np.int32(1)  # every hand is a left hand after the mirror

    pts = tree.surface_points(idx)
    pts = pts[np.random.default_rng((seed, epoch, int(idx), 1)).choice(pts.shape[0], point_nb)]
    out["objpoints3d"] = (_object_points(pts, meta, flip, rot_mat) - center3d).astype(np.float32)

    img_u8 = np.ascontiguousarray(img, np.uint8)
    radius = rng.random() * 0.5
    if radius > 0:
        img_u8 = cv2.GaussianBlur(img_u8, (0, 0), sigmaX=radius, sigmaY=radius)
    img_u8 = _jitter(img_u8, rng)
    inv = np.linalg.inv(np.asarray(affinetrans, np.float64))
    out["images"] = cv2.warpAffine(img_u8, inv[:2], (res, res),
                                   flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
                                   borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    return out


def _object_points(pts: np.ndarray, meta: Dict, flip: bool, rot_mat: np.ndarray) -> np.ndarray:
    hom = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    pts = np.asarray(meta["affine_transform"]).dot(hom.T).T[:, :3]
    pts = (CAM_EXTR_ROT.dot(pts.T).T * 1000).astype(np.float32)
    if flip:
        pts[:, 0] = -pts[:, 0]
    return rot_mat.dot(pts.T).T


def batch(tree: Tree, idxs, epoch: int, seed: int, threads: int = 8, **kw) -> Dict[str, np.ndarray]:
    """Rows ``idxs`` stacked, on ``threads`` threads (cv2 releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(threads) as pool:
        rows = list(pool.map(lambda i: sample(tree, int(i), epoch, seed, **kw), idxs))
    return {k: np.ascontiguousarray(np.stack([r[k] for r in rows])) for k in rows[0]}
