"""ObMan synthetic dataset adapter: the JAX package's ``data/obman.py``,
the reference adapter (handobjectdatasets/obman.py) without tqdm.

Annotation lists are built from the per-sample meta pickles and cached as
one pickle keyed by the split, mode and ``root_cache_tag`` of the root;
fixed intrinsics f=480, c=128 (obman.py:104-106); the extrinsic y/z flip is
applied to all 3D annotations, which are scaled to millimetres
(obman.py:395-413); object points come from ShapeNet
``surface_points.pkl`` with the reference's >20x-median-norm outlier
filter and a random subsample drawn from the adapter's one generator
(obman.py:454-498); crop center/scale from the hand joints2d or (obj mode)
from the segmentation bbox (obman.py:545-566). Images decode through cv2
where it imports, else PIL (the two decoders' pixels differ).

The adapter's generator is shared by every caller: loader threads that
fetch samples concurrently draw from it in the order they reach it, so
only sequential access (or one worker) gives a reproducible subsample —
the JAX package's behaviour, kept so that the two agree draw for draw.

Requires the ObMan + ShapeNet data on disk (not shipped); all file-format
logic is kept faithful so a user can point ``obman_root``/``shapenet_root``
at the official release, or at a tree written by ``data/fabricate.py``.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from obman_train_tpu_torch.data import transforms as T
from obman_train_tpu_torch.data.cacheutil import root_cache_tag
from obman_train_tpu_torch.data.queries import BaseQueries, get_trans_queries

CAM_INTR = np.array(
    [[480.0, 0.0, 128.0], [0.0, 480.0, 128.0], [0.0, 0.0, 1.0]], np.float32
)
CAM_EXTR_ROT = np.array(
    [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]], np.float32
)
SEGM_HAND_LABELS = {"right": (22, 24), "left": (21, 23)}
SEGM_OBJ_LABEL = 100


def _read_rgb(path: str) -> np.ndarray:
    """cv2 (libjpeg-turbo, GIL-releasing) with PIL fallback."""
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is not None:
            return img[:, :, ::-1]
    except ImportError:
        pass
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


class ObMan:
    name = "obman"

    def __init__(
        self,
        split: str = "train",
        mode: str = "all",
        mini_factor: Optional[float] = None,
        use_cache: bool = True,
        root_palm: bool = False,
        segment: bool = False,
        override_scale: bool = False,
        use_external_points: bool = True,
        apply_obj_transform: bool = True,
        obman_root: str = "datasymlinks/obman",
        shapenet_root: str = "datasymlinks/ShapeNetCore.v2",
        cache_folder: str = "data/cache/obman",
        seed: int = 0,
    ):
        self.split = split
        self.mode = mode
        self.mini_factor = mini_factor
        self.root_palm = root_palm
        self.segment = segment
        self.override_scale = override_scale
        self.use_external_points = use_external_points
        self.apply_obj_transform = apply_obj_transform
        self.obman_root = os.path.join(obman_root, split)
        self.shapenet_template = os.path.join(
            shapenet_root, "{}/{}/models/model_normalized.pkl"
        )
        self.cache_folder = cache_folder
        self.use_cache = use_cache
        self._rng = np.random.default_rng(seed)
        self.cam_intr = CAM_INTR

        if mode == "all" and not override_scale:
            self.all_queries = [
                BaseQueries.images, BaseQueries.joints2d, BaseQueries.joints3d,
                BaseQueries.sides, BaseQueries.segms, BaseQueries.verts3d,
                BaseQueries.hand_pcas, BaseQueries.hand_poses,
                BaseQueries.camintrs, BaseQueries.depth,
            ]
            self.all_queries.append(
                BaseQueries.objpoints3d if use_external_points
                else BaseQueries.objverts3d
            )
            if not use_external_points:
                self.all_queries.append(BaseQueries.objfaces)
            self.rgb_folder = os.path.join(self.obman_root, "rgb")
        elif mode == "obj" or (mode == "all" and override_scale):
            self.all_queries = [BaseQueries.images, BaseQueries.camintrs,
                                BaseQueries.objpoints3d]
            if not use_external_points:
                self.all_queries += [BaseQueries.objverts3d, BaseQueries.objfaces]
            self.rgb_folder = os.path.join(
                self.obman_root, "rgb_obj" if mode == "obj" else "rgb"
            )
        elif mode == "hand":
            self.all_queries = [
                BaseQueries.images, BaseQueries.joints2d, BaseQueries.joints3d,
                BaseQueries.sides, BaseQueries.segms, BaseQueries.verts3d,
                BaseQueries.hand_pcas, BaseQueries.hand_poses,
                BaseQueries.camintrs, BaseQueries.depth,
            ]
            self.rgb_folder = os.path.join(self.obman_root, "rgb_hand")
        else:
            raise ValueError(f"Mode should be in [all|obj|hand], got {mode}")
        self.all_queries += get_trans_queries(self.all_queries)

        self.segm_folder = os.path.join(self.obman_root, "segm")
        self.meta_folder = os.path.join(self.obman_root, "meta")
        self.center_scale_cache: dict = {}
        self._load_dataset()

    # -- annotation cache (obman.py:143-322) --------------------------------

    def _load_dataset(self):
        os.makedirs(self.cache_folder, exist_ok=True)
        root_tag = root_cache_tag(self.obman_root)
        cache_path = os.path.join(
            self.cache_folder,
            f"{self.split}_{self.mini_factor}_mode_{self.mode}_{root_tag}.pkl",
        )
        if self.use_cache and os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                ann = pickle.load(f)
        else:
            idxs = [
                int(name.split(".")[0])
                for name in sorted(os.listdir(self.meta_folder))
            ]
            if self.mini_factor:
                idxs = idxs[: int(len(idxs) * self.mini_factor)]
            ann = {
                k: []
                for k in (
                    "image_names", "joints2d", "joints3d", "hand_sides",
                    "hand_poses", "hand_pcas", "hand_verts3d", "obj_paths",
                    "obj_transforms", "meta_infos", "depth_infos",
                )
            }
            for idx in idxs:
                prefix = f"{idx:08d}"
                with open(
                    os.path.join(self.meta_folder, f"{prefix}.pkl"), "rb"
                ) as f:
                    meta = pickle.load(f)
                ann["image_names"].append(
                    os.path.join(self.rgb_folder, f"{prefix}.jpg")
                )
                ann["joints2d"].append(meta["coords_2d"])
                ann["joints3d"].append(meta["coords_3d"])
                ann["hand_verts3d"].append(meta["verts_3d"])
                ann["hand_sides"].append(meta["side"])
                ann["hand_poses"].append(meta["hand_pose"])
                ann["hand_pcas"].append(meta["pca_pose"])
                ann["depth_infos"].append(
                    {
                        k: meta[k]
                        for k in (
                            "depth_min", "depth_max", "hand_depth_min",
                            "hand_depth_max", "obj_depth_min", "obj_depth_max",
                        )
                    }
                )
                ann["obj_paths"].append(
                    self.shapenet_template.format(
                        meta["class_id"], meta["sample_id"]
                    )
                )
                ann["obj_transforms"].append(meta["affine_transform"])
                info = {
                    "obj_scale": meta["obj_scale"],
                    "obj_class_id": meta["class_id"],
                    "obj_sample_id": meta["sample_id"],
                }
                for k in ("grasp_quality", "grasp_epsilon", "grasp_volume"):
                    if k in meta:
                        info[k] = meta[k]
                ann["meta_infos"].append(info)
            if self.use_cache:
                with open(cache_path, "wb") as f:
                    pickle.dump(ann, f)
        for key, val in ann.items():
            setattr(self, key, val)

    def __len__(self):
        return len(self.image_names)

    # -- getters (obman.py:324-566) -----------------------------------------

    def get_image(self, idx) -> np.ndarray:
        img = _read_rgb(self.image_names[idx])
        if self.segment:
            segm = self._segm_channels(idx)
            mask = (segm[:, :, 0] + segm[:, :, 1]) > 0
            img = img * mask[:, :, None].astype(img.dtype)
        return img

    def _segm_path(self, idx):
        path = self.image_names[idx]
        for src in ("rgb_hand", "rgb_obj", "rgb"):
            if f"/{src}/" in path:
                return path.replace(f"/{src}/", "/segm/").replace(
                    "jpg", "png"
                )
        raise ValueError(path)

    def _segm_channels(self, idx) -> np.ndarray:
        """(H, W, 3): [hand mask, obj mask, zeros] (obman.py:585-598)."""
        from PIL import Image

        raw = np.asarray(Image.open(self._segm_path(idx)))
        if raw.ndim == 3:
            chan = {"all": 0, "hand": 1, "obj": 2}[self.mode]
            raw = raw[:, :, chan]
        side = self.get_sides(idx)
        a, b = SEGM_HAND_LABELS[side]
        hand = ((raw == a) | (raw == b)).astype(np.float32)
        obj = (raw == SEGM_OBJ_LABEL).astype(np.float32)
        return np.stack([hand, obj, np.zeros_like(hand)], axis=2)

    def get_segm(self, idx) -> np.ndarray:
        return (255 * self._segm_channels(idx)).astype(np.uint8)

    def get_joints2d(self, idx):
        return np.asarray(self.joints2d[idx], np.float32)

    def get_joints3d(self, idx):
        joints3d = np.asarray(self.joints3d[idx], np.float64)
        if self.root_palm:  # wrist -> palm-center (obman.py:398-401)
            verts3d = np.asarray(self.hand_verts3d[idx])
            palm = (verts3d[95] + verts3d[218]) / 2
            joints3d = np.concatenate([palm[None], joints3d[1:]])
        joints3d = CAM_EXTR_ROT.dot(joints3d.T).T
        return (1000 * joints3d).astype(np.float32)

    def get_verts3d(self, idx):
        verts3d = CAM_EXTR_ROT.dot(np.asarray(self.hand_verts3d[idx]).T).T
        return (1000 * verts3d).astype(np.float32)

    def get_obj_verts_faces(self, idx):
        model_path = self.obj_paths[idx]
        model_path_obj = model_path.replace(".pkl", ".obj")
        if os.path.exists(model_path):
            with open(model_path, "rb") as f:
                mesh = pickle.load(f)
        elif os.path.exists(model_path_obj):
            mesh = T.fast_load_obj(model_path_obj)[0]
        else:
            raise ValueError(f"No model pkl/obj at {model_path}")
        scale = (
            0.18
            if (self.mode == "obj" or self.override_scale)
            else self.meta_infos[idx]["obj_scale"]
        )
        verts = np.asarray(mesh["vertices"]) * scale
        if self.apply_obj_transform:
            hom = np.concatenate([verts, np.ones((len(verts), 1))], axis=1)
            verts = self.obj_transforms[idx].dot(hom.T).T[:, :3]
            verts = CAM_EXTR_ROT.dot(verts.T).T
        return (
            (verts * 1000).astype(np.float32),
            np.asarray(mesh["faces"], np.int32),
        )

    def get_objpoints3d(self, idx, point_nb: int = 600):
        model_path = self.obj_paths[idx].replace(
            "model_normalized.pkl", "surface_points.pkl"
        )
        with open(model_path, "rb") as f:
            points = np.asarray(pickle.load(f))
        if self.mode == "obj" or self.override_scale:
            points = points * 0.18
        # outlier filter: drop points >20x median norm (obman.py:470-483)
        norms = np.linalg.norm(points, axis=1)
        points = points[norms < 20 * np.median(norms)]
        ids = self._rng.choice(points.shape[0], point_nb)
        points = points[ids]
        if self.apply_obj_transform:
            hom = np.concatenate([points, np.ones((len(points), 1))], axis=1)
            points = self.obj_transforms[idx].dot(hom.T).T[:, :3]
            points = CAM_EXTR_ROT.dot(points.T).T
        return (points * 1000).astype(np.float32)

    def get_sides(self, idx):
        return self.hand_sides[idx]

    def get_camintr(self, idx):
        return self.cam_intr

    def get_depth(self, idx):
        from PIL import Image

        path = self.image_names[idx]
        for src in ("rgb_hand", "rgb_obj", "rgb"):
            if f"/{src}/" in path:
                path = path.replace(f"/{src}/", "/depth/")
                break
        path = path.replace("jpg", "png")
        img = np.asarray(Image.open(path))
        if img.ndim == 3:
            chan = {"all": 0, "hand": 1, "obj": 2}[self.mode]
            img = img[:, :, chan]
        info = self.depth_infos[idx]
        dmin, dmax = {
            "all": (info["depth_min"], info["depth_max"]),
            "hand": (info["hand_depth_min"], info["hand_depth_max"]),
            "obj": (info["obj_depth_min"], info["obj_depth_max"]),
        }[self.mode]
        assert img.max() == 255, (
            f"Max value of depth png should be 255, not {img.max()}"
        )
        depth = (img.astype(np.float64) - 1) / 254 * (dmin - dmax) + dmax
        segm = self._segm_channels(idx)
        return depth * ((segm[:, :, 0] + segm[:, :, 1]) > 0)

    def get_center_scale(self, idx, scale_factor: float = 2.2):
        if self.mode == "obj" or self.override_scale:
            if idx not in self.center_scale_cache:
                segm = self._segm_channels(idx)
                ys = np.nonzero(segm[:, :, 1].sum(1))[0]
                xs = np.nonzero(segm[:, :, 1].sum(0))[0]
                center = np.array(
                    [(xs.min() + xs.max()) / 2, (ys.min() + ys.max()) / 2]
                )
                scale = scale_factor * max(
                    ys.max() - ys.min(), xs.max() - xs.min()
                )
                self.center_scale_cache[idx] = (center, scale)
            return self.center_scale_cache[idx]
        joints2d = self.get_joints2d(idx)
        return (
            T.get_annot_center(joints2d),
            T.get_annot_scale(joints2d, scale_factor=scale_factor),
        )

    def get_meta(self, idx):
        return self.meta_infos[idx]

    def get_hand_pcas(self, idx):
        return np.asarray(self.hand_pcas[idx], np.float32)
