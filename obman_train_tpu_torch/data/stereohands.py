"""StereoHands (STB) adapter: the JAX package's ``data/stereohands.py``
(reference: handobjectdatasets/stereohands.py).

12 sequences x 1500 frames; 3D labels from per-sequence .mat files reordered
from tip-first to base-first (:148-172); fixed intrinsics (:43-45); always
left hands (:234-235); palm-root convention via manoidxs (:40); GT or
detector-provided crop center/scale (:240-250).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from obman_train_tpu_torch.data import transforms as T
from obman_train_tpu_torch.data.cacheutil import root_cache_tag
from obman_train_tpu_torch.data.queries import BaseQueries, get_trans_queries

CAM_INTR = np.array(
    [[822.79041, 0, 318.47345], [0, 822.79041, 250.31296], [0, 0, 1]]
)
REORDER_IDX = np.array(
    [0, 17, 18, 19, 20, 13, 14, 15, 16, 9, 10, 11, 12, 5, 6, 7, 8, 1, 2, 3, 4]
)
SPLIT_SEQUENCES = {
    "train": ["B2Counting", "B2Random", "B3Counting", "B3Random",
              "B4Counting", "B4Random", "B5Counting", "B5Random",
              "B6Counting", "B6Random"],
    "test": ["B1Counting", "B1Random"],
    "val": ["B2Counting", "B2Random"],
    "train_val": ["B3Counting", "B3Random", "B4Counting", "B4Random",
                  "B5Counting", "B5Random", "B6Counting", "B6Random"],
    "all": ["B1Counting", "B1Random", "B2Counting", "B2Random",
            "B3Counting", "B3Random", "B4Counting", "B4Random",
            "B5Counting", "B5Random", "B6Counting", "B6Random"],
}


class StereoHands:
    name = "stereohands"

    def __init__(
        self,
        split: str = "train",
        root: str = "datasymlinks/stereohands",
        use_cache: bool = True,
        gt_detections: bool = False,
        cache_folder: str = "data/cache/stereohands",
    ):
        if split not in SPLIT_SEQUENCES:
            raise ValueError(
                f"split {split} not in {sorted(SPLIT_SEQUENCES)}"
            )
        self.split = split
        self.root = root
        self.use_cache = use_cache
        self.cache_folder = cache_folder
        self.gt_detections = gt_detections
        self.sequences = SPLIT_SEQUENCES[split]
        self.cam_intr = CAM_INTR
        self.manoidxs = list(range(1, 21))
        self.all_queries = [
            BaseQueries.manoidxs, BaseQueries.images, BaseQueries.joints2d,
            BaseQueries.joints3d, BaseQueries.sides,
        ]
        self.all_queries += get_trans_queries(self.all_queries)
        self.rgb_folder = os.path.join(root, "images")
        self.label_folder = os.path.join(root, "labels")
        self.left_template = "BB_left_{}.png"
        self._load_dataset()

    def _load_dataset(self):
        os.makedirs(self.cache_folder, exist_ok=True)
        cache_path = os.path.join(
            self.cache_folder,
            f"{self.split}_{root_cache_tag(self.root)}.pkl",
        )
        if self.use_cache and os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                ann = pickle.load(f)
        else:
            from scipy.io import loadmat

            image_names, joints3d, joints2d = [], [], []
            for sequence in sorted(self.sequences):
                mat = loadmat(
                    os.path.join(self.label_folder, f"{sequence}_BB.mat")
                )
                annots = mat["handPara"].transpose(2, 1, 0)
                for i in range(1500):
                    image_names.append(
                        os.path.join(
                            self.rgb_folder, sequence,
                            self.left_template.format(i),
                        )
                    )
                    j3d = annots[i][REORDER_IDX]
                    joints3d.append(j3d)
                    hom = CAM_INTR.dot(j3d.T).T
                    joints2d.append((hom / hom[:, 2:3])[:, :2])
            ann = {
                "image_names": image_names,
                "joints_3d": joints3d,
                "joints_2d": joints2d,
            }
            if not self.gt_detections:
                ann["detected_centers"] = np.loadtxt(
                    os.path.join(
                        self.root, "detections", f"centers_{self.split}.txt"
                    )
                )
                ann["detected_scales"] = np.loadtxt(
                    os.path.join(
                        self.root, "detections", f"scales_{self.split}.txt"
                    )
                )
            if self.use_cache:
                with open(cache_path, "wb") as f:
                    pickle.dump(ann, f)
        self.image_names = ann["image_names"]
        self.joints_3d = ann["joints_3d"]
        self.joints_2d = ann["joints_2d"]
        if not self.gt_detections:
            self.detected_centers = ann["detected_centers"]
            self.detected_scales = ann["detected_scales"]

    def get_image(self, idx):
        from obman_train_tpu_torch.data.obman import _read_rgb

        return _read_rgb(self.image_names[idx])

    def get_joints3d(self, idx):
        return np.asarray(self.joints_3d[idx], np.float32)

    def get_joints2d(self, idx):
        return np.asarray(self.joints_2d[idx], np.float32)

    def get_sides(self, idx):
        return "left"

    def get_manoidxs(self, idx):
        return self.manoidxs

    def get_camintr(self, idx):
        return CAM_INTR.astype(np.float32)

    def get_center_scale(self, idx, scale_factor: float = 2.2):
        if self.gt_detections:
            joints2d = self.get_joints2d(idx)
            return (
                T.get_annot_center(joints2d),
                T.get_annot_scale(joints2d, scale_factor=scale_factor),
            )
        return (
            self.detected_centers[idx],
            self.detected_scales[idx] * scale_factor / 2.2,
        )

    def __len__(self):
        return len(self.image_names)
