"""Core50 adapter: the JAX package's ``data/core50.py`` (reference:
handobjectdatasets/core50.py) — unannotated hand-object video crops used as
a demo source: zero joints/objpoints (core50.py:183-189), crop center/scale
from the per-frame bbox annotations. ``YanaDemo`` reads a folder of frame
folders with centred crops.

One departure: the annotation cache's name carries ``root_cache_tag`` of
the root, as the other adapters' do (the JAX package keys Core50's by the
class and ``mini_factor`` only, so a second root would read the first
root's cached paths).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from obman_train_tpu_torch.data.cacheutil import root_cache_tag
from obman_train_tpu_torch.data.queries import BaseQueries, get_trans_queries

CLASS_DICT = {
    "mobile_phone": [f"o{i}" for i in range(6, 11)],
    "ball": [f"o{i}" for i in range(31, 36)],
    "light_bulb": [f"o{i}" for i in range(16, 21)],
    "marker": [f"o{i}" for i in range(36, 41)],
    "can": [f"o{i}" for i in range(21, 26)],
    "remote_control": [f"o{i}" for i in range(46, 51)],
    "cups": [f"o{i}" for i in range(41, 46)],
}


class Core50:
    name = "core50"

    def __init__(
        self,
        split: str = "all",
        root: str = "datasymlinks/core50",
        class_name: str = "mobile_phone",
        scale_factor: float = 1.2,
        mini_factor: Optional[float] = None,
        use_cache: bool = True,
        cache_folder: str = "data/cache/core50",
    ):
        if class_name not in CLASS_DICT:
            raise ValueError(f"{class_name} should be in {sorted(CLASS_DICT)}")
        self.split = split
        self.root = root
        self.class_name = class_name
        self.class_keys = CLASS_DICT[class_name]
        self.scale_factor = scale_factor
        self.mini_factor = mini_factor
        self.use_cache = use_cache
        self.cache_folder = cache_folder
        self.sessions = [f"s{i}" for i in range(1, 12)]
        self.annot_root = os.path.join(root, "core50_350x350_Annot")
        self.rgb_root = os.path.join(root, "core50_350x350")
        self.cam_intr = np.array(
            [[1060.707, 0, 956.354], [0, 1058.608, 518.978], [0, 0, 1]],
            np.float32,
        )
        self.all_queries = [
            BaseQueries.images, BaseQueries.joints3d, BaseQueries.sides,
            BaseQueries.objpoints3d,
        ]
        self.all_queries += get_trans_queries(self.all_queries)
        self._load_dataset()

    def _load_dataset(self):
        os.makedirs(self.cache_folder, exist_ok=True)
        cache_path = os.path.join(
            self.cache_folder,
            f"{self.mini_factor}_{self.class_name}_{root_cache_tag(self.root)}.pkl",
        )
        if self.use_cache and os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                ann = pickle.load(f)
        else:
            from scipy.io import loadmat

            img_names, hand_sides, centers, scales = [], [], [], []
            for session in self.sessions:
                sess_path = os.path.join(self.annot_root, session)
                if not os.path.isdir(sess_path):
                    continue
                for obj in sorted(os.listdir(sess_path)):
                    if obj not in self.class_keys:
                        continue
                    obj_path = os.path.join(sess_path, obj)
                    for obj_annot in sorted(
                        a for a in os.listdir(obj_path) if a.endswith(".mat")
                    ):
                        annot = loadmat(os.path.join(obj_path, obj_annot))
                        bbox = annot["annot"]["crop"][0, 0]
                        side_code = annot["annot"]["hand"][0, 0]["side"][0, 0][0]
                        hand_sides.append(
                            "right" if side_code == "R" else "left"
                        )
                        centers.append(
                            np.array(
                                [
                                    (bbox[0, 0] + bbox[0, 2]) / 2,
                                    (bbox[0, 1] + bbox[0, 3]) / 2,
                                ]
                            )
                        )
                        scales.append(
                            self.scale_factor
                            * np.array(
                                [bbox[0, 2] - bbox[0, 0], bbox[0, 3] - bbox[0, 1]]
                            )
                        )
                        prefix = "_".join(
                            obj_annot.split(".")[0].split("_")[1:]
                        )
                        img_names.append(
                            os.path.join(
                                self.rgb_root, session, obj, f"C_{prefix}.png"
                            )
                        )
            if self.mini_factor:
                n = int(len(img_names) * self.mini_factor)
                img_names, hand_sides = img_names[:n], hand_sides[:n]
                centers, scales = centers[:n], scales[:n]
            ann = {
                "image_names": img_names,
                "hand_sides": hand_sides,
                "centers": centers,
                "scales": scales,
            }
            if self.use_cache:
                with open(cache_path, "wb") as f:
                    pickle.dump(ann, f)
        self.image_names = ann["image_names"]
        self.hand_sides = ann["hand_sides"]
        self.centers = ann["centers"]
        self.scales = ann["scales"]

    def get_image(self, idx):
        from PIL import Image

        return np.asarray(Image.open(self.image_names[idx]).convert("RGB"))

    def get_joints3d(self, idx):
        return np.zeros((21, 3), np.float32)

    def get_objpoints3d(self, idx, point_nb: int = 100):
        return np.zeros((point_nb, 3), np.float32)

    def get_camintr(self, idx):
        return self.cam_intr

    def get_sides(self, idx):
        return self.hand_sides[idx]

    def get_center_scale(self, idx):
        return self.centers[idx], float(np.max(self.scales[idx]))

    def __len__(self):
        return len(self.image_names)


class YanaDemo:
    """Demo image-folder adapter (reference: handobjectdatasets/yanademo.py):
    center-of-image crops, zero annotations, fixed side."""

    def __init__(self, root: str = "datasymlinks/yanademo", side: str = "right"):
        self.root = root
        self.side = side
        self.name = "yanademo"
        self.split = "all"
        self.all_queries = [
            BaseQueries.images, BaseQueries.joints3d, BaseQueries.sides,
            BaseQueries.objpoints3d,
        ]
        self.all_queries += get_trans_queries(self.all_queries)
        self.image_names = []
        for seq in sorted(os.listdir(root)):
            seq_path = os.path.join(root, seq)
            if os.path.isdir(seq_path):
                for img in sorted(os.listdir(seq_path)):
                    self.image_names.append(os.path.join(seq_path, img))

    def get_image(self, idx):
        from PIL import Image

        return np.asarray(Image.open(self.image_names[idx]).convert("RGB"))

    def get_joints3d(self, idx):
        return np.zeros((21, 3), np.float32)

    def get_objpoints3d(self, idx, point_nb: int = 100):
        return np.zeros((point_nb, 3), np.float32)

    def get_sides(self, idx):
        return self.side

    def get_center_scale(self, idx):
        img = self.get_image(idx)
        h, w = img.shape[:2]
        return np.array([w / 2, h / 2]), float(min(h, w))

    def __len__(self):
        return len(self.image_names)
