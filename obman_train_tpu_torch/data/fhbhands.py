"""First-Person Hand Action Benchmark (FHB) adapter: the JAX package's
``data/fhbhands.py``.

Reimplements handobjectdatasets/fhbhands.py + fhbutils.py: skeleton files ->
camera coordinates through the fixed extrinsics/intrinsics
(fhbhands.py:74-88), tip-to-base joint reordering (:90-114), action/subject/
object splits with the 599-train / 575-test sequence invariants
(fhbutils.py:79-94), optional object 6-DoF annotations + PLY mesh models,
contact filtering at <=10 mm (fhbhands.py:379-387), and quarter-scale image
coordinates (:508-511).
"""

from __future__ import annotations

import os
import pickle
from collections import OrderedDict, defaultdict
from typing import Optional

import numpy as np

from obman_train_tpu_torch.data import transforms as T
from obman_train_tpu_torch.data.cacheutil import root_cache_tag
from obman_train_tpu_torch.data.plyio import load_ply
from obman_train_tpu_torch.data.queries import BaseQueries, get_trans_queries

CAM_EXTR = np.array(
    [
        [0.999988496304, -0.00468848412856, 0.000982563360594, 25.7],
        [0.00469115935266, 0.999985218048, -0.00273845880292, 1.22],
        [-0.000969709653873, 0.00274303671904, 0.99999576807, 3.902],
        [0, 0, 0, 1],
    ]
)
CAM_INTR = np.array(
    [
        [1395.749023, 0, 935.732544],
        [0, 1395.749268, 540.681030],
        [0, 0, 1],
    ]
)
REORDER_IDX = np.array(
    [0, 1, 6, 7, 8, 2, 9, 10, 11, 3, 12, 13, 14, 4, 15, 16, 17, 5, 18, 19, 20]
)
ALL_OBJECTS = ["juice_bottle", "liquid_soap", "milk", "salt"]
SUBJECTS = [f"Subject_{i}" for i in range(1, 7)]


def transform_obj_verts(verts, trans, cam_extr=CAM_EXTR):
    """(fhbutils.py:123-128): metres -> mm, 6-DoF pose, camera extrinsics."""
    verts = verts * 1000
    hom = np.concatenate([verts, np.ones((len(verts), 1))], axis=1)
    return cam_extr.dot(trans.dot(hom.T)).T[:, :3]


def get_action_train_test(lines_raw, subjects_infos):
    """Parse the action-recognition split file (fhbutils.py:52-96),
    asserting the published 599/575 sequence counts."""
    all_infos, train, test = [], {}, {}
    test_split = False
    for line in lines_raw[1:]:
        if line.startswith("Test"):
            test_split = True
            continue
        subject, action_name, seq_idx = line.split(" ")[0].split("/")
        action_idx = line.split(" ")[1].strip()
        frame_nb = int(subjects_infos[subject][(action_name, seq_idx)])
        for frame_idx in range(frame_nb):
            info = (subject, action_name, seq_idx, frame_idx)
            (test if test_split else train)[info] = action_idx
            all_infos.append(info)
    test_nb = len({(s, a, q) for (s, a, q, _) in test})
    train_nb = len({(s, a, q) for (s, a, q, _) in train})
    assert test_nb == 575, f"Should get 575 test sequences, got {test_nb}"
    assert train_nb == 599, f"Should get 599 train sequences, got {train_nb}"
    return list(train), list(test), all_infos


class FHBHands:
    name = "fhb"

    def __init__(
        self,
        split: str = "train",
        split_type: str = "actions",
        split_choice: str = "1",   # accepted for CLI parity; unused
        original_subject_split: bool = True,
        use_cache: bool = True,
        mini_factor: Optional[float] = None,
        use_objects: bool = True,
        test_object: str = "juice_bottle",
        filter_no_contact: bool = True,
        filter_thresh: float = 10.0,
        topology=None,
        filter_object=None,
        override_scale: bool = False,
        root: str = "datasymlinks/fhbhands",
        cache_folder: str = "data/cache/fhb",
    ):
        if split_type == "actions":
            split_type = "action"
        assert split_type in ("action", "objects", "subjects"), split_type
        self.split = split
        self.split_type = split_type
        self.original_subject_split = original_subject_split
        self.use_objects = use_objects
        self.test_object = test_object
        self.filter_no_contact = filter_no_contact
        self.filter_thresh = filter_thresh
        self.topology = topology
        self.filter_object = filter_object
        self.override_scale = override_scale
        self.mini_factor = mini_factor
        self.use_cache = use_cache
        self.cache_folder = cache_folder
        self.root = root
        self.info_root = os.path.join(root, "Subjects_info")
        self.info_split = os.path.join(
            root, "data_split_action_recognition.txt"
        )
        self.rgb_root = os.path.join(root, "process_yana", "videos_480")
        self.skeleton_root = os.path.join(root, "Hand_pose_annotation_v1")
        self.obj_root = os.path.join(root, "Object_models")
        self.obj_pose_root = os.path.join(
            root, "Object_6D_pose_annotation_v1"
        )
        self.rgb_template = "color_{:04d}.jpeg"
        self.cam_intr = CAM_INTR
        self.cam_extr = CAM_EXTR

        self.all_queries = [
            BaseQueries.images, BaseQueries.joints2d, BaseQueries.joints3d,
            BaseQueries.sides, BaseQueries.camintrs, BaseQueries.meta,
        ]
        if use_objects:
            self.all_queries += [
                BaseQueries.objverts3d, BaseQueries.objpoints2d,
                BaseQueries.objfaces,
            ]
        self.all_queries += get_trans_queries(self.all_queries)
        self._load_dataset()

    # -- loading -------------------------------------------------------------

    def _load_objects(self, object_names):
        models = OrderedDict()
        for obj in object_names:
            path = os.path.join(
                self.obj_root, f"{obj}_model", f"{obj}_model.ply"
            )
            verts, faces = load_ply(path)
            models[obj] = {"verts": verts, "faces": faces}
        return models

    def _load_object_infos(self):
        annots = {}
        for subject in os.listdir(self.obj_pose_root):
            subject_dict = {}
            subj_path = os.path.join(self.obj_pose_root, subject)
            for action in os.listdir(subj_path):
                object_name = "_".join(action.split("_")[1:])
                for seq in os.listdir(os.path.join(subj_path, action)):
                    pose_path = os.path.join(
                        subj_path, action, seq, "object_pose.txt"
                    )
                    with open(pose_path) as f:
                        for raw in f:
                            line = raw.strip().split(" ")
                            frame_idx = int(line[0])
                            trans = (
                                np.asarray(line[1:], np.float32)
                                .reshape(4, 4)
                                .T
                            )
                            subject_dict[(action, seq, frame_idx)] = (
                                object_name, trans,
                            )
            annots[subject] = subject_dict
        return annots

    def _get_skeletons(self, subjects_infos):
        skels = defaultdict(dict)
        for subject, samples in subjects_infos.items():
            for action, seq_idx in samples:
                path = os.path.join(
                    self.skeleton_root, subject, action, seq_idx,
                    "skeleton.txt",
                )
                vals = np.loadtxt(path)
                if len(vals):
                    assert np.all(vals[:, 0] == np.arange(len(vals))), (
                        f"row idxs should match frame idx at {path}"
                    )
                    skels[subject][(action, seq_idx)] = vals[:, 1:].reshape(
                        len(vals), 21, -1
                    )
        return skels

    def _load_dataset(self):
        os.makedirs(self.cache_folder, exist_ok=True)
        cache_path = os.path.join(
            self.cache_folder,
            f"{self.split}_{self.split_type}_{self.mini_factor}"
            f"_obj{self.use_objects}_filt{self.filter_thresh}"
            f"_top{self.topology}_{root_cache_tag(self.root)}.pkl",
        )
        if self.use_cache and os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                ann = pickle.load(f)
        else:
            subjects_infos = {}
            for subject in SUBJECTS:
                info_path = os.path.join(self.info_root, f"{subject}_info.txt")
                subjects_infos[subject] = {}
                with open(info_path) as f:
                    for line in f.readlines()[3:]:
                        action, action_idx, length = " ".join(
                            line.split()
                        ).strip().split(" ")
                        subjects_infos[subject][(action, action_idx)] = length
            skel_info = self._get_skeletons(subjects_infos)
            with open(self.info_split) as f:
                lines_raw = f.readlines()
            train_list, test_list, all_infos = get_action_train_test(
                lines_raw, subjects_infos
            )

            if self.topology is None:
                objects = list(ALL_OBJECTS)
            elif int(self.topology) == 0:
                objects = ["juice_bottle", "liquid_soap", "salt"]
            else:
                objects = ["milk"]
            if self.filter_object:
                objects = [self.filter_object]

            split_objects = {}
            obj_infos = {}
            if self.use_objects:
                models = self._load_objects(objects)
                obj_infos = self._load_object_infos()

            if self.split_type == "action":
                sample_list = {
                    "train": train_list,
                    "test": test_list,
                    "all": train_list + test_list,
                }[self.split]
                subjects = SUBJECTS
            elif self.split_type == "subjects":
                if self.original_subject_split:
                    subjects = {
                        "train": ["Subject_1", "Subject_3", "Subject_4"],
                        "test": ["Subject_2", "Subject_5", "Subject_6"],
                    }[self.split]
                else:
                    subjects = {
                        "train": SUBJECTS[:4],
                        "val": ["Subject_5"],
                        "test": ["Subject_6"],
                    }[self.split]
                sample_list = all_infos
            else:  # objects
                if self.use_objects:
                    test_objects = {self.test_object: models.pop(self.test_object)}
                    split_objects = {
                        "train": models,
                        "test": test_objects,
                        "all": {**models, **test_objects},
                    }[self.split]
                sample_list = all_infos
                subjects = SUBJECTS
            if self.use_objects and self.split_type != "objects":
                split_objects = models

            image_names, joints2d, joints3d = [], [], []
            hand_sides, sample_infos = [], []
            objnames, objtransforms = [], []
            for subject, action_name, seq_idx, frame_idx in sample_list:
                if subject not in subjects:
                    continue
                skel = skel_info[subject][(action_name, seq_idx)][frame_idx]
                skel = skel[REORDER_IDX]
                hom = np.concatenate([skel, np.ones((21, 1))], 1)
                cam = CAM_EXTR.dot(hom.T).T[:, :3].astype(np.float32)
                if self.use_objects:
                    key = (action_name, seq_idx, frame_idx)
                    if subject not in obj_infos or key not in obj_infos[subject]:
                        continue
                    obj, trans = obj_infos[subject][key]
                    if obj not in split_objects:
                        continue
                    if self.filter_no_contact:
                        tv = transform_obj_verts(
                            split_objects[obj]["verts"], trans
                        )
                        d2 = (
                            np.sum(tv**2, 1)[:, None]
                            + np.sum(cam**2, 1)[None, :]
                            - 2 * tv @ cam.T
                        )
                        if np.sqrt(max(d2.min(), 0)) > self.filter_thresh:
                            continue
                    objnames.append(obj)
                    objtransforms.append(trans)
                joints3d.append(cam)
                image_names.append(
                    os.path.join(
                        self.rgb_root, subject, action_name, seq_idx,
                        "color", self.rgb_template.format(frame_idx),
                    )
                )
                hom2d = CAM_INTR.dot(cam.T).T
                joints2d.append(
                    (hom2d[:, :2] / hom2d[:, 2:]).astype(np.float32)
                )
                hand_sides.append("right")
                sample_infos.append(
                    {
                        "subject": subject,
                        "action_name": action_name,
                        "seq_idx": seq_idx,
                        "frame_idx": frame_idx,
                    }
                )

            if self.mini_factor:
                import random

                idxs = list(range(len(image_names)))
                random.Random(1).shuffle(idxs)
                idxs = idxs[: int(len(image_names) * self.mini_factor)]
                image_names = [image_names[i] for i in idxs]
                joints2d = [joints2d[i] for i in idxs]
                joints3d = [joints3d[i] for i in idxs]
                hand_sides = [hand_sides[i] for i in idxs]
                sample_infos = [sample_infos[i] for i in idxs]
                if self.use_objects:
                    objnames = [objnames[i] for i in idxs]
                    objtransforms = [objtransforms[i] for i in idxs]

            ann = {
                "image_names": image_names,
                "joints2d": joints2d,
                "joints3d": joints3d,
                "hand_sides": hand_sides,
                "sample_infos": sample_infos,
            }
            if self.use_objects:
                ann.update(
                    objnames=objnames,
                    objtransforms=objtransforms,
                    split_objects=split_objects,
                )
            if self.use_cache:
                with open(cache_path, "wb") as f:
                    pickle.dump(ann, f)
        for k, v in ann.items():
            setattr(self, k, v)

    # -- getters -------------------------------------------------------------

    def get_image(self, idx):
        from obman_train_tpu_torch.data.obman import _read_rgb

        return _read_rgb(self.image_names[idx])

    def get_obj_verts_faces(self, idx):
        obj = self.objnames[idx]
        verts = transform_obj_verts(
            self.split_objects[obj]["verts"], self.objtransforms[idx]
        )
        if self.override_scale:
            verts = verts - verts.mean(0)
            verts = 100 * verts / np.linalg.norm(verts, axis=1).max()
        return (
            verts.astype(np.float32),
            np.asarray(self.split_objects[obj]["faces"], np.int32),
        )

    def get_objpoints2d(self, idx):
        verts, _ = self.get_obj_verts_faces(idx)
        hom = CAM_INTR.dot(verts.T).T
        return (hom[:, :2] / hom[:, 2:]) / 4   # quarter-scale images

    def get_joints3d(self, idx):
        return np.asarray(self.joints3d[idx], np.float32)

    def get_joints2d(self, idx):
        return np.asarray(self.joints2d[idx], np.float32) / 4

    def get_camintr(self, idx):
        return CAM_INTR.astype(np.float32)

    def get_sides(self, idx):
        return self.hand_sides[idx]

    def get_meta(self, idx):
        return {"objname": self.objnames[idx]} if self.use_objects else {}

    def get_center_scale(self, idx):
        joints2d = self.get_joints2d(idx)
        return (
            T.get_annot_center(joints2d),
            T.get_annot_scale(joints2d),
        )

    def __len__(self):
        return len(self.image_names)
