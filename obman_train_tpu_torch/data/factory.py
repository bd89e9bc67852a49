"""Dataset factory (the JAX package's ``data/factory.py``; reference
mano_train/netscripts/get_datasets.py:11-126): builds an adapter by name,
intersects the requested queries with what it provides, and wraps it in
:class:`HandDataset` with the per-dataset jitter magnitudes.

Only the ``synthetic`` adapter is ported; the real datasets (ObMan, FHB,
StereoHands, Core50) are the real-dataset slice and raise here.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np

from obman_train_tpu_torch.data.dataset import HandDataset
from obman_train_tpu_torch.data.queries import BaseQueries, TransQueries
from obman_train_tpu_torch.data.synthetic import SyntheticDataset

DEFAULT_MAX_QUERIES = (
    TransQueries.affinetrans,
    TransQueries.images,
    TransQueries.verts3d,
    TransQueries.center3d,
    TransQueries.joints3d,
    TransQueries.objpoints3d,
    TransQueries.camintrs,
    BaseQueries.sides,
)


class Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    def reseed(self, epoch):
        # keep the per-epoch augmentation stream advancing under wrapping
        if hasattr(self.dataset, "reseed"):
            self.dataset.reseed(epoch)


def make_pose_dataset(dat_name: str, split: str, meta: dict, mini_factor=None):
    meta = dict(meta or {})
    if dat_name == "synthetic":
        return SyntheticDataset(
            size=meta.get("size", 64), img_res=meta.get("img_res", 256), split=split
        )
    raise NotImplementedError(
        f"dataset {dat_name!r}: only 'synthetic' is ported; the real-dataset "
        "adapters (obman, fhbhands, stereohands, core50) are the real-dataset "
        "slice of the port"
    )


def get_dataset(
    dat_name: str,
    split: str,
    meta: Optional[dict] = None,
    sides: str = "left",
    train_it: bool = True,
    max_queries: Sequence = DEFAULT_MAX_QUERIES,
    mini_factor=None,
    point_nb: int = 600,
    center_idx: Optional[int] = 9,
    limit_size: Optional[int] = None,
    inp_res: int = 256,
    device_augment: bool = False,
):
    meta = dict(meta or {})
    pose_dataset = make_pose_dataset(dat_name, split, meta, mini_factor)
    queries = set(max_queries).intersection(set(pose_dataset.all_queries))
    if dat_name == "stereohands":
        max_rot, scale_jittering, center_jittering = np.pi, 0.2, 0.2
    elif dat_name == "synthetic":
        # the fixture keeps every augmentation path active at a magnitude
        # it can learn at its scale (~1-2k samples)
        max_rot, scale_jittering, center_jittering = np.pi / 8, 0.1, 0.1
    else:
        max_rot, scale_jittering, center_jittering = np.pi, 0.3, 0.2
    dataset = HandDataset(
        pose_dataset,
        sides=sides,
        train=train_it,
        max_rot=max_rot,
        center_idx=center_idx,
        point_nb=point_nb,
        inp_res=inp_res,
        scale_jittering=scale_jittering,
        center_jittering=center_jittering,
        queries=queries,
        as_obj_only=meta.get("override_scale", False),
        black_padding=meta.get("black_padding", False),
        emit_uint8=True,
        device_augment=device_augment,
    )
    if limit_size is not None:
        if len(dataset) < limit_size:
            warnings.warn(
                f"limit size {limit_size} < dataset size {len(dataset)}, "
                "working with full dataset"
            )
        else:
            dataset = Subset(dataset, range(limit_size))
    return dataset
