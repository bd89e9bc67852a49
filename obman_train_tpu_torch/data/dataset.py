"""Dataset-agnostic augmentation/transform wrapper: the JAX package's
``data/dataset.py`` ``HandDataset`` (:46-431), the reference
``HandDataset`` pipeline (handobjectdatasets/handataset.py:104-423) in
numpy with explicit RNG.

Side-flip normalization, centre/scale jitter, rotation draw, affine crop,
2D/3D coordinate transforms, camera-intrinsics update, object-point
centring, photometric augmentation and the -0.5 normalization, or, with
``emit_uint8``, the uint8 image the model normalizes on the device. The
augmentation streams are per ``(seed, epoch, idx)`` (:113-122), so the same
indices give the same draws as the JAX package. The image chain is picked
as the JAX package picks it (:350-416): uint8 through cv2 when cv2 imports
and the warp is bilinear, else the float chain. Adapters whose objects are
meshes (``objverts3d``, FHB) give their mesh, and the object points are
sampled on its surface with the sample's own generator (:305-327).
"""

from __future__ import annotations

import traceback
from typing import Optional, Sequence

import numpy as np

from obman_train_tpu_torch.data import transforms as T
from obman_train_tpu_torch.data.queries import (
    BaseQueries,
    TransQueries,
    no_query_in,
    one_query_in,
)


class HandDataset:
    def __init__(
        self,
        pose_dataset,
        center_idx: Optional[int] = 9,
        point_nb: int = 600,
        inp_res: int = 256,
        max_rot: float = np.pi,
        scale_jittering: float = 0.3,
        center_jittering: float = 0.2,
        train: bool = True,
        hue: float = 0.15,
        saturation: float = 0.5,
        contrast: float = 0.5,
        brightness: float = 0.5,
        blur_radius: float = 0.5,
        queries: Sequence = (
            BaseQueries.images,
            TransQueries.joints2d,
            TransQueries.verts3d,
            TransQueries.joints3d,
        ),
        sides: str = "both",
        block_rot: bool = False,
        black_padding: bool = False,
        as_obj_only: bool = False,
        resample: str = "bilinear",
        seed: int = 0,
        emit_uint8: bool = False,
        device_augment: bool = False,
    ):
        """``emit_uint8=True`` outputs ``TransQueries.images`` as uint8 (the
        model normalizes x/255 - 0.5 on the device: 4x less to copy).

        ``device_augment=True`` moves the colour jitter onto the device:
        the host only draws the per-sample factors (``aug_factors``,
        ``aug_order``) and HandNet applies them
        (``ops/image.batched_color_jitter``)."""
        self.pose_dataset = pose_dataset
        self.as_obj_only = as_obj_only
        self.inp_res = inp_res
        self.point_nb = point_nb
        self.center_idx = center_idx
        self.sides = sides
        self.black_padding = black_padding
        self.hue = hue
        self.contrast = contrast
        self.brightness = brightness
        self.saturation = saturation
        self.blur_radius = blur_radius
        self.max_rot = max_rot
        self.block_rot = block_rot
        self.train = train
        self.scale_jittering = scale_jittering
        self.center_jittering = center_jittering
        self.queries = list(queries)
        self.resample = resample
        self._seed = seed
        self._epoch = 0
        self.emit_uint8 = emit_uint8
        self.device_augment = device_augment

    def __len__(self):
        return len(self.pose_dataset)

    def reseed(self, seed: int):
        """Set the per-epoch augmentation stream (called by BatchLoader)."""
        self._epoch = seed

    def _sample_rng(self, idx) -> np.random.Generator:
        """Deterministic per (seed, epoch, idx), so loader threads that pull
        samples concurrently share no mutable generator."""
        return np.random.default_rng((self._seed, self._epoch, int(idx)))

    # -- the pipeline (handataset.py:104-413) --------------------------------

    def get_sample(self, idx, query=None, rng=None):
        rng = rng or self._sample_rng(idx)
        query = set(self.queries if query is None else query)
        sample = {}

        needs_image = BaseQueries.images in query or TransQueries.images in query
        if needs_image:
            center, scale = self.pose_dataset.get_center_scale(idx)
            center = np.asarray(center, np.float64)
            scale = float(scale)

        # sides + flip normalization
        flip = False
        if BaseQueries.sides in query:
            hand_side = self.pose_dataset.get_sides(idx)
            if self.sides == "right" and hand_side == "left":
                flip, hand_side = True, "right"
            elif self.sides == "left" and hand_side == "right":
                flip, hand_side = True, "left"
            sample[BaseQueries.sides] = hand_side

        if needs_image:
            img = np.asarray(self.pose_dataset.get_image(idx))
            if flip:
                img = img[:, ::-1]
            if BaseQueries.images in query:
                sample[BaseQueries.images] = img
            img_w = img.shape[1]
            if flip:
                center[0] = img_w - center[0]

        # geometric jitter (train only)
        if self.train and needs_image:
            center_offsets = (
                self.center_jittering * scale * rng.uniform(low=-1, high=1, size=2)
            )
            center = center + center_offsets.astype(int)
            scale_jit = np.clip(
                self.scale_jittering * rng.standard_normal() + 1,
                1 - self.scale_jittering,
                1 + self.scale_jittering,
            )
            scale = scale * scale_jit
            rot = rng.uniform(-self.max_rot, self.max_rot)
        else:
            rot = 0.0
        if self.block_rot:
            rot = self.max_rot
        rot_mat = np.array(
            [
                [np.cos(rot), -np.sin(rot), 0],
                [np.sin(rot), np.cos(rot), 0],
                [0, 0, 1],
            ],
            dtype=np.float32,
        )
        if TransQueries.rotmat in query:
            sample[TransQueries.rotmat] = rot_mat

        affinetrans = post_rot_trans = None
        if needs_image or TransQueries.joints2d in query:
            affinetrans, post_rot_trans = T.get_affine_transform(
                center, scale, (self.inp_res, self.inp_res), rot=rot
            )
            if TransQueries.affinetrans in query:
                sample[TransQueries.affinetrans] = affinetrans

        # 2D joints
        if BaseQueries.joints2d in query or TransQueries.joints2d in query:
            joints2d = np.asarray(self.pose_dataset.get_joints2d(idx), np.float64)
            if flip:
                joints2d = joints2d.copy()
                joints2d[:, 0] = img_w - joints2d[:, 0]
            if BaseQueries.joints2d in query:
                sample[BaseQueries.joints2d] = joints2d.astype(np.float32)
            if TransQueries.joints2d in query:
                sample[TransQueries.joints2d] = T.transform_coords(
                    joints2d, affinetrans
                ).astype(np.float32)

        # camera intrinsics
        if BaseQueries.camintrs in query or TransQueries.camintrs in query:
            camintr = np.asarray(self.pose_dataset.get_camintr(idx))
            if BaseQueries.camintrs in query:
                sample[BaseQueries.camintrs] = camintr.astype(np.float32)
            if TransQueries.camintrs in query:
                sample[TransQueries.camintrs] = post_rot_trans.dot(camintr).astype(
                    np.float32
                )

        # segmentation
        if BaseQueries.segms in query or TransQueries.segms in query:
            segm = np.asarray(self.pose_dataset.get_segm(idx))
            if flip:
                segm = segm[:, ::-1]
            if BaseQueries.segms in query:
                sample[BaseQueries.segms] = segm
            if TransQueries.segms in query:
                warped = T.transform_img(
                    segm, affinetrans, (self.inp_res, self.inp_res),
                    resample=self.resample,
                )
                sample[TransQueries.segms] = warped / 255.0

        # 3D joints + center3d
        center3d = None
        center3d_queries = [
            TransQueries.joints3d,
            BaseQueries.joints3d,
            TransQueries.verts3d,
        ]
        needs_3d = one_query_in(
            [BaseQueries.joints3d, TransQueries.joints3d, TransQueries.verts3d,
             TransQueries.objverts3d, TransQueries.objpoints3d],
            query,
        )
        obj_only = (
            (TransQueries.objverts3d in query or TransQueries.objpoints3d in query)
            and no_query_in(center3d_queries, self.pose_dataset.all_queries)
        ) or self.as_obj_only
        if needs_3d and not obj_only:
            if one_query_in(
                [TransQueries.objpoints3d, TransQueries.objverts3d] + center3d_queries,
                query,
            ):
                joints3d = np.asarray(
                    self.pose_dataset.get_joints3d(idx), np.float32
                ).copy()
                if flip:
                    joints3d[:, 0] = -joints3d[:, 0]
                if BaseQueries.joints3d in query:
                    sample[BaseQueries.joints3d] = joints3d.copy()
                if self.train:
                    joints3d = rot_mat.dot(joints3d.T).T
                if self.center_idx is not None:
                    if self.center_idx == -1:
                        center3d = (joints3d[9] + joints3d[0]) / 2
                    else:
                        center3d = joints3d[self.center_idx].copy()
                if TransQueries.joints3d in query:
                    out = joints3d
                    if self.center_idx is not None:
                        out = joints3d - center3d
                    sample[TransQueries.joints3d] = out.astype(np.float32)

        # 3D hand vertices
        if TransQueries.verts3d in query:
            verts3d = np.asarray(self.pose_dataset.get_verts3d(idx), np.float32).copy()
            if flip:
                verts3d[:, 0] = -verts3d[:, 0]
            verts3d = rot_mat.dot(verts3d.T).T
            if self.center_idx is not None:
                verts3d = verts3d - center3d
            sample[TransQueries.verts3d] = verts3d.astype(np.float32)

        # 3D object points
        obj_verts3d = None
        if TransQueries.objpoints3d in query and (
            BaseQueries.objpoints3d in self.pose_dataset.all_queries
        ):
            points3d = np.asarray(
                self.pose_dataset.get_objpoints3d(idx, point_nb=self.point_nb),
                np.float32,
            ).copy()
            if flip:
                points3d[:, 0] = -points3d[:, 0]
            obj_verts3d = rot_mat.dot(points3d.T).T
        elif one_query_in(
            [TransQueries.objpoints3d, BaseQueries.objverts3d, TransQueries.objverts3d],
            query,
        ) and (BaseQueries.objverts3d in self.pose_dataset.all_queries):
            mesh_verts, obj_faces = self.pose_dataset.get_obj_verts_faces(idx)
            mesh_verts = np.asarray(mesh_verts, np.float32).copy()
            if flip:
                mesh_verts[:, 0] = -mesh_verts[:, 0]
            if BaseQueries.objverts3d in query:
                sample[BaseQueries.objverts3d] = mesh_verts.copy()
            if TransQueries.objverts3d in query:
                rot_mesh = rot_mat.dot(mesh_verts.T).T
                if self.center_idx is not None:
                    rot_mesh = rot_mesh - center3d
                sample[TransQueries.objverts3d] = rot_mesh.astype(np.float32)
            if BaseQueries.objfaces in query:
                sample[BaseQueries.objfaces] = np.asarray(obj_faces, np.int32)
            sampled = T.points_from_mesh(
                np.asarray(obj_faces), mesh_verts, vertex_nb=self.point_nb, rng=rng)
            obj_verts3d = rot_mat.dot(sampled.T).T
        elif TransQueries.objpoints3d in query:
            raise ValueError(
                "Requested TransQueries.objpoints3d for a dataset without "
                "BaseQueries.objpoints3d or BaseQueries.objverts3d"
            )

        if TransQueries.objpoints3d in query and obj_verts3d is not None:
            if obj_only:
                center3d = (obj_verts3d.max(0) + obj_verts3d.min(0)) / 2
            if self.center_idx is not None or obj_only:
                obj_verts3d = obj_verts3d - center3d
            if obj_only:
                radius = np.linalg.norm(obj_verts3d, axis=1).max()
                obj_verts3d = obj_verts3d / radius
            sample[TransQueries.objpoints3d] = obj_verts3d.astype(np.float32)

        if TransQueries.center3d in query and center3d is not None:
            sample[TransQueries.center3d] = np.asarray(center3d, np.float32)

        if BaseQueries.manoidxs in query:
            sample[BaseQueries.manoidxs] = self.pose_dataset.get_manoidxs(idx)

        # final image: photometric augment + warp + normalize(-0.5). With
        # cv2 and the bilinear warp the chain stays uint8 end to end (the
        # reference's PIL chain quantizes per op too, handataset.py:371-407),
        # else it is the float chain; both draw the same factors in the
        # same order from ``rng``
        if TransQueries.images in query:
            fast_u8 = self.resample == "bilinear" and T._have_cv2()
            img_x = (np.ascontiguousarray(img, np.uint8) if fast_u8
                     else np.asarray(img, np.float32) / 255.0)
            if self.train:
                img_x = T.gaussian_blur(img_x, rng.random() * self.blur_radius)
                if self.device_augment:
                    # factors drawn as get_color_params (imgtrans.py:5-27),
                    # applied on the device by HandNet
                    sample["aug_factors"] = np.array(
                        [
                            rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness),
                            rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation),
                            rng.uniform(-self.hue, self.hue),
                            rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast),
                        ],
                        np.float32,
                    )
                    sample["aug_order"] = np.int32(rng.integers(0, 24))
                else:
                    jitter = T.color_jitter_u8 if fast_u8 else T.color_jitter
                    img_x = jitter(
                        img_x, rng,
                        brightness=self.brightness, contrast=self.contrast,
                        saturation=self.saturation, hue=self.hue,
                    )
            if fast_u8:
                warped = T.warp_affine_u8(img_x, affinetrans, (self.inp_res, self.inp_res))
            else:
                warped = T.transform_img(
                    img_x, affinetrans, (self.inp_res, self.inp_res),
                    resample=self.resample)
            if self.black_padding:
                pad = int(self.inp_res * 0.2)
                warped[0:pad, :] = 0
                warped[-pad:-1, :] = 0
                warped[:, 0:pad] = 0
                warped[:, -pad:-1] = 0
            if self.emit_uint8:
                sample[TransQueries.images] = warped if fast_u8 else np.clip(
                    np.round(warped * 255.0), 0, 255).astype(np.uint8)
            elif fast_u8:
                sample[TransQueries.images] = warped.astype(np.float32) / 255.0 - 0.5
            else:
                sample[TransQueries.images] = (warped - 0.5).astype(np.float32)

        if BaseQueries.meta in query:
            sample[BaseQueries.meta] = self.pose_dataset.get_meta(idx)
        return sample

    def __getitem__(self, idx):
        """Retry with a random substitute sample on error
        (handataset.py:415-423)."""
        try:
            return self.get_sample(idx, self.queries)
        except Exception:
            traceback.print_exc()
            print(f"Encountered error processing sample {idx}")
            random_idx = int(self._sample_rng(idx).integers(0, len(self)))
            return self.get_sample(random_idx, self.queries)
