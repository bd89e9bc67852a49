"""HandNet: the top-level multi-branch model, inference forward
(JAX package: models/handnet.py:41-346; reference handnet.py:20-392).

ResNet encoder -> MANO hand branch and AtlasNet object branch, optional
absolute-position and orthographic scale+trans heads, and, when the config
has contact or collision weights, the contact block (handnet.py:263-278),
which runs even with ``no_loss=True`` and returns ``contact_info``.

Frames arrive NHWC (uint8 or float) as on the JAX path and are permuted to
NCHW once. Branch gating is static, from the config and a
:class:`BatchSpec`, as in the JAX package. Only ``no_loss=True`` is ported;
the loss path is a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from obman_train_tpu_torch.assets.icosphere import icosphere
from obman_train_tpu_torch.assets.mano_assets import ManoAssets
from obman_train_tpu_torch.config import ModelConfig
from obman_train_tpu_torch.device import DeviceLike, resolve_device
from obman_train_tpu_torch.models.branches import AbsoluteBranch, AtlasBranch, ManoBranch
from obman_train_tpu_torch.models.resnet import resnet18, resnet50
from obman_train_tpu_torch.ops.contact import ContainsFn, compute_contact_loss


@dataclass(frozen=True)
class BatchSpec:
    """Static description of which GT queries a batch carries."""

    has_joints3d: bool = True
    has_verts3d: bool = True
    has_joints2d: bool = False
    has_camintrs: bool = False
    has_objpoints3d: bool = True
    has_center3d: bool = False
    has_pcas: bool = False
    has_sides: bool = True
    root: str = "wrist"             # "wrist" | "palm" (datautils.py:22-32)
    use_stereoshape: bool = False

    @property
    def root_palm(self) -> bool:
        return self.root == "palm"


# What a GT-free inference batch carries (bench.py:379-382).
INFER_SPEC = BatchSpec(
    has_joints3d=False, has_verts3d=False, has_objpoints3d=False,
    has_camintrs=False, has_center3d=False,
)


class HandNet(nn.Module):
    """Top-level model; construct with :func:`build_handnet`."""

    def __init__(self, cfg: ModelConfig, mano_right: ManoAssets,
                 mano_left: ManoAssets):
        super().__init__()
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r}: only float32 is ported"
            )
        if cfg.geometry_dtype != "float32":
            raise NotImplementedError(
                f"geometry_dtype={cfg.geometry_dtype!r}: only float32 is ported"
            )
        if not cfg.atlas.mesh:
            raise NotImplementedError(
                "atlas.mesh=False (the random-cloud decoder) is training-only "
                "and not ported yet"
            )
        self.cfg = cfg
        feat = cfg.img_feature_size
        make_resnet = {18: resnet18, 50: resnet50}[int(cfg.resnet_version)]
        self.base_net = make_resnet()
        self.atlas_base_net = make_resnet() if cfg.atlas.separate_encoder else None
        self.atlas_adapter = (
            nn.Linear(feat, feat) if cfg.atlas.adapt_decoder else None
        )
        self.absolute_branch = (
            AbsoluteBranch(feat + 3, (feat // 2,), 3)
            if (cfg.absolute_lambda or cfg.mano.lambda_joints2d) else None
        )
        self.scaletrans_branch = (
            AbsoluteBranch(feat, (feat // 2,), 3) if cfg.mano.lambda_joints2d else None
        )
        m = cfg.mano
        self.mano_branch = ManoBranch(
            mano_right, mano_left, in_features=feat, ncomps=m.ncomps,
            base_neurons=tuple(m.base_neurons), center_idx=m.center_idx,
            use_shape=m.use_shape, use_trans=m.use_trans, use_pca=m.use_pca,
            adapt_skeleton=m.adapt_skeleton, dropout=cfg.fc_dropout,
        )
        ico_verts, ico_faces = icosphere(cfg.atlas.ico_divisions)
        a = cfg.atlas
        self.atlas_branch = AtlasBranch(
            feat, ico_verts, use_residual=a.use_residual, use_tanh=a.use_tanh,
            out_factor=a.out_factor, predict_trans=a.predict_trans,
            predict_scale=a.predict_scale, separate_encoder=a.separate_encoder,
        )
        self.ico_faces_np = np.asarray(ico_faces)
        self.register_buffer(
            "ico_faces", torch.from_numpy(ico_faces.astype(np.int64)),
            persistent=False,
        )

    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        spec: BatchSpec = INFER_SPEC,
        no_loss: bool = False,
        return_features: bool = False,
        force_objects: bool = False,
        force_hand: bool = False,
        contains: Optional[ContainsFn] = None,
    ) -> Tuple[Optional[torch.Tensor], Dict[str, Any], Dict[str, Any]]:
        """Returns ``(total_loss, results, losses)`` like the JAX
        ``HandNet.__call__``. ``contains`` replaces the contact block's
        exterior test (a test hook; the default is the CUDA kernel path)."""
        if not no_loss:
            raise NotImplementedError("loss path: later slice")
        if self.training:
            raise NotImplementedError(
                "training mode (unfrozen BN, dropout) is not ported; call .eval()"
            )
        cfg = self.cfg
        results: Dict[str, Any] = {}
        losses: Dict[str, Any] = {}

        image = batch["images"].permute(0, 3, 1, 2)  # NHWC -> NCHW view
        if not torch.is_floating_point(image):
            # uint8 pipeline: x/255 - 0.5 = to_tensor + normalize
            # (handataset.py:385-407)
            image = image.to(torch.float32) / 255.0 - 0.5
        features, _ = self.base_net(image)
        if cfg.atlas.separate_encoder:
            atlas_infeatures, _ = self.atlas_base_net(image)
            if return_features:
                results["atlas_features"] = atlas_infeatures
        if return_features:
            results["img_features"] = features

        # absolute root position (handnet.py:216-252)
        predict_center = spec.has_camintrs and bool(
            (cfg.absolute_lambda and spec.has_center3d) or cfg.mano.lambda_joints2d
        )
        if predict_center:
            intr = batch["camintrs"]
            absolute_input = torch.cat(
                [intr[:, 0:1, 0], intr[:, 0:1, 2], intr[:, 1:2, 2], features], dim=1
            )
            results["center3d"] = self.absolute_branch(absolute_input)

        # MANO branch (handnet.py:253-309)
        mano_results = None
        run_mano = (
            (
                spec.has_joints3d
                or spec.has_verts3d
                or (spec.has_joints2d and spec.has_camintrs)
                or force_hand
            )
            and spec.has_sides
            and cfg.mano_lambdas
        )
        if run_mano:
            mano_results = self.mano_branch(
                features,
                sides=batch["sides"],
                root_palm=spec.root_palm,
                use_stereoshape=spec.use_stereoshape,
            )
            results.update(mano_results)
            if cfg.mano.lambda_joints2d:
                scaletrans = self.scaletrans_branch(features)
                trans = scaletrans[:, 1:]
                scale = torch.abs(scaletrans[:, :1])
                # 100 ~ the scale of 2D joint coordinates (handnet.py:296-301)
                results["joints2d"] = (
                    mano_results["joints"][:, :, :2] * scale[:, None, :]
                    + 100.0 * trans[:, None, :]
                )

        # Atlas branch (handnet.py:310-386)
        predict_atlas = (spec.has_objpoints3d or force_objects) and bool(
            cfg.atlas.lambda_atlas or cfg.atlas.final_lambda_atlas
        )
        if predict_atlas:
            atlas_features = (
                self.atlas_adapter(features) if cfg.atlas.adapt_decoder else features
            )
            atlas_results = self.atlas_branch.forward_inference(
                atlas_features,
                separate_encoder_features=(
                    atlas_infeatures if cfg.atlas.separate_encoder else None
                ),
            )
            atlas_results["objfaces"] = self.ico_faces_np

            if cfg.need_collisions and mano_results is not None:
                c = cfg.contact
                _, _, contact_infos, _ = compute_contact_loss(
                    mano_results["verts"],
                    atlas_results["objpoints3d"],
                    self.ico_faces,
                    contact_thresh=c.contact_thresh,
                    contact_mode=c.contact_mode,
                    collision_thresh=c.collision_thresh,
                    collision_mode=c.collision_mode,
                    contact_target=c.contact_target,
                    contact_sym=c.contact_sym,
                    contact_zones=c.contact_zones,
                    contains=contains,
                )
                results["contact_info"] = contact_infos
            results.update(atlas_results)

        losses["total_loss"] = None
        return None, results, losses


def build_handnet(
    cfg: ModelConfig,
    mano_right: ManoAssets,
    mano_left: ManoAssets,
    device: DeviceLike = None,
) -> HandNet:
    """Construct HandNet in eval mode on ``device`` (default CUDA; raises
    without a GPU unless ``device="cpu"``). Weights are PyTorch's default
    init: load real ones with ``load_state_dict`` (see :mod:`weights`)."""
    dev = resolve_device(device)
    return HandNet(cfg, mano_right, mano_left).eval().to(dev)
