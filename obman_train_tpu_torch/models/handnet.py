"""HandNet: the top-level multi-branch model, forward and losses
(JAX package: models/handnet.py:41-346; reference handnet.py:20-392).

ResNet encoder -> MANO hand branch and AtlasNet object branch, optional
absolute-position and orthographic scale+trans heads, and, when the config
has contact or collision weights, the contact block (handnet.py:263-278),
which runs even with ``no_loss=True`` and returns ``contact_info``. With
``no_loss=False`` the multi-task losses accumulate into
``(total_loss, results, losses)`` with the JAX package's loss-dict keys and
order, its quirks included: a first absolute loss enters the total
unscaled (handnet.py:182-186), and the contact losses need the MANO branch.

Frames arrive NHWC (uint8 or float) as on the JAX path and are permuted to
NCHW once. Branch gating is static, from the config and a
:class:`BatchSpec`, as in the JAX package. The module runs in ``eval()``
mode only: frozen-BN training (the reference default) is ``eval()`` with
gradients on, the JAX ``train=False``; unfrozen BN is a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from obman_train_tpu_torch.assets.icosphere import icosphere
from obman_train_tpu_torch.assets.laplacian import cotangent_laplacian
from obman_train_tpu_torch.assets.mano_assets import ManoAssets
from obman_train_tpu_torch.config import ModelConfig
from obman_train_tpu_torch.device import DeviceLike, resolve_device
from obman_train_tpu_torch.models.branches import AbsoluteBranch, AtlasBranch, ManoBranch
from obman_train_tpu_torch.models.losses import compute_atlas_loss, compute_mano_loss, mse
from obman_train_tpu_torch.models.resnet import resnet18, resnet50
from obman_train_tpu_torch.ops.chamfer import min_sqdist_to
from obman_train_tpu_torch.ops.contact import ContainsFn, compute_contact_loss
from obman_train_tpu_torch.ops.mesh import meshiou


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
        # dense (V, V) Laplacian of the template, only when its loss is on
        self.register_buffer(
            "laplacian",
            torch.from_numpy(cotangent_laplacian(ico_verts, ico_faces))
            if a.lambda_laplacian else None,
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
        regul_scale=1.0,
        contains: Optional[ContainsFn] = None,
    ) -> Tuple[Optional[torch.Tensor], Dict[str, Any], Dict[str, Any]]:
        """Returns ``(total_loss, results, losses)`` like the JAX
        ``HandNet.__call__`` with ``train=False``. ``regul_scale``
        multiplies the edge and Laplacian weights (the per-epoch regul
        decay). ``contains`` replaces the contact block's exterior test (a
        test hook; the default is the CUDA kernel path)."""
        if self.training:
            raise NotImplementedError(
                "training mode (unfrozen BN, dropout) is not ported; call "
                ".eval(): frozen-BN training is eval() with gradients on"
            )
        cfg = self.cfg
        total_loss = None
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
        supervise_center = bool(
            cfg.absolute_lambda and spec.has_center3d and spec.has_camintrs
        )
        if predict_center:
            intr = batch["camintrs"]
            absolute_input = torch.cat(
                [intr[:, 0:1, 0], intr[:, 0:1, 2], intr[:, 1:2, 2], features], dim=1
            )
            pred_center3d = self.absolute_branch(absolute_input)
            results["center3d"] = pred_center3d
            if not no_loss and supervise_center:
                absolute_loss = mse(pred_center3d, batch["center3d"])
                if total_loss is None:
                    # reference quirk: unscaled when first (handnet.py:248-249)
                    total_loss = absolute_loss
                else:
                    total_loss = total_loss + cfg.absolute_lambda * absolute_loss
                losses["absolute_loss"] = absolute_loss

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
            if not no_loss:
                mano_total, mano_losses = compute_mano_loss(
                    mano_results, batch, cfg.mano,
                    has_verts3d=spec.has_verts3d,
                    has_joints3d=spec.has_joints3d,
                    has_pcas=spec.has_pcas,
                )
                total_loss = (
                    mano_total if total_loss is None else total_loss + mano_total
                )
                losses.update(mano_losses)
            results.update(mano_results)
            if cfg.mano.lambda_joints2d:
                scaletrans = self.scaletrans_branch(features)
                trans = scaletrans[:, 1:]
                scale = torch.abs(scaletrans[:, :1])
                # 100 ~ the scale of 2D joint coordinates (handnet.py:296-301)
                proj = (
                    mano_results["joints"][:, :, :2] * scale[:, None, :]
                    + 100.0 * trans[:, None, :]
                )
                results["joints2d"] = proj
                if not no_loss and spec.has_joints2d:
                    j2d = mse(proj, batch["joints2d"].to(torch.float32))
                    losses["joints2d"] = j2d
                    total_loss = total_loss + cfg.mano.lambda_joints2d * j2d

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
                attr_loss, penetr_loss, contact_infos, contact_metrics = compute_contact_loss(
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
                if not no_loss:
                    if spec.has_verts3d and spec.has_objpoints3d:
                        dist_h2o_gt = min_sqdist_to(
                            batch["verts3d"], batch["objpoints3d"]
                        )
                        contact_ious, contact_auc = meshiou(
                            dist_h2o_gt, contact_infos["min_dists"]
                        )
                        contact_infos["batch_ious"] = contact_ious
                        losses["contact_auc"] = contact_auc
                    contact_loss = (
                        c.contact_lambda * attr_loss
                        + c.collision_lambda * penetr_loss
                    )
                    total_loss = total_loss + contact_loss
                    losses["penetration_loss"] = penetr_loss
                    losses["attraction_loss"] = attr_loss
                    losses["contact_loss"] = contact_loss
                    losses.update(contact_metrics)
                results["contact_info"] = contact_infos

            results.update(atlas_results)
            if not no_loss:
                atlas_total, atlas_losses = compute_atlas_loss(
                    atlas_results, batch, cfg.atlas,
                    has_objpoints3d=spec.has_objpoints3d,
                    has_center3d=spec.has_center3d,
                    obj_faces=self.ico_faces,
                    laplacian=self.laplacian,
                    regul_scale=regul_scale,
                )
                total_loss = (
                    atlas_total if total_loss is None else total_loss + atlas_total
                )
                losses.update(atlas_losses)

        losses["total_loss"] = total_loss
        return total_loss, results, losses


def build_handnet(
    cfg: ModelConfig,
    mano_right: ManoAssets,
    mano_left: ManoAssets,
    device: DeviceLike = None,
) -> HandNet:
    """Construct HandNet in eval mode on ``device`` (default CUDA; raises
    without a GPU unless ``device="cpu"``), with the template's Laplacian
    when ``cfg.atlas.lambda_laplacian`` is set. Weights are PyTorch's
    default init: load real ones with ``load_state_dict`` (see
    :mod:`weights`)."""
    dev = resolve_device(device)
    return HandNet(cfg, mano_right, mano_left).eval().to(dev)
