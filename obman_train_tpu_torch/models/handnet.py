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
NCHW once. A uint8 batch that carries ``aug_factors``/``aug_order`` (the
loader's ``--device_augment``) is colour-jittered after /255 and before
-0.5, where the JAX package does it (handnet.py:137-149). Branch gating is static, from the config and a
:class:`BatchSpec`, as in the JAX package. The module's mode is the JAX
``train`` flag: ``eval()`` is ``train=False`` (BN on its running
statistics, no dropout; frozen-BN training is ``eval()`` with gradients
on), ``train()`` is ``train=True`` (BN on batch statistics with flax's
running-statistics update, dropout on, its mask from ``dropout_gen``). The
contact block and the losses do not depend on the mode.

``compute_dtype="bfloat16"`` builds the encoders, the adapter and every head
to compute in bf16 on float32 parameters (JAX handnet.py:72-120); the
encoder features are cast back to float32 (JAX :151, :159), MANO and the
geometry stay float32, and the atlas outputs are bf16, promoted by the
losses as ``jnp`` promotes them. ``geometry_dtype`` picks the selection
plane of the Chamfer and contact nearest neighbours
(:func:`~obman_train_tpu_torch.ops.chamfer.plane_dtype_for`).
``atlas.mesh=False`` decodes a random unit-sphere cloud instead of the
icosphere template (JAX :246-260), its points drawn from ``points_gen``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

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
from obman_train_tpu_torch.models.resnet import (
    Linear,
    _FlaxTrainBN,
    compute_dtype,
    resnet18,
    resnet50,
)
from obman_train_tpu_torch.ops.chamfer import min_sqdist_to, plane_dtype_for
from obman_train_tpu_torch.ops.contact import ContainsFn, compute_contact_loss
from obman_train_tpu_torch.ops.image import batched_color_jitter
from obman_train_tpu_torch.ops.mesh import meshiou
from obman_train_tpu_torch.utils.tracing import span


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
        dtype = compute_dtype(cfg.compute_dtype)
        self.plane_dtype = plane_dtype_for(cfg.geometry_dtype)
        if not cfg.atlas.mesh and cfg.need_collisions:
            raise ValueError("the contact block needs the icosphere mesh (atlas.mesh="
                             "True): the random cloud has no faces")
        self.cfg = cfg
        feat = cfg.img_feature_size
        make_resnet = {18: resnet18, 50: resnet50}[int(cfg.resnet_version)]
        self.base_net = make_resnet(dtype)
        self.atlas_base_net = make_resnet(dtype) if cfg.atlas.separate_encoder else None
        if cfg.sync_bn:
            # the encoders' BNs carry the data axis (JAX :77-80 bn_axis_name):
            # the SyncBN step synchronizes them, not the atlas decoder's
            for enc in (self.base_net, self.atlas_base_net):
                for m in enc.modules() if enc is not None else ():
                    if isinstance(m, _FlaxTrainBN):
                        m.axis_synced = True
        self.atlas_adapter = (
            Linear(feat, feat, compute_dtype=dtype) if cfg.atlas.adapt_decoder else None
        )
        self.absolute_branch = (
            AbsoluteBranch(feat + 3, (feat // 2,), 3, dtype)
            if (cfg.absolute_lambda or cfg.mano.lambda_joints2d) else None
        )
        self.scaletrans_branch = (
            AbsoluteBranch(feat, (feat // 2,), 3, dtype) if cfg.mano.lambda_joints2d
            else None
        )
        m = cfg.mano
        self.mano_branch = ManoBranch(
            mano_right, mano_left, in_features=feat, ncomps=m.ncomps,
            base_neurons=tuple(m.base_neurons), center_idx=m.center_idx,
            use_shape=m.use_shape, use_trans=m.use_trans, use_pca=m.use_pca,
            adapt_skeleton=m.adapt_skeleton, dropout=cfg.fc_dropout, dtype=dtype,
        )
        ico_verts, ico_faces = icosphere(cfg.atlas.ico_divisions)
        a = cfg.atlas
        self.atlas_branch = AtlasBranch(
            feat, ico_verts, use_residual=a.use_residual, points_nb=a.points_nb,
            use_tanh=a.use_tanh, out_factor=a.out_factor,
            predict_trans=a.predict_trans, predict_scale=a.predict_scale,
            separate_encoder=a.separate_encoder, dtype=dtype,
        )
        self.ico_faces_np = np.asarray(ico_faces)
        self.register_buffer(
            "ico_faces", torch.from_numpy(ico_faces.astype(np.int64)),
            persistent=False,
        )
        # the edge regularizer's faces: the template's; on the random cloud
        # the JAX package gathers the same faces from the cloud's points,
        # its out-of-range indices clamped by jnp's gather (handnet.py:314,
        # branches.py:312-328), and the port computes the same loss
        self.register_buffer(
            "loss_faces",
            self.ico_faces if a.mesh else self.ico_faces.clamp(max=a.points_nb - 1),
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
        contact: bool = True,
        dropout_gen: Optional[torch.Generator] = None,
        points_gen: Optional[torch.Generator] = None,
        feature_probe: Optional[torch.Tensor] = None,
        encoder: Optional[Callable[[nn.Module, torch.Tensor], Tuple[torch.Tensor, Any]]] = None,
    ) -> Tuple[Optional[torch.Tensor], Dict[str, Any], Dict[str, Any]]:
        """Returns ``(total_loss, results, losses)`` like the JAX
        ``HandNet.__call__`` with ``train=False``. ``regul_scale``
        multiplies the edge and Laplacian weights (the per-epoch regul
        decay). ``contains`` replaces the contact block's exterior test (a
        test hook; the default is the CUDA kernel path). ``contact=False``
        with ``no_loss=True`` leaves out the contact block: the demo path
        reads none of its outputs, and the JAX package's jitted demo program
        drops it as dead code (demo/inference.py:95-99). ``dropout_gen``
        draws the MANO MLP's dropout masks in ``train()`` with
        ``fc_dropout > 0``. ``points_gen`` draws the random-cloud decoder's
        sphere points (``atlas.mesh=False``); without one they are the
        points of seed 0, as the JAX eval step's ``PRNGKey(0)``.
        ``feature_probe`` (B, feature size) is added to the image features:
        a zero probe whose gradient is the features' gradient
        (``train/debug.py``, JAX :152-156). ``encoder(net, images)`` replaces
        the call ``net(images)`` of each encoder on the NCHW images:
        ``base_net``, and ``atlas_base_net`` where ``atlas.separate_encoder``
        (the folded encoders of the serving path, ``demo.inference.ServeNet``,
        and of the frozen-BN train step, ``train.steps.fold_encoder``)."""
        if not contact and not no_loss:
            raise ValueError("contact=False needs no_loss=True: the losses read the block")
        cfg = self.cfg
        total_loss = None
        results: Dict[str, Any] = {}
        losses: Dict[str, Any] = {}

        with span("handnet.encoder"):
            image = batch["images"]
            if not torch.is_floating_point(image):
                # uint8 pipeline: x/255 - 0.5 = to_tensor + normalize
                # (handataset.py:385-407)
                image = image.to(torch.float32) / 255.0
                if "aug_factors" in batch:
                    # device-side colour jitter; the host drew the factors
                    image = batched_color_jitter(
                        image, batch["aug_factors"], batch["aug_order"])
                image = image - 0.5
            image = image.permute(0, 3, 1, 2)  # NHWC -> NCHW view
            # the features in at least float32 (JAX :151, :159); a float64 net
            # (a reference copy on the CPU) keeps float64
            encode = encoder or _call_encoder
            features = _at_least_f32(encode(self.base_net, image)[0])
            if feature_probe is not None:
                features = features + feature_probe
            if cfg.atlas.separate_encoder:
                with span("handnet.atlas_encoder"):
                    atlas_infeatures = _at_least_f32(encode(self.atlas_base_net, image)[0])
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
            with span("handnet.mano"):
                mano_results = self.mano_branch(
                    features,
                    sides=batch["sides"],
                    root_palm=spec.root_palm,
                    use_stereoshape=spec.use_stereoshape,
                    dropout_gen=dropout_gen,
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
            with span("handnet.atlas"):
                if cfg.atlas.mesh:
                    atlas_features = (
                        self.atlas_adapter(features) if cfg.atlas.adapt_decoder
                        else features
                    )
                    atlas_results = self.atlas_branch.forward_inference(
                        atlas_features,
                        separate_encoder_features=(
                            atlas_infeatures if cfg.atlas.separate_encoder else None
                        ),
                    )
                    atlas_results["objfaces"] = self.ico_faces_np
                else:
                    if points_gen is None:
                        points_gen = torch.Generator(device=features.device).manual_seed(0)
                    atlas_results = self.atlas_branch(features, generator=points_gen)

            if contact and cfg.need_collisions and mano_results is not None:
                with span("handnet.contact"):
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
                        geometry_dtype=cfg.geometry_dtype,
                        contains=contains,
                    )
                    if not no_loss:
                        if spec.has_verts3d and spec.has_objpoints3d:
                            dist_h2o_gt = min_sqdist_to(
                                batch["verts3d"], batch["objpoints3d"],
                                plane_dtype=self.plane_dtype,
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
                with span("handnet.atlas"):
                    atlas_total, atlas_losses = compute_atlas_loss(
                        atlas_results, batch, cfg.atlas,
                        has_objpoints3d=spec.has_objpoints3d,
                        has_center3d=spec.has_center3d,
                        obj_faces=self.loss_faces,
                        laplacian=self.laplacian,
                        regul_scale=regul_scale,
                        geometry_dtype=cfg.geometry_dtype,
                    )
                    total_loss = (
                        atlas_total if total_loss is None else total_loss + atlas_total
                    )
                    losses.update(atlas_losses)

        losses["total_loss"] = total_loss
        return total_loss, results, losses


def _call_encoder(net: nn.Module, image: torch.Tensor):
    return net(image)


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


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
