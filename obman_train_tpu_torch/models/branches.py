"""Model branches: MANO hand branch, AtlasNet object decoder, absolute head
(JAX package: models/branches.py).

Module names follow the reference torch HandNet (manobranch.py,
atlasbranch.py, atlasutils.py, absolutebranch.py) so the state_dict keys
are the release checkpoints' keys: ``base_layer.{0,2}``, ``pose_reg``,
``decoder.conv{i}``/``bn{i}``, ``decode_trans.{0,2}``, ``decoder.0`` and
``final_layer``, and so on.

- Both MANO sides run on the full batch and a per-sample ``where`` picks
  one (JAX branches.py:169-171): static shapes, no sub-batches.
- PointGenCon is the reference's Conv1d(k=1) + BatchNorm1d stack over
  points, in (B, C, N) layout; in ``train()`` its BN normalizes over B x N
  with flax's statistics (``resnet.BatchNorm1d``).
- The MANO base MLP puts a :class:`Dropout` before each Linear (JAX
  branches.py:49-64), active in ``train()`` only, its mask drawn from the
  ``torch.Generator`` the caller passes.
- ``dtype`` is the compute dtype of every Linear, Conv1d and BatchNorm1d
  (JAX ``dtype=`` on each ``nn.Dense``/``nn.BatchNorm``; see
  :mod:`~obman_train_tpu_torch.models.resnet`); None computes in the
  parameters' own dtype. Mixed operands promote as ``jnp`` promotes them:
  the template (bf16) beside float32 features concatenates to float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from obman_train_tpu_torch.assets.mano_assets import ManoAssets
from obman_train_tpu_torch.models.mano import ManoLayer, mano_forward
from obman_train_tpu_torch.models.resnet import BatchNorm1d, Conv1d, Linear

# Hard-coded StereoHands shape coefficients (reference: manobranch.py:34-47).
STEREO_SHAPE = np.array(
    [
        -0.00298099, -0.0013994, -0.00840144, 0.00362311, 0.00248761,
        0.00044125, 0.00381337, -0.00183374, -0.00149655, 0.00137479,
    ],
    dtype=np.float32,
)

SIDE_RIGHT = 0
SIDE_LEFT = 1


def _bn1d(c: int, dtype: Optional[torch.dtype] = None) -> BatchNorm1d:
    return BatchNorm1d(c, eps=1e-5, momentum=0.1, compute_dtype=dtype)


def _conv1d(cin: int, cout: int, dtype: Optional[torch.dtype]) -> Conv1d:
    return Conv1d(cin, cout, 1, compute_dtype=dtype)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in ``train()`` each entry is kept with
    probability 1 - p and the kept ones are scaled by 1/(1 - p); in
    ``eval()`` the identity. The mask comes from ``generator`` (the train
    step seeds one from the run's seed and the update count), never from
    torch's global generator."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError("dropout in train() needs an explicit torch.Generator")
        keep_prob = 1.0 - self.p
        u = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        return torch.where(u < keep_prob, x / keep_prob, torch.zeros_like(x))


def adapt_skeleton(weight: torch.Tensor, joints: torch.Tensor) -> torch.Tensor:
    """Learned 21x21 joint mixing (reference manobranch.py:183-191)."""
    return torch.einsum("jk,bkd->bjd", weight, joints)


class AbsoluteBranch(nn.Module):
    """Tiny MLP head (reference: absolutebranch.py:4-20): ``decoder`` is
    Linear+ReLU pairs, then ``final_layer``."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        layers = []
        for h in hidden:
            layers += [Linear(in_dim, h, compute_dtype=dtype), nn.ReLU()]
            in_dim = h
        self.decoder = nn.Sequential(*layers)
        self.final_layer = Linear(in_dim, out_dim, compute_dtype=dtype)

    def forward(self, x):
        return self.final_layer(self.decoder(x))


class ManoBranch(nn.Module):
    """MLP + pose/shape/trans heads + both MANO sides
    (reference: manobranch.py:11-218)."""

    def __init__(
        self,
        mano_right: ManoAssets,
        mano_left: ManoAssets,
        in_features: int,
        ncomps: int = 6,
        base_neurons: Sequence[int] = (1024, 256),
        center_idx: Optional[int] = 9,
        use_shape: bool = False,
        use_trans: bool = False,
        use_pca: bool = True,
        adapt_skeleton: bool = False,
        dropout: float = 0.0,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.ncomps = ncomps
        self.center_idx = center_idx
        self.use_pca = use_pca
        layers = []
        neurons = [in_features, *base_neurons]
        for inp, out in zip(neurons[:-1], neurons[1:]):
            if dropout:
                layers.append(Dropout(dropout))
            layers += [Linear(inp, out, compute_dtype=dtype), nn.ReLU()]
        self.base_layer = nn.Sequential(*layers)
        pose_size = (ncomps + 3) if use_pca else 16 * 9
        self.pose_reg = Linear(neurons[-1], pose_size, compute_dtype=dtype)
        self.shape_reg = (
            nn.Sequential(Linear(neurons[-1], 10, compute_dtype=dtype))
            if use_shape else None
        )
        self.trans_reg = (Linear(neurons[-1], 3, compute_dtype=dtype)
                          if use_trans else None)
        if adapt_skeleton:
            self.right_skeleton_reg = nn.Linear(21, 21, bias=False)
            self.left_skeleton_reg = nn.Linear(21, 21, bias=False)
        else:
            self.right_skeleton_reg = self.left_skeleton_reg = None
        self.mano_layer_right = ManoLayer(mano_right)
        self.mano_layer_left = ManoLayer(mano_left)
        self.register_buffer(
            "stereo_shape", torch.from_numpy(STEREO_SHAPE.copy()), persistent=False
        )

    def forward(
        self,
        features: torch.Tensor,
        sides: torch.Tensor,
        root_palm: bool = False,
        use_stereoshape: bool = False,
        dropout_gen: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        B = features.shape[0]
        base = features
        for layer in self.base_layer:
            base = layer(base, dropout_gen) if isinstance(layer, Dropout) else layer(base)
        pose = self.pose_reg(base)
        mano_pose = pose if self.use_pca else pose.reshape(B, 16, 3, 3)

        if use_stereoshape:
            shape = self.stereo_shape.expand(B, 10)
        elif self.shape_reg is not None:
            shape = self.shape_reg(base)
        else:
            shape = None
        trans = self.trans_reg(base) if self.trans_reg is not None else None

        # MANO runs in at least float32 whatever the heads' dtype (JAX
        # :140-151): pose, shape and trans are cast before it; a float64 net
        # (a reference run on the CPU) keeps float64
        geo = torch.promote_types(features.dtype, torch.float32)
        kw = dict(
            betas=None if shape is None else shape.to(geo),
            trans=None if trans is None else trans.to(geo),
            use_pca=self.use_pca,
            ncomps=self.ncomps,
            center_idx=self.center_idx,
            root_palm=root_palm,
        )
        mano_pose = mano_pose.to(geo)
        verts_r, joints_r = mano_forward(self.mano_layer_right, mano_pose, **kw)
        verts_l, joints_l = mano_forward(self.mano_layer_left, mano_pose, **kw)

        if self.right_skeleton_reg is not None:
            joints_r = adapt_skeleton(self.right_skeleton_reg.weight, joints_r)
            joints_l = adapt_skeleton(self.left_skeleton_reg.weight, joints_l)

        is_right = (sides == SIDE_RIGHT)[:, None, None]
        results = {
            "verts": torch.where(is_right, verts_r, verts_l),
            "joints": torch.where(is_right, joints_r, joints_l),
            "shape": shape,
            "pose": pose,
        }
        if trans is not None:
            results["trans"] = trans
        return results


class PointGenCon(nn.Module):
    """AtlasNet point decoder: 4 per-point layers with BN+ReLU, output
    scaled by ``out_factor`` (reference: atlasutils.py:42-75)."""

    def __init__(self, bottleneck_size: int, out_factor: float = 200.0,
                 use_tanh: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        b = bottleneck_size
        self.conv1 = _conv1d(b, b, dtype)
        self.conv2 = _conv1d(b, b // 2, dtype)
        self.conv3 = _conv1d(b // 2, b // 4, dtype)
        self.conv4 = _conv1d(b // 4, 3, dtype)
        self.bn1 = _bn1d(b, dtype)
        self.bn2 = _bn1d(b // 2, dtype)
        self.bn3 = _bn1d(b // 4, dtype)
        self.out_factor = out_factor
        self.use_tanh = use_tanh

    def forward(self, x):  # (B, C, N) -> (B, 3, N)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        x = torch.relu(self.bn3(self.conv3(x)))
        x = self.conv4(x)
        if self.use_tanh:
            x = torch.tanh(x)
        return self.out_factor * x


class DecoderBlock(nn.Module):
    """Residual decoder block (reference: atlasutils.py:78-103)."""

    def __init__(self, in_size: int, res_size: int = 256,
                 out_factor: float = 1.0, residual: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = _conv1d(in_size, res_size, dtype)
        self.conv2 = _conv1d(res_size, res_size, dtype)
        self.conv3 = _conv1d(res_size, 3, dtype)
        self.bn1 = _bn1d(res_size, dtype)
        self.bn2 = _bn1d(res_size, dtype)
        self.out_factor = out_factor
        self.residual = residual

    def forward(self, x):  # (B, C, N) -> (B, 3, N)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.conv3(y)
        if self.residual:
            y = y + x[:, :3] * self.out_factor
        return y


class PointGenConResidual(nn.Module):
    """3 DecoderBlocks with coordinate-residual connections
    (reference: atlasutils.py:106-149)."""

    def __init__(self, bottleneck_size: int, res_size: int = 256,
                 out_factor: float = 200.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.residual1 = DecoderBlock(bottleneck_size, res_size, 1.0, True, dtype)
        self.residual2 = DecoderBlock(bottleneck_size, res_size, 1.0, True, dtype)
        self.residual3 = DecoderBlock(bottleneck_size, res_size, 1.0, False, dtype)
        self.out_factor = out_factor

    def forward(self, x):  # (B, C, N) -> (B, 3, N)
        features = x[:, 3:]
        y = self.residual1(x)
        y = self.residual2(torch.cat([y, features], dim=1))
        y = self.residual3(torch.cat([y, features], dim=1))
        return self.out_factor * y


class AtlasBranch(nn.Module):
    """Object decoder (reference: atlasbranch.py:13-150): mesh mode on the
    icosphere template ``test_verts`` (:meth:`forward_inference`) and the
    random-cloud mode of ``atlas.mesh=False`` (:meth:`forward`); the
    decode_scale final bias starts at 1 (atlasbranch.py:61)."""

    def __init__(
        self,
        bottleneck_size: int,
        test_verts: np.ndarray,
        use_residual: bool = False,
        points_nb: int = 600,
        use_tanh: bool = False,
        out_factor: float = 200.0,
        predict_trans: bool = False,
        predict_scale: bool = False,
        separate_encoder: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if use_residual:
            self.decoder = PointGenConResidual(3 + bottleneck_size,
                                               out_factor=out_factor, dtype=dtype)
        else:
            self.decoder = PointGenCon(3 + bottleneck_size, out_factor, use_tanh, dtype)
        half = bottleneck_size // 2
        self.decode_trans = (
            nn.Sequential(Linear(bottleneck_size, half, compute_dtype=dtype), nn.ReLU(),
                          Linear(half, 3, compute_dtype=dtype))
            if predict_trans else None
        )
        self.decode_scale = (
            nn.Sequential(Linear(bottleneck_size, half, compute_dtype=dtype), nn.ReLU(),
                          Linear(half, 1, compute_dtype=dtype))
            if predict_scale else None
        )
        if predict_scale:
            with torch.no_grad():
                self.decode_scale[2].bias.fill_(1.0)
        self.separate_encoder = separate_encoder
        self.points_nb = int(points_nb)
        self.dtype = dtype
        self.register_buffer(
            "test_verts",
            torch.from_numpy(np.asarray(test_verts, np.float32).copy()),
            persistent=False,
        )

    def _decode(self, grid: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
        """grid (B, 3, N) and features (B, C) -> points (B, N, 3); the two
        concatenate with jnp's promotion (JAX :302-306)."""
        B, _, N = grid.shape
        tiled = features[:, :, None].expand(B, features.shape[1], N)
        return self.decoder(torch.cat([grid, tiled], dim=1)).transpose(1, 2).contiguous()

    def forward(
        self,
        img_features: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        points: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Random-cloud mode (JAX :312-328, reference atlasbranch.py:78-108):
        ``points_nb`` normal draws normalised onto the unit sphere, in the
        compute dtype, decoded with the image features. The draws come from
        ``generator`` (the ``jax.random`` stream cannot be reproduced);
        ``points`` (B, N, 3) injects sphere points instead, for tests."""
        B = img_features.shape[0]
        dt = self.dtype or img_features.dtype
        if points is None:
            if generator is None:
                raise ValueError("the random-cloud decoder needs an explicit "
                                 "torch.Generator (or points)")
            rand = torch.randn((B, self.points_nb, 3), generator=generator,
                               device=img_features.device, dtype=dt)
            points = rand / torch.sqrt(torch.sum(rand**2, dim=-1, keepdim=True) + 1e-12)
        verts = self._decode(points.to(dt).transpose(1, 2), img_features)
        if self.decode_trans is not None:
            trans = self.decode_trans(img_features)
            return {
                "objpoints3d": verts + trans[:, None, :],
                "objtrans": trans,
                "objpointscentered3d": verts,
            }
        return {"objpoints3d": verts}

    def forward_inference(
        self,
        img_features: torch.Tensor,
        separate_encoder_features: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Mesh mode on the icosphere template (reference atlasbranch.py:110-150);
        the template is rounded to the compute dtype first (JAX :335-339)."""
        B = img_features.shape[0]
        dec_feats = (
            separate_encoder_features if self.separate_encoder else img_features
        )
        V = self.test_verts.shape[0]
        grid = self.test_verts.t().to(self.dtype or dec_feats.dtype).expand(B, 3, V)
        verts = self._decode(grid, dec_feats)

        results = {}
        if self.decode_scale is not None:
            scales = self.decode_scale(img_features)  # (B, 1)
            verts_out = scales[:, None, :] * verts
            results["objscale"] = scales
        else:
            verts_out = verts
        if self.decode_trans is not None:
            trans = self.decode_trans(img_features)
            results.update(
                objpoints3d=verts_out + trans[:, None, :],
                objtrans=trans,
                objpointscentered3d=verts,
            )
        else:
            results["objpoints3d"] = verts_out
        return results
