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
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from obman_train_tpu_torch.assets.mano_assets import ManoAssets
from obman_train_tpu_torch.models.mano import ManoLayer, mano_forward
from obman_train_tpu_torch.models.resnet import BatchNorm1d

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


def _bn1d(c: int) -> BatchNorm1d:
    return BatchNorm1d(c, eps=1e-5, momentum=0.1)


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

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int = 3):
        super().__init__()
        layers = []
        for h in hidden:
            layers += [nn.Linear(in_dim, h), nn.ReLU()]
            in_dim = h
        self.decoder = nn.Sequential(*layers)
        self.final_layer = nn.Linear(in_dim, out_dim)

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
            layers += [nn.Linear(inp, out), nn.ReLU()]
        self.base_layer = nn.Sequential(*layers)
        pose_size = (ncomps + 3) if use_pca else 16 * 9
        self.pose_reg = nn.Linear(neurons[-1], pose_size)
        self.shape_reg = (
            nn.Sequential(nn.Linear(neurons[-1], 10)) if use_shape else None
        )
        self.trans_reg = nn.Linear(neurons[-1], 3) if use_trans else None
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

        # MANO runs in at least float32 whatever the encoder's dtype (JAX
        # :130-142); a float64 net (a reference run on the CPU) keeps float64
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
                 use_tanh: bool = False):
        super().__init__()
        b = bottleneck_size
        self.conv1 = nn.Conv1d(b, b, 1)
        self.conv2 = nn.Conv1d(b, b // 2, 1)
        self.conv3 = nn.Conv1d(b // 2, b // 4, 1)
        self.conv4 = nn.Conv1d(b // 4, 3, 1)
        self.bn1 = _bn1d(b)
        self.bn2 = _bn1d(b // 2)
        self.bn3 = _bn1d(b // 4)
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
                 out_factor: float = 1.0, residual: bool = True):
        super().__init__()
        self.conv1 = nn.Conv1d(in_size, res_size, 1)
        self.conv2 = nn.Conv1d(res_size, res_size, 1)
        self.conv3 = nn.Conv1d(res_size, 3, 1)
        self.bn1 = _bn1d(res_size)
        self.bn2 = _bn1d(res_size)
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
                 out_factor: float = 200.0):
        super().__init__()
        self.residual1 = DecoderBlock(bottleneck_size, res_size, 1.0, True)
        self.residual2 = DecoderBlock(bottleneck_size, res_size, 1.0, True)
        self.residual3 = DecoderBlock(bottleneck_size, res_size, 1.0, False)
        self.out_factor = out_factor

    def forward(self, x):  # (B, C, N) -> (B, 3, N)
        features = x[:, 3:]
        y = self.residual1(x)
        y = self.residual2(torch.cat([y, features], dim=1))
        y = self.residual3(torch.cat([y, features], dim=1))
        return self.out_factor * y


class AtlasBranch(nn.Module):
    """Object decoder (reference: atlasbranch.py:13-150), inference on the
    icosphere template ``test_verts``; the decode_scale final bias starts
    at 1 (atlasbranch.py:61)."""

    def __init__(
        self,
        bottleneck_size: int,
        test_verts: np.ndarray,
        use_residual: bool = False,
        use_tanh: bool = False,
        out_factor: float = 200.0,
        predict_trans: bool = False,
        predict_scale: bool = False,
        separate_encoder: bool = False,
    ):
        super().__init__()
        if use_residual:
            self.decoder = PointGenConResidual(3 + bottleneck_size,
                                               out_factor=out_factor)
        else:
            self.decoder = PointGenCon(3 + bottleneck_size, out_factor, use_tanh)
        half = bottleneck_size // 2
        self.decode_trans = (
            nn.Sequential(nn.Linear(bottleneck_size, half), nn.ReLU(),
                          nn.Linear(half, 3))
            if predict_trans else None
        )
        self.decode_scale = (
            nn.Sequential(nn.Linear(bottleneck_size, half), nn.ReLU(),
                          nn.Linear(half, 1))
            if predict_scale else None
        )
        if predict_scale:
            with torch.no_grad():
                self.decode_scale[2].bias.fill_(1.0)
        self.separate_encoder = separate_encoder
        self.register_buffer(
            "test_verts",
            torch.from_numpy(np.asarray(test_verts, np.float32).copy()),
            persistent=False,
        )

    def forward_inference(
        self,
        img_features: torch.Tensor,
        separate_encoder_features: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Mesh mode on the icosphere template (reference atlasbranch.py:110-150)."""
        B = img_features.shape[0]
        dec_feats = (
            separate_encoder_features if self.separate_encoder else img_features
        )
        V = self.test_verts.shape[0]
        grid = self.test_verts.t().to(dec_feats.dtype).expand(B, 3, V)
        tiled = dec_feats[:, :, None].expand(B, dec_feats.shape[1], V)
        verts = self.decoder(torch.cat([grid, tiled], dim=1)).transpose(1, 2).contiguous()

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
