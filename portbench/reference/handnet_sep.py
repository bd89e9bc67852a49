"""Plain float32 reference of the ObMan hand-object network with its object
branch on an encoder of its own, at ResNet-50 widths (Hasson et al.,
CVPR 2019, arXiv:1904.05767; the release's ``--atlas_separate_encoder
--resnet_version 50 --mano_use_shape``): two ResNet-50 encoders (He et
al., arXiv:1512.03385), one for the hand and one for the object; the MANO
branch from the hand encoder's 2048 features, with its shape head and the
shape blend; the AtlasNet sphere decoder fed the object encoder's
features (3 + 2048 = 2051 wide); the translation and scale heads.

Plain ``torch`` (``F.conv2d``, ``F.linear``, ``F.batch_norm`` on running
statistics), float32, run with TF32 off by the checks. It imports nothing
of the program under test; from ``reference/handnet.py`` it takes what is
the same at either width: the MANO tables and their quaternion Rodrigues
chain, the batch norm, the icosphere and the demo preprocessing.

Departures from the published description, each as the release and the
program have it:

- the bottleneck's stride sits on its 3x3 convolution (torchvision's
  layout), where He et al. put it on the first 1x1;
- the translation and scale heads read the hand encoder's features; only
  the point decoder reads the object encoder's (the release's
  ``atlasbranch.py`` ``forward_inference``);
- the weights are drawn from a seed, not ImageNet's or a hand
  checkpoint's (``--atlas_resume``), and the MANO tables are synthetic.

Parameters are a flat dict ``name -> tensor`` under the release
checkpoint's names (``base_net.layer1.0.conv3.weight``,
``atlas_base_net.layer4.0.downsample.1.running_var``,
``mano_branch.shape_reg.0.weight``, ...); :func:`param_specs` lists them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import handnet as ref

# ResNet-50: (width, bottleneck blocks, stride of the first) per stage
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
EXPANSION = 4
FEAT = STAGES[-1][0] * EXPANSION  # 2048
ENCODERS = ("base_net", "atlas_base_net")


def _encoder_specs(prefix: str) -> List[Tuple]:
    specs: List[Tuple] = [(f"{prefix}.conv1.weight", (64, 3, 7, 7), "lecun")]
    specs += ref._bn_specs(f"{prefix}.bn1", 64)
    cin = 64
    for s, (width, blocks, _) in enumerate(STAGES, start=1):
        out = width * EXPANSION
        for b in range(blocks):
            p = f"{prefix}.layer{s}.{b}"
            specs.append((f"{p}.conv1.weight", (width, cin, 1, 1), "lecun"))
            specs += ref._bn_specs(f"{p}.bn1", width)
            specs.append((f"{p}.conv2.weight", (width, width, 3, 3), "lecun"))
            specs += ref._bn_specs(f"{p}.bn2", width)
            specs.append((f"{p}.conv3.weight", (out, width, 1, 1), "lecun"))
            specs += ref._bn_specs(f"{p}.bn3", out)
            if b == 0:  # every stage's first block changes width (and stride)
                specs.append((f"{p}.downsample.0.weight", (out, cin, 1, 1), "lecun"))
                specs += ref._bn_specs(f"{p}.downsample.1", out)
            cin = out
    return specs


def param_specs(cfg: Dict) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, init)`` of every tensor of the model's state, as
    ``reference.handnet.param_specs`` gives them."""
    if int(cfg["resnet_version"]) != 50 or not cfg["atlas"]["separate_encoder"]:
        raise ValueError("this reference is the separate-encoder ResNet-50 network")
    specs = _encoder_specs("base_net") + _encoder_specs("atlas_base_net")
    mano = cfg["mano"]
    neurons = [FEAT, *mano["base_neurons"]]
    for i, (a, b) in enumerate(zip(neurons[:-1], neurons[1:])):
        specs += [(f"mano_branch.base_layer.{2 * i}.weight", (b, a), "lecun"),
                  (f"mano_branch.base_layer.{2 * i}.bias", (b,), "zero")]
    pose = mano["ncomps"] + 3
    specs += [("mano_branch.pose_reg.weight", (pose, neurons[-1]), "lecun"),
              ("mano_branch.pose_reg.bias", (pose,), "zero")]
    if mano["use_shape"]:
        specs += [("mano_branch.shape_reg.0.weight", (10, neurons[-1]), "lecun"),
                  ("mano_branch.shape_reg.0.bias", (10,), "zero")]
    bott = FEAT + 3
    widths = [bott, bott, bott // 2, bott // 4, 3]
    for i in range(4):
        specs += [(f"atlas_branch.decoder.conv{i + 1}.weight", (widths[i + 1], widths[i], 1), "lecun"),
                  (f"atlas_branch.decoder.conv{i + 1}.bias", (widths[i + 1],), "zero")]
    for i in range(3):
        specs += ref._bn_specs(f"atlas_branch.decoder.bn{i + 1}", widths[i + 1])
    atlas = cfg["atlas"]
    for head, out, flag in (("decode_trans", 3, "predict_trans"), ("decode_scale", 1, "predict_scale")):
        if atlas[flag]:
            specs += [(f"atlas_branch.{head}.0.weight", (FEAT // 2, FEAT), "lecun"),
                      (f"atlas_branch.{head}.0.bias", (FEAT // 2,), "zero"),
                      (f"atlas_branch.{head}.2.weight", (out, FEAT // 2), "lecun"),
                      # the scale head's last bias starts at 1 (atlasbranch.py:61)
                      (f"atlas_branch.{head}.2.bias", (out,), "one" if head == "decode_scale" else "zero")]
    return specs


class Model(ref.Model):
    """The reference network: ``reference.handnet.Model``'s tables and MANO
    chain, with bottleneck encoders, the shape blend and the separate
    object encoder."""

    def encode(self, p, x: torch.Tensor, prefix: str = "base_net") -> torch.Tensor:
        """NCHW float images -> (B, 2048) pooled features of the encoder
        ``prefix``."""
        x = F.conv2d(x, p[f"{prefix}.conv1.weight"], stride=2, padding=3)
        x = F.relu(self._bn(p, f"{prefix}.bn1", x))
        x = F.max_pool2d(x, 3, 2, 1)
        for s, (_, blocks, stride) in enumerate(STAGES, start=1):
            for b in range(blocks):
                q = f"{prefix}.layer{s}.{b}"
                st = stride if b == 0 else 1
                y = F.relu(self._bn(p, f"{q}.bn1", F.conv2d(x, p[f"{q}.conv1.weight"])))
                y = F.relu(self._bn(p, f"{q}.bn2",
                                    F.conv2d(y, p[f"{q}.conv2.weight"], stride=st, padding=1)))
                y = self._bn(p, f"{q}.bn3", F.conv2d(y, p[f"{q}.conv3.weight"]))
                if b == 0:
                    x = self._bn(p, f"{q}.downsample.1",
                                 F.conv2d(x, p[f"{q}.downsample.0.weight"], stride=st))
                x = F.relu(y + x)
        return x.mean(dim=(2, 3))

    def mano_forward(self, t: Dict[str, torch.Tensor], pose: torch.Tensor,
                     betas: Optional[torch.Tensor] = None):
        """``reference.handnet.Model.mano_forward`` on the shaped template:
        with ``betas`` (B, 10) the template is ``v_template + shapedirs .
        betas`` per sample, before the joint regression and the pose blend."""
        if betas is not None:
            t = dict(t, v_template=t["v_template"] + torch.einsum("vds,bs->bvd", t["shapedirs"], betas))
        return super().mano_forward(t, pose)

    def forward(self, p: Dict[str, torch.Tensor], images: torch.Tensor, sides: torch.Tensor):
        """NHWC images already normalized (x/255 - 0.5) and sides (0 right,
        1 left) -> the predictions the program returns."""
        x = images.permute(0, 3, 1, 2)
        feats, obj_feats = (self.encode(p, x, prefix) for prefix in ENCODERS)
        h = feats
        for i in range(len(self.cfg["mano"]["base_neurons"])):
            h = F.relu(F.linear(h, p[f"mano_branch.base_layer.{2 * i}.weight"],
                                p[f"mano_branch.base_layer.{2 * i}.bias"]))
        pose = F.linear(h, p["mano_branch.pose_reg.weight"], p["mano_branch.pose_reg.bias"])
        betas = (F.linear(h, p["mano_branch.shape_reg.0.weight"], p["mano_branch.shape_reg.0.bias"])
                 if self.cfg["mano"]["use_shape"] else None)
        vr, jr = self.mano_forward(self.mano["right"], pose, betas)
        vl, jl = self.mano_forward(self.mano["left"], pose, betas)
        right = (sides == 0)[:, None, None]
        out = {"verts": torch.where(right, vr, vl), "joints": torch.where(right, jr, jl)}

        B, V = obj_feats.shape[0], self.template.shape[0]
        grid = self.template.t().expand(B, 3, V)
        y = torch.cat([grid, obj_feats[:, :, None].expand(B, FEAT, V)], dim=1)
        for i in range(1, 4):
            y = F.conv1d(y, p[f"atlas_branch.decoder.conv{i}.weight"],
                         p[f"atlas_branch.decoder.conv{i}.bias"])
            y = F.relu(self._bn(p, f"atlas_branch.decoder.bn{i}", y))
        y = F.conv1d(y, p["atlas_branch.decoder.conv4.weight"], p["atlas_branch.decoder.conv4.bias"])
        verts = (self.cfg["atlas"]["out_factor"] * y).transpose(1, 2)

        def head(name):
            z = F.relu(F.linear(feats, p[f"atlas_branch.{name}.0.weight"], p[f"atlas_branch.{name}.0.bias"]))
            return F.linear(z, p[f"atlas_branch.{name}.2.weight"], p[f"atlas_branch.{name}.2.bias"])

        scale = head("decode_scale")
        trans = head("decode_trans")
        out.update(objscale=scale, objtrans=trans, objpointscentered3d=verts,
                   objpoints3d=scale[:, None, :] * verts + trans[:, None, :])
        return out
