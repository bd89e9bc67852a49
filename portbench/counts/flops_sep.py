"""Operation counts of the separate-encoder ResNet-50 network
(``configs/obman_sep_r50.json``), on ``flops.py``'s conventions (a
multiply-add is two operations; every convolution and linear layer, and
MANO's blend shapes and skinning): two ResNet-50 encoders, the MANO MLP
from 2048 features with its shape head and both sides' shape blend, the
AtlasNet decoder at 3 + 2048 and the heads from 2048."""

from __future__ import annotations

from typing import Dict

from portbench.counts.flops import HAND_VERTS, _conv_out, atlas_macs, ico_verts, mano_macs

# (width, bottleneck blocks, stride of the first) per stage
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))
EXPANSION = 4
FEAT = 2048
BETAS = 10


def resnet50_macs(size: int) -> int:
    """Multiply-adds of ResNet-50's convolutions on one ``size``² image (no
    classifier; the stride on the 3x3 convolution): 4.09 G at 224."""
    h = _conv_out(size, 7, 2, 3)
    macs = h * h * 64 * 3 * 49
    h = _conv_out(h, 3, 2, 1)  # max pool
    cin = 64
    for width, blocks, stride in STAGES:
        out = width * EXPANSION
        for b in range(blocks):
            st = stride if b == 0 else 1
            ho = _conv_out(h, 3, st, 1)
            macs += h * h * width * cin + ho * ho * width * width * 9 + ho * ho * out * width
            if b == 0:
                macs += ho * ho * out * cin
            h, cin = ho, out
    return macs


def shape_macs(base_neurons) -> int:
    """The shape head, and the shape blend of both MANO sides."""
    return base_neurons[-1] * BETAS + 2 * HAND_VERTS * 3 * BETAS


def forward_flops(cfg: Dict, image_size: int) -> float:
    """Operations of one sample's served forward (no losses)."""
    m = cfg["mano"]
    macs = (2 * resnet50_macs(image_size) + mano_macs(m["ncomps"], m["base_neurons"], FEAT)
            + (shape_macs(m["base_neurons"]) if m["use_shape"] else 0)
            + atlas_macs(ico_verts(cfg["atlas"]["ico_divisions"]), FEAT))
    return 2.0 * macs
