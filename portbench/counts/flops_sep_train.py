"""Operations of one sample's train step of the separate-encoder ResNet-50
network trained with the contact losses
(``configs/obman_sep_r50_contact.json``), on ``flops.py``'s conventions:
three forwards (``flops_sep.forward_flops``: the forward, and the
backward's two products per layer), plus the losses' geometry once (the
Chamfer and hand-object nearest neighbours and the inside test,
``flops.train_geometry``), as ``flops.train_flops`` counts the ResNet-18
step."""

from __future__ import annotations

from typing import Dict

from portbench.counts import flops, flops_sep


def geometry_flops(cfg: Dict) -> float:
    """The losses' nearest neighbours and inside tests of one sample."""
    geo = flops.train_geometry(cfg)
    return (sum(flops.nn_ops(1, q, p) for q, p, _ in geo["nn"])
            + sum(flops.raytri_ops(1, p, t) for p, t in geo["raytri"]))


def train_flops(cfg: Dict, image_size: int) -> float:
    return 3.0 * flops_sep.forward_flops(cfg, image_size) + geometry_flops(cfg)
