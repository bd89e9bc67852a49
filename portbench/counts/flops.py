"""Operation and byte counts of the work a cell asks for, from its shapes:
the algorithm's work, the same whatever implements it. A multiply-add is
two operations; a comparison that decides a result is one.

- The network: every convolution and linear layer's multiply-adds (the
  encoder, the MANO MLP, the AtlasNet decoder and heads), twice for
  operations; MANO's blend shapes and skinning; the geometry of the
  losses. A training step is three forwards' worth (the forward, and the
  backward's two products per layer), the usual count.
- K1, the inside test: one Möller–Trumbore test per (point, triangle),
  the triangle's own quantities (edges, ``d x e2``, its determinant and
  reciprocal) counted once per triangle: per pair 3 subtractions, the
  ``u`` dot product and scale (6), the ``q = t x e1`` cross product (9),
  the ``v`` and ``t`` dot products and scales (6 + 6), ``u + v`` (1), and
  5 comparisons: 36.
- ``nn_dir``, the nearest neighbour: per (query, point) one squared
  distance (3 subtractions, 3 squares, 2 additions) and one comparison: 9.
- Bytes: each input read once and each output written once.
"""

from __future__ import annotations

import json
import os
from typing import Dict

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")

RAYTRI_OPS_PER_PAIR = 36
# per triangle: edges 6, d x e2 9, its determinant 5, |det| >= tol 1, 1 / (det + eps) 2
RAYTRI_OPS_PER_TRIANGLE = 23
NN_OPS_PER_PAIR = 9
HAND_VERTS, HAND_JOINTS = 778, 21
STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))


def peaks() -> Dict[str, float]:
    with open(PEAKS) as f:
        return json.load(f)


def _conv_out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def resnet18_macs(size: int) -> int:
    """Multiply-adds of ResNet-18's convolutions on one ``size``² image
    (no classifier): 1.81 G at 224."""
    h = _conv_out(size, 7, 2, 3)
    macs = h * h * 64 * 3 * 49
    h = _conv_out(h, 3, 2, 1)  # max pool
    cin = 64
    for width, stride in STAGES:
        for b in range(2):
            st = stride if b == 0 else 1
            ho = _conv_out(h, 3, st, 1)
            macs += ho * ho * width * cin * 9 + ho * ho * width * width * 9
            if b == 0 and (st != 1 or cin != width):
                macs += ho * ho * width * cin
            h, cin = ho, width
    return macs


def atlas_macs(points: int, feat: int = 512) -> int:
    b = feat + 3
    widths = [b, b, b // 2, b // 4, 3]
    decoder = points * sum(widths[i] * widths[i + 1] for i in range(4))
    heads = 2 * feat * (feat // 2) + (feat // 2) * (3 + 1)
    return decoder + heads


def mano_macs(ncomps: int, base_neurons=(1024, 256), feat: int = 512) -> int:
    """The MLP and pose head, then both sides' MANO layer (the branch runs
    both and picks one a sample): PCA, pose blend shapes, regressor,
    skinning."""
    neurons = [feat, *base_neurons]
    mlp = sum(a * b for a, b in zip(neurons[:-1], neurons[1:])) + neurons[-1] * (ncomps + 3)
    layer = (ncomps * 45 + 16 * HAND_VERTS * 3 + HAND_VERTS * 3 * 135
             + HAND_VERTS * 16 * 12 + HAND_VERTS * 12 + 15 * 64)
    return mlp + 2 * layer


def ico_verts(subdivisions: int) -> int:
    return 10 * 4 ** subdivisions + 2


def forward_flops(cfg: Dict, image_size: int) -> float:
    """Operations of one sample's forward (no losses)."""
    macs = (resnet18_macs(image_size) + mano_macs(cfg["mano"]["ncomps"], cfg["mano"]["base_neurons"])
            + atlas_macs(ico_verts(cfg["atlas"]["ico_divisions"])))
    return 2.0 * macs


def raytri_ops(batch: int, points: int, triangles: int) -> float:
    return float(batch) * (points * triangles * RAYTRI_OPS_PER_PAIR + triangles * RAYTRI_OPS_PER_TRIANGLE)


def raytri_bytes(batch: int, points: int, triangles: int) -> float:
    """Points in (3 floats), triangles in (9 floats), a count out (4 bytes)."""
    return float(batch) * (points * 12 + triangles * 36 + points * 4)


def nn_ops(batch: int, queries: int, points: int) -> float:
    return float(batch) * queries * points * NN_OPS_PER_PAIR


def nn_bytes(batch: int, queries: int, points: int, argmin: bool) -> float:
    """Both clouds in, a minimum (and an index) per query out."""
    return float(batch) * ((queries + points) * 12 + queries * (4 + (8 if argmin else 0)))


def train_geometry(cfg: Dict, gt_points: int = 600) -> Dict[str, list]:
    """The geometric queries one contact-config train step asks for, per
    sample, as ``(queries, points, argmin)``: the Chamfer terms (centred
    and final, both directions), the hand-object nearest neighbours (both
    directions), the GT hand-object metric; and the inside test."""
    obj = ico_verts(cfg["atlas"]["ico_divisions"])
    nn = [(gt_points, obj, True), (obj, gt_points, True)] * 2
    tri = []
    if cfg["contact"]["contact_lambda"] or cfg["contact"]["collision_lambda"]:
        nn += [(HAND_VERTS, obj, True), (obj, HAND_VERTS, True), (HAND_VERTS, gt_points, False)]
        tri = [(HAND_VERTS, 20 * 4 ** cfg["atlas"]["ico_divisions"])]
    return {"nn": nn, "raytri": tri}


def train_flops(cfg: Dict, image_size: int) -> float:
    """Operations of one sample's train step: three forwards, plus the
    geometry of the losses once."""
    geo = train_geometry(cfg)
    extra = sum(nn_ops(1, q, p) for q, p, _ in geo["nn"])
    extra += sum(raytri_ops(1, p, t) for p, t in geo["raytri"])
    return 3.0 * forward_flops(cfg, image_size) + extra
