"""The numbers that decide ``correct``: what the timed path produced,
held to the plain reference (``reference/handnet.py``) run on the same
inputs and weights with TF32 off, after the window has closed.

Training: the reference follows the program's first three updates from
the same weights on the same batches, with its own Adam. Compared are

- ``terms``: the first step's total loss and every loss term (the MANO,
  Chamfer, translation, scale, edge and attraction terms, and the mean
  penetration depth over all hand vertices, which holds the inside test),
  each gap over its own reference value, or over a millionth of the total
  loss for a term that reads 0. The later steps' losses and the repulsion
  term are read but not compared: after one Adam update the two sides'
  weights part where rounding decides a gradient's sign, and the
  repulsion term, a mean over the penetrating vertices alone, jumps by
  1/count when a vertex within rounding of the surface changes sides
  (PERF.md gives their readings);
- ``grad``: the first gradient, as the optimizer got it (from Adam's
  first moment after one update), leaf by leaf: the gap between the two
  norms over the reference leaf's norm or the median leaf's, whichever is
  larger; the median over the leaves (the worst leaf swings from seed to
  seed with the TF32 rounding of the first convolutions' weight
  gradients; PERF.md gives both readings);
- ``joints`` (the train step): the first step's predicted joints, which
  the step returns as the epoch loop asks it to, row by row against the
  reference's forward, as ``outputs`` below;
- ``change``: the parameters' change over the three updates, the same gap,
  the worst leaf, over the leaves whose reference gradient is a
  thousandth of the median leaf's or more (a gradient that is nought to
  rounding moves a leaf under Adam by rounding alone).

Serving: ``outputs`` is the worst gap of any predicted vertex, joint,
object point, translation or scale, as a share of that output's largest
reference magnitude, over the sampled calls.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import handnet as ref

BETAS, EPS = (0.9, 0.999), 1e-8
# leaves whose reference gradient is below this share of the median leaf's
# are left out of ``change``
ROUNDING_ONLY = 1e-3
# a loss term that reads 0 (no penetration) is held against this share of
# the total loss
TERM_FLOOR = 1e-6


@contextlib.contextmanager
def tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def to_device(batch: Dict[str, np.ndarray], device: str) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def follow_training(model: ref.Model, weights: Dict[str, torch.Tensor],
                    batches: List[Dict[str, torch.Tensor]], lr: float):
    """The reference's three updates: ``(losses per step, first gradient,
    change, first step's predicted joints)``, the gradient and the change
    as ``{leaf: tensor}`` on the host."""
    params = {k: v.detach().clone() for k, v in weights.items()}
    leaves = [k for k in params if ref.trainable(k)]
    for k in leaves:
        params[k].requires_grad_(True)
    m = {k: torch.zeros_like(params[k]) for k in leaves}
    v = {k: torch.zeros_like(params[k]) for k in leaves}
    losses, first, joints = [], None, None
    with tf32_off():
        for t, batch in enumerate(batches, start=1):
            out = model.forward(params, ref.normalize(batch["images"]), batch["sides"])
            L = model.losses(out, batch)
            grads = torch.autograd.grad(L["total_loss"], [params[k] for k in leaves])
            losses.append({k: float(L[k].detach()) for k in ref.LOSS_TERMS if k in L})
            if first is None:
                first = {k: g.detach().cpu() for k, g in zip(leaves, grads)}
                joints = out["joints"].detach().cpu()
            with torch.no_grad():
                for k, g in zip(leaves, grads):
                    m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                    v[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                    step = lr / (1 - BETAS[0] ** t)
                    denom = (v[k] / (1 - BETAS[1] ** t)).sqrt().add_(EPS)
                    params[k].addcdiv_(m[k], denom, value=-step)
            del out, L, grads
    change = {k: (params[k].detach() - weights[k]).cpu() for k in leaves}
    return losses, first, change, joints


def _leaf_gaps(prog: Dict[str, torch.Tensor], refs: Dict[str, torch.Tensor], keep) -> List[float]:
    norms = {k: float(torch.linalg.vector_norm(refs[k].double())) for k in refs}
    floor = float(np.median(list(norms.values())))
    gaps = []
    for k in refs:
        if not keep(k):
            continue
        if k not in prog:  # the program left a leaf unmoved that the reference moves
            return [math.inf]
        gap = abs(float(torch.linalg.vector_norm(prog[k].double())) - norms[k])
        gaps.append(gap / max(norms[k], floor))
    return gaps


def train_numbers(prog_losses: List[Dict[str, float]], prog_first: Dict[str, torch.Tensor],
                  prog_change: Dict[str, torch.Tensor], ref_losses, ref_first, ref_change) -> Dict[str, float]:
    if len(prog_losses) < len(ref_losses):
        return {"terms": math.inf, "grad": math.inf, "change": math.inf}
    first, ref1 = prog_losses[0], ref_losses[0]
    floor = TERM_FLOOR * abs(ref1["total_loss"])
    terms = max(_gap(first.get(k, math.nan), ref1[k], floor)
                for k in ref.CONTINUOUS_TERMS if k in ref1)
    g_norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in ref_first.items()}
    g_floor = ROUNDING_ONLY * float(np.median(list(g_norms.values())))
    return {
        "terms": terms,
        "grad": float(np.median(_leaf_gaps(prog_first, ref_first, lambda k: True))),
        "change": max(_leaf_gaps(prog_change, ref_change, lambda k: g_norms[k] >= g_floor)),
    }


def _gap(p: float, r: float, floor: float) -> float:
    if not math.isfinite(p):
        return math.inf
    return abs(p - r) / max(abs(r), floor) if (r or floor) else abs(p)


def output_gap(prog: Dict[str, np.ndarray], refs: Dict[str, torch.Tensor]) -> float:
    """Worst gap over the compared outputs, each as a share of its largest
    reference magnitude."""
    worst = 0.0
    for k, r in refs.items():
        r = r.detach().cpu().double().numpy()
        p = np.asarray(prog[k], np.float64)
        if p.size != r.size or not np.all(np.isfinite(p)):
            return math.inf
        worst = max(worst, float(np.abs(p.reshape(r.shape) - r).max() / max(np.abs(r).max(), 1e-30)))
    return worst


SERVE_KEYS = ("verts", "joints", "objpoints3d", "objtrans", "objscale")


def serve_reference(model: ref.Model, weights, frames_u8: np.ndarray, sides: np.ndarray,
                    size: int, device: str, rows: int = 64) -> Dict[str, torch.Tensor]:
    """The reference's predictions for demo frames, ``rows`` at a time."""
    outs: Dict[str, List[torch.Tensor]] = {k: [] for k in SERVE_KEYS}
    with torch.no_grad(), tf32_off():
        for i in range(0, len(frames_u8), rows):
            x = ref.preprocess(torch.from_numpy(frames_u8[i:i + rows]).to(device), size)
            s = torch.from_numpy(sides[i:i + rows]).to(device)
            out = model.forward(weights, x, s)
            for k in SERVE_KEYS:
                outs[k].append(out[k].cpu())
    return {k: torch.cat(v) for k, v in outs.items()}
