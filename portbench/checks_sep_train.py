"""The numbers that decide ``correct`` in the separate-encoder ResNet-50
train step: ``checks.py``'s four (``terms``, ``joints``, ``grad``,
``change``), held to ``reference/handnet_sep_train.py`` and its own loss
terms, which add the shape term ``mano_shape`` to the ResNet-18
reference's.

The reference follows the program's first three updates from the same
weights on the same batches, with its own Adam, as
``checks.follow_training`` does; its encoders run in checkpointed blocks
of samples so that two ResNet-50s at the cell's batch fit the card beside
the reference's other saved tensors.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench import checks
from portbench.reference import handnet_sep_train as ref


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
    beta1, beta2 = checks.BETAS
    losses, first, joints = [], None, None
    with checks.tf32_off():
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
                    m[k].mul_(beta1).add_(g, alpha=1 - beta1)
                    v[k].mul_(beta2).addcmul_(g, g, value=1 - beta2)
                    denom = (v[k] / (1 - beta2 ** t)).sqrt().add_(checks.EPS)
                    params[k].addcdiv_(m[k], denom, value=-lr / (1 - beta1 ** t))
            del out, L, grads
    change = {k: (params[k].detach() - weights[k]).cpu() for k in leaves}
    return losses, first, change, joints


def train_numbers(prog_losses, prog_first, prog_change, ref_losses, ref_first,
                  ref_change) -> Dict[str, float]:
    """``checks.train_numbers`` with the terms of this reference: each of
    ``CONTINUOUS_TERMS`` of the first step against the reference's, a term
    the program did not report reading infinite."""
    numbers = checks.train_numbers(prog_losses, prog_first, prog_change,
                                   ref_losses, ref_first, ref_change)
    if prog_losses and ref_losses:
        first, ref1 = prog_losses[0], ref_losses[0]
        floor = checks.TERM_FLOOR * abs(ref1["total_loss"])
        numbers["terms"] = max([numbers["terms"]] + [
            checks._gap(first.get(k, float("nan")), ref1[k], floor)
            for k in ref.CONTINUOUS_TERMS if k in ref1])
    return numbers
