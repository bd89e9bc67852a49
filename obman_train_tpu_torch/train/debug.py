"""Training diagnostics (the JAX package's ``train/debug.py``).

``inspect_feature_grads`` reproduces the reference's ``inspect_weights``
mode (mano_train/netscripts/epochpass3d.py:92-108): the gradient norm of
each individual loss with respect to the encoder's image features, useful
for balancing the multi-task lambdas. One forward with a zero-valued
feature probe, then one ``torch.autograd.grad`` a loss; with the contact
terms that forward runs the inside-test kernel and the nearest-neighbour
sweeps on the card.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from obman_train_tpu_torch.device import DeviceLike
from obman_train_tpu_torch.models.handnet import BatchSpec, HandNet
from obman_train_tpu_torch.train.steps import _net_device, _to_device

DEFAULT_INSPECT_LOSSES = (
    "atlas_trans3d",
    "atlas_objpoints3d",
    "mano_verts3d",
    "mano_shape",
    "atlas_edge_regul",
    "total_loss",
)


def inspect_feature_grads(
    net: HandNet,
    batch: Dict,
    spec: BatchSpec,
    loss_names: Sequence[str] = DEFAULT_INSPECT_LOSSES,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Returns {loss_name: ||d loss / d features||} for the losses the
    net computes on ``batch`` (eval mode, as the JAX ``train=False``)."""
    dev = _net_device(net, device)
    batch = _to_device(batch, dev)
    dtype = torch.float64 if next(net.parameters()).dtype == torch.float64 else torch.float32
    probe = torch.zeros((batch["images"].shape[0], net.cfg.img_feature_size),
                        dtype=dtype, device=dev, requires_grad=True)
    net.eval()
    _, _, losses = net(batch, spec, feature_probe=probe)
    names = [n for n in loss_names if losses.get(n) is not None]
    out = {}
    for i, name in enumerate(names):
        (grad,) = torch.autograd.grad(losses[name], probe, allow_unused=True,
                                      retain_graph=i < len(names) - 1)
        out[name] = 0.0 if grad is None else float(torch.linalg.vector_norm(grad))
    return out
