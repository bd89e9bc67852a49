"""Optimizers and the train and eval steps (JAX package: train/steps.py).

- ``make_optimizer``: adam | rms | sgd with the reference's per-epoch
  StepLR staircase (traineval.py:113-127, 179-182). Parameters frozen by
  the freeze flags (traineval.py:91-101) are left out of the optimizer,
  which is what the JAX ``optax.multi_transform`` with ``set_to_zero``
  does to them.
- ``make_train_step``: frozen-BN training, the reference default
  (README.md:133, netutils.py:4-19) and the JAX ``train_bn=False``: the
  net runs in ``eval()`` (BN on its running stats, no dropout) with
  gradients on. Gradient accumulation over strided microbatches averages
  losses and gradients as the JAX ``lax.scan`` does.
- ``make_eval_step``: losses and predictions without gradients.

The port's state is PyTorch's own: the parameters live in the module and
the moments in the optimizer, both updated in place, so a
:class:`TrainState` carries the module, the optimizer, the learning-rate
schedule, the update count and the regul decay factor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from obman_train_tpu_torch.config import TrainConfig
from obman_train_tpu_torch.device import DeviceLike, resolve_device
from obman_train_tpu_torch.models.handnet import BatchSpec, HandNet

_EVAL_KEYS = ("verts", "joints", "objpoints3d", "objtrans", "objscale",
              "joints2d", "center3d")


@dataclass
class TrainState:
    net: HandNet
    optimizer: torch.optim.Optimizer
    lr_fn: Callable[[int], float]   # learning rate of update number `step`
    step: int = 0
    regul_scale: float = 1.0        # decay factor of the edge/Laplacian reguls


def _frozen(name: str, train_cfg: TrainConfig) -> bool:
    """The JAX ``_freeze_labels`` (:37-52) on torch parameter names."""
    return bool(
        (train_cfg.freeze_encoder and name.startswith("base_net."))
        or (train_cfg.atlas_freeze_encoder and name.startswith("atlas_base_net."))
        or (train_cfg.atlas_freeze_decoder and name.startswith("atlas_branch.decoder."))
    )


def lr_schedule(train_cfg: TrainConfig, steps_per_epoch: int = 1) -> Callable[[int], float]:
    """The StepLR staircase as a function of the update count: ``lr *
    gamma ** (count // (lr_decay_step * steps_per_epoch))``, as the JAX
    ``optax.exponential_decay(staircase=True)`` evaluates it (:55-68)."""
    gamma = train_cfg.lr_decay_gamma
    if gamma and gamma != 1.0:
        period = train_cfg.lr_decay_step * steps_per_epoch
        return lambda count: train_cfg.lr * gamma ** (count // period)
    return lambda count: train_cfg.lr


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop`` (decay 0.9, eps 1e-8 inside the square root,
    ``scale_by_rms(eps_in_sqrt=True)``, no centering or momentum), with
    ``optax.add_decayed_weights`` first when ``weight_decay`` is set:

        nu = (1 - decay) g^2 + decay nu;   p -= lr g / sqrt(nu + eps)

    ``torch.optim.RMSprop`` differs: alpha 0.99 and eps outside the root.
    """

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxRMSprop takes no closure")
        for group in self.param_groups:
            decay, eps, wd = group["decay"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if wd:
                    g = g + wd * p
                state = self.state[p]
                if "nu" not in state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1.0 - decay) * (g * g) + decay * nu)
                p.add_(g * torch.rsqrt(nu + eps), alpha=-group["lr"])


def make_optimizer(train_cfg: TrainConfig, net: nn.Module) -> torch.optim.Optimizer:
    """adam | rms | sgd over the net's trainable parameters (the JAX
    ``make_optimizer``, :71-106). The learning rate is set before each
    update from :func:`lr_schedule` by the train step."""
    params = [p for name, p in net.named_parameters() if not _frozen(name, train_cfg)]
    lr, wd = train_cfg.lr, train_cfg.weight_decay
    if train_cfg.optimizer == "adam":
        if wd:
            return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=wd)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if train_cfg.optimizer == "rms":
        return OptaxRMSprop(params, lr=lr, weight_decay=wd)
    if train_cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=train_cfg.momentum,
                               weight_decay=wd)
    raise ValueError(f"optimizer {train_cfg.optimizer} not in [adam|rms|sgd]")


def create_train_state(net: HandNet, optimizer: torch.optim.Optimizer,
                       train_cfg: TrainConfig, steps_per_epoch: int = 1) -> TrainState:
    """The state of a run that starts at update 0 with no regul decay."""
    return TrainState(net, optimizer, lr_schedule(train_cfg, steps_per_epoch))


def _net_device(net: nn.Module, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    have = next(net.parameters()).device
    if have.type != dev.type or (dev.index is not None and have != dev):
        raise ValueError(f"the net is on {have}, the step on {dev}: move it first")
    return have


def _to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def make_train_step(
    net: HandNet,
    opt: torch.optim.Optimizer,
    spec: BatchSpec,
    train_bn: bool = False,
    accum_steps: int = 1,
    device: DeviceLike = None,
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step ``step(state, batch) -> (state, losses)`` (JAX
    :138-305). It runs on ``device`` (default CUDA; raises without a GPU
    unless ``device="cpu"``), where the net must already be; the batch's
    arrays are moved there.

    ``accum_steps=A > 1`` splits the batch into A strided microbatches
    (rows i, i+A, ...), sums their gradients and scales the sum by 1/A,
    as the JAX scan does; the losses are averaged the same way. The
    contact terms' masked means then normalize per microbatch, as in JAX.
    """
    if train_bn:
        raise NotImplementedError(
            "train_bn=True (unfrozen BN, SyncBN under DDP) is not ported yet: "
            "a later slice")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    dev = _net_device(net, device)

    def forward_backward(batch, regul_scale):
        total, _, losses = net(batch, spec, regul_scale=regul_scale)
        total.backward()
        return {k: v.detach() for k, v in losses.items()}

    def step_fn(state: TrainState, batch: Dict):
        if state.net is not net or state.optimizer is not opt:
            raise ValueError("the state holds another net or optimizer than this step")
        net.eval()  # frozen BN: running stats, no dropout
        batch = _to_device(batch, dev)
        net.zero_grad(set_to_none=True)
        if accum_steps == 1:
            losses = forward_backward(batch, state.regul_scale)
        else:
            b = int(batch["images"].shape[0])
            if b % accum_steps:
                raise ValueError(
                    f"batch size {b} not divisible by accum_steps {accum_steps}")
            losses = None
            for i in range(accum_steps):
                micro = {k: v[i::accum_steps] if v.ndim and v.shape[0] == b else v
                         for k, v in batch.items()}
                mb_losses = forward_backward(micro, state.regul_scale)
                losses = mb_losses if losses is None else {
                    k: losses[k] + v for k, v in mb_losses.items()}
            inv = 1.0 / accum_steps
            with torch.no_grad():
                for p in net.parameters():
                    if p.grad is not None:
                        p.grad.mul_(inv)
            losses = {k: v * inv for k, v in losses.items()}
        lr = state.lr_fn(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return state, losses

    return step_fn


def make_eval_step(
    net: HandNet, spec: BatchSpec, no_loss: bool = False, device: DeviceLike = None
) -> Callable[[Dict], Tuple[Dict, Dict]]:
    """``eval(batch) -> (losses, out)`` without gradients (JAX :391-417);
    ``out`` holds the predictions the evaluators read."""
    dev = _net_device(net, device)

    def eval_fn(batch: Dict):
        net.eval()
        with torch.no_grad():
            _, results, losses = net(_to_device(batch, dev), spec, no_loss=no_loss)
        return losses, {k: results[k] for k in _EVAL_KEYS if k in results}

    return eval_fn
