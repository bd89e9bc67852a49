"""Optimizers and the train and eval steps (JAX package: train/steps.py).

- ``make_optimizer``: adam | rms | sgd with the reference's per-epoch
  StepLR staircase (traineval.py:113-127, 179-182). Parameters frozen by
  the freeze flags (traineval.py:91-101) are left out of the optimizer,
  which is what the JAX ``optax.multi_transform`` with ``set_to_zero``
  does to them.
- ``make_train_step``: frozen-BN training, the reference default
  (README.md:133, netutils.py:4-19) and the JAX ``train_bn=False``: the
  net runs in ``eval()`` (BN on its running stats, no dropout) with
  gradients on. ``train_bn=True`` (JAX :140-290, ``mutable=["batch_stats"]``)
  runs the step in ``train()``: BN on batch statistics, updating the
  running ones, and dropout drawn from a generator seeded by the run's seed,
  the update count and the microbatch; with ``atlas.mesh=False`` the random
  cloud's sphere points come from another generator of the same three (the
  JAX step splits its key into dropout and points, :193-235). Gradient
  accumulation over strided
  microbatches averages losses and gradients as the JAX ``lax.scan`` does;
  in ``train()`` its microbatch forwards update the running statistics in
  sequence, as the scan carries them.
- ``make_eval_step``: losses and predictions without gradients.
- Data parallel (steps built after ``parallel.init_distributed``; JAX: the
  same steps jitted over a batch-sharded global mesh): each rank runs its
  rows of the global batch
  inside ``parallel.data_parallel``, so BatchNorm statistics, the contact
  masked means and the random draws are the global batch's, then one
  all-reduce of a flat buffer averages the gradients and the losses over
  the ranks (:class:`_RankMean`). ``make_train_step_syncbn`` is
  the JAX ``shard_map`` SyncBN step.
- ``compute_dtype="bfloat16"``: the forward computes in bf16 on the float32
  parameters, so gradients, the optimizer's moments and the updates stay
  float32 and the optimizers are unchanged; no loss scaling (JAX uses
  none).
- Frozen BN on the card: each ResNet encoder runs with its BatchNorms
  folded into its convolutions at every forward, under autograd
  (:func:`fold_encoder`, ``models/resnet_fold.py``).

The port's state is PyTorch's own: the parameters live in the module and
the moments in the optimizer, both updated in place, so a
:class:`TrainState` carries the module, the optimizer, the learning-rate
schedule, the update count and the regul decay factor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from obman_train_tpu_torch.config import TrainConfig
from obman_train_tpu_torch.device import DeviceLike, resolve_device
from obman_train_tpu_torch.models import resnet_fold
from obman_train_tpu_torch.models.handnet import BatchSpec, HandNet
from obman_train_tpu_torch.models.resnet import _FlaxTrainBN
from obman_train_tpu_torch.parallel import mesh as parallel
from obman_train_tpu_torch.utils.tracing import span

EVAL_KEYS = ("verts", "joints", "objpoints3d", "objtrans", "objscale",
             "joints2d", "center3d")


@dataclass
class TrainState:
    net: HandNet
    optimizer: torch.optim.Optimizer
    lr_fn: Callable[[int], float]   # learning rate of update number `step`
    step: int = 0
    regul_scale: float = 1.0        # decay factor of the edge/Laplacian reguls
    seed: int = 0                   # the run's seed, for the dropout masks


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
    return TrainState(net, optimizer, lr_schedule(train_cfg, steps_per_epoch),
                      seed=int(train_cfg.manual_seed))


def dropout_generator(device: torch.device, seed: int, step: int,
                      micro: int = 0) -> torch.Generator:
    """The dropout masks' generator of update ``step``, microbatch
    ``micro``: a pure function of the three, as the JAX step folds the
    update count into its key (:193), so a resumed run draws the masks of
    the run that never stopped."""
    return _generator(device, [int(seed), int(step), int(micro)])


def points_generator(device: torch.device, seed: int, step: int,
                     micro: int = 0) -> torch.Generator:
    """The random-cloud decoder's generator of update ``step``, microbatch
    ``micro`` (``atlas.mesh=False``), a stream apart from the dropout's."""
    return _generator(device, [int(seed), int(step), int(micro), 1])


def _generator(device: torch.device, entropy) -> torch.Generator:
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _net_device(net: nn.Module, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    have = next(net.parameters()).device
    if have.type != dev.type or (dev.index is not None and have != dev):
        raise ValueError(f"the net is on {have}, the step on {dev}: move it first")
    return have


# per-batch scalars that the host reads (the jitter's op order selects a
# branch on the host, as lax.switch does on the TPU): kept on the CPU so
# reading them does not wait for the device
HOST_KEYS = ("aug_order",)


def _to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v) if k in HOST_KEYS
            else torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def _data_axis() -> Optional[parallel.DataParallel]:
    """The step's :class:`~parallel.DataParallel`: the world when
    ``parallel.init_distributed`` has run, else None (one process)."""
    return parallel.world_axis() if parallel.is_distributed() else None


class _RankMean:
    """Averages a step's gradients of ``params`` and its ``losses`` over the
    ranks in ONE all-reduce of a flat buffer (the JAX ``pmean``).

    A parameter without a gradient on this rank enters as zeros with a flag
    of 0, so every rank sends the same layout whatever its rows reached; a
    parameter that no rank reached keeps ``grad=None`` (the optimizer skips
    it, as one process would). The flags ride in the same buffer; which
    parameters get a gradient follows from the config and the batch spec,
    fixed for a step, so the world's flags are read on the host (a
    synchronization) at the first call and again only when this rank's own
    pattern changes. The averaged gradients are views of the buffer. Every
    rank receives the same sums, so the parameters and optimizer states
    stay bit-identical after the update."""

    def __init__(self, dp: parallel.DataParallel):
        self.dp = dp
        self._reached = None  # (this rank's gradient pattern, the world's)

    def __call__(self, params, losses: Dict) -> Dict:
        keys = [k for k, v in losses.items() if v is not None]
        if not params and not keys:
            return losses
        local = tuple(p.grad is not None for p in params)
        ref = params[0] if params else losses[keys[0]]
        dt = ref.dtype if params else torch.float32
        flags = torch.ones(len(params), dtype=dt, device=ref.device)
        if not all(local):
            flags[torch.tensor([i for i, hit in enumerate(local) if not hit])] = 0
        parts = [p.grad.reshape(-1) if p.grad is not None else p.new_zeros(p.numel())
                 for p in params]
        parts += [flags, torch.stack([losses[k].detach().reshape(()).to(dt) for k in keys])
                  if keys else flags.new_zeros(0)]
        flat = torch.cat(parts)
        dist.all_reduce(flat)
        flat.div_(self.dp.world)
        n_grad = sum(p.numel() for p in params)
        if self._reached is None or self._reached[0] != local:
            world = flat[n_grad:n_grad + len(params)].tolist()
            self._reached = (local, tuple(v > 0 for v in world))
        offset = 0
        for p, hit in zip(params, self._reached[1]):
            if hit:
                p.grad = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        means = flat[n_grad + len(params):]
        out = dict(losses)
        for k, v in zip(keys, means):
            out[k] = v.to(losses[k].dtype)
        return out


def _average_unsynced_bn_stats(net: nn.Module, dp: parallel.DataParallel) -> None:
    """The SyncBN step's ``pmean`` of the running statistics (JAX :362-365)
    for the BatchNorms that normalized each rank's own rows (the atlas
    decoder's); the synced ones are identical on every rank already."""
    bufs = [b for m in net.modules()
            if isinstance(m, _FlaxTrainBN) and not m.axis_synced
            for b in (m.running_mean, m.running_var)]
    if not bufs:
        return
    flat = torch.cat([b.reshape(-1) for b in bufs])
    dist.all_reduce(flat)
    flat.div_(dp.world)
    offset = 0
    for b in bufs:
        b.copy_(flat[offset:offset + b.numel()].view_as(b))
        offset += b.numel()


def fold_encoder(handnet: HandNet):
    """``HandNet.forward``'s ``encoder`` hook for the train step. An encoder
    in ``eval()`` (frozen BN) that computes in its parameters' dtype, given
    CUDA float32 images, runs folded: its BatchNorms folded into its
    convolutions under autograd (``resnet_fold.fold``, inside a
    ``train.fold`` span that names the encoder), then conv + bias (+
    residual) + ReLU as cuDNN's fused ops, the whole encoder one autograd
    node with a hand-written backward (``resnet_fold.train_features``).
    The running statistics are constants of the step; the weights and the
    BatchNorms' scale and shift get the gradients of the unfolded chain.
    Everything else (unfrozen BN, bf16, the CPU) runs ``ResNet.forward``."""

    def encode(net: nn.Module, image: torch.Tensor):
        if not (image.is_cuda and image.dtype == torch.float32
                and net.conv1.compute_dtype is None and not net.training):
            return net(image)
        name = next((n for n, m in handnet.named_children() if m is net), None)
        with span("train.fold", name):
            folded = resnet_fold.fold(net)
        return resnet_fold.train_features(folded, image)

    return encode


def _optimizer_params(opt: torch.optim.Optimizer):
    return [p for group in opt.param_groups for p in group["params"]]


def make_train_step(
    net: HandNet,
    opt: torch.optim.Optimizer,
    spec: BatchSpec,
    train_bn: bool = False,
    accum_steps: int = 1,
    device: DeviceLike = None,
    return_joints: bool = False,
) -> Callable[[TrainState, Dict], Tuple]:
    """The train step ``step(state, batch) -> (state, losses)`` (JAX
    :138-305). It runs on ``device`` (default CUDA; raises without a GPU
    unless ``device="cpu"``), where the net must already be; the batch's
    arrays are moved there.

    ``return_joints=True`` also returns the predicted joints of the step's
    own forward, detached, for the epoch loop's PCK evaluator
    (epochpass3d.py:141-151): ``(state, losses, joints)``.

    ``accum_steps=A > 1`` splits the batch into A strided microbatches
    (rows i, i+A, ...), sums their gradients and scales the sum by 1/A,
    as the JAX scan does; the losses are averaged the same way. The
    contact terms' masked means then normalize per microbatch, as in JAX.

    ``train_bn=True`` runs the forwards in ``train()`` (unfrozen BN and
    dropout) and puts the net back in ``eval()`` after the step, also when
    the step raises.

    Built after ``parallel.init_distributed``, it is the data-parallel
    step: ``batch`` is this rank's contiguous
    rows of the global batch (the process-sliced loader's), and the step
    computes what one process computes on the global batch, within the
    reduction order's rounding: global BN statistics, global masked means,
    the global batch's dropout masks and sphere points, gradients and
    losses averaged over the ranks. With ``accum_steps=A`` the rank's rows
    ``i::A`` are global microbatch ``i``, which needs the rank's rows to
    divide by A. The gradients are averaged by one explicit all-reduce
    after the last microbatch's backward, not by ``DistributedDataParallel``:
    the step already sums its microbatches itself, the BN buffers are
    global already (nothing to broadcast), and a parameter that a flag
    leaves without a gradient needs no ``find_unused_parameters`` (see
    :class:`_RankMean`).
    """
    return _build_train_step(net, opt, spec, train_bn, accum_steps, device, return_joints,
                             _data_axis())


def make_train_step_syncbn(
    net: HandNet,
    opt: torch.optim.Optimizer,
    spec: BatchSpec,
    return_joints: bool = False,
    device: DeviceLike = None,
) -> Callable[[TrainState, Dict], Tuple]:
    """The SyncBN train step (JAX :308-388): unfrozen BN whose batch
    statistics are synchronized over the ranks, gradients and losses
    averaged, parameters identical on every rank. Needs
    ``ModelConfig(sync_bn=True)`` (as the JAX step does) and an initialized
    process group; the CLI does not reach it.

    It differs from ``make_train_step(train_bn=True)`` in distributed use
    where the JAX ``shard_map`` body reduces over each shard's own rows
    (``DataParallel(global_batch=False)``): each rank computes the contact
    terms' masked means over its OWN rows and the ranks' losses are
    averaged, where ``make_train_step`` normalizes by the global batch's
    mask count; and only the BatchNorms built with the data axis (the
    ResNet encoders', ``sync_bn``) use the global statistics, the atlas
    decoder's normalize each rank's rows and their running statistics are
    averaged over the ranks after the step (the JAX ``pmean`` of
    ``batch_stats``). Dropout masks are the global batch's rows here too
    (the JAX step draws the same local mask on every shard from its
    replicated key, a quirk of the reference that is not copied)."""
    if not net.cfg.sync_bn:
        raise ValueError("make_train_step_syncbn needs ModelConfig(sync_bn=True)")
    dp = parallel.world_axis(global_batch=False)
    step = _build_train_step(net, opt, spec, True, 1, device, return_joints, dp)

    def syncbn_step(state: TrainState, batch: Dict):
        out = step(state, batch)
        with torch.no_grad():
            _average_unsynced_bn_stats(net, dp)
        return out

    return syncbn_step


def _build_train_step(net, opt, spec, train_bn, accum_steps, device, return_joints, dp):
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    dev = _net_device(net, device)
    rank_mean = _RankMean(dp) if dp is not None else None
    use_dropout = train_bn and bool(net.cfg.fc_dropout)
    random_cloud = not net.cfg.atlas.mesh
    encoder = fold_encoder(net)

    def forward_backward(batch, regul_scale, gens):
        with span("train.forward"):
            total, results, losses = net(batch, spec, regul_scale=regul_scale,
                                         dropout_gen=gens[0], points_gen=gens[1],
                                         encoder=encoder)
        with span("train.backward"):
            total.backward()
        joints = results["joints"].detach() if return_joints else None
        return {k: v.detach() for k, v in losses.items()}, joints

    def step_fn(state: TrainState, batch: Dict):
        with span("train.step", str(state.step)):
            if state.net is not net or state.optimizer is not opt:
                raise ValueError("the state holds another net or optimizer than this step")
            # frozen BN: running stats, no dropout; unfrozen: the JAX train=True
            net.train(train_bn)
            try:
                return update(state, batch)
            finally:
                net.eval()

    def gen_for(state, micro):
        return (
            dropout_generator(dev, state.seed, state.step, micro) if use_dropout else None,
            points_generator(dev, state.seed, state.step, micro) if random_cloud else None,
        )

    def update(state: TrainState, batch: Dict):
        batch = _to_device(batch, dev)
        net.zero_grad(set_to_none=True)
        with parallel.data_parallel(dp):
            losses, joints = accumulate(state, batch)
        with span("train.optimizer"):
            if dp is not None:
                losses = rank_mean(_optimizer_params(opt), losses)
            lr = state.lr_fn(state.step)
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
        state.step += 1
        if return_joints:
            return state, losses, joints
        return state, losses

    def accumulate(state: TrainState, batch: Dict):
        if accum_steps == 1:
            losses, joints = forward_backward(batch, state.regul_scale, gen_for(state, 0))
        else:
            b = int(batch["images"].shape[0])
            if b % accum_steps:
                raise ValueError(
                    f"batch size {b} not divisible by accum_steps {accum_steps}"
                    + (f" (a rank's rows of the global batch, {b * dp.world}, must "
                       "divide: its rows i::A are then global microbatch i)" if dp else ""))
            losses, joints = None, None
            for i in range(accum_steps):
                micro = {k: v[i::accum_steps] if v.ndim and v.shape[0] == b else v
                         for k, v in batch.items()}
                mb_losses, mb_joints = forward_backward(micro, state.regul_scale,
                                                        gen_for(state, i))
                losses = mb_losses if losses is None else {
                    k: losses[k] + v for k, v in mb_losses.items()}
                if return_joints:
                    if joints is None:
                        joints = mb_joints.new_empty((b,) + mb_joints.shape[1:])
                    joints[i::accum_steps] = mb_joints  # back to row order
            inv = 1.0 / accum_steps
            with torch.no_grad():
                for p in net.parameters():
                    if p.grad is not None:
                        p.grad.mul_(inv)
            losses = {k: v * inv for k, v in losses.items()}
        return losses, joints

    return step_fn


def make_eval_step(
    net: HandNet, spec: BatchSpec, no_loss: bool = False, device: DeviceLike = None,
    keys: Tuple[str, ...] = EVAL_KEYS,
) -> Callable[[Dict], Tuple[Dict, Dict]]:
    """``eval(batch) -> (losses, out)`` without gradients (JAX :391-417);
    ``out`` holds the results named in ``keys`` that the forward computes:
    by default the predictions the evaluators read; the epoch loop's
    figures also take ``contact_info``. Built after
    ``parallel.init_distributed``, the losses are the global batch's, averaged
    over the ranks, and ``out`` holds this rank's rows: every rank must
    call it, as every collective."""
    dev = _net_device(net, device)
    dp = _data_axis()
    rank_mean = _RankMean(dp) if dp is not None else None

    def eval_fn(batch: Dict):
        net.eval()
        with torch.no_grad(), parallel.data_parallel(dp):
            _, results, losses = net(_to_device(batch, dev), spec, no_loss=no_loss)
        if dp is not None:
            losses = rank_mean([], losses)
        return losses, {k: results[k] for k in keys if k in results}

    return eval_fn
