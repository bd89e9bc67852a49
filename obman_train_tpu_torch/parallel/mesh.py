"""Process groups and the global-batch helpers of data-parallel training
(the JAX package's ``parallel/mesh.py``).

The JAX package trains multi-process as one jit-compiled SPMD program over
a global ``data`` mesh: the batch is sharded on its leading dimension, and
every reduction over the batch (BatchNorm statistics, the contact terms'
masked-mean normalizers) is a reduction over the GLOBAL batch. The port
runs one process per card (torchrun's model: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), a ``torch.distributed``
process group in place of the mesh; the mesh's devices are the port's
ranks. Each rank holds only its own contiguous rows of each global batch
(``data/loader.py``'s process slice), so :func:`local_shard` is the
identity.

Inside a distributed step (:func:`data_parallel`) three things read the
active :class:`DataParallel`, so that W ranks with global batch B compute
what one process computes on B:

- the training-mode BatchNorm all-reduces its per-channel sum, sum of
  squares and count (``models/resnet.py``);
- ``ops/contact.py``'s ``masked_mean_loss`` all-reduces its numerator and
  its denominator;
- dropout masks and the random cloud's sphere points are drawn for the
  global batch from the step's generator, and each rank keeps its rows
  (:func:`global_draw`).

The collectives that carry a gradient go through :func:`all_reduce_sum`,
whose backward is the same sum over ranks: every rank computes the same
global value, and the train step averages the ranks' gradients, so each
rank's share of the global gradient arrives once.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from obman_train_tpu_torch.device import DeviceLike, resolve_device

TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")
LAUNCH_HINT = (
    "launch each rank with torchrun's environment: `torchrun --nproc_per_node N -m "
    "obman_train_tpu_torch.cli.traineval --distributed ...` (or `python -m "
    "torch.distributed.run ...`)")


@dataclass(frozen=True)
class DistInfo:
    """What :func:`init_distributed` set up for this process."""

    rank: int
    world: int
    local_rank: int
    backend: str
    device: torch.device


_INFO: Optional[DistInfo] = None
_HOST_GROUP = None  # a gloo group beside an NCCL world (host objects)


def init_distributed(device: DeviceLike = None, timeout_s: float = 600.0) -> DistInfo:
    """Join the process group that torchrun's environment describes.

    ``device="cpu"`` runs the rank on the CPU over gloo; otherwise the rank
    takes ``cuda:{LOCAL_RANK % device_count}`` and NCCL when each rank of
    the host has a card of its own, gloo when the host's ranks
    (``LOCAL_WORLD_SIZE``, else ``WORLD_SIZE``) outnumber its cards: NCCL
    refuses two ranks on one device. The choice is printed in one line.
    A collective that hangs raises after ``timeout_s``."""
    global _INFO, _HOST_GROUP
    present = [v for v in TORCHRUN_VARS if v in os.environ]
    if not present:
        raise RuntimeError(f"--distributed found none of {', '.join(TORCHRUN_VARS)}: "
                           + LAUNCH_HINT)
    missing = [v for v in TORCHRUN_VARS if v not in os.environ]
    if missing:
        raise SystemExit(
            f"{', '.join(present)} {'is' if len(present) == 1 else 'are'} set but "
            f"{', '.join(missing)} {'is' if len(missing) == 1 else 'are'} not: torchrun's "
            f"variables must be set together for --distributed")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if _INFO is not None:
        raise RuntimeError("init_distributed was already called in this process")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed on cuda: no CUDA device is available; "
                               "OBMAN_PLATFORM=cpu runs the ranks on the CPU")
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        if local_world <= cards:
            backend, why = "nccl", f"{local_world} rank(s) on {cards} card(s)"
        else:
            backend, why = "gloo", (f"{local_world} ranks share {cards} card(s): NCCL "
                                    "refuses two ranks on one device")
    else:
        backend, why = "gloo", "CPU ranks"
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _HOST_GROUP = dist.new_group(backend="gloo") if backend != "gloo" else None
    _INFO = DistInfo(rank, world, local_rank, backend, dev)
    print(f"distributed: rank {rank} of {world}, local rank {local_rank}, backend "
          f"{backend} ({why}), device {dev}", flush=True)
    return _INFO


def destroy_distributed() -> None:
    """Leave the process group (a no-op when none was joined)."""
    global _INFO, _HOST_GROUP
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _INFO, _HOST_GROUP = None, None


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def host_group():
    """The gloo group for host objects (the PCK pools): the world itself
    when it is gloo, else a gloo group over the same ranks."""
    return _HOST_GROUP


def barrier() -> None:
    """Wait for every rank (a no-op in one process); over the host group,
    which never needs a card."""
    if is_distributed():
        dist.barrier(group=_HOST_GROUP)


def local_shard(x) -> np.ndarray:
    """Host-read a value of the step: a rank holds only its own rows, so
    this is the array itself (the JAX ``local_shard`` gathers a process's
    shards of a global array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def infer_batch_size(batch: dict) -> int:
    """The batch's leading dimension: ``images`` when present (every model
    batch carries it), else the most common leading dim with a
    deterministic largest-dim tie-break (JAX :70-80)."""
    if "images" in batch:
        return int(batch["images"].shape[0])
    dims = [int(v.shape[0]) for v in batch.values() if getattr(v, "ndim", 0)]
    if not dims:
        return 0
    counts = {d: dims.count(d) for d in set(dims)}
    return max(sorted(counts), key=lambda d: (counts[d], d))


def shard_batch(batch: Dict, device: DeviceLike = None, batch_size: Optional[int] = None,
                rank: Optional[int] = None, world: Optional[int] = None) -> Dict:
    """This rank's contiguous rows of a GLOBAL batch, on ``device`` (by
    default the rank's device, else CUDA).

    Leaves with the batch's leading dim are sliced; per-batch leaves (the
    device jitter's ``aug_order``) are kept whole. A global batch that does
    not divide the world raises (JAX :105-112). The loader already yields a
    rank's rows (``BatchLoader(process_rank=, process_count=)``); this is
    for a global batch that every rank holds."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    total = infer_batch_size(batch) if batch_size is None else batch_size
    if total and total % world:
        raise ValueError(f"global batch {total} not divisible by the {world} ranks "
                         "of the data axis")
    per = total // world
    if device is None:
        device = _INFO.device if _INFO is not None else resolve_device(None)
    out = {}
    for k, v in batch.items():
        if not getattr(v, "ndim", 0):
            out[k] = torch.as_tensor(v) if isinstance(v, np.ndarray) else v
            continue
        t = torch.as_tensor(v)
        if t.shape[0] == total:
            t = t[rank * per:(rank + 1) * per].contiguous()
        out[k] = t.to(device)
    return out


# ---------------------------------------------------------------------------
# The global batch inside a step
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DataParallel:
    """The ranks that split the batch of a step.

    ``global_batch=True`` is the JAX jit-SPMD step's semantics: every
    reduction over the batch (all BatchNorm statistics, the masked means)
    is global. ``global_batch=False`` is its SyncBN ``shard_map`` body's:
    each rank reduces over its own rows (its masked means, the atlas
    decoder's BatchNorms) except the BatchNorms built with the data axis
    (``ModelConfig.sync_bn``: the ResNet encoders'). Random draws are the
    global batch's either way."""

    rank: int
    world: int
    global_batch: bool = True


_ACTIVE: Optional[DataParallel] = None


def current() -> Optional[DataParallel]:
    """The :class:`DataParallel` of the step running now, or None."""
    return _ACTIVE


@contextlib.contextmanager
def data_parallel(dp: Optional[DataParallel]) -> Iterator[None]:
    """Run the block with ``dp`` as the step's data axis (None: one
    process's batch)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, dp
    try:
        yield
    finally:
        _ACTIVE = prev


def world_axis(global_batch: bool = True) -> DataParallel:
    """The :class:`DataParallel` of the initialized world."""
    if not is_distributed():
        raise RuntimeError("no process group: call init_distributed first")
    return DataParallel(dist.get_rank(), dist.get_world_size(), global_batch)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks whose backward is the same sum: every rank's loss
    reads the global value, and the step averages the ranks' gradients."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable."""
    return _AllReduceSum.apply(x)


def global_draw(draw: Callable[..., torch.Tensor], shape, generator: torch.Generator,
                **kw) -> torch.Tensor:
    """``draw(shape, generator=generator, **kw)`` for this rank's rows of
    the global batch: inside a distributed step the tensor of the global
    batch (``world`` times the rows) is drawn and the rank keeps its
    contiguous rows, so W ranks draw what one process draws; else the
    local draw itself. ``draw`` is ``torch.rand`` or ``torch.randn``."""
    dp = _ACTIVE
    if dp is None:
        return draw(tuple(shape), generator=generator, **kw)
    n = int(shape[0])
    full = draw((n * dp.world, *shape[1:]), generator=generator, **kw)
    return full[dp.rank * n:(dp.rank + 1) * n]
