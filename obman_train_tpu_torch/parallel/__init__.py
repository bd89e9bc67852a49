"""Data-parallel training over ``torch.distributed`` (the JAX package's
``parallel/``): see :mod:`obman_train_tpu_torch.parallel.mesh`."""

from obman_train_tpu_torch.parallel.mesh import (
    DataParallel,
    DistInfo,
    all_reduce_sum,
    barrier,
    current,
    data_parallel,
    destroy_distributed,
    global_draw,
    host_group,
    infer_batch_size,
    init_distributed,
    is_distributed,
    local_shard,
    process_count,
    process_index,
    shard_batch,
    world_axis,
)

__all__ = [
    "DataParallel",
    "DistInfo",
    "all_reduce_sum",
    "barrier",
    "current",
    "data_parallel",
    "destroy_distributed",
    "global_draw",
    "host_group",
    "infer_batch_size",
    "init_distributed",
    "is_distributed",
    "local_shard",
    "process_count",
    "process_index",
    "shard_batch",
    "world_axis",
]
