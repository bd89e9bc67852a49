"""Batching, prefetching and round-robin concatenation (the JAX package's
``data/loader.py``; reference traineval.py:223-230, datautils.py:5-37).

Samples are numpy dicts from :class:`HandDataset`; a thread pool overlaps
augmentation with device compute (the ctypes warp releases the GIL, numpy
and scipy only in part: 8 threads run the float chain about twice as fast
as one), batches are fixed-shape stacked arrays, and
:class:`ConcatLoader` cycles loaders round-robin, injecting
dataset/root/split metadata. The seeded order, the per-epoch ``reseed`` and
the per-batch ``aug_order`` rule are the JAX package's, so the port yields
the same batch stream for the same seed.

``to_model_batch`` turns a query-keyed batch into the static-key batch the
model reads ("images" NHWC, "sides" int32 0=right/1=left) and
``derive_spec`` builds the matching :class:`BatchSpec`. With
``use_processes=True`` a persistent pool of spawned worker processes loads
whole batches instead (the reference's DataLoader worker model, JAX
:100-215): each child holds its own copy of the dataset, never sees the
GPU, and yields the threaded loader's batches bit for bit.
Process-sliced (multi-process) loading comes with the DDP slice.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from obman_train_tpu_torch.data.queries import BaseQueries, TransQueries

SIDE_TO_INT = {"right": 0, "left": 1}


def collate(samples: Sequence[Dict]) -> Dict:
    """Stack a list of sample dicts into fixed-shape arrays; string fields
    (sides) and meta dicts stay lists."""
    out: Dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


def to_model_batch(batch: Dict) -> Dict[str, np.ndarray]:
    """Query-keyed collated batch -> model batch with plain string keys."""
    mapping = {
        TransQueries.images: "images",
        TransQueries.joints3d: "joints3d",
        TransQueries.verts3d: "verts3d",
        TransQueries.joints2d: "joints2d",
        TransQueries.objpoints3d: "objpoints3d",
        TransQueries.camintrs: "camintrs",
        TransQueries.center3d: "center3d",
        BaseQueries.hand_pcas: "hand_pcas",
    }
    out = {}
    for q, name in mapping.items():
        if q in batch:
            val = np.asarray(batch[q])
            # C order whatever the samples' layout (a transposed rotation
            # result stacks into a strided array): the tensors' reductions
            # then take one order on every path, threads or processes
            if name == "images" and val.dtype == np.uint8:
                out[name] = np.ascontiguousarray(val)  # normalized on the device
            else:
                out[name] = np.ascontiguousarray(val, dtype=np.float32)
    if "aug_factors" in batch:
        out["aug_factors"] = np.asarray(batch["aug_factors"], np.float32)
        # one op order per batch; sample 0's draw is the standalone
        # fallback, BatchLoader._finalize replaces it
        out["aug_order"] = np.asarray(batch["aug_order"][0], np.int32)
    if BaseQueries.sides in batch:
        out["sides"] = np.asarray(
            [SIDE_TO_INT[s] for s in batch[BaseQueries.sides]], np.int32
        )
    return out


def derive_spec(batch: Dict, root: str = "wrist"):
    from obman_train_tpu_torch.models.handnet import BatchSpec

    return BatchSpec(
        has_joints3d="joints3d" in batch,
        has_verts3d="verts3d" in batch,
        has_joints2d="joints2d" in batch,
        has_camintrs="camintrs" in batch,
        has_objpoints3d="objpoints3d" in batch,
        has_center3d="center3d" in batch,
        has_pcas="hand_pcas" in batch,
        has_sides="sides" in batch,
        root=root,
    )


# ---------------------------------------------------------------------------
# Process workers: spawned interpreters, each with its own copy of the
# dataset (pickled once, at spawn). The host warp's ctypes library is a
# module global that a child loads at its first warp, never pickled.
# ---------------------------------------------------------------------------

_WORKER_DATASET = None
_WORKER_EPOCH = None


def _proc_init(dataset):
    global _WORKER_DATASET, _WORKER_EPOCH
    import torch

    torch.set_num_threads(1)  # one core a worker; the pool is the parallelism
    try:
        import cv2

        cv2.setNumThreads(1)  # cv2's own threads would oversubscribe the cores
    except ImportError:
        pass
    _WORKER_DATASET = dataset
    _WORKER_EPOCH = None


def _proc_ping(_):
    time.sleep(0.3)  # hold the worker so that every slot of the pool spawns


def _proc_load(idxs, epoch: int):
    global _WORKER_EPOCH
    ds = _WORKER_DATASET
    if epoch != _WORKER_EPOCH:
        if hasattr(ds, "reseed"):
            ds.reseed(epoch)
        _WORKER_EPOCH = epoch
    return to_model_batch(collate([ds[int(i)] for i in idxs]))


class BatchLoader:
    """Shuffling, drop-last iterator of model batches with prefetch on
    threads or, with ``use_processes=True``, on spawned processes.

    Epoch ``e`` (the ``e``-th iteration, or the one :meth:`set_epoch`
    names) shuffles with ``seed + e`` and reseeds the dataset's
    augmentation stream with ``e + 1``, as the JAX package's loader does on
    its ``e``-th iteration."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        seed: int = 0,
        use_processes: bool = False,
        process_rank: int = 0,
        process_count: int = 1,
        clamp_threads: bool = True,
    ):
        if process_count > 1 or process_rank:
            raise NotImplementedError(
                "process-sliced loading (multi-process runs) comes with the DDP "
                "slice of the port (ROADMAP queue 1, item 8)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.clamp_threads = clamp_threads
        self.use_processes = use_processes
        self._pool = None
        self._epoch = 0

    def _ensure_pool(self):
        """The persistent ``spawn`` pool, every worker started while the
        environment hides the GPU: the children run with
        ``CUDA_VISIBLE_DEVICES`` empty, so none of them can initialize
        CUDA."""
        if self._pool is not None:
            return self._pool
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        # no GPU, and one BLAS/OpenMP thread a child (as torch's and cv2's
        # in _proc_init): the pool is the parallelism
        child_env = {"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
                     "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
        saved = {k: os.environ.get(k) for k in child_env}
        os.environ.update(child_env)
        try:
            pool = ProcessPoolExecutor(
                self.num_workers, mp_context=multiprocessing.get_context("spawn"),
                initializer=_proc_init, initargs=(self.dataset,))
            # workers spawn lazily at submit: start every slot now, while
            # the environment hides the GPU
            list(pool.map(_proc_ping, range(self.num_workers)))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        self._pool = pool
        return pool

    def close(self) -> None:
        """Shut the process pool down (a no-op for threads)."""
        if self._pool is not None:
            self._pool.shutdown(cancel_futures=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        return len(self.dataset) // self.batch_size  # the last partial batch is dropped

    def set_epoch(self, epoch: int) -> None:
        """Make the next iteration epoch ``epoch`` of the seeded stream: a
        run resumed at epoch ``e`` then sees the batches a run that never
        stopped sees."""
        self._epoch = epoch

    def _finalize(self, batch: Dict, epoch: int, batch_idx: int) -> Dict:
        """``aug_order`` is one value per batch, drawn from (seed, epoch,
        batch_idx)."""
        if "aug_order" in batch:
            batch["aug_order"] = np.asarray(
                np.random.default_rng((self.seed, epoch, batch_idx)).integers(0, 24),
                np.int32,
            )
        return batch

    def __iter__(self) -> Iterator[Dict]:
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        epoch = self._epoch
        # samples are deterministic per (seed, epoch, idx): thread-safe
        if hasattr(self.dataset, "reseed"):
            self.dataset.reseed(epoch)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        n_batches = len(self)
        batches = [
            order[i * self.batch_size: (i + 1) * self.batch_size]
            for i in range(n_batches)
        ]

        if self.use_processes:
            pool = self._ensure_pool()
            submit = lambda idxs: pool.submit(_proc_load, idxs, epoch)  # noqa: E731
            window = self.num_workers * 2
            yield from self._drain(submit, batches, window, epoch)
            return

        def load(idxs):
            return to_model_batch(collate([self.dataset[int(i)] for i in idxs]))

        # the default worker count is clamped to the host's cores (threads
        # beyond them only contend for the GIL on CPU-bound augmentation);
        # an explicit count is honored (I/O-bound adapters)
        threads = self.num_workers
        if self.clamp_threads:
            threads = min(threads, os.cpu_count() or 1)
        with ThreadPoolExecutor(threads) as pool:
            yield from self._drain(lambda idxs: pool.submit(load, idxs), batches,
                                   threads * 2, epoch)

    def _drain(self, submit, batches, window, epoch):
        """Yield the batches in order, ``window`` of them in flight."""
        futures = deque(submit(b) for b in batches[:window])
        next_submit = min(window, len(batches))
        yielded = 0
        while futures:
            yield self._finalize(futures.popleft().result(), epoch, yielded)
            yielded += 1
            if next_submit < len(batches):
                futures.append(submit(batches[next_submit]))
                next_submit += 1


class ConcatLoader:
    """Round-robin over several loaders, injecting metadata
    (reference datautils.py:5-37; len = min-len * count)."""

    def __init__(self, loaders: List, metas: Optional[List[Dict]] = None):
        self.loaders = loaders
        self.metas = metas or [{} for _ in loaders]

    def __len__(self):
        return min(len(ld) for ld in self.loaders) * len(self.loaders)

    def set_epoch(self, epoch: int) -> None:
        for ld in self.loaders:
            ld.set_epoch(epoch)

    def close(self) -> None:
        for ld in self.loaders:
            ld.close()

    def __iter__(self):
        iters = [iter(ld) for ld in self.loaders]
        for _ in range(min(len(ld) for ld in self.loaders)):
            for it, meta in zip(iters, self.metas):
                batch = dict(next(it))
                batch.update(meta)
                yield batch


def loader_meta(dat_name: str, split: str) -> Dict:
    """dataset/root/split metadata injected per batch (datautils.py:22-32)."""
    root = "palm" if dat_name in ("stereohands", "zimsynth") else "wrist"
    return {"dataset": dat_name, "root": root, "split": split}
