"""Host cost of the port's input pipeline (``obman_train_tpu_torch.data``).

    python3 tools/torch_data_pipeline.py [--size 256] [--batch 256] [--batches 8] [--samples 64]

On the synthetic train split at full size (256x256 images), with the host
colour jitter and with ``--device_augment`` (the host then only draws the
factors):

- per-sample milliseconds of ``HandDataset`` in one thread, by stage
  (image fetch, blur, jitter, warp), median of ``--samples`` samples;
- samples/s of the threaded ``BatchLoader`` at ``--batch`` with the CLI's
  default worker count (8, clamped to the cores): one pass over
  ``--batches`` batches, from the iterator's start to its last batch, as
  an epoch of the training loop would see it with a device that never
  waits.

Needs no GPU. Prints one JSON line with ``os.cpu_count()`` beside the
numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from obman_train_tpu_torch.data import factory, loader  # noqa: E402
from obman_train_tpu_torch.data import transforms as T  # noqa: E402


def _stages(ds, idx):
    """One sample's stage times (ms), replaying ``HandDataset``'s image chain."""
    rng = ds._sample_rng(idx)
    times = {}
    t0 = time.perf_counter()
    img = ds.pose_dataset.get_image(idx)
    center, scale = ds.pose_dataset.get_center_scale(idx)
    times["fetch"] = time.perf_counter() - t0
    aff, _ = T.get_affine_transform(center, scale, (ds.inp_res, ds.inp_res))
    x = np.asarray(img, np.float32) / 255.0
    t0 = time.perf_counter()
    x = T.gaussian_blur(x, 0.5 * rng.random())
    times["blur"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not ds.device_augment:
        x = T.color_jitter(x, rng, brightness=ds.brightness, contrast=ds.contrast,
                           saturation=ds.saturation, hue=ds.hue)
    times["jitter"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    T.transform_img(x, aff, (ds.inp_res, ds.inp_res))
    times["warp"] = time.perf_counter() - t0
    return {k: v * 1e3 for k, v in times.items()}


def measure(size: int, batch: int, n_batches: int, n_samples: int,
            device_augment: bool) -> dict:
    ds = factory.get_dataset("synthetic", "train",
                             meta={"size": max(n_batches * batch, n_samples + 1),
                                   "img_res": size},
                             inp_res=size, device_augment=device_augment)
    ds[0]  # builds the native warp
    per_sample, stages = [], []
    for i in range(1, n_samples + 1):
        t0 = time.perf_counter()
        ds[i]
        per_sample.append((time.perf_counter() - t0) * 1e3)
        stages.append(_stages(ds, i))
    workers = min(8, os.cpu_count() or 1)
    bl = loader.BatchLoader(ds, batch_size=batch, num_workers=8, seed=0)
    t0 = time.perf_counter()
    n = sum(1 for _ in bl)
    wall = time.perf_counter() - t0
    return {
        "device_augment": device_augment,
        "per_sample_ms_median": float(np.median(per_sample)),
        "per_sample_ms_all": per_sample,
        "stage_ms_median": {k: float(np.median([s[k] for s in stages])) for k in stages[0]},
        "loader_threads": workers,
        "loader_batches": n,
        "loader_samples_per_s": n * batch / wall,
        "loader_batch_s": wall / n,
    }


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--samples", type=int, default=64)
    args = p.parse_args()
    out = {"cpu_count": os.cpu_count(), "size": args.size, "batch": args.batch,
           "runs": [measure(args.size, args.batch, args.batches, args.samples, da)
                    for da in (False, True)]}
    for r in out["runs"]:
        print(f"device_augment={r['device_augment']}: {r['per_sample_ms_median']:.2f} ms a "
              f"sample in one thread (stages {json.dumps(r['stage_ms_median'])}); loader "
              f"{r['loader_samples_per_s']:.1f} samples/s on {r['loader_threads']} threads",
              flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
