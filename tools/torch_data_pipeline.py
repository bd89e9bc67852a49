"""Host cost of the port's input pipeline (``obman_train_tpu_torch.data``).

    python3 tools/torch_data_pipeline.py [--size 256] [--batch 256] [--batches 8] [--samples 64]

On the synthetic train split at full size (256x256 images), on each image
chain the package can take (``uint8``: cv2, what it picks where cv2
imports; ``float``: the fallback without cv2, cv2 hidden from the process),
with the host colour jitter and with ``--device_augment`` (the host then
only draws the factors):

- per-sample milliseconds of ``HandDataset`` in one thread, and by stage
  (image fetch, blur, jitter, warp), medians of ``--samples`` samples;
- samples/s of the ``BatchLoader`` at ``--batch`` with the CLI's default
  worker count (8): on threads (clamped to the cores) for both chains, and
  on spawned processes (``--loader_processes``) for the uint8 chain: one
  pass over ``--batches`` batches, from the iterator's start to its last
  batch, as an epoch of the training loop would see it with a device that
  never waits (the process pool's spawn is timed apart).

Then the real-decode stage (the JAX ``bench.py`` ``input_pipeline_real_decode``
entry's counterpart): a fabricated ObMan tree of 1024 256x256 JPEG frames
(``data/fabricate.py``) in a temporary directory, ``get_dataset("obman",
...)`` over it with the host jitter and with ``--device_augment`` (the JAX
entry's setting), each sample's stage times as above (``fetch`` is the
JPEG decode and the meta read) and the ``BatchLoader`` on 8 threads at
batch 64: one warm-up pass, then one timed pass, samples/s.

Needs no GPU. Prints one line a row and one JSON line with
``os.cpu_count()`` beside the numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from obman_train_tpu_torch.data import factory, loader  # noqa: E402
from obman_train_tpu_torch.data import transforms as T  # noqa: E402

# the real-decode stage: the JAX bench entry's batch and a tree of 16 of them
DECODE_SAMPLES, DECODE_BATCH = 1024, 64


@contextlib.contextmanager
def _chain(name: str):
    """``float``: cv2 hidden from this process, so the package takes its
    cv2-free chain; ``uint8``: cv2 as installed."""
    if name == "uint8":
        if not T._have_cv2():
            raise SystemExit("the uint8 chain needs cv2")
        yield
        return
    saved = sys.modules.get("cv2", 0)
    sys.modules["cv2"] = None
    try:
        yield
    finally:
        if saved == 0:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved


def _stages(ds, idx, u8: bool):
    """One sample's stage times (ms), replaying ``HandDataset``'s image chain."""
    rng = ds._sample_rng(idx)
    times = {}
    t0 = time.perf_counter()
    img = ds.pose_dataset.get_image(idx)
    center, scale = ds.pose_dataset.get_center_scale(idx)
    times["fetch"] = time.perf_counter() - t0
    aff, _ = T.get_affine_transform(center, scale, (ds.inp_res, ds.inp_res))
    x = np.ascontiguousarray(img, np.uint8) if u8 else np.asarray(img, np.float32) / 255.0
    t0 = time.perf_counter()
    x = T.gaussian_blur(x, 0.5 * rng.random())
    times["blur"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not ds.device_augment:
        jitter = T.color_jitter_u8 if u8 else T.color_jitter
        x = jitter(x, rng, brightness=ds.brightness, contrast=ds.contrast,
                   saturation=ds.saturation, hue=ds.hue)
    times["jitter"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if u8:
        T.warp_affine_u8(x, aff, (ds.inp_res, ds.inp_res))
    else:
        T.transform_img(x, aff, (ds.inp_res, ds.inp_res))
    times["warp"] = time.perf_counter() - t0
    return {k: v * 1e3 for k, v in times.items()}


def _loader_rate(ds, batch: int, processes: bool) -> dict:
    bl = loader.BatchLoader(ds, batch_size=batch, num_workers=8, seed=0,
                            use_processes=processes)
    spawn = None
    try:
        if processes:
            t0 = time.perf_counter()
            bl._ensure_pool()
            spawn = time.perf_counter() - t0
        t0 = time.perf_counter()
        n = sum(1 for _ in bl)
        wall = time.perf_counter() - t0
    finally:
        bl.close()
    workers = 8 if processes else min(8, os.cpu_count() or 1)
    return {"workers": workers, "batches": n, "samples_per_s": n * batch / wall,
            "batch_s": wall / n, "spawn_s": spawn}


def measure(chain: str, size: int, batch: int, n_batches: int, n_samples: int,
            device_augment: bool) -> dict:
    with _chain(chain):
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
            stages.append(_stages(ds, i, chain == "uint8"))
        out = {
            "chain": chain,
            "device_augment": device_augment,
            "per_sample_ms_median": float(np.median(per_sample)),
            "stage_ms_median": {k: float(np.median([s[k] for s in stages]))
                                for k in stages[0]},
            "threads": _loader_rate(ds, batch, processes=False),
        }
        if chain == "uint8":
            out["processes"] = _loader_rate(ds, batch, processes=True)
    return out


def measure_real_decode(tree: str, n_samples: int, batch: int, device_augment: bool) -> dict:
    """The real-decode rows over the ObMan tree under ``tree``. The adapter
    writes its annotation cache relative to the working directory: it is
    built inside ``tree``."""
    cwd = os.getcwd()
    os.chdir(tree)
    try:
        ds = factory.get_dataset(
            "obman", "train", meta={"obman_root": os.path.join(tree, "obman"),
                                    "shapenet_root": os.path.join(tree, "shapenet")},
            device_augment=device_augment)
    finally:
        os.chdir(cwd)
    ds[0]  # builds the native warp
    per_sample, stages = [], []
    for i in range(1, min(n_samples, len(ds) - 1) + 1):
        t0 = time.perf_counter()
        ds[i]
        per_sample.append((time.perf_counter() - t0) * 1e3)
        stages.append(_stages(ds, i, T._have_cv2()))
    bl = loader.BatchLoader(ds, batch_size=batch, num_workers=8, seed=0)
    for _ in bl:  # warm-up pass: thread pool, page cache
        pass
    t0 = time.perf_counter()
    n = sum(b["images"].shape[0] for b in bl)
    wall = time.perf_counter() - t0
    return {
        "chain": "uint8" if T._have_cv2() else "float",
        "device_augment": device_augment,
        "dataset": "obman (fabricated, JPEG on disk)",
        "samples": len(ds),
        "per_sample_ms_median": float(np.median(per_sample)),
        "stage_ms_median": {k: float(np.median([s[k] for s in stages])) for k in stages[0]},
        "threads": {"workers": min(8, os.cpu_count() or 1), "batch": batch, "samples": n,
                    "samples_per_s": n / wall, "batch_s": wall / (n // batch)},
    }


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--samples", type=int, default=64)
    args = p.parse_args()
    out = {"cpu_count": os.cpu_count(), "size": args.size, "batch": args.batch, "runs": [
        measure(chain, args.size, args.batch, args.batches, args.samples, da)
        for chain in ("uint8", "float") for da in (False, True)]}
    from obman_train_tpu_torch.data.fabricate import fabricate_obman

    with tempfile.TemporaryDirectory() as tree:
        t0 = time.perf_counter()
        fabricate_obman(tree, DECODE_SAMPLES, img_size=256)
        out["real_decode_fabricate_s"] = time.perf_counter() - t0
        out["real_decode"] = [
            measure_real_decode(tree, args.samples, DECODE_BATCH, da)
            for da in (False, True)]
    for r in out["runs"] + out["real_decode"]:
        rows = [f"threads {r['threads']['samples_per_s']:.1f} samples/s on "
                f"{r['threads']['workers']}"]
        if "processes" in r:
            rows.append(f"processes {r['processes']['samples_per_s']:.1f} samples/s on "
                        f"{r['processes']['workers']} (spawn {r['processes']['spawn_s']:.1f} s)")
        print(f"{r.get('dataset', 'synthetic')}, {r['chain']} chain, "
              f"device_augment={r['device_augment']}: "
              f"{r['per_sample_ms_median']:.2f} ms a sample in one thread (stages "
              f"{json.dumps(r['stage_ms_median'])}); loader " + "; ".join(rows), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
