"""On-card smoke run of the PyTorch/CUDA port (obman_train_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and nvcc;
run it from the root of the repository. It imports nothing of JAX. Phases,
each fatal on failure:

1. device: name, count, ``nvidia-smi``'s name and power limit, and the
   host's PIL, matplotlib and cv2 (the figures need matplotlib or PIL);
2. build: every CUDA kernel of the port, from the sources in the repo (one
   nvcc per source, all started together), with ptxas registers and spills,
   and beside them the input pipeline's host C++ warp (g++);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' full shapes and on ragged ones (tolerance: exact, values
   and argmins), with CUDA-event times of both (``ms``: eager calls, as
   a caller sees them; ``device_ms``: the same calls replayed from a CUDA
   graph, without the host's cost of a call), the card's lower bound and
   the share of it that the device time reaches, and, for the
   nearest-neighbour kernel, its launch plan (queries per thread R, slices
   S of the search set, blocks) and the dense-plane route's time. Shapes that split the search set
   across blocks (one large cloud, a tiny query set against a large search
   set) carry a minimum whose first occurrence lies in a middle slice and
   repeats in the later ones;
4. backward: ``chamfer_loss`` forward and gradient on the kernel route
   against the same VJP on the plain nearest-neighbour version;
   large-cloud Chamfer path: ``chamfer_loss`` at 1x16384x16384 with its
   gradient and at 1x20000x20000 without, launches counted;
5. slice 1, serving: the contact-config HandNet (ResNet-18, B=256, 256x256
   uint8 frames, synthetic MANO, seeded random weights) through
   ``make_infer``: launch counts, shapes, finiteness, contact masks equal to
   the same forward with the plain inside test, agreement with the CPU port
   on a small input, frames/s with TF32 off and at PyTorch's default; the
   headline ``hand_object`` config timed the same way;
6. slice 2, training: the contact-config train step (B=256, 256x256 float
   frames, the synthetic GT batch, adam at lr 1e-4, frozen BN) through
   ``train.make_train_step``: launch counts per step, loss names and
   finiteness, a falling loss over 10 steps, gradients against the CPU
   port, samples/s, a breakdown of one step and the profiler's busy share;
   then the same step with unfrozen BN (``train_bn=True``): launches per
   step, a falling loss, running statistics that moved and are finite, one
   step's gradients and updated statistics against the CPU port run in
   float64 (the whole gradient within 1e-2 in relative L2, each tensor
   within 1e-1 of its largest entry, each statistic within 1e-2), and
   samples/s against the frozen step on the same net, turn by turn;
7. slice 4, the training entry point: ``cli.traineval``'s ``main()`` in
   this process on the card (contact config, B=256, 256x256 synthetic
   data, ``--synthetic_size 512``: 2 train and 2 val steps an epoch, PyTorch's
   default TF32 setting): (a) 2 epochs; (b) ``--resume`` to a third, which
   must start at epoch 2 with the optimizer's update count and moments
   restored; (c) ``--resume --evaluate``, whose val metrics must equal the
   ones logged for the same weights within 1e-5; (d) 2 epochs with
   ``--device_augment``; (e) 1 epoch with ``--device_augment --display_freq
   1``, which must draw every batch's figure and the PCK curve image; (f)
   1 epoch with ``--loader_processes``; (g) 1 epoch with
   ``--no_freeze_batchnorm``. The data chain is the one the package picks:
   the cv2 uint8 chain where cv2 imports.
   Launches per train step and per val forward inside the loop (a display
   step adds the figure's eval forward), finite losses, the run's files;
   the loop's samples/s (epoch wall clock) and the share of the epoch
   spent waiting for data;
8. slice 5, the serving entry points, at full width: (a) ``DemoModel``
   (hand_object, the headline config) streaming 128 camera frames of
   480x640 uint8 on the device, duplicated and flipped into one B=256
   forward: source frames/s with TF32 off and at PyTorch's default, a
   per-layer breakdown, the card's preprocessing against the CPU port's
   (1e-5); (b) phase 7's contact-config experiment reloaded into
   ``DemoModel``: ``predict_dual`` equal bit for bit to the full HandNet
   forward on the same preprocessed batch, and no kernel launch on the
   demo path; (c) ``export_model`` for cuda with a symbolic batch, served at
   B=1 and B=256 by ``load_exported`` in a fresh process that cannot import
   the port, against the live model (rtol 1e-5, atol 2e-3); (d) cold start
   of a live ``DemoModel`` and of an ``ExportedModel``, each in a fresh
   process; (e) ``video_demo`` over 256 480x640 PNGs at ``--batch 64``, then
   with ``--attention --render --max_frames 8``, and ``image_demo``;
9. the precision rungs (JAX bench.py:107-146), at full width: (a)
   ``hand_object_bf16`` and ``contact_bf16`` through ``make_infer`` at B=256:
   launches per forward, frames/s, the max abs delta (mm) against the
   float32 net on the same weights (a report), the eval BN kernels; (b)
   the bf16 train step of ``contact_bf16``, ``contact_bf16_f32sel`` and
   ``contact_bf16_bf16sel`` (B=256, frozen BN): the first step's loss and
   gradients against the card's float32 step (TF32 off) within
   ``BF16_LOSS_REL`` and ``BF16_GRAD_REL``, launches per step, a falling
   loss over 10 steps, samples/s on the kernel route and with
   ``use_kernel=False`` (the rung's own plane), and one unfrozen-BN bf16
   step with float32 running statistics; (c) the rungs' selection planes
   at 256x778x642 and 256x600x642 against the kernel route: the differing
   selections counted, each within its near-tie bound; (d) one-epoch
   ``cli.traineval`` runs with ``--compute_dtype bfloat16`` (contact flags)
   and ``--no_atlas_mesh``, then the bf16 experiment reloaded in
   ``DemoModel`` and exported, exported against live.

Output: progress lines, then one JSON line ``{"kernels": [...]}``, one
JSON line ``{"traineval": {...}}``, one JSON line ``{"serving": {...}}``,
one JSON line ``{"precision": {...}}``,
the ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
With no GPU, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NoReturn

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit: 67 TFLOP/s of
# float32 outside the tensor cores counts each FMA as two operations. The
# kernels are built with -fmad=false, so every sub, mul, add, min and
# compare is one float32 instruction of its own: half that rate.
PEAK_FP32_INSTS = 67e12 / 2  # float32 instructions/s
PEAK_HBM_BYTES = 3.35e12     # bytes/s
RAYTRI_OPS_PER_TEST = 36  # 31 arithmetic + 5 comparisons, raytri.cu
# nnsqdist.cu per (query, search) pair: 3 sub + 3 mul + 2 add + 1 min. The
# argmin variant is counted at 9 as well: the least work any design of the
# same function does is the min alone (its index bookkeeping can be
# amortised, so a count of 10 could read above 100 % of the bound)
NN_OPS_PER_PAIR = {False: 9, True: 9}
KERNELS = ("raytri", "nnsqdist")

B_FULL, IMAGE = 256, 256


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> NoReturn:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 3) -> float:
    """Mean device milliseconds of ``fn()``: ``iters`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so the
    host's cost of a call (Python, the wrapper, the launch) is not in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture (builds, allocator)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def set_tf32(on: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not os.path.isdir(os.path.join(HERE, "obman_train_tpu_torch")):
        fail("obman_train_tpu_torch/ is not beside chip_smoke.py: run it from the repo")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"device: {kind} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"default TF32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    log(f"nvidia-smi: {smi_line}")
    versions = {}
    for mod in ("PIL", "matplotlib", "cv2", "numpy", "scipy"):
        try:
            versions[mod] = __import__(mod).__version__
        except ImportError:
            versions[mod] = None
    # the figures and the demos' panels: matplotlib where it is installed,
    # else the PIL raster figures of visualize/raster.py; without PIL the
    # figure checks of phases 7 and 8 fail
    versions["figure_renderer"] = ("matplotlib" if versions["matplotlib"]
                                   else "PIL raster" if versions["PIL"] else None)
    log(f"host libraries: {json.dumps(versions)}")
    return kind, count, smi_line, versions


def phase_build():
    from obman_train_tpu_torch.ops.kernels import build

    from obman_train_tpu_torch.native import load_imageproc_lib

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        host = pool.submit(load_imageproc_lib)
        list(pool.map(build.build, KERNELS))
        host.result()
    for name in KERNELS:
        build.load(name)
    log(f"build: {', '.join(k + '.cu' for k in KERNELS)} and the host warp "
        f"native/imageproc.cpp in {time.perf_counter() - t0:.2f} s (in parallel)")
    for name in KERNELS:
        for line in build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")


def raytri_scene(B, P, T, seed):
    """B icosphere(3) meshes of radius 30-70 mm, P points inside, outside
    and straddling each surface, the first T faces."""
    import torch

    from obman_train_tpu_torch.assets import icosphere

    gen = torch.Generator().manual_seed(seed)
    verts, faces = icosphere(3)
    verts = torch.from_numpy(verts.copy())
    faces = torch.from_numpy(faces.astype("int64"))[:T]
    radii = torch.rand(B, 1, 1, generator=gen) * 40 + 30
    centers = torch.randn(B, 1, 3, generator=gen) * 5
    tris = (verts[None] * radii + centers)[:, faces]
    dirs = torch.randn(B, P, 3, generator=gen)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    frac = torch.tensor([0.3, 0.97, 0.999, 1.001, 1.03, 2.0])[
        torch.randint(0, 6, (B, P, 1), generator=gen)]
    pts = centers + dirs * radii * frac
    return pts.cuda(), tris.cuda()


def phase_kernels():
    """K1 against its plain version; returns the kernel's JSON entry."""
    import torch

    from obman_train_tpu_torch.ops import raytri

    set_tf32(False)
    P, T = 778, 1280
    pts, tris = raytri_scene(B_FULL, P, T, seed=0)
    table = raytri.triangle_table(tris)
    got = raytri.raytri_count(pts, table)
    torch.cuda.synchronize()
    want = raytri.raytri_count_plain(pts, table)
    mismatches = int((got != want).sum())
    max_err = int((got - want).abs().max())
    exterior = int((got % 2 == 0).sum())
    interior = got.numel() - exterior
    log(f"raytri B={B_FULL} P={P} T={T}: {mismatches} mismatches, max |count diff| "
        f"{max_err}, interior {interior}, exterior {exterior}")
    if mismatches:
        fail(f"raytri kernel disagrees with the plain version at {mismatches} points")
    if interior == 0 or exterior == 0:
        fail("raytri scene must hold both interior and exterior points")
    for seed, (b, p, t) in enumerate([(3, 100, 77), (2, 129, 513), (1, 1, 1)], 1):
        rp, rt = raytri_scene(b, p, t, seed)
        rtab = raytri.triangle_table(rt)
        n = int((raytri.raytri_count(rp, rtab) != raytri.raytri_count_plain(rp, rtab)).sum())
        log(f"raytri ragged B={b} P={p} T={t}: {n} mismatches")
        if n:
            fail(f"raytri kernel disagrees on the ragged case B={b} P={p} T={t}")

    kernel_ms = cuda_ms(lambda: raytri.raytri_count(pts, table), iters=50)
    device_ms = graph_ms(lambda: raytri.raytri_count(pts, table), iters=50)
    plain_ms = cuda_ms(lambda: raytri.raytri_count_plain(pts, table), iters=3, warmup=1)
    ops = B_FULL * P * T * RAYTRI_OPS_PER_TEST
    nbytes = pts.numel() * 4 + table.numel() * 4 + got.numel() * 4
    ops_ms, bytes_ms = ops / PEAK_FP32_INSTS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f"raytri times (warm L2, TF32 off): kernel {kernel_ms:.4f} ms (device "
        f"{device_ms:.4f} ms), plain {plain_ms:.3f} ms; bound {bound_ms:.4f} ms "
        f"(ops {ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms), {bound_ms / device_ms:.1%} of it")
    return {
        "name": raytri.KERNEL,
        "route": "cuda",
        "source": "obman_train_tpu_torch/ops/kernels/raytri.cu",
        "replaces": "obman_train_tpu/ops/pallas/raytri_kernel.py:29",
        "launches": None,  # filled from the main path's run
        "max_abs_err": max_err,
        "mismatches": mismatches,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "device_ms": device_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,  # no single PyTorch call computes ray parity
        "share_of_bound": bound_ms / device_ms,
        "tf32": "off",
    }


NN_SHAPES = (
    # (B, N, M, variants): the training shapes, both directions
    (256, 600, 642, (False, True)),
    (256, 642, 600, (False, True)),
    (256, 778, 642, (False, True)),
    (256, 642, 778, (False, True)),
    (256, 778, 600, (False, True)),
    # large clouds: K5's route with argmin, K4's min only
    (1, 16384, 16384, (True,)),
    (1, 20000, 20000, (False,)),
    # ragged
    (1, 1, 1, (False, True)),
    (3, 100, 77, (False, True)),
    (2, 129, 2049, (False, True)),
    # the search set split across blocks, ragged slices, ties across them
    (1, 4097, 20000, (False, True)),
    (2, 129, 70000, (False, True)),
    (1, 1, 50000, (False, True)),
)
# The rows of the kernel table: (name, counter, TPU kernel, shape, argmin,
# the path whose run gives the row's launches)
NN_ENTRIES = (
    ("nn_dir_min", "nn_dir_min",
     "obman_train_tpu/ops/pallas/chamfer_kernel.py:82", (256, 778, 600), False, "train_step"),
    ("nn_dir_argmin", "nn_dir_argmin",
     "obman_train_tpu/ops/pallas/chamfer_kernel.py:98", (256, 600, 642), True, "train_step"),
    ("nn_dir_min_large", "nn_dir_min",
     "obman_train_tpu/ops/pallas/chamfer_kernel.py:141", (1, 20000, 20000), False,
     "large_cloud_chamfer"),
    ("nn_dir_argmin_large", "nn_dir_argmin",
     "obman_train_tpu/ops/pallas/chamfer_kernel.py:155", (1, 16384, 16384), True,
     "large_cloud_chamfer"),
)


def nn_scene(B, N, M, seed):
    """Query and search clouds (mm scale) with planted exact ties: every
    8th search point repeats an earlier one, and every 16th query point
    sits on a search point (distance 0, tied with its repeats)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(B, N, 3, generator=gen) * 40
    s = torch.randn(B, M, 3, generator=gen) * 40
    dup = torch.arange(M)[7::8]
    if len(dup):
        s[:, dup] = s[:, torch.randint(0, 7, (len(dup),), generator=gen)]
    on = torch.arange(N)[::16]
    q[:, on] = s[:, torch.randint(0, M, (len(on),), generator=gen)]
    return q.cuda(), s.cuda()


def _plane_route(q, s, with_argmin):
    import torch

    from obman_train_tpu_torch.ops.chamfer import batch_pairwise_sqdist

    d = batch_pairwise_sqdist(q, s)
    return torch.amin(d, dim=2), (torch.argmin(d, dim=2) if with_argmin else None)


def phase_nn_kernels():
    """Every nearest-neighbour entry against its plain version (bitwise
    values, exact argmins) and the times at each shape."""
    import torch

    from obman_train_tpu_torch.ops import nnsqdist

    set_tf32(False)
    rows = {}
    for seed, (B, N, M, variants) in enumerate(NN_SHAPES):
        q, s = nn_scene(B, N, M, seed)
        sms = nnsqdist._sms(q.device)
        plan = nnsqdist._launch_plan(B, N, M, sms)
        nnsqdist.tie_across_slices(q, s, sms)
        for am in variants:
            got, garg = nnsqdist.nn_dir(q, s, am)
            torch.cuda.synchronize()
            want, warg = nnsqdist.nn_dir_plain(q, s, am)
            bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            bad_arg = int((garg != warg).sum()) if am else 0
            err = float((got - want).abs().max())
            label = f"nn_dir {'argmin' if am else 'min'} B={B} N={N} M={M}"
            if bad or bad_arg:
                fail(f"{label}: {bad} values and {bad_arg} argmins differ from the plain version")
            pairs = B * N * M
            big = pairs >= 1e8
            # eager calls (the host's time where that is the longer) and the
            # device's (the same calls replayed from a CUDA graph)
            ms = cuda_ms(lambda: nnsqdist.nn_dir(q, s, am), iters=20 if big else 50)
            device_ms = graph_ms(lambda: nnsqdist.nn_dir(q, s, am), iters=20 if big else 50)
            plain = cuda_ms(lambda: nnsqdist.nn_dir_plain(q, s, am), iters=2, warmup=1)
            plane = cuda_ms(lambda: _plane_route(q, s, am), iters=3 if big else 10, warmup=1)
            ops_ms = pairs * NN_OPS_PER_PAIR[am] / PEAK_FP32_INSTS * 1e3
            nbytes = (q.numel() + s.numel() + B * N) * 4 + (B * N * 8 if am else 0)
            bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
            row = dict(max_abs_err=err, mismatches=bad + bad_arg, ms=ms, device_ms=device_ms,
                       plain_ms=plain,
                       plane_ms=plane, bound_ms=max(ops_ms, bytes_ms),
                       bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                       plan=dict(zip(("rows", "slices", "slice_len", "blocks"), plan)))
            row["share_of_bound"] = row["bound_ms"] / device_ms
            rows[(B, N, M, am)] = row
            log(f"{label}: 0 mismatches (ties planted), plan R={plan[0]} S={plan[1]} "
                f"slice {plan[2]} blocks {plan[3]}; kernel {ms:.4f} ms (device "
                f"{device_ms:.4f} ms), plain "
                f"{plain:.3f} ms, dense plane {plane:.3f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}; ops {ops_ms:.4f}, bytes {bytes_ms:.4f}), device time "
                f"{row['share_of_bound']:.1%} of it")
        del q, s
    torch.cuda.empty_cache()
    entries = []
    for name, counter, replaces, (B, N, M), am, path in NN_ENTRIES:
        row = rows[(B, N, M, am)]
        entries.append({
            "name": name, "counter": counter, "route": "cuda",
            "source": "obman_train_tpu_torch/ops/kernels/nnsqdist.cu",
            "replaces": replaces, "shape": [B, N, M], "path": path, "launches": None,
            "max_abs_err": row["max_abs_err"], "mismatches": row["mismatches"],
            "ms": row["ms"], "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a nearest-neighbour min
            "plane_ms": row["plane_ms"], "ops_per_pair": NN_OPS_PER_PAIR[am],
            "share_of_bound": row["share_of_bound"], "plan": row["plan"], "tf32": "off",
        })
    return entries


def phase_backward():
    """``chamfer_loss`` forward + gradient on the kernel route against the
    same VJP on the plain nearest-neighbour version (values bitwise equal;
    the backward's index_add_ is atomic on CUDA, so the gradients may
    differ in the last bits: rtol 1e-5, atol 1e-9), and the times of the
    kernel and dense-plane routes."""
    import torch

    from obman_train_tpu_torch.ops import chamfer, nnsqdist

    set_tf32(False)
    out = {}
    for B, N, M in ((256, 600, 642), (1, 16384, 16384)):
        preds, gts = nn_scene(B, N, M, seed=B + N)

        def route(use_kernel):
            p = preds.clone().requires_grad_(True)
            g = gts.clone().requires_grad_(True)
            l1, l2 = chamfer.chamfer_loss(p, g, use_kernel=use_kernel)
            loss = torch.mean(l1 + l2)
            loss.backward()
            return loss.detach(), p.grad, g.grad

        loss, gp, gg = route(True)
        # the plain route: plain minima, the same VJP
        min_g2p, arg_g2p = nnsqdist.nn_dir_plain(gts, preds, True)
        min_p2g, arg_p2g = nnsqdist.nn_dir_plain(preds, gts, True)
        want = torch.mean(torch.mean(min_p2g, 1) + torch.mean(min_g2p, 1))
        cot_g = torch.full_like(min_g2p, 1.0 / (B * M))
        cot_p = torch.full_like(min_p2g, 1.0 / (B * N))
        wgg, wgp = chamfer._min_sqdists_bwd(gts, preds, arg_g2p, arg_p2g, cot_g, cot_p)
        torch.cuda.synchronize()
        if not torch.equal(loss, want):
            fail(f"chamfer_loss B={B} N={N} M={M}: kernel route {loss} != plain {want}")
        errs = {}
        for name, a, b in (("preds", gp, wgp), ("gts", gg, wgg)):
            errs[name] = float((a - b).abs().max())
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-9):
                fail(f"chamfer_loss grad wrt {name} B={B} N={N} M={M}: "
                     f"max abs err {errs[name]}")
        big = B * N * M >= 1e8
        it = 10 if big else 20
        times = {}
        for label, uk in (("kernel", True), ("plane", False)):
            def fwd(uk=uk):
                with torch.no_grad():
                    return chamfer.chamfer_loss(preds, gts, use_kernel=uk)
            times[f"{label}_fwd_ms"] = cuda_ms(fwd, iters=it)
            times[f"{label}_fwd_grad_ms"] = cuda_ms(lambda uk=uk: route(uk), iters=it)
        out[f"{B}x{N}x{M}"] = dict(times, max_abs_err_grad=errs)
        log(f"chamfer_loss B={B} N={N} M={M}: loss equal to the plain route, grad max abs "
            f"err {errs} (rtol 1e-5, atol 1e-9); times {json.dumps(times)}")
        del preds, gts
    torch.cuda.empty_cache()
    return out


def phase_large_cloud():
    """The large-cloud Chamfer path (the JAX bench's ``chamfer_large``), the
    TPU route of K4 and K5: ``chamfer_loss`` with its default dispatch,
    forward + gradient at 1x16384x16384 (argmin sweeps) and forward alone at
    1x20000x20000 (min-only sweeps), each run counted from 0 and its loss
    held bitwise against the plain minima. Returns the launches of both."""
    import torch

    from obman_train_tpu_torch.ops import chamfer, nnsqdist
    from obman_train_tpu_torch.ops.kernels import LAUNCHES

    launches = {}
    for (B, N, M), grad in (((1, 16384, 16384), True), ((1, 20000, 20000), False)):
        preds, gts = nn_scene(B, N, M, seed=N + 1)
        p = preds.clone().requires_grad_(grad)
        LAUNCHES.clear()
        l1, l2 = chamfer.chamfer_loss(p, gts)
        loss = torch.mean(l1 + l2)
        if grad:
            loss.backward()
        torch.cuda.synchronize()
        counted = dict(LAUNCHES)
        want_counts = {nnsqdist.KERNEL_ARGMIN if grad else nnsqdist.KERNEL_MIN: 2}
        if counted != want_counts:
            fail(f"large-cloud chamfer_loss {B}x{N}x{M} launched {counted}, want {want_counts}")
        want = torch.mean(torch.mean(nnsqdist.nn_dir_plain(preds, gts)[0], 1)
                          + torch.mean(nnsqdist.nn_dir_plain(gts, preds)[0], 1))
        if not torch.equal(loss.detach(), want):
            fail(f"large-cloud chamfer_loss {B}x{N}x{M}: {float(loss)} != plain {float(want)}")
        if grad and not torch.isfinite(p.grad).all():
            fail(f"large-cloud chamfer_loss {B}x{N}x{M}: non-finite gradient")
        launches.update(counted)
        log(f"large-cloud chamfer_loss {B}x{N}x{M} ({'forward + grad' if grad else 'forward'}):"
            f" launches {counted}, loss {float(loss)} equal to the plain minima")
        del preds, gts, p
    torch.cuda.empty_cache()
    return launches


def synthetic_gt(B, S, seed):
    """The JAX bench's synthetic all-losses batch (bench.py:166-184):
    float frames x/255 - 0.5, sides, joints3d/verts3d N(0, 30) mm, 600
    object points N(0, 50) mm, as numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {
        "images": rng.integers(0, 256, (B, S, S, 3)).astype(np.float32) / 255.0 - 0.5,
        "sides": rng.integers(0, 2, (B,)).astype(np.int32),
        "joints3d": rng.normal(0, 30, (B, 21, 3)).astype(np.float32),
        "verts3d": rng.normal(0, 30, (B, 778, 3)).astype(np.float32),
        "objpoints3d": rng.normal(0, 50, (B, 600, 3)).astype(np.float32),
    }


TRAIN_LOSS_KEYS = {
    "mano_verts3d", "mano_joints3d", "mano_total_loss", "contact_auc",
    "penetration_loss", "attraction_loss", "contact_loss", "max_penetr",
    "mean_penetr", "atlas_trans3d", "atlas_scale3d", "final_chamfer_loss",
    "atlas_objpoints3d", "total_loss",
}
# per train step: 2 atlas Chamfer calls + the contact block, two argmin
# sweeps each; one min-only sweep for min_sqdist_to; one K1 launch
TRAIN_LAUNCHES = {"raytri_count": 1, "nn_dir_argmin": 6, "nn_dir_min": 1}
# per eval forward with losses (a val step, or a display step's figure):
# the contact block (K1, two argmin sweeps), the two Chamfer losses without
# a gradient (two min sweeps each) and min_sqdist_to (one)
EVAL_LAUNCHES = {"raytri_count": 1, "nn_dir_argmin": 2, "nn_dir_min": 5}


def _train_setup(device, B, S, seed=0):
    import torch

    from obman_train_tpu_torch import train
    from obman_train_tpu_torch.config import TrainConfig
    from obman_train_tpu_torch.models import BatchSpec

    net = _build_net(contact=True, seed=seed, device=device)
    tcfg = TrainConfig()
    opt = train.make_optimizer(tcfg, net)
    state = train.create_train_state(net, opt, tcfg)
    step = train.make_train_step(net, opt, BatchSpec(), device=device)
    batch = {k: torch.from_numpy(v).to(device) for k, v in synthetic_gt(B, S, seed + 1).items()}
    return net, state, step, batch


def _grads(net, batch):
    from obman_train_tpu_torch.models import BatchSpec

    net.zero_grad(set_to_none=True)
    total, _, _ = net(batch, BatchSpec())
    total.backward()
    return {n: p.grad.detach().cpu() for n, p in net.named_parameters() if p.grad is not None}


def phase_train():
    """The contact-config train step at full width; returns the launches
    of one step and the measurements."""
    import torch

    from obman_train_tpu_torch.ops.kernels import LAUNCHES

    dev = torch.device("cuda")
    set_tf32(False)
    result = {}

    # gradients of one step against the CPU port, B=4, 64 px, TF32 off.
    # The CPU's "auto" Chamfer route is the dense plane (rx+ry-2xy), the
    # card's the kernel (direct differences): a near-tie may pick another
    # neighbour, so each tensor is held to 1e-2 of its largest entry.
    small = {k: torch.from_numpy(v) for k, v in synthetic_gt(4, 64, 5).items()}
    cpu_g = _grads(_build_net(contact=True, seed=0, device="cpu"), small)
    gpu_net = _build_net(contact=True, seed=0, device=dev)
    gpu_g = _grads(gpu_net, {k: v.to(dev) for k, v in small.items()})
    worst = max(float((gpu_g[n] - g).abs().max() / max(float(g.abs().max()), 1e-12))
                for n, g in cpu_g.items())
    if set(cpu_g) != set(gpu_g) or worst > 1e-2:
        fail(f"train-step gradients on the card differ from the CPU port: worst "
             f"max|diff|/max|grad| {worst}")
    log(f"train grads GPU vs CPU port, B=4 64 px, TF32 off: {len(cpu_g)} tensors, worst "
        f"max|diff|/max|grad| {worst:.3e} (limit 1e-2)")
    result["grad_worst_rel_vs_cpu"] = worst
    del gpu_net, gpu_g, cpu_g

    net, state, step, batch = _train_setup(dev, B_FULL, IMAGE)
    LAUNCHES.clear()
    state, losses = step(state, batch)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"train step launches (one step, B={B_FULL}): {launches}")
    for name, n in TRAIN_LAUNCHES.items():
        if launches.get(name, 0) != n:
            fail(f"the train step launched {name} {launches.get(name, 0)} times, want {n}")
    if set(losses) != TRAIN_LOSS_KEYS:
        fail(f"train loss keys {sorted(losses)}, want {sorted(TRAIN_LOSS_KEYS)}")
    bad = [k for k, v in losses.items() if not torch.isfinite(v).all()]
    if bad:
        fail(f"non-finite train losses: {bad}")
    first = float(losses["total_loss"])
    for _ in range(9):
        state, losses = step(state, batch)
    last = float(losses["total_loss"])
    log(f"train total_loss step 1 {first}, step 10 {last}; losses at step 10: "
        + json.dumps({k: float(v) for k, v in losses.items()}))
    if not last < first:
        fail(f"the total loss did not fall over 10 steps: {first} -> {last}")
    result.update(launches=launches, loss_step1=first, loss_step10=last)

    rates = {}
    for label, cudnn_tf32 in (("tf32_off", False), ("pytorch_default", True)):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        step(state, batch)
        rates[label] = _train_windows(state, step, batch)
        result[f"breakdown_{label}"] = _train_breakdown(net, state, step, batch, label)
    log(f"train samples/s at B={B_FULL}, 256x256 float frames, adam, frozen BN, three "
        f"windows of five steps: {json.dumps(rates)}")
    result["samples_per_s"] = rates
    result["route_ab"] = _route_ab(state, step, batch)
    set_tf32(False)
    del net, state, batch
    torch.cuda.empty_cache()
    return result


# conv biases right before a training-mode BN: the batch mean removes them,
# so their exact gradient is 0 and both devices hold rounding noise there
BEFORE_BN = ("atlas_branch.decoder.conv1.bias", "atlas_branch.decoder.conv2.bias",
             "atlas_branch.decoder.conv3.bias")


def _unfrozen_grads(net, batch):
    """One train-mode forward + backward: the gradients and the updated
    running statistics (on the CPU), the net back in ``eval()``."""
    from obman_train_tpu_torch.models import BatchSpec

    net.zero_grad(set_to_none=True)
    net.train()
    try:
        total, _, _ = net(batch, BatchSpec())
        total.backward()
    finally:
        net.eval()
    grads = {n: p.grad.detach().cpu() for n, p in net.named_parameters() if p.grad is not None}
    stats = {k: v.detach().cpu() for k, v in net.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return grads, stats


def phase_train_unfrozen():
    """The contact-config train step with unfrozen BN (``train_bn=True``),
    B=256, full width: launches per step, a falling loss over 10 steps,
    running statistics that moved and are finite, one step's gradients and
    updated statistics against the CPU port run in float64 (TF32 off; the
    bounds below), and samples/s against the frozen step on the
    same net, in turns frozen, unfrozen, unfrozen, frozen, under both
    precision settings."""
    import torch

    from obman_train_tpu_torch import train
    from obman_train_tpu_torch.models import BatchSpec
    from obman_train_tpu_torch.ops.kernels import LAUNCHES

    dev = torch.device("cuda")
    set_tf32(False)
    result = {}
    # gradients of one train-mode step, B=4, 64 px, TF32 off: the card's
    # float32 and the CPU port's float32 against the CPU port in float64.
    # Train-mode BN over 16 values a channel at the last stage makes the
    # gradients ill-conditioned: float32 rounding (and cuDNN's FFT
    # convolutions on the card) move single tensors by up to ~7e-2 of their
    # largest entry (measured: CPU float32 5.4e-2 on the decoder's bn2.bias
    # here, the card 7.1e-2 on a layer3 conv in tests/test_torch_cuda.py),
    # while the whole gradient stays within ~1e-3 in L2. So: the whole
    # gradient within 1e-2 (relative L2), each tensor within 1e-1 of its
    # largest entry, each running statistic within 1e-2 (well conditioned)
    small = {k: torch.from_numpy(v) for k, v in synthetic_gt(4, 64, 5).items()}
    ref_g, ref_s = _unfrozen_grads(_build_net(contact=True, seed=0, device="cpu").double(),
                                   {k: v.double() if v.is_floating_point() else v
                                    for k, v in small.items()})
    cpu_g, cpu_s = _unfrozen_grads(_build_net(contact=True, seed=0, device="cpu"), small)
    gpu_g, gpu_s = _unfrozen_grads(_build_net(contact=True, seed=0, device=dev),
                                   {k: v.to(dev) for k, v in small.items()})
    if not set(ref_g) == set(cpu_g) == set(gpu_g) or not set(ref_s) == set(cpu_s) == set(gpu_s):
        fail("unfrozen-BN step: the card's gradients or statistics have other keys")
    names = [n for n in ref_g if n not in BEFORE_BN]
    measures = {}
    for label, g, st in (("card", gpu_g, gpu_s), ("cpu_float32", cpu_g, cpu_s)):
        d = {n: (g[n].double() - ref_g[n]) for n in names}
        tensor = {n: float(d[n].abs().max() / ref_g[n].abs().max()) for n in names}
        worst = max(tensor, key=tensor.get)
        measures[label] = {
            "grad_rel_l2": (sum(float((v ** 2).sum()) for v in d.values())
                            / sum(float((ref_g[n] ** 2).sum()) for n in names)) ** 0.5,
            "grad_worst_tensor": [worst, tensor[worst]],
            "stats_worst": max(float((st[k].double() - v).abs().max() / v.abs().max())
                               for k, v in ref_s.items())}
    zero = {n: max(float(cpu_g[n].abs().max()), float(gpu_g[n].abs().max()))
            / float(cpu_g[n.replace(".bias", ".weight")].abs().max()) for n in BEFORE_BN}
    log(f"unfrozen-BN grads and running stats, B=4 64 px, TF32 off, against the CPU port "
        f"in float64: {json.dumps(measures)}; zero-gradient biases at most "
        f"{max(zero.values()):.3e} of their weight's gradient (limit 1e-4)")
    card = measures["card"]
    if (card["grad_rel_l2"] > 1e-2 or card["grad_worst_tensor"][1] > 1e-1
            or card["stats_worst"] > 1e-2 or max(zero.values()) > 1e-4):
        fail(f"unfrozen-BN step on the card: {card} (limits 1e-2 L2, 1e-1 a tensor, "
             f"1e-2 statistics); zero-gradient biases {zero}")
    result.update(vs_cpu_float64=measures, zero_grad_bias_rel=max(zero.values()))

    net, state, frozen_step, batch = _train_setup(dev, B_FULL, IMAGE)
    step = train.make_train_step(net, state.optimizer, BatchSpec(), train_bn=True, device=dev)
    before = {k: v.clone() for k, v in net.state_dict().items()
              if k.endswith(("running_mean", "running_var"))}
    LAUNCHES.clear()
    state, losses = step(state, batch)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"unfrozen-BN train step launches (one step, B={B_FULL}): {launches}")
    for name, n in TRAIN_LAUNCHES.items():
        if launches.get(name, 0) != n:
            fail(f"the unfrozen-BN step launched {name} {launches.get(name, 0)} times, want {n}")
    if net.training or set(losses) != TRAIN_LOSS_KEYS:
        fail(f"unfrozen-BN step: net.training {net.training}, losses {sorted(losses)}")
    first = float(losses["total_loss"])
    for _ in range(9):
        state, losses = step(state, batch)
    last = float(losses["total_loss"])
    after = {k: v for k, v in net.state_dict().items() if k in before}
    moved = sum(not torch.equal(v, before[k]) for k, v in after.items())
    finite = all(bool(torch.isfinite(v).all()) for v in after.values())
    log(f"unfrozen-BN total_loss step 1 {first}, step 10 {last}; running statistics "
        f"moved {moved} of {len(after)}, finite {finite}")
    if not last < first or moved != len(after) or not finite:
        fail(f"unfrozen-BN: loss {first} -> {last}, stats moved {moved}/{len(after)}, "
             f"finite {finite}")
    result.update(launches=launches, loss_step1=first, loss_step10=last,
                  stats_moved=moved, stats_total=len(after))
    rates = {}
    for label, cudnn_tf32 in (("tf32_off", False), ("pytorch_default", True)):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        out = {"frozen": [], "unfrozen": []}
        for kind in ("frozen", "unfrozen", "unfrozen", "frozen"):
            fn = frozen_step if kind == "frozen" else step
            fn(state, batch)
            out[kind] += _train_windows(state, fn, batch)
        rates[label] = out
    log(f"train samples/s at B={B_FULL}, frozen vs unfrozen BN, turns F U U F, three "
        f"windows of five steps each: {json.dumps(rates)}")
    result["samples_per_s"] = rates
    set_tf32(False)
    del net, state, batch
    torch.cuda.empty_cache()
    return result


def _train_windows(state, step, batch):
    import torch

    torch.cuda.synchronize()
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(5):
            step(state, batch)
        torch.cuda.synchronize()
        windows.append(B_FULL * 5 / (time.perf_counter() - t0))
    return sorted(windows)


def _route_ab(state, step, batch):
    """The train step with every ``"auto"`` nearest-neighbour call on the
    kernel (the port's rule) and on the dense plane (what the JAX rule
    picks at these shapes), in turns kernel, plane, plane, kernel:
    samples/s and peak memory, TF32 off."""
    import torch

    from obman_train_tpu_torch.ops import chamfer

    set_tf32(False)
    rule = chamfer._use_kernel
    plane_rule = lambda x, y, use_kernel: (  # noqa: E731
        False if use_kernel == "auto" else rule(x, y, use_kernel))
    out = {"kernel": [], "plane": []}
    peak = {}
    try:
        for route in ("kernel", "plane", "plane", "kernel"):
            chamfer._use_kernel = rule if route == "kernel" else plane_rule
            step(state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out[route] += _train_windows(state, step, batch)
            peak[route] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        chamfer._use_kernel = rule
    log(f"train route A/B (TF32 off, kernel/plane/plane/kernel, three windows of five "
        f"steps each turn): samples/s {json.dumps(out)}; peak GiB {json.dumps(peak)}")
    return {"samples_per_s": out, "peak_gib": peak}


def _train_breakdown(net, state, step, batch, label):
    """One step in three parts (CUDA events): forward + losses, backward,
    optimizer update; then the profiler's busy share over three steps."""
    import torch

    from obman_train_tpu_torch.models import BatchSpec

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    parts = {"forward_losses": [], "backward": [], "optimizer": []}
    for _ in range(3):
        net.zero_grad(set_to_none=True)
        ev[0].record()
        total, _, _ = net(batch, BatchSpec(), regul_scale=state.regul_scale)
        ev[1].record()
        total.backward()
        ev[2].record()
        state.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        for i, k in enumerate(parts):
            parts[k].append(ev[i].elapsed_time(ev[i + 1]))
    ms = {k: sorted(v)[1] for k, v in parts.items()}
    log(f"train breakdown ({label}) ms per B={B_FULL} step (median of 3): {json.dumps(ms)}")
    return {"parts_ms": ms,
            **_profile(lambda: step(state, batch), f"train profiler ({label})", "step")}


def _profile(fn, label, unit):
    """The device's busy share and top kernels from torch.profiler over
    three calls of ``fn``, logged and returned ({} when the profiler
    records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.device_time_total for e in kernels) / 1e6
    if device_s == 0:
        log(f"{label}: no device time recorded; busy share not measured")
        return {}
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3 / 3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log(f"{label}: {len(kernels) / 3:.0f} kernels per {unit}, device busy "
        f"{device_s / 3 * 1e3:.3f} ms of {wall / 3 * 1e3:.3f} ms wall per {unit} (busy "
        f"share {device_s / wall:.4f}, under the profiler)")
    log(f"{label} top kernels, ms per {unit}: "
        + json.dumps({name[:70]: t for name, t in top}))
    return {"busy_share": device_s / wall, f"kernels_per_{unit}": len(kernels) / 3,
            f"device_ms_per_{unit}": device_s / 3 * 1e3,
            f"wall_ms_per_{unit}": wall / 3 * 1e3}


def _build_net(contact: bool, seed: int, device, **model_kw):
    """The bench configurations (bench.py:100-146): hand_object, or contact
    with ``contact``; ``model_kw`` sets ``compute_dtype`` and
    ``geometry_dtype`` (hand_object_bf16, contact_bf16*). The weights are
    the seed's, whatever the dtypes."""
    from obman_train_tpu_torch.assets import synthetic_mano_assets
    from obman_train_tpu_torch.config import AtlasConfig, ContactConfig, ModelConfig
    from obman_train_tpu_torch.models import build_handnet
    from obman_train_tpu_torch.weights import init_weights

    cfg = ModelConfig(
        atlas=AtlasConfig(predict_trans=True, predict_scale=True),
        contact=(ContactConfig(contact_lambda=0.167, collision_lambda=0.167)
                 if contact else ContactConfig()),
        **model_kw,
    )
    net = build_handnet(cfg, synthetic_mano_assets("right"),
                        synthetic_mano_assets("left"), device="cpu")
    return init_weights(net, seed=seed).to(device)


def _frames(B, S, seed, device):
    import torch

    gen = torch.Generator().manual_seed(seed)
    frames = torch.randint(0, 256, (B, S, S, 3), generator=gen, dtype=torch.uint8)
    sides = torch.randint(0, 2, (B,), generator=gen, dtype=torch.int32)
    return frames.to(device), sides.to(device)


def _fps(fn, frames, sides, windows=3, iters=5):
    """Frames/s of ``fn`` in ``windows`` host-clock windows of ``iters``
    forwards each, every window closed by a synchronize."""
    import torch

    fn(frames, sides)
    torch.cuda.synchronize()
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(frames, sides)
        torch.cuda.synchronize()
        rates.append(frames.shape[0] * iters / (time.perf_counter() - t0))
    return sorted(rates)


def phase_breakdown(net, frames, sides, label):
    """Per-layer times of one contact-config forward (CUDA events, so a
    launch-bound layer shows its real duration), and the device's busy
    share and top kernels from torch.profiler over three forwards."""
    import torch

    from obman_train_tpu_torch.models import INFER_SPEC
    from obman_train_tpu_torch.ops import compute_contact_loss, mesh_contains_points

    def forward():
        return net({"images": frames, "sides": sides}, INFER_SPEC, no_loss=True,
                   force_hand=True, force_objects=True)

    with torch.inference_mode():
        image = frames.permute(0, 3, 1, 2).to(torch.float32) / 255.0 - 0.5
        feats, _ = net.base_net(image)
        mano = net.mano_branch(feats, sides)
        atlas = net.atlas_branch.forward_inference(feats)
        tris = atlas["objpoints3d"][:, net.ico_faces]
        stages = {
            "normalize": lambda: frames.permute(0, 3, 1, 2).to(torch.float32) / 255.0 - 0.5,
            "encoder": lambda: net.base_net(image),
            "mano_heads_both_sides": lambda: net.mano_branch(feats, sides),
            "atlas_decoder": lambda: net.atlas_branch.forward_inference(feats),
            "contact_block": lambda: compute_contact_loss(
                mano["verts"], atlas["objpoints3d"], net.ico_faces, **_contact_kw(net)),
            "inside_test_table_and_k1": lambda: mesh_contains_points(mano["verts"], tris),
            "forward": forward,
        }
        ms = {name: cuda_ms(fn, iters=5) for name, fn in stages.items()}
        log(f"breakdown ({label}) ms per B={frames.shape[0]} forward: {json.dumps(ms)}")
        _profile(forward, f"profiler ({label})", "forward")


def phase_slice(entry):
    import torch

    from obman_train_tpu_torch.infer import make_infer
    from obman_train_tpu_torch.models import INFER_SPEC
    from obman_train_tpu_torch.ops import compute_contact_loss, mesh_contains_points_plain
    from obman_train_tpu_torch.ops.kernels import LAUNCHES
    from obman_train_tpu_torch.ops.nnsqdist import KERNEL_ARGMIN
    from obman_train_tpu_torch.ops.raytri import KERNEL

    dev = torch.device("cuda")
    set_tf32(False)
    net = _build_net(contact=True, seed=0, device=dev)
    infer = make_infer(net)
    frames, sides = _frames(B_FULL, IMAGE, seed=1, device=dev)

    # the main path, counted
    LAUNCHES.clear()
    out = infer(frames, sides)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"serving path launches (one forward): {launches}")
    for name in (KERNEL, KERNEL_ARGMIN):
        if launches.get(name, 0) == 0:
            fail(f"the serving path never launched {name}")
    entry["launches_per_forward"] = launches[KERNEL]

    shapes = {"verts": (B_FULL, 778, 3), "joints": (B_FULL, 21, 3),
              "objpoints3d": (B_FULL, 642, 3)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            fail(f"{key} shape {tuple(out[key].shape)}, want {shape}")
        if not torch.isfinite(out[key]).all():
            fail(f"{key} has non-finite values")
    info = out["contact_info"]
    for key in ("attraction_masks", "repulsion_masks"):
        if info[key].dtype != torch.bool or tuple(info[key].shape) != (B_FULL, 778):
            fail(f"contact_info[{key}] is {info[key].dtype} {tuple(info[key].shape)}")
    if not torch.isfinite(info["min_dists"]).all():
        fail("contact_info[min_dists] has non-finite values")

    # same forward, inside test swapped for the plain version (test hook)
    with torch.inference_mode():
        _, ref, _ = net({"images": frames, "sides": sides}, INFER_SPEC, no_loss=True,
                        force_hand=True, force_objects=True,
                        contains=mesh_contains_points_plain)
    same_floats = all(torch.equal(out[k], ref[k]) for k in ("verts", "objpoints3d"))
    for key in ("attraction_masks", "repulsion_masks"):
        n = int((info[key] != ref["contact_info"][key]).sum())
        log(f"slice {key}: {n} mismatches kernel vs plain inside test "
            f"(identical input floats: {same_floats}); {int(info[key].sum())} set")
        if n:
            fail(f"contact_info[{key}] differs between the kernel and the plain path")

    # agreement with the CPU port on a small input (the CPU port is held
    # against the JAX package by tests/test_torch_*.py)
    small_f, small_s = _frames(4, 64, seed=2, device="cpu")
    gpu = make_infer(net)(small_f.to(dev), small_s.to(dev))
    cpu_net = _build_net(contact=True, seed=0, device="cpu")
    cpu = make_infer(cpu_net)(small_f, small_s)
    errs = {k: float((gpu[k].cpu() - cpu[k]).abs().max()) for k in shapes}
    log(f"slice GPU vs CPU port, B=4 64 px, TF32 off: max abs err {errs}")
    if errs["verts"] > 1e-2 or errs["joints"] > 1e-2 or errs["objpoints3d"] > 2e-2:
        fail(f"GPU forward disagrees with the CPU port: {errs}")
    # the CPU port's contact block on the card's output floats: the parity
    # masks must be identical; the zone winners may flip only at near-ties
    # of the two devices' nearest-distance planes, so they are reported
    _, _, cinfo, _ = compute_contact_loss(
        gpu["verts"].cpu(), gpu["objpoints3d"].cpu(), cpu_net.ico_faces,
        **_contact_kw(cpu_net))
    ginfo = {k: v.cpu() for k, v in gpu["contact_info"].items()}
    if not torch.equal(cinfo["repulsion_masks"], ginfo["repulsion_masks"]):
        fail("repulsion masks on the card differ from the CPU port on the same floats")
    if not torch.allclose(cinfo["min_dists"], ginfo["min_dists"], rtol=1e-4, atol=1e-2):
        fail("min_dists on the card differ from the CPU port on the same floats")
    log("slice GPU vs CPU contact block on the same floats: repulsion masks equal, "
        f"attraction-mask near-tie flips "
        f"{int((cinfo['attraction_masks'] != ginfo['attraction_masks']).sum())}")

    fps = {}
    for label, tf32 in (("tf32_off", False), ("pytorch_default", None)):
        if tf32 is None:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = True
        else:
            set_tf32(tf32)
        fps[f"contact_{label}"] = _fps(infer, frames, sides)
        phase_breakdown(net, frames, sides, label)
    del net, infer, out, ref
    torch.cuda.empty_cache()

    ho = _build_net(contact=False, seed=0, device=dev)
    ho_infer = make_infer(ho)
    ho_out = ho_infer(frames, sides)
    if "contact_info" in ho_out or not all(
            torch.isfinite(ho_out[k]).all() for k in shapes):
        fail("hand_object forward: unexpected contact_info or non-finite outputs")
    set_tf32(False)
    fps["hand_object_tf32_off"] = _fps(ho_infer, frames, sides)
    torch.backends.cudnn.allow_tf32 = True
    fps["hand_object_pytorch_default"] = _fps(ho_infer, frames, sides)
    log("slice frames/s at B=256, 256x256 uint8 frames on the device, fp32 "
        "(tf32_off: matmul and cuDNN TF32 off; pytorch_default: cuDNN TF32 on, "
        f"matmul off), three windows of five forwards each: {json.dumps(fps)}")
    return fps


TRAINEVAL_SIZE = 512  # samples per split: 2 train and 2 val steps an epoch at B=256
TRAINEVAL_FILES = ("checkpoint.pth.tar", "model_best.pth.tar", "opt.json", "logs/train.txt",
                   "logs/val.txt", "metrics.json", "pcks/val/epoch_1.pkl")


def _traineval_argv(exp, contact=True):
    return ["--train_datasets", "synthetic", "--val_datasets", "synthetic",
            "--mano_assets", "synthetic", "--synthetic_size", str(TRAINEVAL_SIZE),
            "--image_size", str(IMAGE), "--train_batch", str(B_FULL),
            "--test_batch", str(B_FULL), "--atlas_predict_trans", "--atlas_predict_scale",
            "--display_freq", "0", "--exp_id", exp] + (
                ["--contact_lambda", "0.167", "--collision_lambda", "0.167"] if contact else [])


def _logged(exp, split):
    from obman_train_tpu_torch.utils.logging import parse_log_line

    with open(os.path.join(exp, "logs", f"{split}.txt")) as f:
        return [parse_log_line(line) for line in f if line.strip()]


def phase_traineval(tmp):
    """Slice 4's main path: ``cli.traineval.main()`` in this process (see
    the module docstring, phase 7), its runs under ``tmp``. Each epoch pass
    of the loop is wrapped to count the kernel launches and the wall clock
    of that pass; returns the launches of run (a), the measurements and
    the contact-config experiment directory of runs (a)-(c)."""
    import numpy as np
    import torch

    from obman_train_tpu_torch.cli import traineval
    from obman_train_tpu_torch.ops.kernels import LAUNCHES
    from obman_train_tpu_torch.train import loop

    # a user's process: PyTorch's default (cuDNN TF32 on, matmul TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}
    passes = []
    original = loop.epoch_pass

    def counted(loader, state, epoch, train=True, **kw):
        before = dict(LAUNCHES)
        first_of_run = not any(p["run"] == passes_run[0] for p in passes)
        restored = None
        if train and first_of_run and passes_run[0] == "b":
            restored = _optimizer_matches(state, passes_run[1])
        step0 = state.step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(loader, state, epoch, train=train, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        meters = out[1].averages()
        steps = len(loader)
        passes.append({
            "run": passes_run[0], "train": train, "epoch": epoch, "steps": steps,
            "samples": steps * B_FULL, "wall_s": wall, "samples_per_s": steps * B_FULL / wall,
            "data_time_s": meters["data_time"] * steps,
            "data_wait_share": meters["data_time"] * steps / wall,
            "launches": {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES
                         if LAUNCHES[k] != before.get(k, 0)},
            "step_count_at_start": step0,
            "optimizer_restored": restored,
        })
        return out

    passes_run = ["a", None]
    result = {"synthetic_size": TRAINEVAL_SIZE, "batch": B_FULL, "tf32": tf32,
              "cpu_count": os.cpu_count(), "workers": min(8, os.cpu_count() or 1)}
    t_phase = time.perf_counter()
    loop.epoch_pass = counted
    try:
        exp = os.path.join(tmp, "run")
        argv = _traineval_argv(exp)
        # (a) two epochs, counted from 0
        LAUNCHES.clear()
        traineval.main(argv + ["--epochs", "2"])
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        missing = [f for f in TRAINEVAL_FILES if not os.path.exists(os.path.join(exp, f))]
        if missing:
            fail(f"traineval run wrote no {missing}")
        saved = torch.load(os.path.join(exp, "checkpoint.pth.tar"), map_location="cpu",
                           weights_only=True)
        if saved["epoch"] != 2 or saved["step"] != 4:
            fail(f"traineval checkpoint at epoch {saved['epoch']}, step {saved['step']}; "
                 "want 2 and 4")
        # (b) resumed to a third epoch
        passes_run[:] = ["b", saved["optimizer"]]
        traineval.main(argv + ["--epochs", "3", "--resume", exp])
        first_b = next(p for p in passes if p["run"] == "b" and p["train"])
        if first_b["epoch"] != 2 or first_b["step_count_at_start"] != 4 \
                or not first_b["optimizer_restored"]:
            fail(f"the resumed run started at epoch {first_b['epoch']}, update "
                 f"{first_b['step_count_at_start']}, optimizer restored "
                 f"{first_b['optimizer_restored']}; want 2, 4, True")
        # (c) evaluate the checkpoint: the metrics logged for these weights
        passes_run[:] = ["c", None]
        logged = _logged(exp, "val")[-1][1]
        _, val = traineval.main(argv + ["--resume", exp, "--evaluate"])
        diffs = {k: abs(val[k] - logged[k]) / max(1.0, abs(logged[k]))
                 for k in val if k not in ("data_time", "batch_time")}
        worst = max(diffs.values())
        log(f"traineval evaluate after resume vs the logged val line: worst "
            f"|diff|/max(1,|v|) {worst:.3e} over {len(diffs)} metrics (limit 1e-5)")
        if worst > 1e-5:
            fail(f"evaluate-after-resume metrics differ from the logged ones: {diffs}")
        # (d) two epochs with the colour jitter on the device (the first
        # pays the loader's start)
        passes_run[:] = ["d", None]
        exp_d = os.path.join(tmp, "device_augment")
        traineval.main(_traineval_argv(exp_d) + ["--epochs", "2", "--device_augment"])
        # (f) the spawned process loader workers; (g) unfrozen BN
        runs_fg = {}
        for run, flag in (("f", "--loader_processes"), ("g", "--no_freeze_batchnorm")):
            passes_run[:] = [run, None]
            exp_run = os.path.join(tmp, flag.strip("-"))
            LAUNCHES.clear()
            traineval.main(_traineval_argv(exp_run) + ["--epochs", "1", flag])
            torch.cuda.synchronize()
            runs_fg[run] = {"exp": exp_run, "launches": dict(LAUNCHES)}
        # (e) the figures: every batch a display step
        passes_run[:] = ["e", None]
        exp_e = os.path.join(tmp, "figures")
        LAUNCHES.clear()
        traineval.main(_traineval_argv(exp_e) + ["--epochs", "1", "--device_augment",
                                                 "--display_freq", "1"])
        torch.cuda.synchronize()
        figures_run = dict(LAUNCHES)
        steps = TRAINEVAL_SIZE // B_FULL
        want_files = [f"images/{split}/epoch_0/img_{i:06d}.png"
                      for split in ("train", "val") for i in range(steps)]
        want_files.append("pcks/val/epoch_0.png")
        missing = [f for f in want_files if not os.path.exists(os.path.join(exp_e, f))]
        if missing:
            fail(f"traineval --display_freq 1 drew no {missing}")
        figures = {"files": want_files, "launches": figures_run,
                   "bytes": sum(os.path.getsize(os.path.join(exp_e, f)) for f in want_files)}
        for e in (exp, exp_d, exp_e, runs_fg["f"]["exp"], runs_fg["g"]["exp"]):
            for split in ("train", "val"):
                for epoch, values in _logged(e, split):
                    bad = [k for k, v in values.items() if not np.isfinite(v)]
                    if bad:
                        fail(f"non-finite {split} values at epoch {epoch}: {bad}")
    finally:
        loop.epoch_pass = original
    for p in passes:
        per_step = {k: v / p["steps"] for k, v in p["launches"].items()}
        # a display step adds the figure's eval forward to a train step; a
        # val step's figure reads the val forward
        want = EVAL_LAUNCHES
        if p["train"]:
            want = {k: n + (EVAL_LAUNCHES[k] if p["run"] == "e" else 0)
                    for k, n in TRAIN_LAUNCHES.items()}
        if per_step != want:
            fail(f"run ({p['run']}) epoch {p['epoch']}: launches per "
                 f"{'train step' if p['train'] else 'val forward'} inside the loop "
                 f"{per_step}, want {want}")
        if p["run"] == "e" and p["train"]:
            figures["launches_per_display_train_step"] = per_step
            figures["figure_forward_launches"] = {
                k: per_step[k] - TRAIN_LAUNCHES[k] for k in TRAIN_LAUNCHES}
        log(f"traineval run ({p['run']}) epoch {p['epoch']} {'train' if p['train'] else 'val'}:"
            f" {p['steps']} steps, {p['samples_per_s']:.1f} samples/s over {p['wall_s']:.3f} s,"
            f" data wait {p['data_time_s']:.3f} s ({p['data_wait_share']:.1%}); launches "
            f"{p['launches']}")
    train_passes = [p for p in passes if p["train"] and p["run"] != "e"]
    kinds = {"host_jitter": "abc", "device_augment": "d", "loader_processes": "f",
             "unfrozen_bn": "g"}
    result.update(
        exp=exp,
        figures=figures,
        launches=launches,
        launches_loader_processes_run=runs_fg["f"]["launches"],
        launches_unfrozen_run=runs_fg["g"]["launches"],
        launches_per_train_step=TRAIN_LAUNCHES,
        passes=passes,
        train_samples_per_s={k: [p["samples_per_s"] for p in train_passes if p["run"] in r]
                             for k, r in kinds.items()},
        data_wait_share={k: [p["data_wait_share"] for p in train_passes if p["run"] in r]
                         for k, r in kinds.items()},
        evaluate_worst_rel_diff=worst,
        seconds=time.perf_counter() - t_phase,
    )
    log(f"traineval phase: {result['seconds']:.1f} s")
    torch.cuda.empty_cache()
    return result


STREAM_SOURCES = 128  # camera frames a streaming step takes; both flips: B=256
CAMERA_HW = (480, 640)
COLDSTART_FRAMES = 20


def _demo_keys_ok(out, B, label, with_trans=False):
    want = {"verts": (B, 778, 3), "joints": (B, 21, 3), "objpoints3d": (B, 642, 3)}
    if with_trans:
        want.update(objtrans=(B, 3), objscale=(B, 1))
    if {k: tuple(v.shape) for k, v in out.items()} != want:
        fail(f"{label}: outputs {({k: tuple(v.shape) for k, v in out.items()})}, want {want}")
    import numpy as np

    if not all(np.isfinite(np.asarray(v.cpu() if hasattr(v, "cpu") else v)).all()
               for v in out.values()):
        fail(f"{label}: non-finite outputs")


def _serving_stream(dev):
    """(a) DemoModel streaming: 128 camera frames duplicated and flipped
    into one B=256 forward (the JAX bench's ``streaming_dual_flip``)."""
    import torch

    from obman_train_tpu_torch.config import ExperimentConfig
    from obman_train_tpu_torch.demo import DemoModel
    from obman_train_tpu_torch.ops.image import preprocess_frames

    model = DemoModel(config=ExperimentConfig(mano_assets="synthetic"), device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    cam = torch.randint(0, 256, (STREAM_SOURCES, *CAMERA_HW, 3), generator=gen, device=dev,
                        dtype=torch.uint8)
    n = STREAM_SOURCES
    flip = torch.cat([torch.zeros(n, dtype=torch.bool, device=dev),
                      torch.ones(n, dtype=torch.bool, device=dev)])
    sides = torch.cat([torch.ones(n, dtype=torch.int32, device=dev),
                       torch.zeros(n, dtype=torch.int32, device=dev)])

    def step():
        return model._infer(model._variables, torch.cat([cam, cam]), sides, flip)

    set_tf32(False)
    out = step()
    _demo_keys_ok(out, 2 * n, "streaming forward")
    # preprocessing on the card against the CPU port, normalised scale
    few = torch.cat([cam[:2], cam[:2]])
    ff = torch.tensor([False, False, True, True])
    size = model.image_size
    got = preprocess_frames(few.to(torch.float32), size, flip=ff.to(dev)).cpu()
    want = preprocess_frames(few.cpu().to(torch.float32), size, flip=ff)
    pre_err = float((got - want).abs().max())
    log(f"serving (a) preprocessing 480x640 -> {size} on the card vs the CPU port: max abs err "
        f"{pre_err:.3e} (limit 1e-5)")
    if pre_err > 1e-5:
        fail(f"preprocessing on the card differs from the CPU port by {pre_err}")
    rates, breakdown = {}, {}
    for label, cudnn_tf32 in (("tf32_off", False), ("pytorch_default", True)):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        step()
        torch.cuda.synchronize()
        windows = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(5):
                step()
            torch.cuda.synchronize()
            windows.append(n * 5 / (time.perf_counter() - t0))
        rates[label] = sorted(windows)
        net = model.net
        with torch.inference_mode():
            dup = torch.cat([cam, cam])
            images = preprocess_frames(dup.to(torch.float32), size, flip=flip)
            nchw = images.permute(0, 3, 1, 2)
            feats, _ = net.base_net(nchw)
            stages = {
                "preprocess": lambda: preprocess_frames(dup.to(torch.float32), size, flip=flip),
                "encoder": lambda: net.base_net(nchw),
                "mano_both_sides": lambda: net.mano_branch(feats, sides),
                "atlas_decoder": lambda: net.atlas_branch.forward_inference(feats),
                "demo_forward": step,
            }
            breakdown[label] = {k: cuda_ms(fn, iters=5) for k, fn in stages.items()}
    log(f"serving (a) streaming dual flip, {n} camera frames 480x640 uint8 on the device -> "
        f"B={2 * n}, hand_object, three windows of five: source frames/s {json.dumps(rates)}; "
        f"ms per step {json.dumps(breakdown)}")
    set_tf32(False)
    del model, cam
    torch.cuda.empty_cache()
    return {"source_frames": n, "batch": 2 * n, "camera_hw": list(CAMERA_HW),
            "source_frames_per_s": rates, "breakdown_ms": breakdown,
            "preprocess_max_abs_err_vs_cpu": pre_err}


def _serving_reload(exp, dev):
    """(b) phase 7's contact-config experiment in DemoModel: the demo path
    equal to the full HandNet forward bit for bit, and no kernel launch."""
    import numpy as np
    import torch

    from obman_train_tpu_torch.demo import DemoModel
    from obman_train_tpu_torch.models import INFER_SPEC
    from obman_train_tpu_torch.ops.image import preprocess_frames
    from obman_train_tpu_torch.ops.kernels import LAUNCHES

    set_tf32(False)
    model = DemoModel(exp_dir=exp, device=dev)
    if not model.cfg.model.need_collisions or model.epoch != 3:
        fail(f"reloaded {exp}: epoch {model.epoch}, contact config "
             f"{model.cfg.model.need_collisions}; want 3, True")
    frame = np.random.default_rng(11).integers(0, 256, (*CAMERA_HW, 3)).astype(np.uint8)
    LAUNCHES.clear()
    dual = model.predict_dual(frame, hand_side="left")
    gen = torch.Generator(device=dev).manual_seed(12)
    frames = torch.randint(0, 256, (B_FULL, *CAMERA_HW, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    sides = (torch.arange(B_FULL, device=dev) % 2).to(torch.int32)
    flip = torch.arange(B_FULL, device=dev) % 3 == 0
    batch_out = model._infer(model._variables, frames, sides, flip)
    torch.cuda.synchronize()
    demo_launches = dict(LAUNCHES)
    _demo_keys_ok(dual, 2, "reloaded predict_dual", with_trans=True)
    _demo_keys_ok(batch_out, B_FULL, "reloaded B=256 demo forward", with_trans=True)
    if sum(demo_launches.values()):
        fail(f"the demo path of a contact-config model launched kernels: {demo_launches}")
    with torch.inference_mode():
        images = preprocess_frames(torch.from_numpy(np.stack([frame, frame])).to(dev)
                                   .to(torch.float32), model.image_size,
                                   flip=torch.tensor([False, True], device=dev))
        _, full, _ = model.net({"images": images,
                                "sides": torch.tensor([1, 0], dtype=torch.int32, device=dev)},
                               INFER_SPEC, no_loss=True, force_hand=True, force_objects=True)
    torch.cuda.synchronize()
    full_launches = {k: v for k, v in LAUNCHES.items() if v}
    if "contact_info" not in full or full_launches.get("raytri_count") != 1:
        fail(f"the full forward ran no contact block ({full_launches})")
    unequal = [k for k in dual if not np.array_equal(dual[k], full[k].cpu().numpy())]
    if unequal:
        fail(f"predict_dual differs from the full HandNet forward at {unequal}")
    log(f"serving (b) DemoModel from phase 7's contact experiment (epoch {model.epoch}): "
        f"predict_dual and a B={B_FULL} demo forward launched {demo_launches or 'no kernel'}; "
        f"predict_dual equal bit for bit to the full forward (which launched {full_launches})")
    return model, {"demo_path_launches": demo_launches, "full_forward_launches": full_launches,
                   "bitwise_equal_keys": sorted(dual)}


def _child(code, label, timeout=300):
    """Run ``code`` in a fresh python process from the repo root; its last
    stdout line is a JSON object."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=HERE, timeout=timeout)
    if proc.returncode != 0:
        fail(f"{label}: child exited {proc.returncode}: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["process_s"] = time.perf_counter() - t0
    return out


def _serving_export(model, tmp, dev):
    """(c) a cuda export with a symbolic batch, served at B=1 and B=256 in a
    fresh process that cannot import the port, against the live model."""
    import numpy as np
    import torch

    from obman_train_tpu_torch.demo.export import export_model

    set_tf32(False)
    path = os.path.join(tmp, "model.pt2")
    t0 = time.perf_counter()
    info = export_model(model, path, platforms=["cuda"])
    export_s = time.perf_counter() - t0
    if info["batch"] != "symbolic" or info["platforms"] != ["cuda"]:
        fail(f"export info {info}")
    rng = np.random.default_rng(13)
    size = model.image_size
    batches = {}
    for B in (1, B_FULL):
        batches[B] = (rng.integers(0, 256, (B, size, size, 3)).astype(np.uint8),
                      (np.arange(B) % 2).astype(np.int32), np.arange(B) % 2 == 1)
        np.savez(os.path.join(tmp, f"in_{B}.npz"), *batches[B])
    loader = os.path.join(HERE, "obman_train_tpu_torch", "demo", "export.py")
    code = "\n".join([
        "import importlib.util, json, sys, time",
        "t0 = time.perf_counter()",
        "import numpy as np, torch",
        "sys.modules['obman_train_tpu_torch'] = None  # any import of the port raises",
        "torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False",
        f"spec = importlib.util.spec_from_file_location('artifact_loader', {loader!r})",
        "mod = importlib.util.module_from_spec(spec)",
        "spec.loader.exec_module(mod)",
        f"serve = mod.load_exported({path!r})",
        "t_load = time.perf_counter()",
        "times = {}",
        f"for B in (1, {B_FULL}):",
        f"    d = np.load(f'{tmp}/in_{{B}}.npz')",
        "    args = [torch.from_numpy(d[f'arr_{i}']).cuda() for i in range(3)]",
        "    out = serve(*args)",
        "    torch.cuda.synchronize()",
        "    t = time.perf_counter()",
        "    for _ in range(3):",
        "        out = serve(*args)",
        "    torch.cuda.synchronize()",
        "    times[B] = (time.perf_counter() - t) / 3 * 1e3",
        f"    np.savez(f'{tmp}/out_{{B}}.npz', **{{k: v.cpu().numpy() for k, v in out.items()}})",
        "bad = [m for m in sys.modules if m.startswith('obman_train_tpu')",
        "       and sys.modules[m] is not None]",
        "assert not bad, bad",
        "print(json.dumps({'load_s': t_load - t0, 'serve_ms': times}))",
    ])
    child = _child(code, "export round trip")
    errs = {}
    for B, (frames, sides, flip) in batches.items():
        live = model._infer(model._variables, *(torch.from_numpy(a).to(dev)
                                                for a in (frames, sides, flip)))
        got = np.load(os.path.join(tmp, f"out_{B}.npz"))
        if sorted(got.files) != sorted(live):
            fail(f"exported outputs {sorted(got.files)}, live {sorted(live)}")
        excess = 0.0
        errs[B] = {}
        for k, v in live.items():
            v = v.cpu().numpy()
            errs[B][k] = float(np.abs(got[k] - v).max())
            excess = max(excess, float((np.abs(got[k] - v) - (2e-3 + 1e-5 * np.abs(v))).max()))
        if excess > 0:
            fail(f"exported B={B} differs from the live model beyond rtol 1e-5, atol 2e-3: "
                 f"{errs[B]}")
    log(f"serving (c) export for cuda, symbolic batch: {info['bytes']} bytes in {export_s:.1f} s; "
        f"served in a fresh process without the port (load {child['load_s']:.2f} s, "
        f"ms per call {json.dumps(child['serve_ms'])}); max abs err vs live {json.dumps(errs)} "
        "(limit rtol 1e-5, atol 2e-3)")
    return path, {"bytes": info["bytes"], "export_s": export_s, "max_abs_err": errs,
                  "child": child}


def _serving_coldstart(exp, artifact):
    """(d) a fresh process each for the live DemoModel (built, reloaded) and
    the ExportedModel: construction, first frame, steady predict calls."""
    tail = "\n".join([
        "t_ctor = time.perf_counter()",
        "frame = np.random.default_rng(0).integers(0, 256, (m.image_size, m.image_size, 3))"
        ".astype(np.uint8)",
        "m.predict(frame)",
        "t_first = time.perf_counter()",
        f"for _ in range({COLDSTART_FRAMES}):",
        "    m.predict(frame)",
        f"t_steady = (time.perf_counter() - t_first) / {COLDSTART_FRAMES}",
        "print(json.dumps({'construct_s': t_ctor - t0, 'first_frame_s': t_first - t_ctor,",
        "                  'steady_ms': t_steady * 1e3, 'parts_s': {",
        "                  'import_torch_cuda_init': t_cuda - t0,",
        "                  'import_port': t_import - t_cuda, 'build_or_load': t_ctor - t_import}}))",
    ])
    # construct_s runs from the first line (imports and the CUDA context
    # included), as the JAX bench's; parts_s splits it
    head = "\n".join(["import json, time", "t0 = time.perf_counter()", "import numpy as np",
                      "import torch", "torch.zeros(1, device='cuda')",
                      "t_cuda = time.perf_counter()", ""])
    out = {}
    for name, imp, make in (
            ("live", "from obman_train_tpu_torch.demo import DemoModel",
             f"m = DemoModel(exp_dir={exp!r})"),
            ("from_export", "from obman_train_tpu_torch.demo.export import ExportedModel",
             f"m = ExportedModel({artifact!r})")):
        code = head + "\n".join([imp, "t_import = time.perf_counter()", make, tail])
        out[name] = _child(code, f"cold start ({name})")
    log(f"serving (d) cold start, fresh process each, {COLDSTART_FRAMES} steady predict calls "
        f"(PyTorch's default TF32): {json.dumps(out)}")
    return out


def _serving_clis(exp, tmp):
    """(e) the demo CLIs on the card, on phase 7's contact experiment."""
    import numpy as np
    from PIL import Image

    from obman_train_tpu_torch.cli import image_demo, video_demo
    from obman_train_tpu_torch.ops.kernels import LAUNCHES

    frames_dir = os.path.join(tmp, "frames")
    os.makedirs(frames_dir)
    rng = np.random.default_rng(21)
    for i in range(256):  # smooth seeded frames: quick to encode and decode
        small = rng.integers(0, 256, (30, 40, 3)).astype(np.uint8)
        Image.fromarray(small.repeat(16, 0).repeat(16, 1)).save(
            os.path.join(frames_dir, f"f{i:04d}.png"), compress_level=1)
    LAUNCHES.clear()
    runs = {}
    for label, extra in (("stream", ["--batch", "64"]),
                         ("render", ["--batch", "64", "--attention", "--render",
                                     "--max_frames", "8"])):
        out_dir = os.path.join(tmp, f"video_{label}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            stats = video_demo.main(["--frames_dir", frames_dir, "--resume", exp,
                                     "--out_dir", out_dir] + extra)
        printed = buf.getvalue()
        log(printed.strip())
        m = re.search(r"Processed (\d+) frames in ([0-9.]+)s \(([0-9.]+) fps", printed)
        n_want = 256 if label == "stream" else 8
        files = sorted(os.listdir(out_dir))
        kinds = ((".npz",) if label == "stream" else (".npz", ".png.png", "_attention.png"))
        counts = {k: sum(f.endswith(k) for f in files) for k in kinds}
        if not m or int(m.group(1)) != n_want or any(c != n_want for c in counts.values()):
            fail(f"video_demo {label}: printed {printed!r}, files {counts}, want {n_want} each")
        runs[label] = {"frames": int(m.group(1)), "printed_fps": float(m.group(3)),
                       "fps": stats["fps"], "files": counts}
    img_out = os.path.join(tmp, "image_demo.png")
    image_demo.main(["--image", os.path.join(frames_dir, "f0000.png"), "--resume", exp,
                     "--output", img_out])
    if not os.path.getsize(img_out):
        fail("image_demo wrote no figure")
    runs["image_demo_bytes"] = os.path.getsize(img_out)
    if sum(LAUNCHES.values()):
        fail(f"the demo CLIs launched kernels: {dict(LAUNCHES)}")
    log(f"serving (e) video_demo on 256 480x640 PNGs at --batch 64 (contact experiment): "
        f"{json.dumps(runs)}")
    return runs


def phase_serving(exp, tmp):
    """Slice 5's serving entry points (see the module docstring, phase 8)."""
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    result = {"stream": _serving_stream(dev)}
    model, result["reload"] = _serving_reload(exp, dev)
    artifact, result["export"] = _serving_export(model, tmp, dev)
    del model
    torch.cuda.empty_cache()
    result["cold_start"] = _serving_coldstart(exp, artifact)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # the CLIs as a user runs them
    result["demo_clis"] = _serving_clis(exp, tmp)
    set_tf32(False)
    result["seconds"] = time.perf_counter() - t0
    log(f"serving phase: {result['seconds']:.1f} s")
    return result


# Phase 9, the precision rungs (JAX bench.py:107-146, stages :963-976). The
# bf16 step's first loss and gradients are held against the card's float32
# step on the same weights and batch, at about twice the whole-gradient gap
# (relative L2) and three times the loss gap between JAX's own bf16 and
# float32 steps that tests/test_torch_bf16.py computes at B=2, 64 px.
BF16_GRAD_REL = 0.15
BF16_LOSS_REL = 1e-2
RUNG_CONFIGS = (("contact_bf16", "float32"), ("contact_bf16_f32sel", "float32_select"),
                ("contact_bf16_bf16sel", "bfloat16"))
# near-tie bounds, times the plane's largest magnitude: a float32 selection
# plane against the kernel's direct differences may pick another
# neighbour only where its rounding (a few ulp of that magnitude) cannot
# separate two pairs; the card's bf16 plane against the CPU port's (the
# JAX package's selection, tests/test_torch_geometry_dtype.py) only within
# the bf16 plane's resolution, JAX's bound (tests/test_geometry_ops.py:215-235).
# Against the kernel the bf16 plane's selections are counted, not held: its
# rounding can exceed that bound (the JAX package's own on the CPU does)
NEAR_TIE = {"float32_select": 2.0 ** -20, "bfloat16": 2.0 ** -8}
SERVE_LAUNCHES = {"raytri_count": 1, "nn_dir_argmin": 2}


def _counted(fn):
    """``fn()`` with the kernel counts set to 0 just before it and read
    just after: ``(result, launches)``."""
    import torch

    from obman_train_tpu_torch.ops.kernels import LAUNCHES

    torch.cuda.synchronize()
    LAUNCHES.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in LAUNCHES.items() if v}


def _norm_kernels(fn):
    """The names of the normalization kernels one call of ``fn`` runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    return sorted(n[:90] for n in names if re.search(r"bn|norm", n, re.I))


def _precision_serving(dev):
    """(a) hand_object_bf16 and contact_bf16 through ``make_infer`` at
    B=256, uint8 frames on the device: launches per forward, frames/s over
    three windows, and the max abs delta (mm) of the outputs against the
    float32 net on the same weights (a report, as JAX bench.py:440-461)."""
    import torch

    from obman_train_tpu_torch.infer import make_infer

    set_tf32(False)
    frames, sides = _frames(B_FULL, IMAGE, seed=1, device=dev)
    out = {}
    for name, contact in (("hand_object_bf16", False), ("contact_bf16", True)):
        with torch.inference_mode():
            ref = make_infer(_build_net(contact, 0, dev))(frames, sides)
        net = _build_net(contact, 0, dev, compute_dtype="bfloat16")
        infer = make_infer(net)
        got, launches = _counted(lambda: infer(frames, sides))
        if launches != (SERVE_LAUNCHES if contact else {}):
            fail(f"{name} forward launched {launches}")
        if got["verts"].dtype != torch.float32 or got["objpoints3d"].dtype != torch.bfloat16:
            fail(f"{name} output dtypes {got['verts'].dtype}, {got['objpoints3d'].dtype}")
        keys = ("verts", "joints", "objpoints3d")
        if not all(torch.isfinite(got[k]).all() for k in keys):
            fail(f"{name}: non-finite outputs")
        delta = {k: float((got[k].float() - ref[k]).abs().max()) for k in keys}
        fps = _fps(infer, frames, sides)
        entry = {"launches_per_forward": launches, "frames_per_s": fps,
                 "max_abs_delta_mm_vs_float32": delta,
                 "precision": "bf16 compute; float32 ops with TF32 off"}
        if contact:
            with torch.inference_mode():
                entry["eval_bn_kernels"] = _norm_kernels(lambda: infer(frames, sides))
        log(f"precision (a) {name} via make_infer, B={B_FULL}: launches {launches}, frames/s "
            f"{json.dumps(fps)}, max abs delta vs float32 (mm) {json.dumps(delta)}"
            + (f"; eval BN kernels {entry['eval_bn_kernels']}" if contact else ""))
        out[name] = entry
        del net, infer, got, ref
        torch.cuda.empty_cache()
    return out


def _first_step(net, batch):
    """The total loss and gradients of one frozen-BN forward + backward."""
    from obman_train_tpu_torch.models import BatchSpec

    net.zero_grad(set_to_none=True)
    total, _, _ = net(batch, BatchSpec())
    total.backward()
    return float(total.detach()), {n: p.grad.detach().clone()
                                   for n, p in net.named_parameters() if p.grad is not None}


def _rel_l2(got, want):
    import torch

    keys = sorted(want)
    a = torch.cat([got[k].double().flatten() for k in keys])
    b = torch.cat([want[k].double().flatten() for k in keys])
    return float((a - b).norm() / b.norm())


def _precision_train(dev):
    """(b) the bf16 train steps of the three rungs at B=256, frozen BN:
    the first step held against the float32 step, launches per step, a
    falling loss over 10 steps, samples/s on the kernel route and with
    ``use_kernel=False`` (the rung's own plane on the card) in turns, a
    breakdown of the contact_bf16 step; one unfrozen-BN bf16 step."""
    import torch

    from obman_train_tpu_torch import train
    from obman_train_tpu_torch.config import TrainConfig
    from obman_train_tpu_torch.models import BatchSpec
    from obman_train_tpu_torch.ops import chamfer

    set_tf32(False)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_gt(B_FULL, IMAGE, 1).items()}
    ref = _build_net(True, 0, dev)
    loss32, g32 = _first_step(ref, batch)
    del ref
    rule = chamfer._use_kernel
    plane_rule = lambda x, y, use_kernel: (  # noqa: E731
        False if use_kernel == "auto" else rule(x, y, use_kernel))
    out = {}
    for name, gd in RUNG_CONFIGS:
        net = _build_net(True, 0, dev, compute_dtype="bfloat16", geometry_dtype=gd)
        loss16, g16 = _first_step(net, batch)
        grad_rel, loss_rel = _rel_l2(g16, g32), abs(loss16 - loss32) / abs(loss32)
        if set(g16) != set(g32) or grad_rel > BF16_GRAD_REL or loss_rel > BF16_LOSS_REL:
            fail(f"{name}: first step against float32: gradient rel L2 {grad_rel} (limit "
                 f"{BF16_GRAD_REL}), loss rel {loss_rel} (limit {BF16_LOSS_REL})")
        del g16
        cfg = TrainConfig()
        opt = train.make_optimizer(cfg, net)
        state = train.create_train_state(net, opt, cfg)
        step = train.make_train_step(net, opt, BatchSpec(), device=dev)
        (state, losses), launches = _counted(lambda: step(state, batch))
        if launches != TRAIN_LAUNCHES:
            fail(f"{name} step launched {launches}, want {TRAIN_LAUNCHES}")
        first = float(losses["total_loss"])
        for _ in range(9):
            state, losses = step(state, batch)
        last = float(losses["total_loss"])
        if not last < first:
            fail(f"{name}: the loss did not fall over 10 steps: {first} -> {last}")
        try:
            chamfer._use_kernel = plane_rule
            _, plane_launches = _counted(lambda: step(state, batch))
        finally:
            chamfer._use_kernel = rule
        # the kernel route and use_kernel=False (the rung's own plane) in
        # turns kernel, plane, plane, kernel
        ab = _route_ab(state, step, batch)
        out[name] = {
            "geometry_dtype": gd, "first_step_grad_rel_l2_vs_float32": grad_rel,
            "first_step_loss_rel_vs_float32": loss_rel, "launches_per_step": launches,
            "loss_step1": first, "loss_step10": last,
            "samples_per_s": {"kernel": ab["samples_per_s"]["kernel"],
                              "use_kernel_false": ab["samples_per_s"]["plane"]},
            "launches_per_step_use_kernel_false": plane_launches,
            "peak_gib": {"kernel": ab["peak_gib"]["kernel"],
                         "use_kernel_false": ab["peak_gib"]["plane"]},
            "precision": "bf16 compute; float32 ops with TF32 off"}
        if name == "contact_bf16":
            out[name]["breakdown"] = _train_breakdown(net, state, step, batch, name)
        log(f"precision (b) {name} step, B={B_FULL}, frozen BN: vs float32 grad rel L2 "
            f"{grad_rel:.4e} (limit {BF16_GRAD_REL}), loss rel {loss_rel:.3e}; launches "
            f"{launches}; loss {first} -> {last}; use_kernel=False launches {plane_launches}")
        del net, opt, state, step
        torch.cuda.empty_cache()
    # one unfrozen-BN bf16 step: float32 running statistics that move,
    # finite gradients
    net = _build_net(True, 0, dev, compute_dtype="bfloat16")
    before = {k: v.clone() for k, v in net.state_dict().items() if k.endswith("running_var")}
    cfg = TrainConfig()
    opt = train.make_optimizer(cfg, net)
    state = train.create_train_state(net, opt, cfg)
    step = train.make_train_step(net, opt, BatchSpec(), train_bn=True, device=dev)
    (state, losses), launches = _counted(lambda: step(state, batch))
    stats = {k: v for k, v in net.state_dict().items() if k in before}
    grads_ok = all(torch.isfinite(p.grad).all() for p in net.parameters() if p.grad is not None)
    if not grads_ok or not torch.isfinite(losses["total_loss"]) or any(
            v.dtype != torch.float32 or not torch.isfinite(v).all() for v in stats.values()) \
            or all(torch.equal(stats[k], before[k]) for k in stats):
        fail("the unfrozen bf16 step: non-finite gradients or loss, or running statistics "
             "not float32, not finite or unmoved")
    out["contact_bf16_unfrozen"] = {"launches_per_step": launches,
                                    "loss": float(losses["total_loss"]),
                                    "running_stats_dtype": "float32"}
    log(f"precision (b) contact_bf16 unfrozen BN step: launches {launches}, loss "
        f"{float(losses['total_loss'])}, {len(stats)} running variances float32 and moved")
    del net, opt, state, step, batch
    torch.cuda.empty_cache()
    return out


def _selection_gaps(q, s, got, want):
    """How many selections differ, and the largest gap between the exact
    values of the two pairs selected (mm^2, float64)."""
    import torch

    differ = got != want
    exact = lambda a: ((q.double() - torch.gather(  # noqa: E731
        s.double(), 1, a[..., None].expand(-1, -1, 3))) ** 2).sum(-1)
    gap = (exact(got) - exact(want)).abs()[differ]
    return int(differ.sum()), float(gap.max()) if gap.numel() else 0.0


def _precision_planes():
    """(c) the rungs' selection planes on the card (``use_kernel=False``) at
    the contact and atlas shapes: the float32_select plane against the
    kernel route and the bf16 plane against the CPU port's, each
    differing selection within its near-tie bound; the bf16 plane's
    differences from the kernel counted; the time of each route."""
    import torch

    from obman_train_tpu_torch.ops import chamfer

    out = {}
    for label, (N, M) in (("256x778x642", (778, 642)), ("256x600x642", (600, 642))):
        x, y = nn_scene(B_FULL, N, M, seed=N + M)
        kern = chamfer.chamfer_min_sqdist(x, y, use_kernel=True)
        mag = float((x.double() ** 2).sum(-1).max() + (y.double() ** 2).sum(-1).max())
        entry = {"kernel_ms": cuda_ms(lambda: chamfer.chamfer_min_sqdist(x, y, use_kernel=True),
                                      iters=5)}
        for gd, dt in (("float32_select", torch.float32), ("bfloat16", torch.bfloat16)):
            sel = chamfer.chamfer_min_sqdist(x, y, use_kernel=False, plane_dtype=dt)
            row = {"plane_ms": cuda_ms(lambda: chamfer.chamfer_min_sqdist(
                x, y, use_kernel=False, plane_dtype=dt), iters=5)}
            ref = kern if gd == "float32_select" else [
                None if t is None else t.to(x.device) for t in chamfer.chamfer_min_sqdist(
                    x.cpu(), y.cpu(), use_kernel=False, plane_dtype=dt)]
            for i, (q, s) in ((1, (x, y)), (3, (y, x))):
                n, worst = _selection_gaps(q, s, sel[i], ref[i])
                if worst > NEAR_TIE[gd] * mag:
                    fail(f"{gd} plane at {label}: a selection {worst} mm^2 off the "
                         f"reference's, above the near-tie bound {NEAR_TIE[gd] * mag}")
                d = {"differing_selections": n, "of": sel[i].numel(),
                     "worst_value_gap_mm2": worst, "bound_mm2": NEAR_TIE[gd] * mag,
                     "against": "kernel" if gd == "float32_select" else "cpu_port_plane"}
                if gd == "bfloat16":
                    d["vs_kernel_differing"], d["vs_kernel_worst_gap_mm2"] = _selection_gaps(
                        q, s, sel[i], kern[i])
                row["x2y" if i == 1 else "y2x"] = d
            entry[gd] = row
        log(f"precision (c) rung planes at {label} vs the kernel route: {json.dumps(entry)}")
        out[label] = entry
    return out


def _precision_traineval(tmp):
    """(d) two one-epoch ``cli.traineval`` runs at B=256: ``--compute_dtype
    bfloat16`` with the contact flags, and ``--no_atlas_mesh`` (without the
    contact terms, which need the mesh); samples/s and the data-wait share
    of each train pass; then the bf16 experiment reloaded in ``DemoModel``
    and exported for cuda, exported against live."""
    import numpy as np
    import torch

    from obman_train_tpu_torch.cli import traineval
    from obman_train_tpu_torch.demo import DemoModel
    from obman_train_tpu_torch.demo.export import export_model, load_exported
    from obman_train_tpu_torch.ops.kernels import LAUNCHES
    from obman_train_tpu_torch.train import loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # a user's process
    original, passes = loop.epoch_pass, []

    def timed(loader, state, epoch, train=True, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(loader, state, epoch, train=train, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = len(loader)
        passes.append({"train": train, "steps": steps, "samples_per_s": steps * B_FULL / wall,
                       "data_wait_share": out[1].averages()["data_time"] * steps / wall})
        return out

    runs = {"bf16": (os.path.join(tmp, "bf16"), ["--compute_dtype", "bfloat16"], True),
            "no_atlas_mesh": (os.path.join(tmp, "cloud"), ["--no_atlas_mesh"], False)}
    out = {}
    loop.epoch_pass = timed
    try:
        for name, (exp, extra, contact) in runs.items():
            argv = _traineval_argv(exp, contact)
            passes.clear()
            LAUNCHES.clear()
            traineval.main(argv + ["--epochs", "1"] + extra)
            torch.cuda.synchronize()
            for split in ("train", "val"):
                for epoch, values in _logged(exp, split):
                    bad = [k for k, v in values.items() if not np.isfinite(v)]
                    if bad:
                        fail(f"traineval {name}: non-finite {split} values: {bad}")
            tr = [p for p in passes if p["train"]]
            out[name] = {"samples_per_s": [p["samples_per_s"] for p in tr],
                         "data_wait_share": [p["data_wait_share"] for p in tr],
                         "launches": {k: v for k, v in LAUNCHES.items() if v},
                         "tf32": "cuDNN on, matmul off (PyTorch's default)"}
            log(f"precision (d) traineval {name}, 1 epoch at B={B_FULL}: {json.dumps(out[name])}")
    finally:
        loop.epoch_pass = original
    set_tf32(False)
    model = DemoModel(exp_dir=runs["bf16"][0])
    if model.cfg.model.compute_dtype != "bfloat16" or model.epoch != 1:
        fail(f"DemoModel reloaded {model.cfg.model.compute_dtype} at epoch {model.epoch}")
    path = os.path.join(tmp, "bf16.pt2")
    t0 = time.perf_counter()
    export_model(model, path, platforms=[model.device.type])
    export_s = time.perf_counter() - t0
    serve = load_exported(path)
    frames, sides = _frames(B_FULL, IMAGE, seed=5, device=model.device)
    flip = (torch.arange(B_FULL, device=model.device) % 2) == 1
    live = model._infer(model._variables, frames, sides, flip)
    got = serve(frames, sides, flip)
    errs = {}
    for k, v in live.items():
        if got[k].dtype != v.dtype:
            fail(f"exported {k} is {got[k].dtype}, live {v.dtype}")
        # a bf16 output to its own resolution (one ulp, 2^-7 relative,
        # tests/test_torch_bf16_serving.py), float32 to the float32 bound
        rtol, atol = (2.0 ** -7, 0.0) if v.dtype == torch.bfloat16 else (1e-5, 2e-3)
        diff = (got[k].float() - v.float()).abs()
        errs[k] = float(diff.max())
        if (diff > atol + rtol * v.float().abs()).any():
            fail(f"exported bf16 {k} differs from live: max abs {errs[k]}")
    out["export"] = {"export_s": export_s, "max_abs_err": errs,
                     "output_dtypes": {k: str(v.dtype) for k, v in live.items()}}
    log(f"precision (d) bf16 experiment in DemoModel, exported for cuda in {export_s:.1f} s: "
        f"exported vs live at B={B_FULL}, max abs err {json.dumps(errs)}")
    del model, serve
    torch.cuda.empty_cache()
    return out


def phase_precision(tmp):
    """Phase 9: the precision rungs (see the module docstring)."""
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    result = {"serving": _precision_serving(dev), "train": _precision_train(dev),
              "planes": _precision_planes(), "traineval": _precision_traineval(tmp)}
    result["seconds"] = time.perf_counter() - t0
    log(f"precision phase: {result['seconds']:.1f} s")
    return result


def _optimizer_matches(state, saved):
    """Whether the optimizer's moments equal the saved ones."""
    import torch

    live = state.optimizer.state_dict()["state"]
    return live.keys() == saved["state"].keys() and all(
        torch.equal(v.cpu(), saved["state"][i][k].cpu())
        for i, st in live.items() for k, v in st.items())


def _contact_kw(net):
    c = net.cfg.contact
    return dict(contact_thresh=c.contact_thresh, contact_mode=c.contact_mode,
                collision_thresh=c.collision_thresh, collision_mode=c.collision_mode,
                contact_target=c.contact_target, contact_sym=c.contact_sym,
                contact_zones=c.contact_zones)


def main() -> None:
    t0 = time.perf_counter()
    kind, count, smi_line, versions = phase_device()
    phase_build()
    entry = phase_kernels()
    nn_entries = phase_nn_kernels()
    phase_backward()
    large = phase_large_cloud()
    phase_slice(entry)
    train = phase_train()
    unfrozen = phase_train_unfrozen()
    with tempfile.TemporaryDirectory() as tmp:
        te = phase_traineval(tmp)
        log("traineval loop vs bare step, samples/s at B=256: loop "
            f"{json.dumps(te['train_samples_per_s'])} (epoch wall clock, TF32 "
            f"{json.dumps(te['tf32'])}), bare step {json.dumps(train['samples_per_s'])}")
        serving = phase_serving(te["exp"], tmp)
        precision = phase_precision(tmp)
    # launches: K1-K3 from run (a) of the training entry point, the main path
    # of this slice (with one train step's beside them); the large-cloud
    # rows', from the large-cloud Chamfer path
    paths = {"traineval": te["launches"], "train_step": train["launches"],
             "large_cloud_chamfer": large}
    entry["path"] = "traineval"
    for e in nn_entries:
        if e["path"] == "train_step":
            e["path"] = "traineval"
    figure = te["figures"]["figure_forward_launches"]
    for e in (entry, *nn_entries):
        counter = e.get("counter", e["name"])
        e["launches"] = paths[e["path"]][counter]
        if e["path"] == "traineval":
            e["launches_one_train_step"] = paths["train_step"][counter]
            e["launches_one_unfrozen_train_step"] = unfrozen["launches"].get(counter, 0)
            e["launches_traineval_unfrozen_run"] = te["launches_unfrozen_run"].get(counter, 0)
            e["launches_traineval_loader_processes_run"] = \
                te["launches_loader_processes_run"].get(counter, 0)
            e["launches_figure_forward"] = figure.get(counter, 0)
            e["launches_figures_run"] = te["figures"]["launches"].get(counter, 0)
        e["launches_demo_path"] = serving["reload"]["demo_path_launches"].get(counter, 0)
        if e["path"] == "traineval":  # phase 9's paths, each counted from 0
            e["launches_precision_paths"] = {
                **{f"{k}_forward": v["launches_per_forward"].get(counter, 0)
                   for k, v in precision["serving"].items()},
                **{f"{k}_step": v["launches_per_step"].get(counter, 0)
                   for k, v in precision["train"].items()},
                **{f"{k}_step_use_kernel_false":
                   v["launches_per_step_use_kernel_false"].get(counter, 0)
                   for k, v in precision["train"].items()
                   if "launches_per_step_use_kernel_false" in v},
                **{f"traineval_{k}_run": v["launches"].get(counter, 0)
                   for k, v in precision["traineval"].items() if "launches" in v},
            }
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [entry, *nn_entries]}), flush=True)
    print(json.dumps({"traineval": {
        **{k: te[k] for k in ("synthetic_size", "batch", "tf32", "cpu_count", "workers",
                              "launches", "launches_loader_processes_run",
                              "launches_unfrozen_run", "launches_per_train_step",
                              "train_samples_per_s",
                              "data_wait_share", "evaluate_worst_rel_diff", "figures",
                              "seconds")},
        "bare_step_samples_per_s": train["samples_per_s"],
        "unfrozen_step": unfrozen,
        "passes": te["passes"]}}), flush=True)
    print(json.dumps({"serving": {"host_libraries": versions, **serving}}), flush=True)
    print(json.dumps({"precision": precision}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    main()
