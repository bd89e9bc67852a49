"""On-card smoke run of the PyTorch/CUDA port (obman_train_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and nvcc;
run it from the root of the repository. It imports nothing of JAX. Phases,
each fatal on failure:

1. device: name, count, and ``nvidia-smi``'s name and power limit;
2. build: every CUDA kernel of the port, from the sources in the repo (one
   nvcc per source, all started together), with ptxas registers and spills;
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
   port, samples/s, a breakdown of one step and the profiler's busy share.

Output: progress lines, then one JSON line ``{"kernels": [...]}``, the
``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
With no GPU, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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
    return kind, count, smi_line


def phase_build():
    from obman_train_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(build.build, KERNELS))
    for name in KERNELS:
        build.load(name)
    log(f"build: {', '.join(k + '.cu' for k in KERNELS)} in "
        f"{time.perf_counter() - t0:.2f} s (in parallel)")
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


def _build_net(contact: bool, seed: int, device):
    from obman_train_tpu_torch.assets import synthetic_mano_assets
    from obman_train_tpu_torch.config import AtlasConfig, ContactConfig, ModelConfig
    from obman_train_tpu_torch.models import build_handnet
    from obman_train_tpu_torch.weights import init_weights

    cfg = ModelConfig(
        atlas=AtlasConfig(predict_trans=True, predict_scale=True),
        contact=(ContactConfig(contact_lambda=0.167, collision_lambda=0.167)
                 if contact else ContactConfig()),
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


def _contact_kw(net):
    c = net.cfg.contact
    return dict(contact_thresh=c.contact_thresh, contact_mode=c.contact_mode,
                collision_thresh=c.collision_thresh, collision_mode=c.collision_mode,
                contact_target=c.contact_target, contact_sym=c.contact_sym,
                contact_zones=c.contact_zones)


def main() -> None:
    t0 = time.perf_counter()
    kind, count, smi_line = phase_device()
    phase_build()
    entry = phase_kernels()
    nn_entries = phase_nn_kernels()
    phase_backward()
    large = phase_large_cloud()
    phase_slice(entry)
    # launches: those of one train step, the main path of this slice; the
    # large-cloud rows', those of the large-cloud Chamfer path
    paths = {"train_step": phase_train()["launches"], "large_cloud_chamfer": large}
    entry["launches"] = paths["train_step"]["raytri_count"]
    entry["path"] = "train_step"
    for e in nn_entries:
        e["launches"] = paths[e["path"]][e["counter"]]
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [entry, *nn_entries]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    main()
