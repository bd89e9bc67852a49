"""On-card smoke run of the PyTorch/CUDA port (obman_train_tpu_torch).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and nvcc;
run it from the root of the repository. It imports nothing of JAX. Phases,
each fatal on failure:

1. device: name, count, and ``nvidia-smi``'s name and power limit;
2. build: every CUDA kernel of the main path, from the sources in the repo;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's full shapes and on ragged ones (tolerance: exact), with
   CUDA-event times of both, the card's lower bound, and launch counts;
4. slice: the contact-config HandNet (ResNet-18, B=256, 256x256 uint8
   frames, synthetic MANO, seeded random weights) through ``make_infer``:
   shapes, finiteness, contact masks equal to the same forward with the
   plain inside test, agreement with the CPU port on a small input,
   frames/s with TF32 off and at PyTorch's default; the headline
   ``hand_object`` config timed the same way.

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
from typing import NoReturn

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
PEAK_FP32_FLOPS = 67e12   # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # bytes/s
RAYTRI_OPS_PER_TEST = 36  # 31 arithmetic + 5 comparisons, raytri.cu

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
    build.load("raytri")
    log(f"build: raytri.cu in {time.perf_counter() - t0:.2f} s")
    for line in build.BUILD_LOGS.get("raytri", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


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
    plain_ms = cuda_ms(lambda: raytri.raytri_count_plain(pts, table), iters=3, warmup=1)
    ops = B_FULL * P * T * RAYTRI_OPS_PER_TEST
    nbytes = pts.numel() * 4 + table.numel() * 4 + got.numel() * 4
    ops_ms, bytes_ms = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    log(f"raytri times (warm L2, TF32 off): kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms; bound {max(ops_ms, bytes_ms):.4f} ms "
        f"(ops {ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms)")
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
        "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,  # no single PyTorch call computes ray parity
        "tf32": "off",
    }


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
    from torch.profiler import ProfilerActivity, profile

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

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                forward()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.device_time_total for e in kernels) / 1e6
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3 / 3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    if device_s == 0:
        log(f"profiler ({label}): no device time recorded; busy share not measured")
    else:
        log(f"profiler ({label}): {len(kernels) / 3:.0f} kernels per forward, device "
            f"busy {device_s / 3 * 1e3:.3f} ms of {wall / 3 * 1e3:.3f} ms wall per "
            f"forward (busy share {device_s / wall:.4f}, under the profiler)")
        log(f"profiler ({label}) top kernels, ms per forward: "
            + json.dumps({name[:70]: t for name, t in top}))


def phase_slice(entry):
    import torch

    from obman_train_tpu_torch.infer import make_infer
    from obman_train_tpu_torch.models import INFER_SPEC
    from obman_train_tpu_torch.ops import compute_contact_loss, mesh_contains_points_plain
    from obman_train_tpu_torch.ops.kernels import LAUNCHES
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
    log(f"slice main path launches: {launches}")
    if launches.get(KERNEL, 0) == 0:
        fail(f"the main path never launched {KERNEL}")
    entry["launches"] = launches[KERNEL]
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
    phase_slice(entry)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    main()
