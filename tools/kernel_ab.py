"""Times the hand-written kernels of one tree of this repository on an
NVIDIA GPU, the inside test K1 (``raytri_count``) and the nearest-neighbour
sweep (``nn_dir``), and reads the inner loop of each one's SASS. Run it on
two trees on one card, one after the other, e.g. a ``git archive`` of an
earlier commit and this one, in turns A, B, B, A, to compare the kernels.

    python3 tools/kernel_ab.py [--root DIR] [--label NAME] [--out PATH]
                               [--sass_out PATH]

``--root`` (default: this repository) is the tree whose
``obman_train_tpu_torch`` is imported and built. Of it the tool uses
``ops.raytri`` (``raytri_count``, ``raytri_count_plain``,
``triangle_table``, ``_launch_plan``, ``_library``), ``ops.nnsqdist``
(``nn_dir``, ``nn_dir_plain``, ``_launch_plan``, ``tie_across_slices``),
``ops.chamfer.chamfer_loss``, ``ops.relu_grad`` (where it has one) and
``ops.kernels.build``. The scenes and
timers are this file's. A row's bound is the larger of its operations over
the card's float32 rate and its bytes over the card's HBM rate, both from
this repository's ``portbench/counts/flops.py`` and ``peaks()``: the
yardstick of the benchmark's ``raytri_roofline.train`` and
``nn_dir_roofline.train``. It prints JSON lines (and writes them to
``--out``):

- ``raytri`` at the rows of PERF.md's kernel table (256x778x1280, the hand
  and object voxel grids 1x32768x1538 and 1x4096x1280) and at the contact
  forward of the smaller callers (1, 16 and 32 x 778 x 1280); ``nn_dir``
  at the table's rows (256x778x600 min, 256x600x642 argmin, 1x20000^2
  min, 1x16384^2 argmin) and the training shapes' other directions. Each
  row: exactness against the plain version (values bitwise, argmins
  exactly; fatal), ``ms`` (eager calls between CUDA events),
  ``device_ms`` (the same calls replayed from a CUDA graph), the bound, the
  device time's share of it, and the launch plan;
- ``split``: where the tree's K1 plan splits the triangles across blocks
  (S > 1), the built library launched at that plan and at S = 1 in turns
  split, unsplit, unsplit, split, each bitwise checked;
- ``chamfer_loss`` forward and forward + gradient at 256x600x642 and
  1x16384x16384 on the kernel route: ``ms`` (eager) and the device's busy
  milliseconds a call from torch.profiler (its kernels' durations summed);
- ``relu_bias_grad``, where the tree has ``ops.relu_grad``: at the stem,
  layer1 and layer4 shapes of the two training towers (the ResNet-18 at
  B=512, the ResNet-50 at B=256), with one gradient or two: exactness
  against the plain version (``g`` bitwise; fatal), ``device_ms`` of the
  kernel as the folded backward calls it (in place), its bound (2 or 3
  reads and a write of float32 at the HBM rate), and ``chain_device_ms``
  of the ATen chain it replaced at the same shape (the add of the two
  gradients, ``threshold_backward``, the bias sum over N, H and W);
- ``sass``: the inner loop of each kernel function of the built libraries
  (``cuobjdump -sass``; the innermost loop with the most FMULs), its
  instructions per (point, triangle) test or (query, point) pair by
  opcode; ``--sass_out`` also writes those loops' instructions.

Needs one GPU and the CUDA toolkit; imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, B, P, T): the kernel table's K1 rows besides the voxel grids, then
# a contact forward at the smaller callers' batches (the image demo, 16,
# and inspect_feature_grads)
RAYTRI_ROWS = (("raytri_count", 256, 778, 1280),
               ("contact_b1", 1, 778, 1280), ("contact_b16", 16, 778, 1280),
               ("contact_b32", 32, 778, 1280))
# (B, N, M, argmin): the kernel table's rows, then the training shapes'
# other directions
NN_ROWS = ((256, 778, 600, False), (256, 600, 642, True), (1, 20000, 20000, False),
           (1, 16384, 16384, True), (256, 778, 642, True), (256, 642, 600, True),
           (256, 642, 778, True))
CHAMFER_SHAPES = ((256, 600, 642), (1, 16384, 16384))
# (name, (N, C, H, W), gradients): relu_bias_grad at the ReLU'd outputs of
# the training towers' stem, layer1 and layer4 (a block's output takes two
# gradients, a ReLU inside a block or the stem one)
RELU_ROWS = (("r18_stem", (512, 64, 128, 128), 1), ("r18_layer1", (512, 64, 64, 64), 2),
             ("r18_layer1_inner", (512, 64, 64, 64), 1), ("r18_layer4", (512, 512, 8, 8), 2),
             ("r50_stem", (256, 64, 128, 128), 1), ("r50_layer1", (256, 256, 64, 64), 2),
             ("r50_layer1_inner", (256, 64, 64, 64), 1), ("r50_layer4", (256, 2048, 8, 8), 2),
             ("r50_layer4_inner", (256, 512, 8, 8), 1))
# the SASS inner loops: kernel function, FMULs per unit of work (a
# point-triangle test: u 4, q 6, v 4, t 4; a query-point pair: 3 squares)
SASS = {"raytri": ("raytri_count_kernel", 18), "nnsqdist": ("nn_dir_kernel", 3)}
GROUPS = ("FADD", "FMUL", "FSETP", "LDS")

_INST = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRA = re.compile(r"\bBRA\s+(?:`\()?(0x[0-9a-f]+|\.L_x_\d+)")


def raytri_scene(B, P, T, seed, device="cuda"):
    """B icosphere(3) meshes of radius 30-70 mm, P points inside, outside
    and straddling each surface, the first T faces: ``(points (B, P, 3),
    triangles (B, T, 3, 3))``."""
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
    return pts.to(device), tris.to(device)


def voxel_scenes(device="cuda"):
    """K1's inputs at the voxel shapes of ``intersect_vox``, the whole grid
    in one launch (B=1): ``[(name, points (1, n^3, 3), triangles (1, T, 3,
    3))]``. A 32^3 lattice (32768 points, metres) over the box of the
    synthetic MANO hand at a seeded pose against its 1538 faces, and a 16^3
    lattice over an icosphere-3 object (1280 faces) of 40 mm radius at the
    hand's centroid, each box padded by 5 mm."""
    import numpy as np
    import torch

    from obman_train_tpu_torch.assets import icosphere, synthetic_mano_assets
    from obman_train_tpu_torch.models.mano import ManoLayer, mano_forward
    from obman_train_tpu_torch.simulation.savemano import _hand_faces

    pose = np.random.default_rng(11).normal(0, 0.5, (1, 9)).astype(np.float32)
    with torch.no_grad():
        hand = mano_forward(ManoLayer(synthetic_mano_assets("right")),
                            torch.from_numpy(pose))[0][0].double().numpy() * 0.001
    ico_v, ico_f = icosphere(3)
    obj = ico_v * 0.04 + hand.mean(0)
    out = []
    for name, verts, faces, n in (("raytri_count_voxel_hand", hand, _hand_faces(), 32),
                                  ("raytri_count_voxel_object", obj, ico_f, 16)):
        lo, hi = verts.min(0) - 0.005, verts.max(0) + 0.005
        axes = [np.linspace(lo[d], hi[d], n) for d in range(3)]
        grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
        pts = torch.from_numpy(grid.astype(np.float32))[None]
        v = torch.from_numpy(verts.astype(np.float32))
        tris = v[torch.from_numpy(np.asarray(faces, np.int64))][None]
        out.append((name, pts.to(device), tris.to(device)))
    return out


def nn_scene(B, N, M, seed, sms, device="cuda"):
    """Query and search clouds (mm scale) with planted exact ties: every
    8th search point repeats an earlier one, every 16th query point sits on
    a search point (distance 0, tied with its repeats), and where the plan
    on a card of ``sms`` SMs cuts the search set into 3 or more slices,
    query 0's minimum first occurs in a middle slice and repeats in every
    later one (``nnsqdist.tie_across_slices``)."""
    import torch

    from obman_train_tpu_torch.ops import nnsqdist

    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(B, N, 3, generator=gen) * 40
    s = torch.randn(B, M, 3, generator=gen) * 40
    dup = torch.arange(M)[7::8]
    if len(dup):
        s[:, dup] = s[:, torch.randint(0, 7, (len(dup),), generator=gen)]
    on = torch.arange(N)[::16]
    q[:, on] = s[:, torch.randint(0, M, (len(on),), generator=gen)]
    nnsqdist.tie_across_slices(q, s, sms)
    return q.to(device), s.to(device)


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


def busy_ms(fn, calls: int = 3) -> float:
    """The device's busy milliseconds a call of ``fn``: its kernels'
    durations under torch.profiler over ``calls`` calls, summed; None where
    the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / calls if us else None


def bound_ms(kernel: str, B: int, N: int, M: int, argmin: bool = False) -> dict:
    """The least time of one call at (B, N, M) on the card:
    ``portbench/counts/flops.py``'s operations at ``peaks()["fp32_flops"]``
    or its bytes at ``peaks()["hbm_bytes_per_s"]``, whichever is longer."""
    from portbench.counts import flops

    if kernel == "raytri":
        ops, nbytes = flops.raytri_ops(B, N, M), flops.raytri_bytes(B, N, M)
    else:
        ops, nbytes = flops.nn_ops(B, N, M), flops.nn_bytes(B, N, M, argmin)
    peak = flops.peaks()
    ops_ms, bytes_ms = ops / peak["fp32_flops"] * 1e3, nbytes / peak["hbm_bytes_per_s"] * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def inner_loops(text: str, function: str, fmul_per_unit: int) -> dict:
    """``{kernel function: (inner-loop mix, its instructions)}`` of the
    functions named ``*function*`` in the text of ``cuobjdump -sass``: for
    each, the innermost loop with the most FMULs, its instructions per unit
    of work by opcode and grouped as FADD / FMUL / FSETP / LDS / other."""
    out = {}
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", text,
                                 re.S):
        if function not in name:
            continue
        insts, labels, pending = [], {}, []
        for line in body.splitlines():
            m = _LABEL.match(line)
            if m:
                pending.append(m.group(1))
                continue
            m = _INST.match(line)
            if m:
                addr = int(m.group(1), 16)
                for lab in pending:
                    labels[lab] = addr
                pending = []
                insts.append((addr, m.group(2)))
        loops = []
        for addr, txt in insts:
            m = _BRA.search(txt)
            if not m:
                continue
            tgt = m.group(1)
            tgt = int(tgt, 16) if tgt.startswith("0x") else labels.get(tgt, addr + 1)
            if tgt <= addr:
                loops.append((tgt, addr))
        inner = [lp for lp in loops
                 if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        best = None
        for lo, hi in inner:
            ops = collections.Counter()
            for addr, txt in insts:
                if lo <= addr <= hi:
                    ops[re.sub(r"^@!?U?P\w+\s+", "", txt).split()[0].split(".")[0]] += 1
            if best is None or ops["FMUL"] > best[1]["FMUL"]:
                best = ((lo, hi), ops)
        if best is None or best[1]["FMUL"] == 0:
            continue
        (lo, hi), ops = best
        units = ops["FMUL"] / fmul_per_unit
        grouped = {g: ops[g] / units for g in GROUPS}
        grouped["other"] = sum(v for k, v in ops.items() if k not in GROUPS) / units
        out[name] = ({"loop": [hex(lo), hex(hi)], "units_per_iteration": units,
                      "instructions": sum(ops.values()),
                      "instructions_per_unit": sum(ops.values()) / units,
                      "per_unit_grouped": grouped,
                      "per_unit": {k: v / units for k, v in ops.most_common()}},
                     [(addr, txt) for addr, txt in insts if lo <= addr <= hi])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose obman_train_tpu_torch is timed")
    ap.add_argument("--label", default=None, help="names the tree in the output")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    ap.add_argument("--sass_out", default=None,
                    help="write the built kernels' inner loops (SASS) here")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    label = args.label or root

    sys.path.insert(0, HERE)
    # the counts and peaks of this repository, whatever --root holds
    from portbench.counts import flops

    sys.path.insert(0, root)  # the tree under test, ahead of this one
    import torch

    from obman_train_tpu_torch.ops import chamfer, nnsqdist, raytri
    from obman_train_tpu_torch.ops.kernels import build

    try:
        from obman_train_tpu_torch.ops import relu_grad
    except ImportError:  # a tree from before the kernel
        relu_grad = None
    if not os.path.realpath(raytri.__file__).startswith(os.path.realpath(root) + os.sep):
        sys.exit(f"kernel_ab: imported {raytri.__file__}, not the tree {root}")
    if not torch.cuda.is_available():
        sys.exit("kernel_ab: no CUDA device: the tool runs the kernels on the card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    sink = open(args.out, "w") if args.out else None

    def emit(rec):
        line = json.dumps({"tree": label, **rec})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")

    def exact(what, got, want, warg=None, garg=None):
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        bad += int((garg != warg).sum()) if warg is not None else 0
        if bad:
            sys.exit(f"kernel_ab: {label}: {what}: {bad} mismatches against the plain version")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip()})
    sms = nnsqdist._sms(torch.device("cuda", 0))

    peak = flops.peaks()
    for name, (n, c, h, w), grads in RELU_ROWS if relu_grad is not None else ():
        gen = torch.Generator(device="cuda").manual_seed(n + c + h)

        def t():
            return torch.randn(n, h, w, c, generator=gen, device="cuda").permute(0, 3, 1, 2)

        a, y = t(), torch.relu(t())
        b = t() if grads == 2 else None
        want, _ = relu_grad.relu_bias_grad_plain(a, b, y)
        got, _ = relu_grad.relu_bias_grad(a, b, y)
        exact(f"relu_bias_grad {name}", got, want)
        del want, got

        def kernel():
            relu_grad.relu_bias_grad(a, b, y, out=a)

        def chain():
            g = torch.ops.aten.threshold_backward(a if b is None else a + b, y, 0)
            g.sum(dim=(0, 2, 3))

        device_ms = graph_ms(kernel, iters=20)
        bound = (grads + 2) * 4 * n * c * h * w / peak["hbm_bytes_per_s"] * 1e3
        emit({"relu_bias_grad": [n, c, h, w], "name": name, "gradients": grads,
              "mismatches": 0, "device_ms": device_ms, "bound_ms": bound, "bound_by": "bytes",
              "share_of_bound": bound / device_ms, "chain_device_ms": graph_ms(chain, iters=20),
              "plan": relu_grad._launch_plan(n * h * w, c, sms)})
        del a, b, y

    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    dump = open(args.sass_out, "w") if args.sass_out else None
    for lib, (function, per_unit) in SASS.items():
        text = subprocess.run([cuobjdump, "-sass", build.build(lib)], capture_output=True,
                              text=True, check=True).stdout
        for fn, (mix, insts) in inner_loops(text, function, per_unit).items():
            emit({"sass": fn, **mix})
            if dump:
                dump.write(f"// {fn}\n" + "".join(f"{a:05x}  {t}\n" for a, t in insts))
    if dump:
        dump.close()

    scenes = [(name, *raytri_scene(B, P, T, seed=i * 10)) for i, (name, B, P, T)
              in enumerate(RAYTRI_ROWS)]
    tables = [(name, pts, raytri.triangle_table(tris))
              for name, pts, tris in scenes[:1] + voxel_scenes() + scenes[1:]]
    for name, pts, table in tables:
        (B, P, _), T = pts.shape, table.shape[1]
        exact(f"raytri {B}x{P}x{T}", raytri.raytri_count(pts, table),
              raytri.raytri_count_plain(pts, table))
        device_ms = graph_ms(lambda: raytri.raytri_count(pts, table), iters=50)
        bound = bound_ms("raytri", B, P, T)
        emit({"raytri": [B, P, T], "name": name, "mismatches": 0,
              "ms": cuda_ms(lambda: raytri.raytri_count(pts, table), iters=50),
              "device_ms": device_ms, **bound, "share_of_bound": bound["bound_ms"] / device_ms,
              "plan": raytri._launch_plan(B, P, T, sms)})

    lib = raytri._library()
    for name, pts, table in tables:
        (B, P, _), T = pts.shape, table.shape[1]
        plan = raytri._launch_plan(B, P, T, sms)
        if plan[1] == 1:
            continue
        unsplit = (plan[0], 1, T, -(-P // (32 * plan[0])) * B)
        want = raytri.raytri_count_plain(pts, table)
        for turn, p in enumerate((plan, unsplit, unsplit, plan)):
            counts = torch.empty((B, P), dtype=torch.int32, device=pts.device)

            def call(p=p, counts=counts):
                err = lib.raytri_count(pts.data_ptr(), table.data_ptr(), B, P, T,
                                       *raytri._DIR_F32, raytri._TOL_F32, p[1], p[2],
                                       counts.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    sys.exit(f"kernel_ab: raytri launch failed: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            exact(f"raytri {B}x{P}x{T} plan {p}", counts, want)
            device_ms = graph_ms(call, iters=50)
            bound = bound_ms("raytri", B, P, T)
            emit({"split": p[1] > 1, "turn": turn, "raytri": [B, P, T], "name": name,
                  "plan": p, "mismatches": 0, "ms": cuda_ms(call, iters=50),
                  "device_ms": device_ms, **bound,
                  "share_of_bound": bound["bound_ms"] / device_ms})
    del scenes, tables

    for seed, (B, N, M, am) in enumerate(NN_ROWS):
        q, s = nn_scene(B, N, M, seed, sms)
        got, garg = nnsqdist.nn_dir(q, s, am)
        exact(f"nn_dir {B}x{N}x{M} argmin={am}", got, *nnsqdist.nn_dir_plain(q, s, am),
              garg)
        it = 20 if B * N * M >= 1e8 else 50
        device_ms = graph_ms(lambda: nnsqdist.nn_dir(q, s, am), iters=it)
        bound = bound_ms("nn", B, N, M, am)
        emit({"nn_dir": [B, N, M], "argmin": am, "mismatches": 0,
              "ms": cuda_ms(lambda: nnsqdist.nn_dir(q, s, am), iters=it),
              "device_ms": device_ms, **bound, "share_of_bound": bound["bound_ms"] / device_ms,
              "plan": nnsqdist._launch_plan(B, N, M, sms)})
        del q, s

    for B, N, M in CHAMFER_SHAPES:
        preds, gts = nn_scene(B, N, M, B + N, sms)

        def fwd():
            with torch.no_grad():
                return chamfer.chamfer_loss(preds, gts, use_kernel=True)

        def fwd_grad():
            p = preds.clone().requires_grad_(True)
            g = gts.clone().requires_grad_(True)
            l1, l2 = chamfer.chamfer_loss(p, g, use_kernel=True)
            torch.mean(l1 + l2).backward()

        for part, fn in (("forward", fwd), ("forward_grad", fwd_grad)):
            emit({"chamfer_loss": [B, N, M], "part": part, "ms": cuda_ms(fn, iters=10),
                  "device_busy_ms": busy_ms(fn)})
        del preds, gts
    if sink:
        sink.close()


if __name__ == "__main__":
    main()
