"""Times the ray-parity kernel K1 (``raytri_count``) of one tree of this
repository on an NVIDIA GPU and reads the inner loop of its SASS. Run it on
two trees on one card, one after the other, e.g. a ``git archive`` of an
earlier commit and this one, in turns A, B, B, A, to compare the kernels.

    python3 tools/raytri_ab.py [--root DIR] [--label NAME] [--out PATH]
                               [--sass_out PATH]

``--root`` (default: this repository) is the tree whose
``obman_train_tpu_torch`` is imported and built. Of it the tool uses only
``ops.raytri`` (``raytri_count``, ``raytri_count_plain``,
``triangle_table``, and ``_launch_plan`` and ``bind`` where the tree has
them) and ``ops.kernels.build.build``. The scenes (``raytri_scene``,
``voxel_scenes``), the timers, the bound and the card's peaks come from
this repository's ``chip_smoke.py``. It prints JSON lines (and writes them
to ``--out``):

- ``raytri`` at the three rows of chip_smoke's kernel table (256x778x1280,
  the hand and object voxel grids 1x32768x1538 and 1x4096x1280) and at the
  contact forward of the smaller callers (1, 16 and 32 x 778 x 1280):
  exactness against ``raytri_count_plain`` (bitwise; fatal), ``ms`` (eager
  calls between CUDA events), ``device_ms`` (the same calls replayed from a
  CUDA graph), the bound (36 float32 instructions a test) and the device
  time's share of it, and the launch plan;
- ``split``: where the tree's plan splits the triangles across blocks
  (S > 1), the built library launched at that plan and at S = 1, in turns
  split, unsplit, unsplit, split, each bitwise checked: ``ms`` (eager) and
  ``device_ms``, so the split is judged where its callers launch eagerly;
- ``sass``: the inner loop of the built library's kernel (``cuobjdump
  -sass``; the innermost loop with the most FMULs), its instructions per
  (point, triangle) test by opcode (18 FMULs a test) and grouped as
  FADD / FMUL / FSETP / LDS / other.

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

_INST = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRA = re.compile(r"\bBRA\s+(?:`\()?(0x[0-9a-f]+|\.L_x_\d+)")
FMUL_PER_TEST = 18  # u 4, q 6, v 4, t 4 (raytri.cu)
GROUPS = ("FADD", "FMUL", "FSETP", "LDS")
# (B, P, T) of a contact forward at the smaller callers' batches: one
# sample (the image demo, max_penetration_depth), 16, and 32
# (inspect_feature_grads)
CALLERS = ((1, 778, 1280), (16, 778, 1280), (32, 778, 1280))


def inner_loop(text: str, dump: str = None) -> dict:
    """The inner-loop mix of the ``raytri_count_kernel`` in the text of
    ``cuobjdump -sass``: the innermost loop with the most FMULs (its
    instructions also written to ``dump``)."""
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", text,
                                 re.S):
        if "raytri_count_kernel" not in name:
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
        if dump:
            with open(dump, "w") as f:
                f.writelines(f"{addr:05x}  {txt}\n" for addr, txt in insts
                             if lo <= addr <= hi)
        tests = ops["FMUL"] / FMUL_PER_TEST
        grouped = {g: ops[g] / tests for g in GROUPS}
        grouped["other"] = sum(v for k, v in ops.items() if k not in GROUPS) / tests
        return {"function": name, "loop": [hex(lo), hex(hi)],
                "tests_per_iteration": tests, "instructions": sum(ops.values()),
                "instructions_per_test": sum(ops.values()) / tests,
                "per_test_grouped": grouped,
                "per_test": {k: v / tests for k, v in ops.most_common()}}
    return {}


def sass_mix(lib_path: str, find_nvcc, dump: str = None) -> dict:
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    return inner_loop(text, dump)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose obman_train_tpu_torch is timed")
    ap.add_argument("--label", default=None, help="names the tree in the output")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    ap.add_argument("--sass_out", default=None,
                    help="write the built kernel's inner loop (SASS) here")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    label = args.label or root

    sys.path.insert(0, HERE)
    import chip_smoke  # this repository's scenes, timers, bound and peaks

    sys.path.insert(0, root)  # the tree under test, ahead of this one
    import torch

    from obman_train_tpu_torch.ops import nnsqdist, raytri
    from obman_train_tpu_torch.ops.kernels import build

    if not os.path.realpath(raytri.__file__).startswith(os.path.realpath(root) + os.sep):
        chip_smoke.fail(f"imported {raytri.__file__}, not the tree {root}")
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: the tool runs the kernel on the card")
    sink = open(args.out, "w") if args.out else None

    def emit(rec):
        line = json.dumps({"tree": label, **rec})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.stdout.strip()})
    chip_smoke.set_tf32(False)
    sms = nnsqdist._sms(torch.device("cuda", 0))

    emit({"sass": "default",
          **sass_mix(build.build("raytri"), build.find_nvcc, args.sass_out)})

    scenes = [("raytri_count", *chip_smoke.raytri_scene(256, 778, 1280, seed=0)),
              *chip_smoke.voxel_scenes(),
              *((f"contact_b{b}", *chip_smoke.raytri_scene(b, p, t, seed=10 + b))
                for b, p, t in CALLERS)]
    tables = [(name, pts, raytri.triangle_table(tris)) for name, pts, tris in scenes]
    for name, pts, table in tables:
        B, P, _ = pts.shape
        T = table.shape[1]
        got = raytri.raytri_count(pts, table)
        want = raytri.raytri_count_plain(pts, table)
        bad = int((got != want).sum())
        if bad:
            chip_smoke.fail(f"{label}: raytri {B}x{P}x{T}: {bad} mismatches")
        ms = chip_smoke.cuda_ms(lambda: raytri.raytri_count(pts, table), iters=50)
        device_ms = chip_smoke.graph_ms(lambda: raytri.raytri_count(pts, table), iters=50)
        bound_ms = chip_smoke.raytri_bound(B, P, T)["bound_ms"]
        plan = (raytri._launch_plan(B, P, T, sms) if hasattr(raytri, "_launch_plan")
                else None)
        emit({"raytri": [B, P, T], "name": name, "mismatches": 0, "ms": ms,
              "device_ms": device_ms, "bound_ms": bound_ms,
              "share_of_bound": bound_ms / device_ms, "plan": plan})

    if hasattr(raytri, "_launch_plan") and hasattr(raytri, "bind"):
        lib = raytri._library()
        for name, pts, table in tables:
            B, P, _ = pts.shape
            T = table.shape[1]
            plan = raytri._launch_plan(B, P, T, sms)
            if plan[1] == 1:
                continue
            unsplit = (plan[0], 1, T, -(-P // (32 * plan[0])) * B)
            for turn, p in enumerate((plan, unsplit, unsplit, plan)):
                row = _time_lib(chip_smoke, raytri, lib, pts, table, p)
                emit({"split": p[1] > 1, "turn": turn, "raytri": [B, P, T], "name": name,
                      "plan": p, **row})
    if sink:
        sink.close()


def _time_lib(chip_smoke, raytri, lib, pts, table, plan) -> dict:
    """The library's launch at ``plan``: bitwise against the plain version
    (fatal), ``ms`` (eager), ``device_ms``, bound and share."""
    import torch

    B, P, _ = pts.shape
    T = table.shape[1]
    _, slices, slice_len, _ = plan
    counts = torch.empty((B, P), dtype=torch.int32, device=pts.device)

    def call():
        err = lib.raytri_count(pts.data_ptr(), table.data_ptr(), B, P, T,
                               *raytri._DIR_F32, raytri._TOL_F32, slices, slice_len,
                               counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            chip_smoke.fail(f"raytri launch failed: CUDA error {err}")

    call()
    torch.cuda.synchronize()
    bad = int((counts != raytri.raytri_count_plain(pts, table)).sum())
    if bad:
        chip_smoke.fail(f"raytri {B}x{P}x{T} plan {plan}: {bad} mismatches")
    ms = chip_smoke.cuda_ms(call, iters=50)
    device_ms = chip_smoke.graph_ms(call, iters=50)
    bound_ms = chip_smoke.raytri_bound(B, P, T)["bound_ms"]
    return {"mismatches": 0, "ms": ms, "device_ms": device_ms, "bound_ms": bound_ms,
            "share_of_bound": bound_ms / device_ms}


if __name__ == "__main__":
    main()
