"""Times the nearest-neighbour kernel (``nn_dir``) of one tree of this
repository on an NVIDIA GPU and reads the inner loop of its SASS. Run it on
two trees on one card, one after the other, e.g. a ``git archive`` of an
earlier commit and this one, in turns A, B, B, A, to compare the kernels.

    python3 tools/nn_dir_ab.py [--root DIR] [--label NAME] [--out PATH]

``--root`` (default: this repository) is the tree whose
``obman_train_tpu_torch`` is imported and built. Of it the tool uses only
``ops.nnsqdist.nn_dir`` / ``nn_dir_plain``, ``ops.chamfer.chamfer_loss``
and ``ops.kernels.build.build``. The scenes (``nn_scene``: seeded clouds
with planted exact ties), the timers and the card's peaks come from this
repository's ``chip_smoke.py``. It prints JSON lines (and writes them to
``--out``):

- ``nn_dir`` at the rows of chip_smoke's kernel table and the training
  shapes' other directions: exactness against ``nn_dir_plain`` (values
  bitwise, argmins exactly; fatal), ``ms`` (eager calls between CUDA
  events), ``device_ms`` (the same calls replayed from a CUDA graph), the
  bound (9 float32 instructions per pair) and the device time's share of it;
- ``chamfer_loss`` forward and forward + gradient at 256x600x642 and
  1x16384x16384 on the kernel route: ``ms`` (eager) and the device's busy
  time per call from torch.profiler (the sum of its kernels' durations);
- ``sass``: the inner loop of each ``nn_dir_kernel`` instantiation of the
  built library (``cuobjdump -sass``; the innermost loop with the most
  FMULs), its instructions per pair by opcode (3 FMULs a pair).

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

NN_SHAPES = (
    # (B, N, M, argmin): chip_smoke's kernel table, then the training
    # shapes' other directions
    (256, 778, 600, False),
    (256, 600, 642, True),
    (256, 778, 642, True),
    (1, 20000, 20000, False),
    (1, 16384, 16384, True),
    (256, 642, 600, True),
    (256, 642, 778, True),
)
CHAMFER_SHAPES = ((256, 600, 642), (1, 16384, 16384))

_INST = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRA = re.compile(r"\bBRA\s+(?:`\()?(0x[0-9a-f]+|\.L_x_\d+)")


def inner_loops(text: str) -> dict:
    """{kernel function: inner-loop mix} from the text of ``cuobjdump -sass``."""
    out = {}
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", text,
                                 re.S):
        if "nn_dir_kernel" not in name:
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
        pairs = ops["FMUL"] / 3
        out[name] = {
            "argmin": "ILb1E" in name, "loop": [hex(lo), hex(hi)],
            "pairs_per_iteration": pairs, "instructions": sum(ops.values()),
            "instructions_per_pair": sum(ops.values()) / pairs,
            "per_pair": {k: v / pairs for k, v in ops.most_common()},
        }
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose obman_train_tpu_torch is timed")
    ap.add_argument("--label", default=None, help="names the tree in the output")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    label = args.label or root

    sys.path.insert(0, HERE)
    import chip_smoke  # this repository's scenes, timers and peaks

    sys.path.insert(0, root)  # the tree under test, ahead of this one
    import torch

    from obman_train_tpu_torch.ops import chamfer, nnsqdist
    from obman_train_tpu_torch.ops.kernels import build

    if not os.path.realpath(nnsqdist.__file__).startswith(os.path.realpath(root) + os.sep):
        chip_smoke.fail(f"imported {nnsqdist.__file__}, not the tree {root}")
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

    lib_path = build.build("nnsqdist")
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    for fn, mix in inner_loops(text).items():
        emit({"sass": fn, **mix})

    for seed, (B, N, M, am) in enumerate(NN_SHAPES):
        q, s = chip_smoke.nn_scene(B, N, M, seed)
        got, garg = nnsqdist.nn_dir(q, s, am)
        want, warg = nnsqdist.nn_dir_plain(q, s, am)
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        bad += int((garg != warg).sum()) if am else 0
        if bad:
            chip_smoke.fail(f"{label}: nn_dir {B}x{N}x{M} argmin={am}: {bad} mismatches")
        it = 20 if B * N * M >= 1e8 else 50
        ms = chip_smoke.cuda_ms(lambda: nnsqdist.nn_dir(q, s, am), iters=it)
        device_ms = chip_smoke.graph_ms(lambda: nnsqdist.nn_dir(q, s, am), iters=it)
        bound_ms = (B * N * M * chip_smoke.NN_OPS_PER_PAIR[am]
                    / chip_smoke.PEAK_FP32_INSTS * 1e3)
        emit({"nn_dir": [B, N, M], "argmin": am, "mismatches": 0, "ms": ms,
              "device_ms": device_ms, "bound_ms": bound_ms,
              "share_of_bound": bound_ms / device_ms})
        del q, s

    for B, N, M in CHAMFER_SHAPES:
        preds, gts = chip_smoke.nn_scene(B, N, M, seed=B + N)

        def fwd():
            with torch.no_grad():
                return chamfer.chamfer_loss(preds, gts, use_kernel=True)

        def fwd_grad():
            p = preds.clone().requires_grad_(True)
            g = gts.clone().requires_grad_(True)
            l1, l2 = chamfer.chamfer_loss(p, g, use_kernel=True)
            torch.mean(l1 + l2).backward()

        for name, fn in (("forward", fwd), ("forward_grad", fwd_grad)):
            ms = chip_smoke.cuda_ms(fn, iters=10)
            prof = chip_smoke._profile(fn, f"{label} chamfer_loss {name} {B}x{N}x{M}", "call")
            emit({"chamfer_loss": [B, N, M], "part": name, "ms": ms,
                  "device_busy_ms": prof.get("device_ms_per_call"),
                  "wall_ms_under_profiler": prof.get("wall_ms_per_call"),
                  "kernels_per_call": prof.get("kernels_per_call")})
        del preds, gts
    if sink:
        sink.close()


if __name__ == "__main__":
    main()
