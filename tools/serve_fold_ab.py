"""Times the serving encoder's layers on the card: today's chain
(convolution, frozen BatchNorm, ReLU, residual add: ``ResNet.forward``'s
modules) against the folded layer run by cuDNN's fused ops
(``models/resnet_fold.CUDNN``) and by the plain folded chain
(``PLAIN``: ``F.conv2d`` with its bias, then add and ReLU).

    python3 tools/serve_fold_ab.py [--batch 256] [--size 256] [--resnet 18]
                                   [--out chiprun_out/serve_fold_ab.json]

Rows: the stem (conv, BN, ReLU; the max-pool left out), every block, and
the whole encoder. Each row's ms is CUDA-event time over ``--iters``
back-to-back calls after a warm-up, TF32 convolutions on (as served);
``gap`` is the fused row's largest difference from today's chain with
TF32 off, over the chain's largest magnitude. The last line is the JSON
summary; it also lists the kernels one fused encoder call launches.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from obman_train_tpu_torch.models import resnet_fold as rf  # noqa: E402
from obman_train_tpu_torch.models.resnet import resnet18, resnet50  # noqa: E402


def _time(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _net(resnet: int) -> torch.nn.Module:
    torch.manual_seed(0)
    net = (resnet18 if resnet == 18 else resnet50)().cuda().eval()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 2.0)
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.2, 0.2)
    return net


def _rows(net, folded, x):
    """(name, today_fn, {route: fn}) for the stem, each block, the encoder."""
    stem = lambda: net.relu(net.bn1(net.conv1(x)))  # noqa: E731
    rows = [("stem", stem, {r: (lambda o=o: o.conv_relu(x, folded.stem))
                            for r, o in (("cudnn", rf.CUDNN), ("plain", rf.PLAIN))})]
    h = net.maxpool(stem())
    blocks = [b for s in (net.layer1, net.layer2, net.layer3, net.layer4) for b in s]
    for i, (block, fb) in enumerate(zip(blocks, folded.blocks)):
        name = f"block{i} {tuple(h.shape[1:])}->{block.conv1.out_channels * block.expansion}"
        rows.append((name, (lambda b=block, inp=h: b(inp)),
                     {r: (lambda o=o, fb=fb, inp=h: rf.block(fb, inp, o))
                      for r, o in (("cudnn", rf.CUDNN), ("plain", rf.PLAIN))}))
        h = block(h)
    rows.append(("encoder", lambda: net(x)[0],
                 {r: (lambda o=o: rf.features(folded, x, o)[0])
                  for r, o in (("cudnn", rf.CUDNN), ("plain", rf.PLAIN))}))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--resnet", type=int, default=18, choices=(18, 50))
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--out", default="chiprun_out/serve_fold_ab.json")
    args = p.parse_args(argv)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    net = _net(args.resnet)
    frames = torch.randn(args.batch, args.size, args.size, 3, device="cuda")
    x = frames.permute(0, 3, 1, 2)  # NHWC frames viewed as NCHW, as HandNet passes them
    out = {"card": smi, "torch": torch.__version__, "batch": args.batch, "size": args.size,
           "resnet": args.resnet, "rows": []}
    with torch.inference_mode():
        with torch.inference_mode(False), torch.no_grad():
            folded = rf.fold(net)
        rows = _rows(net, folded, x)
        for name, today, routes in rows:
            row = {"row": name}
            torch.backends.cudnn.allow_tf32 = False
            want = today()
            for r, fn in routes.items():
                row[f"gap_{r}"] = _gap(fn(), want)
            torch.backends.cudnn.allow_tf32 = True
            row["today_ms"] = _time(today, args.iters)
            for r, fn in routes.items():
                row[f"{r}_ms"] = _time(fn, args.iters)
            out["rows"].append(row)
            print(json.dumps(row), flush=True)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rf.features(folded, x, rf.CUDNN)
            torch.cuda.synchronize()
        out["fused_kernels"] = sorted(
            {(e.key, e.count) for e in prof.key_averages() if e.device_type.name == "CUDA"},
            key=lambda kv: kv[0])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("card", "torch", "fused_kernels")}))


if __name__ == "__main__":
    main()
