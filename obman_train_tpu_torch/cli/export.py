"""Export a trained model to a self-contained serving artifact (the JAX
package's ``cli/export.py``, with its flags).

    python -m obman_train_tpu_torch.cli.export --resume checkpoints/exp \
        --out model.pt2 --platforms cuda cpu

The artifact is the uint8-RGB -> hand+object-mesh program (preprocessing
on the device included, weights baked in) traced by ``torch.export``; load
it anywhere with ``obman_train_tpu_torch.demo.export.load_exported``, which
needs only torch. On the CPU set ``OBMAN_PLATFORM=cpu``.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--resume", required=True,
                   help="experiment dir (opt.json + checkpoint)")
    p.add_argument("--out", required=True, help="artifact output path")
    p.add_argument("--mano_assets", default=None,
                   help="override MANO asset dir ('synthetic' for testing)")
    p.add_argument("--image_size", type=int, default=None,
                   help="model input resolution (default: the experiment's "
                        "config.model.image_size)")
    p.add_argument("--platforms", nargs="*", default=None,
                   help="platforms to export for (cpu, cuda or gpu); default: "
                        "the model's device")
    p.add_argument("--batch_size", type=int, default=None,
                   help="pin a static batch; default exports a symbolic "
                        "batch dimension (any batch size)")
    p.add_argument("--smoke", action="store_true",
                   help="reload the artifact and run one call (at the "
                        "pinned --batch_size, else batch 1) against the "
                        "live model as a consistency check")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from obman_train_tpu_torch.cli import apply_platform_override
    from obman_train_tpu_torch.demo.export import export_model, load_exported
    from obman_train_tpu_torch.demo.inference import DemoModel

    device = apply_platform_override()
    model = DemoModel(exp_dir=args.resume, mano_assets=args.mano_assets,
                      image_size=args.image_size, device=device)
    info = export_model(model, args.out, platforms=args.platforms,
                        batch_size=args.batch_size)
    print(json.dumps(info))

    if args.smoke:
        serve = load_exported(args.out)
        # a static-batch artifact accepts only its pinned batch size
        b = args.batch_size or 1
        size = model.image_size
        frame = torch.zeros((b, size, size, 3), dtype=torch.uint8)
        sides = torch.zeros((b,), dtype=torch.int32)
        flip = torch.zeros((b,), dtype=torch.bool)
        live = model._infer(model._variables, frame.to(device), sides.to(device),
                            flip.to(device))
        for platform in info["platforms"]:
            dev = torch.device(platform)
            out = serve(frame.to(dev), sides.to(dev), flip.to(dev))
            assert sorted(out) == sorted(live), (sorted(out), sorted(live))
            for k in live:
                np.testing.assert_allclose(out[k].float().cpu().numpy(),
                                           live[k].float().cpu().numpy(),
                                           rtol=1e-5, atol=2e-3, err_msg=k)
        print(f"smoke OK: exported == live on {sorted(live)} for {info['platforms']}")
    return info


if __name__ == "__main__":
    main()
