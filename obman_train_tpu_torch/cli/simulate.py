"""Simulation CLI (the JAX package's ``cli/simulate.py``; reference:
scripts/simulate3d.py). On the GPU; ``OBMAN_PLATFORM=cpu`` for the CPU.

  python -m obman_train_tpu_torch.cli.simulate \\
      --exp_id checkpoints/exp/save_results/val/epoch_0 [--intersect]
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--exp_id", required=True,
                        help="dir containing batch_*.pkl result dumps")
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--backend", default="native",
                        choices=["native", "pybullet"])
    parser.add_argument("--intersect", action="store_true",
                        help="also compute intersection volumes")
    parser.add_argument("--intersect_mode", default="voxels",
                        choices=["voxels", "engines"],
                        help="'voxels' (reference default, built-in) or "
                             "'engines' (exact trimesh scad/blender "
                             "booleans; needs those installed)")
    parser.add_argument("--pitch", type=float, default=0.005)
    parser.add_argument("--vhacd_exe", default=None,
                        help="V-HACD executable (forces the pybullet backend)")
    parser.add_argument("--save_gifs", action="store_true",
                        help="save per-sample obj/trajectory/gif artifacts "
                        "(reference simulate.py:43-108)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from obman_train_tpu_torch.cli import apply_platform_override
    from obman_train_tpu_torch.simulation import full_simul
    from obman_train_tpu_torch.simulation.intersect import full_intersect

    device = apply_platform_override()  # the depths and voxels run on it
    summary = full_simul(
        args.exp_id, workers=args.workers, backend=args.backend,
        vhacd_exe=args.vhacd_exe, save_gifs=args.save_gifs, device=device,
    )
    print("simulation:", summary)
    if args.intersect:
        inter = full_intersect(args.exp_id, pitch=args.pitch,
                               mode=args.intersect_mode, device=device)
        print("intersection:", inter)
    return summary


if __name__ == "__main__":
    main()
