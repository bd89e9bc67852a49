"""Single-image inference demo (the JAX package's ``cli/image_demo.py``;
reference image_demo.py): the frame and its mirror image run as one batch
of 2, and the predicted hand and object meshes are drawn to a PNG.

  python -m obman_train_tpu_torch.cli.image_demo --image path.jpg \
      --resume checkpoints/exp --output demo_out.png

On the CPU set ``OBMAN_PLATFORM=cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--image", required=True)
    parser.add_argument("--resume", default=None,
                        help="experiment dir with opt.json + checkpoint")
    parser.add_argument("--from_export", default=None,
                        help="serve from a cli.export artifact (skips model "
                        "construction and checkpoint restore at startup; "
                        "needs the artifact's .meta.json sidecar)")
    parser.add_argument("--output", default="image_demo_out.png")
    parser.add_argument("--hand_side", default="left", choices=["left", "right"])
    parser.add_argument("--mano_assets", default=None)
    parser.add_argument("--no_flip", action="store_true")
    args = parser.parse_args(argv)

    from PIL import Image

    from obman_train_tpu_torch.cli import apply_platform_override

    device = apply_platform_override()
    if args.from_export is not None:
        from obman_train_tpu_torch.demo.export import ExportedModel

        model = ExportedModel(args.from_export, device=device)
    else:
        from obman_train_tpu_torch.config import ExperimentConfig
        from obman_train_tpu_torch.demo import DemoModel

        if args.resume is None:
            model = DemoModel(config=ExperimentConfig(),
                              mano_assets=args.mano_assets or "synthetic", device=device)
        else:
            model = DemoModel(exp_dir=args.resume, mano_assets=args.mano_assets,
                              device=device)

    frame = np.asarray(Image.open(args.image).convert("RGB"))
    if args.no_flip:
        results = model.predict(frame, hand_side=args.hand_side)
    else:
        results = model.predict_dual(frame, hand_side=args.hand_side)

    _save_figure(args.output, frame, results, model)
    print(f"Saved {args.output}")
    print("verts", results["verts"].shape, "joints", results["joints"].shape,
          "obj", results.get("objpoints3d", np.zeros(())).shape)
    return results


def _save_figure(path, frame, results, model):
    """The input beside each prediction's meshes (matplotlib 3D axes;
    without matplotlib, PIL raster panels, one row per prediction)."""
    n = results["verts"].shape[0]
    try:
        import matplotlib
    except ImportError:
        from PIL import Image

        from obman_train_tpu_torch.visualize.raster import mesh_panel

        rows = [mesh_panel(frame, None, [(results["verts"][i], "b")] + (
            [(results["objpoints3d"][i], "r")] if "objpoints3d" in results else []))
            for i in range(n)]
        Image.fromarray(np.concatenate(rows, axis=0)).save(path)
        return

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from obman_train_tpu_torch.visualize.displaymano import add_mesh

    fig = plt.figure(figsize=(4 * (n + 1), 4))
    ax = fig.add_subplot(1, n + 1, 1)
    ax.imshow(frame)
    ax.set_title("input")
    ax.axis("off")
    for i in range(n):
        ax = fig.add_subplot(1, n + 1, i + 2, projection="3d")
        add_mesh(ax, results["verts"][i], model.hand_faces, c="b")
        if "objpoints3d" in results:
            add_mesh(ax, results["objpoints3d"][i], model.obj_faces, c="r")
        ax.set_title(["unflipped", "flipped"][i] if n == 2 else "pred")
        ax.axis("off")
    fig.savefig(path, dpi=100)
    plt.close(fig)


if __name__ == "__main__":
    main()
