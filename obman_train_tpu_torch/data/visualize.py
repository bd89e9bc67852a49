"""Dataset sanity-inspection harnesses (the JAX package's
``data/visualize.py``).

Headless (save-to-file) equivalents of the reference's interactive
``HandDataset.visualize_original / visualize_transformed /
visualize_3d_transformed / visualize_3d_proj`` plots
(handobjectdatasets/handataset.py:425-629) — the visual QA workflow used to
validate new dataset adapters and augmentation settings.

Each function takes the wrapped :class:`HandDataset`, a sample index, and a
path; it returns the path after writing a PNG. Where matplotlib is not
installed (some GPU hosts have PIL only) the same calls draw PIL raster
panels through ``visualize/raster.py``: the image with its 2D joints, and
the 3D points as their x-y, x-z and y-z projections.
"""

from __future__ import annotations

import numpy as np

from obman_train_tpu_torch.data.queries import BaseQueries, TransQueries


def _plt():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _available(dataset, queries):
    return [q for q in queries if q in dataset.pose_dataset.all_queries]


def _transformed_image(sample):
    img = np.asarray(sample[TransQueries.images])
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return np.clip(img + 0.5, 0, 1)


# the 3D layers of the point figures: (query, raster colour, size)
_LAYERS_3D = (
    (TransQueries.verts3d, "b", 1),
    (TransQueries.objpoints3d, "g", 1),
    (TransQueries.joints3d, "r", 12),
)
_PROJECTIONS = ((0, 1, "xy"), (0, 2, "xz"), (1, 2, "yz"))


def _raster_row(tiles, title, save_path):
    """PIL tiles side by side under a one-line title."""
    from PIL import Image, ImageDraw

    size = tiles[0].size[0]
    out = Image.new("RGB", (size * len(tiles), size + 20), "white")
    for col, tile in enumerate(tiles):
        out.paste(tile, (col * size, 20))
    ImageDraw.Draw(out).text((4, 4), title, fill=(0, 0, 0))
    out.save(save_path)
    return save_path


def _raster_image(img, joints2d=None, points2d=None):
    """The image tile with its skeleton and, in green, 2D points."""
    from PIL import ImageDraw

    from obman_train_tpu_torch.visualize.raster import RGB, TILE, image_tile

    tile = image_tile(img, joints2d)
    if points2d is not None:
        h, w = np.asarray(img).shape[:2]
        pts = np.asarray(points2d, np.float64)[:, :2] * [TILE / w, TILE / h]
        ImageDraw.Draw(tile).point([tuple(p) for p in pts], fill=RGB["g"])
    return tile


def _raster_projections(sample):
    from obman_train_tpu_torch.visualize.raster import points_tile

    return [points_tile([(np.asarray(sample[q])[:, [i, j]], color)
                         for q, color, _ in _LAYERS_3D if q in sample])
            for i, j, _ in _PROJECTIONS]


def visualize_original(dataset, idx: int, save_path: str) -> str:
    """Raw image + annotated 2D joints / object points
    (reference handataset.py:425-459)."""
    from obman_train_tpu_torch.visualize.viz2d import visualize_joints_2d

    queries = _available(
        dataset,
        [
            BaseQueries.sides, BaseQueries.images, BaseQueries.joints2d,
            BaseQueries.objpoints2d,
        ],
    )
    sample = dataset.get_sample(idx, query=queries)
    title = f"{sample[BaseQueries.sides]} hand" if BaseQueries.sides in sample else ""
    plt = _plt()
    if plt is None:
        tile = _raster_image(sample[BaseQueries.images], sample.get(BaseQueries.joints2d),
                             sample.get(BaseQueries.objpoints2d))
        return _raster_row([tile], title, save_path)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(np.asarray(sample[BaseQueries.images]))
    if title:
        ax.set_title(title)
    if BaseQueries.joints2d in sample:
        visualize_joints_2d(ax, np.asarray(sample[BaseQueries.joints2d]))
    if BaseQueries.objpoints2d in sample:
        pts = np.asarray(sample[BaseQueries.objpoints2d])
        ax.scatter(pts[:, 0], pts[:, 1], alpha=0.05, s=2)
    ax.axis("off")
    fig.savefig(save_path, dpi=90)
    plt.close(fig)
    return save_path


def visualize_transformed(dataset, idx: int, save_path: str) -> str:
    """Augmented crop + transformed 2D joints
    (reference handataset.py:576-629)."""
    from obman_train_tpu_torch.visualize.viz2d import visualize_joints_2d

    queries = [TransQueries.images] + _available(
        dataset, [BaseQueries.sides, TransQueries.joints2d]
    )
    sample = dataset.get_sample(idx, query=queries)
    title = (f"{sample[BaseQueries.sides]} hand (transformed)"
             if BaseQueries.sides in sample else "")
    plt = _plt()
    if plt is None:
        tile = _raster_image(sample[TransQueries.images], sample.get(TransQueries.joints2d))
        return _raster_row([tile], title, save_path)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(_transformed_image(sample))
    if title:
        ax.set_title(title)
    if TransQueries.joints2d in sample:
        visualize_joints_2d(ax, np.asarray(sample[TransQueries.joints2d]))
    ax.axis("off")
    fig.savefig(save_path, dpi=90)
    plt.close(fig)
    return save_path


def visualize_3d_transformed(dataset, idx: int, save_path: str) -> str:
    """3D scatter of the transformed joints/verts/object points
    (reference handataset.py:532-574); without matplotlib, its three axis
    projections."""
    queries = _available(
        dataset,
        [TransQueries.joints3d, TransQueries.verts3d, TransQueries.objpoints3d],
    )
    sample = dataset.get_sample(idx, query=queries)
    plt = _plt()
    if plt is None:
        return _raster_row(_raster_projections(sample),
                           "hand verts (b), joints (r), object (g): xy, xz, yz", save_path)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    if TransQueries.verts3d in sample:
        v = np.asarray(sample[TransQueries.verts3d])
        ax.scatter(v[:, 0], v[:, 1], v[:, 2], s=1, alpha=0.3, label="hand verts")
    if TransQueries.joints3d in sample:
        j = np.asarray(sample[TransQueries.joints3d])
        ax.scatter(j[:, 0], j[:, 1], j[:, 2], s=20, c="r", label="joints")
    if TransQueries.objpoints3d in sample:
        o = np.asarray(sample[TransQueries.objpoints3d])
        ax.scatter(o[:, 0], o[:, 1], o[:, 2], s=1, alpha=0.3, c="g",
                   label="object")
    ax.legend(loc="upper right")
    fig.savefig(save_path, dpi=90)
    plt.close(fig)
    return save_path


def visualize_3d_proj(dataset, idx: int, save_path: str) -> str:
    """Crop + the three axis projections of the transformed 3D annotations
    (reference handataset.py:493-530)."""
    from obman_train_tpu_torch.visualize.viz2d import visualize_joints_2d

    queries = [TransQueries.images] + _available(
        dataset,
        [
            TransQueries.joints3d, TransQueries.verts3d,
            TransQueries.objpoints3d, TransQueries.joints2d,
        ],
    )
    sample = dataset.get_sample(idx, query=queries)
    plt = _plt()
    if plt is None:
        tile = _raster_image(sample[TransQueries.images], sample.get(TransQueries.joints2d))
        return _raster_row([tile] + _raster_projections(sample), "crop; xy, xz, yz", save_path)
    fig, axes = plt.subplots(1, 4, figsize=(16, 4))
    axes[0].imshow(_transformed_image(sample))
    if TransQueries.joints2d in sample:
        visualize_joints_2d(axes[0], np.asarray(sample[TransQueries.joints2d]))
    axes[0].axis("off")
    for ax, (i, j, label) in zip(axes[1:], _PROJECTIONS):
        for q, color, size in _LAYERS_3D:
            if q in sample:
                pts = np.asarray(sample[q])
                ax.scatter(pts[:, i], pts[:, j], s=size, c=color, alpha=0.4)
        ax.set_title(label)
        ax.set_aspect("equal", "box")
        if label == "xy":
            ax.invert_yaxis()
    fig.savefig(save_path, dpi=90)
    plt.close(fig)
    return save_path
