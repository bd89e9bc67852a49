"""Per-batch diagnostic figures and PCK-curve plots (the JAX package's
``visualize/displaymano.py``, numpy and matplotlib only).

Where matplotlib is not installed, ``visualize_batch`` and
``save_pck_img`` draw PIL raster versions (:mod:`raster`).

Equivalent of mano_train/visualize/displaymano.py: a grid with input image +
reprojected 2D joints, 3D hand/object meshes, and three axis projections per
sample (visualize_batch:66-339), plus ``save_pck_img`` with the published
literature PCK curves overlaid for the StereoHands protocols
(:494-662 — the overlay numbers are published benchmark results).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# Published literature PCK curves (benchmark data from the respective
# papers, as tabulated in the reference for plot overlays).
LITERATURE_CURVES = {
    "stereo_all": {
        "Ganerated": (
            [20.2020, 22.2222, 24.2424, 26.2626, 28.2828, 30.3030, 32.3232,
             34.3434, 36.3636, 38.3838, 40.4040, 42.4242, 44.4444, 46.4646,
             48.4848, 50.5051],
            [0.4416, 0.4772, 0.5101, 0.5410, 0.5699, 0.5968, 0.6212, 0.6445,
             0.6660, 0.6858, 0.7049, 0.7229, 0.7394, 0.7550, 0.7697, 0.7835],
        ),
    },
    "stereo_test": {
        "Ganerated wo": (
            [19.1919, 22.2222, 25.2525, 28.2828, 31.3131, 34.3434, 37.3737,
             40.4040, 43.4343, 46.4646, 49.4949],
            [0.7031, 0.7323, 0.7586, 0.7831, 0.8056, 0.8249, 0.8424, 0.8586,
             0.8728, 0.8859, 0.8972],
        ),
        "Ganerated w": (
            [19.1919, 22.2222, 25.2525, 28.2828, 31.3131, 34.3434, 37.3737,
             40.4040, 43.4343, 46.4646, 49.4949],
            [0.8713, 0.9035, 0.9271, 0.9446, 0.9574, 0.9670, 0.9741, 0.9795,
             0.9833, 0.9867, 0.9895],
        ),
        "Z&B": (
            [21.0526, 23.6842, 26.3158, 28.9474, 31.5789, 34.2105, 36.8421,
             39.4737, 42.1053, 44.7368, 47.3684, 50.0],
            [0.8699, 0.8969, 0.9168, 0.9321, 0.9435, 0.9528, 0.9599, 0.9660,
             0.9716, 0.9765, 0.9802, 0.9833],
        ),
        "CHPR": (
            [20, 25, 30, 35, 40, 45, 50],
            [0.5658, 0.7171, 0.8224, 0.8816, 0.9145, 0.9375, 0.9605],
        ),
    },
}


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def create_segments(contact_info: Dict, verts: np.ndarray, idx: int):
    """Per-sample (hand vertex -> closest object point) segment endpoints
    for the attraction and repulsion masks (reference displaymano.py:12-18).
    Returns (penetr_verts, penetr_close, missed_verts, missed_close)."""
    att = np.asarray(contact_info["attraction_masks"])[idx].astype(bool)
    rep = np.asarray(contact_info["repulsion_masks"])[idx].astype(bool)
    close = np.asarray(contact_info["contact_points"])[idx]
    return verts[rep], close[rep], verts[att], close[att]


def visualize_contacts3d(ax, contact_info, verts, idx, alpha=0.1):
    """Red repulsion + blue attraction segments on a 3D axis
    (reference displaymano.py:21-40), drawn as one Line3DCollection per
    family instead of a python loop per segment."""
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    pv, pc, mv, mc = create_segments(contact_info, verts, idx)
    if len(pv):
        ax.add_collection3d(
            Line3DCollection(np.stack([pv, pc], axis=1), colors="r",
                             alpha=alpha)
        )
    if len(mv):
        ax.add_collection3d(
            Line3DCollection(np.stack([mv, mc], axis=1), colors="b",
                             alpha=alpha)
        )


def visualize_contacts2d(ax, contact_info, verts, idx, proj=(0, 1),
                         alpha=0.5):
    """Contact segments projected on two axes
    (reference displaymano.py:43-63)."""
    from matplotlib.collections import LineCollection

    i, j = proj
    pv, pc, mv, mc = create_segments(contact_info, verts, idx)
    if len(pv):
        segs = np.stack([pv[:, [i, j]], pc[:, [i, j]]], axis=1)
        ax.add_collection(LineCollection(segs, colors="r", alpha=alpha))
    if len(mv):
        segs = np.stack([mv[:, [i, j]], mc[:, [i, j]]], axis=1)
        ax.add_collection(LineCollection(segs, colors="b", alpha=alpha))


def add_mesh(ax, verts: np.ndarray, faces: np.ndarray, alpha: float = 0.2,
             c: str = "b"):
    """Poly3DCollection mesh rendering (reference displaymano.py:447-472)."""
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    mesh = Poly3DCollection(verts[faces], alpha=alpha)
    mesh.set_edgecolor("none")
    mesh.set_facecolor(c)
    ax.add_collection3d(mesh)
    c_min, c_max = verts.min(0), verts.max(0)
    ax.auto_scale_xyz(*[[c_min[i], c_max[i]] for i in range(3)])


def visualize_batch(
    save_path: str,
    batch: Dict[str, np.ndarray],
    results: Dict[str, np.ndarray],
    hand_faces: np.ndarray,
    obj_faces: Optional[np.ndarray] = None,
    max_samples: int = 5,
    fig=None,
):
    """Diagnostic grid: rows = [input+joints2d, 3D meshes (+contact
    segments), xy/yz/xz projections], cols = samples
    (displaymano.visualize_batch:66-339; contact segments :21-63). Without
    matplotlib, the PIL raster grid of :mod:`raster`."""
    try:
        plt = _plt()
    except ImportError:
        from obman_train_tpu_torch.visualize import raster

        return raster.visualize_batch(save_path, batch, results, max_samples)
    if fig is None:
        fig = plt.figure(figsize=(12, 12))
    fig.clf()
    images = np.asarray(batch["images"])
    n = min(max_samples, images.shape[0])
    rows = 4

    pred_verts = np.asarray(results.get("verts")) if "verts" in results else None
    pred_obj = (
        np.asarray(results.get("objpoints3d"))
        if "objpoints3d" in results
        else None
    )
    contact_info = results.get("contact_info")
    for col in range(n):
        # input image (+0.5 to undo normalization)
        ax = fig.add_subplot(rows, n, col + 1)
        ax.imshow(np.clip(images[col] + 0.5, 0, 1))
        ax.axis("off")
        if "joints2d" in results:
            from obman_train_tpu_torch.visualize.viz2d import visualize_joints_2d

            visualize_joints_2d(ax, np.asarray(results["joints2d"])[col])

        # 3D meshes (+ contact attraction/repulsion segments)
        ax = fig.add_subplot(rows, n, n + col + 1, projection="3d")
        if pred_verts is not None:
            add_mesh(ax, pred_verts[col], hand_faces, c="b")
        if pred_obj is not None and obj_faces is not None:
            add_mesh(ax, pred_obj[col], obj_faces, c="r")
        if contact_info is not None and pred_verts is not None:
            visualize_contacts3d(ax, contact_info, pred_verts[col], col)
        ax.axis("off")

        # axis projections of GT vs pred point clouds
        for row, (i, j) in enumerate([(0, 1), (1, 2), (0, 2)][:2], start=2):
            ax = fig.add_subplot(rows, n, row * n + col + 1)
            if contact_info is not None and pred_verts is not None:
                visualize_contacts2d(
                    ax, contact_info, pred_verts[col], col, proj=(i, j)
                )
            if pred_verts is not None:
                ax.scatter(pred_verts[col][:, i], pred_verts[col][:, j], s=1,
                           c="b", alpha=0.4)
            if "verts3d" in batch:
                gt = np.asarray(batch["verts3d"])[col]
                ax.scatter(gt[:, i], gt[:, j], s=1, c="g", alpha=0.4)
            if pred_obj is not None:
                ax.scatter(pred_obj[col][:, i], pred_obj[col][:, j], s=1,
                           c="r", alpha=0.4)
            if "objpoints3d" in batch:
                gt = np.asarray(batch["objpoints3d"])[col]
                ax.scatter(gt[:, i], gt[:, j], s=1, c="y", alpha=0.4)
            ax.set_aspect("equal", "box")
            ax.invert_yaxis()
    fig.savefig(save_path, dpi=80)
    return save_path


def save_pck_img(
    thresholds, pck_values, auc_all, save_path, overlay: Optional[str] = None
):
    """PCK curve plot with literature overlays (displaymano.py:494-662).
    Without matplotlib, the PIL raster plot of :mod:`raster`."""
    try:
        plt = _plt()
    except ImportError:
        from obman_train_tpu_torch.visualize import raster

        return raster.save_pck_img(thresholds, pck_values, auc_all, save_path,
                                   curves=LITERATURE_CURVES.get(overlay))
    plt.clf()
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(thresholds, pck_values, "ro-", markersize=8, label="Ours")
    if overlay in LITERATURE_CURVES:
        styles = ["bv-", "c^-", "gs-", "mD-"]
        for style, (name, (xs, ys)) in zip(
            styles, LITERATURE_CURVES[overlay].items()
        ):
            ax.plot(xs, ys, style, markersize=8, label=name)
        ax.set_title(
            "Stereo dataset (12 seq.)"
            if overlay == "stereo_all"
            else "Stereo dataset (2 seq.)"
        )
    else:
        ax.set_title(
            f"auc in [{thresholds[0]},{thresholds[-1]}]: {auc_all:.4f}"
        )
    ax.set_ylim(0, 1)
    ax.set_xlabel("Error Thresholds (mm)")
    ax.set_ylabel("3D PCK")
    ax.grid(linestyle="-", color="lightgray", alpha=0.5)
    ax.legend()
    fig.tight_layout()
    fig.savefig(save_path)
    plt.close(fig)
    return save_path
