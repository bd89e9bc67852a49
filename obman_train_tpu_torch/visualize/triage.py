"""Score-sorted sample triage (the JAX package's ``visualize/triage.py``;
reference mano_train/visualize/jupytervis.py:21-402).

Rank evaluated samples by a score (per-sample Chamfer or max penetration
depth), render best / median / worst grids, and export meshes for
inspection, headless, from the saved ``batch_*.pkl`` result dumps. The
Chamfer scores of all samples of one shape come from one batched
``chamfer_loss`` call (the nearest-neighbour kernel on the card); each
sample's score is the one a call on that sample alone gives. The grids are
drawn with matplotlib, or with PIL where matplotlib is not installed.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from obman_train_tpu_torch.device import DeviceLike, resolve_device


def score_samples(samples: List[Dict], metric: str = "chamfer",
                  device: DeviceLike = None) -> np.ndarray:
    """Per-sample scalar scores (lower is better); 0 where the metric does
    not apply."""
    scores = np.zeros(len(samples), np.float64)
    if metric == "max_depth":
        return np.asarray([float(s.get("max_depth", 0.0)) for s in samples])
    if metric != "chamfer":
        return scores
    from obman_train_tpu_torch.ops.chamfer import chamfer_loss

    dev = resolve_device(device)
    groups: Dict[tuple, List[int]] = {}
    for i, s in enumerate(samples):
        if "gt_objpoints3d" in s:
            key = (np.shape(s["obj_verts"]), np.shape(s["gt_objpoints3d"]))
            groups.setdefault(key, []).append(i)
    for idxs in groups.values():
        preds = torch.as_tensor(np.stack([samples[i]["obj_verts"] for i in idxs]), device=dev)
        gts = torch.as_tensor(np.stack([samples[i]["gt_objpoints3d"] for i in idxs]),
                              device=dev)
        l1, l2 = chamfer_loss(preds, gts)
        scores[idxs] = (l1 + l2).cpu().numpy()
    return scores


def load_eval_samples(results_dir: str) -> List[Dict]:
    """Load all saved batches; attach GT object points when present."""
    from obman_train_tpu_torch.simulation.savemano import load_batch_info

    samples: List[Dict] = []
    for name in sorted(os.listdir(results_dir)):
        if not (name.startswith("batch_") and name.endswith(".pkl")):
            continue
        path = os.path.join(results_dir, name)
        batch_samples = load_batch_info(path, compute_depth=False)
        with open(path, "rb") as f:
            payload = pickle.load(f)
        gt_obj = payload["batch"].get("objpoints3d")
        gt_img = payload["batch"].get("images")
        for i, s in enumerate(batch_samples):
            if gt_obj is not None:
                s["gt_objpoints3d"] = np.asarray(gt_obj[i])
            if gt_img is not None:
                s["image"] = np.asarray(gt_img[i])
            samples.append(s)
    return samples


def _mpl_group(path, samples, idxs, scores, metric):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from obman_train_tpu_torch.visualize.displaymano import add_mesh

    fig = plt.figure(figsize=(4 * len(idxs), 5))
    for col, idx in enumerate(idxs):
        s = samples[idx]
        ax = fig.add_subplot(1, len(idxs), col + 1, projection="3d")
        add_mesh(ax, s["hand_verts"], s["hand_faces"], c="b")
        if s.get("obj_faces") is not None:
            add_mesh(ax, s["obj_verts"], s["obj_faces"], c="r")
        ax.set_title(f"#{idx} {metric}={scores[idx]:.1f}")
        ax.axis("off")
    fig.savefig(path, dpi=80)
    plt.close(fig)


def _raster_group(path, samples, idxs, scores, metric):
    """Without matplotlib: one x-y tile a sample (hand blue, object red),
    its index and score above it."""
    from PIL import Image, ImageDraw

    from obman_train_tpu_torch.visualize.raster import TILE, points_tile

    out = Image.new("RGB", (TILE * max(1, len(idxs)), TILE + 20), "white")
    draw = ImageDraw.Draw(out)
    for col, idx in enumerate(idxs):
        s = samples[idx]
        tile = points_tile([(s["hand_verts"][:, :2], "b"), (s["obj_verts"][:, :2], "r")])
        out.paste(tile, (col * TILE, 20))
        draw.text((col * TILE + 4, 4), f"#{idx} {metric}={scores[idx]:.1f}", fill=(0, 0, 0))
    out.save(path)


def triage(
    results_dir: str,
    out_dir: Optional[str] = None,
    metric: str = "chamfer",
    n_show: int = 3,
    export_meshes: bool = False,
    device: DeviceLike = None,
):
    """Render best/median/worst sample grids; optionally export OBJ meshes.

    Returns {"best": idxs, "median": idxs, "worst": idxs, "scores": array}.
    """
    samples = load_eval_samples(results_dir)
    if not samples:
        raise ValueError(f"no saved batches under {results_dir}")
    scores = score_samples(samples, metric, device=device)
    order = np.argsort(scores)
    mid = len(order) // 2
    groups = {
        "best": order[:n_show],
        "median": order[max(0, mid - n_show // 2): max(0, mid - n_show // 2) + n_show],
        "worst": order[::-1][:n_show],
    }
    out_dir = out_dir or os.path.join(results_dir, "triage")
    os.makedirs(out_dir, exist_ok=True)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        draw = _raster_group
    else:
        draw = _mpl_group

    from obman_train_tpu_torch.simulation.savemano import save_obj
    from obman_train_tpu_torch.visualize.html_mesh import export_sample_html

    for group, idxs in groups.items():
        draw(os.path.join(out_dir, f"{group}.png"), samples, idxs, scores, metric)
        if export_meshes:
            for idx in idxs:
                s = samples[idx]
                save_obj(os.path.join(out_dir, f"{group}_{idx}_hand.obj"),
                         s["hand_verts"], s["hand_faces"])
                save_obj(os.path.join(out_dir, f"{group}_{idx}_obj.obj"),
                         s["obj_verts"], s.get("obj_faces"))
        if len(idxs):
            s0 = samples[idxs[0]]
            export_sample_html(
                os.path.join(out_dir, f"{group}.html"),
                s0["hand_verts"], s0["hand_faces"],
                s0["obj_verts"], s0.get("obj_faces"),
            )
    return {**groups, "scores": scores}
