"""(De)serialization of evaluation results for the simulation pipeline (the
JAX package's ``simulation/savemano.py:19-90``; reference
mano_train/netscripts/savemano.py).

The training loop saves per-batch ``{'batch', 'results'}`` pickles of numpy
arrays and plain Python (``train/loop.py``), which either package's
``load_batch_info`` reads. ``load_batch_info`` rebuilds the per-sample hand
and object meshes and the max penetration depth the reference computes with
trimesh.proximity (savemano.py:8-54): here the ray-parity inside test (K1,
``ops/raytri.py``) and a min-only nearest-neighbour sweep (``nn_dir``,
``ops/nnsqdist.py``) on the device, one launch of each for a whole saved
batch (:func:`max_penetration_depths`).
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from obman_train_tpu_torch.device import DeviceLike, resolve_device


def save_obj(path: str, verts: np.ndarray, faces: Optional[np.ndarray]):
    """Wavefront writer (reference: netscripts/reload.py:16-21)."""
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if faces is not None:
            for face in np.asarray(faces):
                f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


def max_penetration_depths(
    hand_verts: np.ndarray, obj_verts: np.ndarray, obj_faces: np.ndarray,
    device: DeviceLike = None,
) -> np.ndarray:
    """Max depth (mm) of each sample's hand vertices inside its object mesh:
    hand (B, 778, 3), objects (B, V, 3) sharing ``obj_faces`` -> (B,)
    float32. One inside-test launch and one min-only sweep for the batch;
    a sample's depth does not depend on the others, so each equals
    :func:`max_penetration_depth` of that sample alone."""
    from obman_train_tpu_torch.ops.chamfer import min_sqdist_to
    from obman_train_tpu_torch.ops.raytri import mesh_contains_points

    dev = resolve_device(device)
    hv = torch.as_tensor(np.asarray(hand_verts, np.float32), device=dev)
    ov = torch.as_tensor(np.asarray(obj_verts, np.float32), device=dev)
    faces = torch.as_tensor(np.asarray(obj_faces, np.int64), device=dev)
    if hv.shape[1] == 0:
        return np.zeros(hv.shape[0], np.float32)
    exterior = mesh_contains_points(hv, ov[:, faces]).cpu().numpy()
    min_sq = min_sqdist_to(hv, ov).cpu().numpy()
    depths = np.sqrt(np.maximum(min_sq, 0)) * (~exterior)
    return depths.max(axis=1)


def max_penetration_depth(
    hand_verts: np.ndarray, obj_verts: np.ndarray, obj_faces: np.ndarray,
    device: DeviceLike = None,
) -> float:
    """Max depth of hand vertices inside the object mesh (mm), one sample."""
    return float(max_penetration_depths(
        np.asarray(hand_verts)[None], np.asarray(obj_verts)[None], obj_faces,
        device=device)[0])


def _obj_faces(n_obj: int) -> Optional[np.ndarray]:
    """The icosphere template's faces for an object of ``n_obj`` points."""
    from obman_train_tpu_torch.assets.icosphere import icosphere

    for sub in (1, 2, 3, 4):
        verts, faces = icosphere(sub)
        if len(verts) == n_obj:
            return faces
    return None


def load_batch_info(path: str, compute_depth: bool = True,
                    device: DeviceLike = None) -> List[Dict]:
    """Per-sample dicts {'hand_verts', 'hand_faces', 'obj_verts',
    'obj_faces', 'max_depth', 'sample_id'} from a saved batch pickle; the
    depths of the batch are computed on ``device`` (CUDA by default)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    results = payload["results"]
    if "verts" not in results or "objpoints3d" not in results:
        return []
    hand_faces = _hand_faces()
    obj_faces = _obj_faces(results["objpoints3d"].shape[1])
    depths = None
    if compute_depth and obj_faces is not None:
        depths = max_penetration_depths(results["verts"], results["objpoints3d"],
                                        obj_faces, device=device)
    samples = []
    for i in range(results["verts"].shape[0]):
        sample = {
            "sample_id": f"{path}:{i}",
            "hand_verts": np.asarray(results["verts"][i]),
            "hand_faces": hand_faces,
            "obj_verts": np.asarray(results["objpoints3d"][i]),
            "obj_faces": obj_faces,
        }
        if depths is not None:
            sample["max_depth"] = float(depths[i])
        samples.append(sample)
    return samples


def _hand_faces() -> np.ndarray:
    """MANO topology from the contact-zones asset (same 1538 faces)."""
    from obman_train_tpu_torch.assets.contact_zones import DATA_PATH

    return np.load(DATA_PATH)["faces"].astype(np.int32)
