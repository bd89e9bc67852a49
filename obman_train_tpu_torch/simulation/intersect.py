"""Hand-object intersection volume via voxelization (the JAX package's
``simulation/intersect.py:19-165``; reference
mano_train/netscripts/intersect.py:18-114).

Voxelize both meshes at a fixed pitch (reference default 0.005 m = 5 mm on
metre-scale meshes) over their overlapping bounding box and count doubly
occupied voxels. Occupancy is the ray-parity inside test of the contact
loss (``ops/raytri.py``, the CUDA kernel K1 on the card): the whole grid
goes to the hand mesh in one launch, and the object is tested only at the
hand-occupied voxels, in a second.
"""

from __future__ import annotations

import importlib.util
import json
import os
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from obman_train_tpu_torch.device import DeviceLike, resolve_device

_ENGINES_MISSING = ("--intersect_mode engines needs trimesh (+ openscad or "
                    "blender); use the default voxel mode in this image")


def _occupancy(points: np.ndarray, verts: np.ndarray, faces: np.ndarray,
               device: torch.device) -> np.ndarray:
    """Bool (P,): which ``points`` lie inside the mesh, in float32 as the
    JAX package casts them."""
    from obman_train_tpu_torch.ops.raytri import mesh_contains_points

    v = torch.as_tensor(np.asarray(verts, np.float32), device=device)
    tri = v[torch.as_tensor(np.asarray(faces, np.int64), device=device)][None]
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)[None]
    return ~mesh_contains_points(pts, tri)[0].cpu().numpy()


def voxel_grid(hand_verts: np.ndarray, obj_verts: np.ndarray,
               pitch: float) -> np.ndarray:
    """Voxel centres (P, 3) over the meshes' overlapping bounding box,
    padded by one pitch; empty when the boxes do not overlap."""
    lo = np.maximum(hand_verts.min(0), obj_verts.min(0)) - pitch
    hi = np.minimum(hand_verts.max(0), obj_verts.max(0)) + pitch
    if (hi <= lo).any():
        return np.zeros((0, 3))
    axes = [np.arange(lo[d], hi[d] + pitch, pitch) for d in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)


def intersect_vox(
    hand_verts: np.ndarray,
    hand_faces: np.ndarray,
    obj_verts: np.ndarray,
    obj_faces: np.ndarray,
    pitch: float = 0.005,
    device: DeviceLike = None,
) -> float:
    """Intersection volume (units: pitch-cubed x voxel count, e.g. m^3 for
    metre meshes at 5 mm pitch)."""
    dev = resolve_device(device)
    grid = voxel_grid(hand_verts, obj_verts, pitch)
    if len(grid) == 0:
        return 0.0
    occ_h = _occupancy(grid, hand_verts, hand_faces, dev)
    if not occ_h.any():
        return 0.0
    occ_o = _occupancy(grid[occ_h], obj_verts, obj_faces, dev)
    return float(occ_o.sum()) * pitch**3


def intersect_engines(
    hand_verts: np.ndarray,
    hand_faces: np.ndarray,
    obj_verts: np.ndarray,
    obj_faces: np.ndarray,
) -> Optional[float]:
    """Exact boolean intersection volume, the reference's ``mode="engines"``
    (netscripts/intersect.py:82-111): scad first, blender fallback, None
    (counted as skipped) for a non-watertight result or when both engines
    error. Needs trimesh + openscad/blender; a missing trimesh raises a
    clean RuntimeError."""
    try:
        import trimesh
    except ImportError as e:
        raise RuntimeError(_ENGINES_MISSING) from e

    obj_mesh = trimesh.Trimesh(vertices=obj_verts, faces=obj_faces)
    hand_mesh = trimesh.Trimesh(vertices=hand_verts, faces=hand_faces)
    trimesh.repair.fix_normals(obj_mesh)

    def _try(engine):
        inter = obj_mesh.intersection(hand_mesh, engine=engine)
        if inter.vertices.shape[0] == 0:
            return 0.0
        return float(inter.volume) if inter.is_watertight else None

    try:
        vol = _try("scad")
        if vol is not None:
            return vol
    except Exception:
        pass
    try:
        return _try("blender")
    except Exception as e:
        # an engine failure must not abort the whole epoch aggregation:
        # count the sample as skipped like a non-watertight boolean
        warnings.warn(f"boolean engines failed ({e}); sample skipped")
        return None


def full_intersect(
    exp_id: str, pitch: float = 0.005, mode: str = "voxels",
    device: DeviceLike = None,
) -> Dict:
    """Aggregate intersection volumes over an epoch's saved batches
    (netscripts/intersect.py:53-114); meshes are mm -> converted to m.

    ``mode="voxels"`` (reference default) counts doubly-occupied voxels at
    ``pitch`` on ``device``; ``mode="engines"`` uses exact trimesh booleans
    when trimesh is importable and skips samples whose boolean comes back
    non-watertight (the reference counted those as skipped too). The JAX
    signature's ``workers``, which it never reads, is left out."""
    from obman_train_tpu_torch.simulation.savemano import load_batch_info

    if mode not in ("voxels", "engines"):
        raise ValueError(f"unknown intersect mode {mode!r}")
    if mode == "engines" and importlib.util.find_spec("trimesh") is None:
        raise RuntimeError(_ENGINES_MISSING)  # before scanning an epoch of batches
    dev = resolve_device(device) if mode == "voxels" else None
    volumes = []
    skipped = 0
    for name in sorted(os.listdir(exp_id)):
        if not (name.startswith("batch_") and name.endswith(".pkl")):
            continue
        for s in load_batch_info(os.path.join(exp_id, name), compute_depth=False):
            if s["obj_faces"] is None:
                continue
            hv, ov = s["hand_verts"] * 0.001, s["obj_verts"] * 0.001
            if mode == "engines":
                vol = intersect_engines(hv, s["hand_faces"], ov, s["obj_faces"])
                if vol is None:
                    skipped += 1
                    continue
                volumes.append(vol)
            else:
                volumes.append(intersect_vox(hv, s["hand_faces"], ov, s["obj_faces"],
                                             pitch=pitch, device=dev))
    summary = {
        "mean_volume": float(np.mean(volumes)) if volumes else 0.0,
        "std_volume": float(np.std(volumes)) if volumes else 0.0,
        "sample_nb": len(volumes),
        "skipped": skipped,
        "mode": mode,
        "pitch": pitch,
    }
    out_dir = os.path.join(exp_id, "intersect_results")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary
