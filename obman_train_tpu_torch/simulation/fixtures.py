"""Deterministic synthetic grasp set for solver-regression fixtures (the
port's copy of the JAX package's ``simulation/fixtures.py``, pure numpy).

The native rigid-body stepper (``native/physics.cpp``, a byte copy of the
JAX package's) is protocol-matched to the reference's pybullet setup
(mano_train/simulation/simulate.py:111-345) but its impulse solver is
first-party, so nothing outside this repo pins its numerics. This module
builds a fixed set of synthetic "grasps" (concave static hands + convex
objects in stable/marginal/falling poses) whose displacements are frozen in
``tests/goldens/grasp_fixture.npz``; the port's simulation tests replay
them against its own build of the stepper.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from obman_train_tpu_torch.assets import icosphere


def _bowl(radius: float, n: int = 2, tilt: float = 0.0) -> tuple:
    """Open hemisphere 'palm' (opening toward -y; gravity pulls +y),
    optionally tilted about z."""
    verts, faces = icosphere(n)
    verts = verts * radius
    centroids = verts[faces].mean(1)
    faces = faces[centroids[:, 1] > 0]
    if tilt:
        c, s = np.cos(tilt), np.sin(tilt)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        verts = verts @ rot.T
    return verts, faces.astype(np.int32)


def _box(half: np.ndarray) -> tuple:
    corners = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float64,
    ) * np.asarray(half)
    faces = np.array(
        [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
         [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
        np.int32,
    )
    return corners, faces


def grasp_set() -> List[Dict[str, np.ndarray]]:
    """20 deterministic grasps, all coordinates in mm (the
    ``run_simulation`` input contract).  Mix: cradled spheres/boxes at
    varied radii and offsets (stable), rim-balanced poses (marginal), and
    clear-of-the-hand drops (large displacement)."""
    grasps = []
    rng = np.random.default_rng(20260817)
    sphere_v, sphere_f = icosphere(2)
    sphere_f = sphere_f.astype(np.int32)
    for i in range(20):
        kind = i % 4
        bowl_r = 0.05 + 0.04 * rng.random()
        tilt = float(rng.uniform(-0.35, 0.35)) if i % 3 == 0 else 0.0
        hand_v, hand_f = _bowl(bowl_r, n=2, tilt=tilt)
        if kind in (0, 1):  # sphere, cradled (0) or offset toward the rim (1)
            scale = (0.25 + 0.35 * rng.random()) * bowl_r
            off = np.array([0.0, 0.25 * bowl_r, 0.0])
            if kind == 1:
                off = off + np.array(
                    [0.7 * bowl_r * rng.standard_normal(), 0.0,
                     0.7 * bowl_r * rng.standard_normal()]
                )
            obj_v = sphere_v * scale + off
            obj_f = sphere_f
        elif kind == 2:  # box resting in the bowl
            half = (0.2 + 0.25 * rng.random(3)) * bowl_r
            obj_v, obj_f = _box(half)
            obj_v = obj_v + np.array([0.0, 0.2 * bowl_r, 0.0])
        else:  # free drop: object clear of the hand entirely
            scale = 0.3 * bowl_r
            obj_v = sphere_v * scale + np.array(
                [2.5 * bowl_r, -1.5 * bowl_r, 0.0]
            )
            obj_f = sphere_f
        grasps.append(
            {
                "hand_verts": (hand_v * 1000.0).astype(np.float64),
                "hand_faces": hand_f,
                "obj_verts": (obj_v * 1000.0).astype(np.float64),
                "obj_faces": obj_f,
            }
        )
    return grasps
