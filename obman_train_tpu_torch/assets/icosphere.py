"""Icosphere generation, the object decoder's template mesh.

Same geodesic polyhedron and vertex order as the JAX package's
``assets/icosphere.py`` (and ``trimesh.creation.icosphere``, reference
atlasbranch.py:63-76): icosahedron + recursive 4-way face subdivision with
midpoint caching, vertices projected to the unit sphere.
Subdivisions 0..4 give 12, 42, 162, 642, 2562 vertices.
"""

from __future__ import annotations

import functools

import numpy as np


def _icosahedron() -> tuple[np.ndarray, np.ndarray]:
    """Regular icosahedron inscribed in the unit sphere."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int32,
    )
    return verts, faces


def _subdivide(verts: np.ndarray, faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split every triangle into 4; shared edges get a single midpoint."""
    verts = list(map(tuple, verts))
    midpoint_cache: dict[tuple[int, int], int] = {}

    def midpoint(i: int, j: int) -> int:
        key = (i, j) if i < j else (j, i)
        if key in midpoint_cache:
            return midpoint_cache[key]
        verts.append(tuple((np.asarray(verts[i]) + np.asarray(verts[j])) / 2.0))
        midpoint_cache[key] = len(verts) - 1
        return midpoint_cache[key]

    new_faces = []
    for a, b, c in faces:
        ab = midpoint(a, b)
        bc = midpoint(b, c)
        ca = midpoint(c, a)
        new_faces.extend([[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]])
    return np.asarray(verts, dtype=np.float64), np.asarray(new_faces, dtype=np.int32)


@functools.lru_cache(maxsize=8)
def icosphere(subdivisions: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """Unit icosphere ``(verts[float32 (V,3)], faces[int32 (F,3)])``;
    subdivisions=3 gives V=642, F=1280. The arrays are read-only."""
    verts, faces = _icosahedron()
    for _ in range(subdivisions):
        verts, faces = _subdivide(verts, faces)
        verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    verts = verts.astype(np.float32)
    verts.setflags(write=False)
    faces.setflags(write=False)
    return verts, faces
