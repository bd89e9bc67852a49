"""Dense cotangent mesh Laplacian, precomputed once on the host (the port's
own copy of the JAX package's numpy-only ``assets/laplacian.py``).

The reference assembles a scipy CSR matrix and round-trips to the CPU with
a hand-written autograd Function on every loss call (reference:
laplacianloss.py:71-185). The template mesh is small (642 verts), so the
dense symmetric (V, V) Laplacian is built once in numpy; ``L @ verts`` is
then one on-device matmul with plain autograd (L is symmetric, so the
reference's custom backward, ``L @ g``, is what autograd gives).

Cotangent convention follows the reference (laplacianloss.py:153-185):
per-face cotangents of the angles opposite edges (23, 31, 12), via Heron's
formula, divided by 4x area; off-diagonals accumulated at (F[:,1],F[:,2]),
(F[:,2],F[:,0]), (F[:,0],F[:,1]), symmetrized, diagonal = -rowsum.
"""

from __future__ import annotations

import numpy as np


def cotangent_weights(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Per-face cotangent weights ``(F, 3)`` for edges (23, 31, 12)."""
    v1 = verts[faces[:, 0]]
    v2 = verts[faces[:, 1]]
    v3 = verts[faces[:, 2]]
    l1 = np.linalg.norm(v2 - v3, axis=1)
    l2 = np.linalg.norm(v3 - v1, axis=1)
    l3 = np.linalg.norm(v1 - v2, axis=1)
    sp = (l1 + l2 + l3) * 0.5
    area2 = 2.0 * np.sqrt(np.maximum(sp * (sp - l1) * (sp - l2) * (sp - l3), 0.0))
    cot23 = l2**2 + l3**2 - l1**2
    cot31 = l1**2 + l3**2 - l2**2
    cot12 = l1**2 + l2**2 - l3**2
    return np.stack([cot23, cot31, cot12], axis=1) / area2[:, None] / 4.0


def cotangent_laplacian(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Dense symmetric cotangent Laplacian ``(V, V)`` float32.

    ``loss = mean(||L @ verts||_2)`` reproduces the reference LaplacianLoss
    (laplacianloss.py:36-41).
    """
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    V = verts.shape[0]
    C = cotangent_weights(verts, faces)
    rows = faces[:, [1, 2, 0]].reshape(-1)
    cols = faces[:, [2, 0, 1]].reshape(-1)
    L = np.zeros((V, V), dtype=np.float64)
    np.add.at(L, (rows, cols), C.reshape(-1))
    L = L + L.T
    L -= np.diag(L.sum(axis=1))
    return L.astype(np.float32)
