"""Cross-validate the first-party impulse solver against pybullet (the
port's copy of the JAX package's ``simulation/compare.py``).

The native stepper (native/physics.cpp) is protocol-matched to the
reference's pybullet setup (reference:
mano_train/simulation/simulate.py:111-293 — same gravity, timestep, step
count, static-hand/dynamic-object roles, friction/restitution products)
but its numerics are first-party, so absolute displacements can be
compared only where pybullet is installed.  This module is the turnkey
comparison to run in any pybullet-equipped environment: replay the
committed fixture grasps plus N extra random grasps through BOTH backends
and report how well the native solver reproduces pybullet's
*distribution* — displacement correlation, rank agreement, and the
stable/falling classification the simulation metric actually feeds
(reference simulate.py:236-246 reports mean displacement over samples).

Runbook (any image with pybullet):

    from obman_train_tpu_torch.simulation.compare import compare_backends, random_grasps
    from obman_train_tpu_torch.simulation.fixtures import grasp_set
    report = compare_backends(grasp_set() + random_grasps(30))

Interpretation: the grasp-stability metric averages displacements, so what
must agree is ordering and the settled-vs-dropped split, not trajectories.
``rank_correlation`` >= 0.8 and ``stability_agreement`` >= 0.9 mean the
native metric orders models the way the reference's pybullet metric would;
large ``pearson_r`` gaps with high rank agreement indicate scale
differences only.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# Displacement (metres) splitting "object stayed in the hand" from "object
# fell": fixture free-falls travel >0.1 m in the 2-second protocol window
# while settled grasps stay within solver jitter (<0.02 m); 5 cm is the
# midpoint both solvers classify identically on the fixture set.
STABLE_THRESHOLD_M = 0.05


def random_grasps(n: int, seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """N extra random grasps drawn from the fixture generator's families
    (cradled / rim-offset / box / free-drop) with an independent seed, so
    the comparison is not limited to the poses the golden fixture froze."""
    from obman_train_tpu_torch.simulation import fixtures

    rng = np.random.default_rng(seed)
    from obman_train_tpu_torch.assets import icosphere

    sphere_v, sphere_f = icosphere(2)
    sphere_f = sphere_f.astype(np.int32)
    grasps = []
    for i in range(n):
        kind = int(rng.integers(0, 4))
        bowl_r = 0.05 + 0.04 * rng.random()
        tilt = float(rng.uniform(-0.35, 0.35))
        hand_v, hand_f = fixtures._bowl(bowl_r, n=2, tilt=tilt)
        if kind in (0, 1):
            scale = (0.25 + 0.35 * rng.random()) * bowl_r
            off = np.array([0.0, 0.25 * bowl_r, 0.0])
            if kind == 1:
                off = off + np.array(
                    [0.7 * bowl_r * rng.standard_normal(), 0.0,
                     0.7 * bowl_r * rng.standard_normal()]
                )
            obj_v, obj_f = sphere_v * scale + off, sphere_f
        elif kind == 2:
            half = (0.2 + 0.25 * rng.random(3)) * bowl_r
            obj_v, obj_f = fixtures._box(half)
            obj_v = obj_v + np.array([0.0, 0.2 * bowl_r, 0.0])
        else:
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


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation without scipy (average ranks for ties)."""

    def ranks(x):
        order = np.argsort(x, kind="stable")
        r = np.empty(len(x), np.float64)
        r[order] = np.arange(len(x), dtype=np.float64)
        # average tied ranks so identical displacements don't fake order
        for v in np.unique(x):
            m = x == v
            if m.sum() > 1:
                r[m] = r[m].mean()
        return r

    ra, rb = ranks(np.asarray(a)), ranks(np.asarray(b))
    sa, sb = ra.std(), rb.std()
    if sa == 0.0 or sb == 0.0:
        return float("nan")
    return float(np.mean((ra - ra.mean()) * (rb - rb.mean())) / (sa * sb))


def compare_backends(
    grasps: List[Dict[str, np.ndarray]],
    vhacd_exe: Optional[str] = None,
) -> Dict:
    """Run every grasp through the native and pybullet backends.

    Returns a report dict (displacements per backend, pearson/spearman
    correlation, stable-vs-falling agreement at STABLE_THRESHOLD_M, mean
    absolute displacement difference).  Raises RuntimeError when pybullet
    is not importable — callers gate on that.
    """
    try:
        import pybullet  # noqa: F401
    except ImportError as e:  # pragma: no cover - exercised in pb images
        raise RuntimeError(
            "pybullet is not installed; run this comparison in a "
            "pybullet-equipped image (see README 'Simulation backends')"
        ) from e

    from obman_train_tpu_torch.simulation.simulate import run_simulation

    native, bullet = [], []
    for g in grasps:
        args = (g["hand_verts"], g["hand_faces"],
                g["obj_verts"], g["obj_faces"])
        native.append(float(run_simulation(*args, backend="native")))
        bullet.append(
            float(run_simulation(*args, backend="pybullet",
                                 vhacd_exe=vhacd_exe))
        )
    native_a, bullet_a = np.asarray(native), np.asarray(bullet)
    ns = native_a < STABLE_THRESHOLD_M
    bs = bullet_a < STABLE_THRESHOLD_M
    if native_a.std() > 0 and bullet_a.std() > 0:
        pearson = float(np.corrcoef(native_a, bullet_a)[0, 1])
    else:
        pearson = float("nan")
    return {
        "n_grasps": len(grasps),
        "stable_threshold_m": STABLE_THRESHOLD_M,
        "native_displacements": [round(d, 6) for d in native],
        "pybullet_displacements": [round(d, 6) for d in bullet],
        "pearson_r": pearson,
        "rank_correlation": _spearman(native_a, bullet_a),
        "stability_agreement": float(np.mean(ns == bs)),
        "mean_abs_diff_m": float(np.mean(np.abs(native_a - bullet_a))),
        "native_mean_m": float(native_a.mean()),
        "pybullet_mean_m": float(bullet_a.mean()),
    }
