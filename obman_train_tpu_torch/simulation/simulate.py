"""Grasp-stability simulation (the JAX package's
``simulation/simulate.py:1-404``; reference
mano_train/simulation/simulate.py:111-345 + netscripts/simulate.py:12-89).

Load predicted hand + object meshes (mm -> m), drop the object under
gravity (+9.8 y) with the hand static, run 35 steps at 1/240 s, and report
the object's center displacement. The stepper is the JAX package's own
compact C++ rigid-body solver (``native/physics.cpp``, a byte copy) loaded
via ctypes; ``backend="pybullet"`` reproduces the reference setup verbatim
where pybullet is installed.

:func:`full_simul` computes the max penetration depths on the device first,
one saved batch at a time (one inside-test launch and one nearest-neighbour
sweep each, ``savemano.max_penetration_depths``), and only then fans the
per-sample stepper calls over a thread pool: the ctypes call releases the
GIL, and no CUDA work runs in a pool thread.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, Optional

import numpy as np

from obman_train_tpu_torch.device import DeviceLike, resolve_device

# Reference simulation constants.  Per-body materials from
# simulate.py:117-145: static hand friction 3 / restitution 0, dynamic
# object friction 3 / restitution 0.5, mass 1; 35 steps at 1/240 s with
# gravity +9.8 on y (simulate.py:258-291).  The contact values are the
# pybullet default combiners (products): friction 9, restitution 0.
DT = 1.0 / 240.0
N_STEPS = 35
GRAVITY_Y = 9.8
HAND_FRICTION = 3.0
OBJ_FRICTION = 3.0
HAND_RESTITUTION = 0.0
OBJ_RESTITUTION = 0.5
SUBSTEPS = 4
CONTACT_MARGIN = 0.002  # 2 mm

_warned_numpy_fallback = False


def simulation_backend() -> str:
    """'native' when the C++ stepper is available, else 'numpy'."""
    from obman_train_tpu_torch.native import load_physics_lib

    return "native" if load_physics_lib() is not None else "numpy"


def run_simulation(
    hand_verts: np.ndarray,
    hand_faces: np.ndarray,
    obj_verts: np.ndarray,
    obj_faces: Optional[np.ndarray] = None,
    vhacd_exe: Optional[str] = None,
    backend: str = "native",
    return_trajectory: bool = False,
    hand_friction: float = HAND_FRICTION,
    obj_friction: float = OBJ_FRICTION,
    hand_restitution: float = HAND_RESTITUTION,
    obj_restitution: float = OBJ_RESTITUTION,
):
    """Simulate and return the object displacement in metres.

    Args:
      hand_verts: (778, 3) in mm; hand_faces (F, 3).
      obj_verts: (V, 3) in mm; obj_faces: (F_o, 3) — when given, the native
        stepper also generates hand-vertex vs object-triangle contacts
        (solid-vs-solid, playing V-HACD's role; reference
        simulate.py:296-345).
      hand_/obj_ friction & restitution: per-body materials; the contact
        values are their products (pybullet's default combiners).
    """
    hand_verts = np.asarray(hand_verts, np.float64) * 0.001
    obj_verts = np.asarray(obj_verts, np.float64) * 0.001
    if backend == "pybullet":
        dist = _run_pybullet(
            hand_verts, hand_faces, obj_verts, obj_faces, vhacd_exe
        )
        # pybullet records no trajectory; keep the return shape contract
        return (dist, None) if return_trajectory else dist

    from obman_train_tpu_torch.native import load_physics_lib

    lib = load_physics_lib()
    if lib is None:
        global _warned_numpy_fallback
        if not _warned_numpy_fallback:
            _warned_numpy_fallback = True
            warnings.warn(
                "obman_train_tpu_torch: C++ physics stepper unavailable (no g++?);"
                " falling back to the coarse numpy integrator — simulation"
                " distances will NOT be comparable to the native protocol.",
                RuntimeWarning,
                stacklevel=2,
            )
        return _run_numpy(
            hand_verts, hand_faces, obj_verts, return_trajectory,
            friction=hand_friction * obj_friction,
            restitution=hand_restitution * obj_restitution,
        )
    import ctypes

    hv = np.ascontiguousarray(hand_verts, np.float64)
    hf = np.ascontiguousarray(hand_faces, np.int32)
    ov = np.ascontiguousarray(obj_verts, np.float64)
    of = (
        np.ascontiguousarray(obj_faces, np.int32)
        if obj_faces is not None
        else None
    )
    disp = ctypes.c_double(0.0)
    traj = (
        np.zeros((N_STEPS, 3), np.float64) if return_trajectory else None
    )
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_ip = ctypes.POINTER(ctypes.c_int32)
    ret = lib.run_grasp_simulation(
        hv.ctypes.data_as(c_dp), len(hv),
        hf.ctypes.data_as(c_ip), len(hf),
        ov.ctypes.data_as(c_dp), len(ov),
        of.ctypes.data_as(c_ip) if of is not None else None,
        len(of) if of is not None else 0,
        DT, N_STEPS, SUBSTEPS,
        GRAVITY_Y,
        hand_friction, obj_friction,
        hand_restitution, obj_restitution,
        CONTACT_MARGIN,
        ctypes.byref(disp),
        traj.ctypes.data_as(c_dp) if traj is not None else None,
    )
    if ret != 0:
        raise RuntimeError(f"run_grasp_simulation failed with code {ret}")
    if return_trajectory:
        return float(disp.value), traj
    return float(disp.value)


def _run_numpy(
    hand_verts, hand_faces, obj_verts, return_trajectory,
    friction=HAND_FRICTION * OBJ_FRICTION,
    restitution=HAND_RESTITUTION * OBJ_RESTITUTION,
):
    """Pure-numpy fallback of the native stepper (translational only, every
    8th triangle — a COARSER metric; run_simulation warns when it engages)."""
    tri = hand_verts[hand_faces]  # (F, 3, 3)
    com = obj_verts.mean(0)
    local = obj_verts - com
    x = com.copy()
    v = np.zeros(3)
    g = np.array([0.0, GRAVITY_Y, 0.0])
    h = DT / SUBSTEPS
    traj = []
    tri_a, tri_b, tri_c = tri[:, 0], tri[:, 1], tri[:, 2]
    normals = np.cross(tri_b - tri_a, tri_c - tri_a)
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
    for step in range(N_STEPS):
        for _ in range(SUBSTEPS):
            v = v + g * h
            pts = x + local
            # coarse contacts against a subsample of triangle planes
            d = pts[:, None, :] - tri_a[None, ::8, :]
            dist = np.einsum("pfd,fd->pf", d, normals[::8])
            inside = dist < CONTACT_MARGIN
            if inside.any():
                p_idx, f_idx = np.nonzero(inside)
                n = normals[::8][f_idx].mean(0)
                n /= max(np.linalg.norm(n), 1e-12)
                vn = np.dot(v, n)
                if vn < 0:
                    v = v - (1 + restitution) * vn * n
                    vt = v - np.dot(v, n) * n
                    v = v - np.clip(friction * abs(vn) /
                                    max(np.linalg.norm(vt), 1e-9), 0, 1) * vt
            x = x + v * h
        traj.append(x.copy())
    disp = float(np.linalg.norm(x - com))
    if return_trajectory:
        return disp, np.asarray(traj)
    return disp


def _run_pybullet(hand_verts, hand_faces, obj_verts, obj_faces, vhacd_exe):
    """Reference-faithful pybullet path (simulate.py:111-293), used when
    pybullet is installed."""
    import tempfile

    import pybullet as p

    from obman_train_tpu_torch.simulation.savemano import save_obj

    conn = p.connect(p.DIRECT)
    p.setGravity(0, GRAVITY_Y, 0)
    tmpdir = tempfile.mkdtemp()
    hand_path = os.path.join(tmpdir, "hand.obj")
    obj_path = os.path.join(tmpdir, "obj.obj")
    save_obj(hand_path, hand_verts, hand_faces)
    save_obj(obj_path, obj_verts, obj_faces)
    final_obj_path = obj_path
    if vhacd_exe is not None:
        vhacd_out = os.path.join(tmpdir, "obj_vhacd.obj")
        import subprocess

        subprocess.run(
            [vhacd_exe, "--input", obj_path, "--output", vhacd_out],
            check=True, capture_output=True,
        )
        final_obj_path = vhacd_out
    hand_col = p.createCollisionShape(
        p.GEOM_MESH, fileName=hand_path,
        flags=p.GEOM_FORCE_CONCAVE_TRIMESH,
    )
    hand_id = p.createMultiBody(
        baseMass=0, baseCollisionShapeIndex=hand_col,
    )
    # Per-body dynamics exactly as the reference (simulate.py:117-145).
    p.changeDynamics(
        hand_id, -1, lateralFriction=HAND_FRICTION,
        restitution=HAND_RESTITUTION,
    )
    obj_col = p.createCollisionShape(p.GEOM_MESH, fileName=final_obj_path)
    obj_id = p.createMultiBody(baseMass=1, baseCollisionShapeIndex=obj_col)
    p.changeDynamics(
        obj_id, -1, lateralFriction=OBJ_FRICTION,
        restitution=OBJ_RESTITUTION,
    )
    start = np.asarray(p.getBasePositionAndOrientation(obj_id)[0])
    for _ in range(N_STEPS):
        p.stepSimulation()
    end = np.asarray(p.getBasePositionAndOrientation(obj_id)[0])
    p.disconnect(conn)
    return float(np.linalg.norm(end - start))


def _mpl_frames(hand_verts, hand_faces, obj_verts, traj):
    """The JAX package's matplotlib 3D view, one RGB frame per step."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(111, projection="3d")
    mesh = Poly3DCollection(hand_verts[hand_faces], alpha=0.15)
    mesh.set_edgecolor((0.3, 0.3, 0.3, 0.2))
    ax.add_collection3d(mesh)
    sub = obj_verts[:: max(1, len(obj_verts) // 200)]
    com = obj_verts.mean(0)
    scat = ax.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=4, c="tab:orange")
    allpts = np.concatenate([hand_verts, obj_verts, traj], axis=0)
    lo, hi = allpts.min(0), allpts.max(0)
    pad = 0.1 * (hi - lo).max()
    ax.set_xlim(lo[0] - pad, hi[0] + pad)
    ax.set_ylim(lo[1] - pad, hi[1] + pad)
    ax.set_zlim(lo[2] - pad, hi[2] + pad)
    ax.invert_yaxis()  # gravity is +y in the simulation frame
    ax.axis("off")

    frames = []
    for i in range(len(traj)):
        pts = sub + (traj[i] - com)
        scat._offsets3d = (pts[:, 0], pts[:, 1], pts[:, 2])
        fig.canvas.draw()
        frames.append(np.asarray(fig.canvas.buffer_rgba())[..., :3].copy())
    plt.close(fig)
    return frames


def _raster_frames(hand_verts, hand_faces, obj_verts, traj, size: int = 400):
    """Without matplotlib: the x-y projection (gravity, +y, points down the
    image) drawn with PIL, the hand's edges in grey, the object's points in
    orange at each step's offset, the centre's path so far in red."""
    from PIL import Image, ImageDraw

    sub = obj_verts[:: max(1, len(obj_verts) // 200)]
    com = obj_verts.mean(0)
    moved = sub[None] + (traj - com)[:, None]
    allpts = np.concatenate([hand_verts, moved.reshape(-1, 3), traj], axis=0)[:, :2]
    lo, hi = allpts.min(0), allpts.max(0)
    pad = 0.1 * size
    scale = (size - 2 * pad) / max(float((hi - lo).max()), 1e-9)

    def px(p):
        return (np.asarray(p)[..., :2] - lo) * scale + pad

    hand = px(hand_verts)
    edges = np.asarray(hand_faces)[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2)
    base = Image.new("RGB", (size, size), "white")
    draw = ImageDraw.Draw(base)
    for a, b in edges:
        draw.line([tuple(hand[a]), tuple(hand[b])], fill=(150, 150, 150))
    path = px(traj)
    frames = []
    for i in range(len(traj)):
        img = base.copy()
        draw = ImageDraw.Draw(img)
        if i:
            draw.line([tuple(p) for p in path[: i + 1]], fill=(230, 0, 0), width=2)
        for x, y in px(moved[i]):
            draw.ellipse([x - 1.5, y - 1.5, x + 1.5, y + 1.5], fill=(255, 127, 14))
        frames.append(np.asarray(img))
    return frames


def _save_trajectory_video(base, hand_verts, hand_faces, obj_verts, traj,
                           fps: int = 12):
    """Animated view of the object sliding through the grasp: renders the
    frames once (matplotlib's 3D view, or PIL's x-y projection where
    matplotlib is not installed), then writes ``<base>.gif`` (always) and
    ``<base>.mp4`` via cv2.VideoWriter when the codec is available; the
    reference saved per-sample mp4s via skvideo (simulate.py:43-108)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        render = _raster_frames
    else:
        render = _mpl_frames
    frames = render(hand_verts, hand_faces, obj_verts, traj)

    from PIL import Image

    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(
        base + ".gif", save_all=True, append_images=ims[1:],
        duration=int(1000 / fps), loop=0,
    )
    try:
        import cv2

        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(
            base + ".mp4", cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
        )
        if vw.isOpened():
            for f in frames:
                vw.write(np.ascontiguousarray(f[..., ::-1]))  # RGB -> BGR
        vw.release()
    except Exception as e:  # mp4 is best-effort beside the gif
        warnings.warn(f"mp4 write skipped: {e}")


def process_sample(
    sample_idx: int,
    sample: Dict[str, np.ndarray],
    save_dir: Optional[str] = None,
    backend: str = "native",
    vhacd_exe: Optional[str] = None,
    save_artifacts: bool = False,
) -> Dict:
    """One sample -> {'idx', 'distance', ...} (simulate.process_sample).

    With ``save_artifacts`` (reference simulate.py:43-108 saved obj + video
    per sample): writes hand/obj wavefront dumps, the object-center
    trajectory (npy) and an animated gif + mp4 under ``save_dir``.
    """
    want_traj = save_artifacts and save_dir is not None
    sim = run_simulation(
        sample["hand_verts"], sample["hand_faces"],
        sample["obj_verts"], sample.get("obj_faces"),
        backend=backend, vhacd_exe=vhacd_exe,
        return_trajectory=want_traj,
    )
    dist, traj = sim if want_traj else (sim, None)
    used = backend if backend == "pybullet" else simulation_backend()
    out = {
        "sample_idx": sample_idx,
        "simulation_distance": dist,
        "backend": used,
    }
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, f"{sample_idx:06d}.json"), "w") as f:
            json.dump(out, f)
    if want_traj and traj is not None:
        from obman_train_tpu_torch.simulation.savemano import save_obj

        base = os.path.join(save_dir, f"{sample_idx:06d}")
        hv = np.asarray(sample["hand_verts"], np.float64) * 0.001
        ov = np.asarray(sample["obj_verts"], np.float64) * 0.001
        save_obj(base + "_hand.obj", hv, sample["hand_faces"])
        if sample.get("obj_faces") is not None:
            save_obj(base + "_obj.obj", ov, sample["obj_faces"])
        np.save(base + "_traj.npy", traj)
        try:
            _save_trajectory_video(
                base, hv, np.asarray(sample["hand_faces"]), ov, traj
            )
        except Exception as e:  # rendering must never fail the metric
            warnings.warn(
                f"video rendering failed for sample {sample_idx}: {e}"
            )
    return out


def _worker(args):
    idx, sample, save_dir, backend, vhacd_exe, save_artifacts = args
    return process_sample(idx, sample, save_dir, backend, vhacd_exe,
                          save_artifacts)


def full_simul(
    exp_id: str,
    workers: int = 8,
    backend: str = "native",
    vhacd_exe: Optional[str] = None,
    save_gifs: bool = False,
    device: DeviceLike = None,
) -> Dict:
    """Driver: read the epoch's saved batch pickles (computing each batch's
    max penetration depths on ``device``, CUDA by default), fan the
    per-sample simulations over a thread pool, aggregate mean/std
    displacement + max penetration depth to results.json
    (netscripts/simulate.py:12-89)."""
    from obman_train_tpu_torch.simulation.savemano import load_batch_info

    dev = resolve_device(device)
    samples = []
    for name in sorted(os.listdir(exp_id)):
        if name.startswith("batch_") and name.endswith(".pkl"):
            samples.extend(load_batch_info(os.path.join(exp_id, name), device=dev))
    if not samples:
        raise ValueError(f"No batch_*.pkl files under {exp_id}")

    save_dir = os.path.join(exp_id, "simulation_results")
    os.makedirs(save_dir, exist_ok=True)
    if vhacd_exe is not None:
        backend = "pybullet"  # V-HACD only applies to the pybullet path
    art_dir = os.path.join(save_dir, "samples") if save_gifs else None
    jobs = [
        (i, s, art_dir, backend, vhacd_exe, save_gifs)
        for i, s in enumerate(samples)
    ]
    if workers > 1:
        # Threads, not processes: the native stepper releases the GIL for
        # the duration of the ctypes call, so threads parallelize it, and
        # the depths above already ran on the device, so no pool thread
        # touches CUDA (the reference used joblib process pools,
        # netscripts/simulate.py:43-73).
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(workers) as pool:
            results = list(pool.map(_worker, jobs))
    else:
        results = [_worker(j) for j in jobs]

    dists = np.asarray([r["simulation_distance"] for r in results])
    depths = np.asarray(
        [s.get("max_depth", 0.0) for s in samples], np.float64
    )
    summary = {
        "mean_dist": float(dists.mean()),
        "std_dist": float(dists.std()),
        "max_depths": float(depths.mean()),
        "sample_nb": int(len(dists)),
        "backend": results[0]["backend"] if results else "none",
    }
    with open(os.path.join(save_dir, "results.json"), "w") as f:
        json.dump({"summary": summary, "per_sample": results}, f, indent=1)
    return summary
