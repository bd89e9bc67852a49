"""The port's grasp simulation (``obman_train_tpu_torch.simulation``) on the
CPU, against the JAX package's.

- Twins of every case of ``tests/test_simulation.py``: the native stepper
  (the port's own build of its byte copy of ``native/physics.cpp``), the
  inside-test volumes and depths, the OBJ round trip, the golden grasp
  fixture at the JAX test's rtol 1e-6 / atol 1e-9; the pybullet and
  trimesh cases skip exactly when the JAX ones do.
- Parity with the JAX package on the same inputs: stepper displacements
  and trajectories equal (the same source, the same flags); the exterior
  masks of ``max_penetration_depths`` equal, its depths within rtol 1e-5 /
  atol 1e-4 mm of JAX's ``max_penetration_depth`` (the nearest-neighbour
  plane of each package rounds on its own), and the batched call equal bit
  for bit to one call a sample; ``intersect_vox`` volumes equal (the same
  float32 inside test on the same lattice); ``full_simul`` and
  ``full_intersect`` summaries on a directory written by the port's
  ``cli.traineval --evaluate --save_results`` and on one of overlapping
  scenes, and JAX's ``load_batch_info`` reading the port's pickles.

The scenes are seeded with numpy: the port's synthetic MANO hand (mm) at
random PCA poses, with icosphere-3 objects (642 points, 1280 faces) placed
on a hand vertex so that they overlap it.
"""

import json
import os
import pickle
import sys
import warnings

import numpy as np
import pytest
import torch

from obman_train_tpu.simulation import compare as jcompare
from obman_train_tpu.simulation import intersect as jintersect
from obman_train_tpu.simulation import savemano as jsavemano
from obman_train_tpu.simulation import simulate as jsimulate
from obman_train_tpu_torch.assets import icosphere
from obman_train_tpu_torch.simulation import compare, intersect, savemano, simulate

torch.set_num_threads(2)


def make_bowl(radius=0.05, n=2):
    """Static open 'bowl': the half of an icosphere opening toward -y
    (gravity pulls +y)."""
    verts, faces = icosphere(n)
    verts = verts * radius
    centroids = verts[faces].mean(1)
    return verts, faces[centroids[:, 1] > 0]


def hand_scenes(B, seed):
    """(hand (B, 778, 3), objects (B, 642, 3), object faces) in mm: the
    synthetic MANO hand at seeded poses, an icosphere-3 of radius 20-45 mm
    centred within 15 mm of a random hand vertex."""
    from obman_train_tpu_torch.assets import synthetic_mano_assets
    from obman_train_tpu_torch.models.mano import ManoLayer, mano_forward

    rng = np.random.default_rng(seed)
    layer = ManoLayer(synthetic_mano_assets("right"))
    pose = torch.from_numpy(rng.normal(0, 0.5, (B, 9)).astype(np.float32))
    with torch.no_grad():
        hands = mano_forward(layer, pose)[0].numpy()
    verts, faces = icosphere(3)
    centres = hands[np.arange(B), rng.integers(0, 778, B)] + rng.normal(0, 15, (B, 3))
    radii = rng.uniform(20, 45, (B, 1, 1))
    objs = (verts[None] * radii + centres[:, None]).astype(np.float32)
    return hands.astype(np.float32), objs, faces.astype(np.int32)


# -- twins of tests/test_simulation.py ---------------------------------------


def test_native_lib_builds():
    from obman_train_tpu_torch.native import load_physics_lib

    assert load_physics_lib() is not None, "g++ toolchain expected"
    assert simulate.simulation_backend() == "native"


def test_free_fall_displacement():
    """Object far from the hand mesh falls freely: d = g t^2 / 2."""
    hand_verts, hand_faces = icosphere(1)
    obj_verts, _ = icosphere(1)
    dist = simulate.run_simulation(hand_verts * 10.0, hand_faces,
                                   obj_verts * 20.0 + np.array([500.0, 0, 0]))
    t = simulate.DT * simulate.N_STEPS
    assert dist == pytest.approx(0.5 * simulate.GRAVITY_Y * t**2, rel=0.15)


def test_supported_object_stays():
    """An object resting inside a bowl barely moves; without the bowl it falls."""
    bowl_verts, bowl_faces = make_bowl(radius=0.08)
    bowl_mm = bowl_verts * 1000.0
    obj_verts, _ = icosphere(1)
    ball_mm = obj_verts * 30.0 + np.array([0.0, 40.0, 0.0])
    d_support = simulate.run_simulation(bowl_mm, bowl_faces, ball_mm)
    d_free = simulate.run_simulation(bowl_mm + np.array([1000.0, 0, 0]), bowl_faces, ball_mm)
    assert d_free > 5 * max(d_support, 1e-4)
    assert d_support < 0.03


def test_full_simul_pipeline(tmp_path):
    """End to end: batch pickle -> full_simul -> results.json."""
    rng = np.random.default_rng(0)
    overts, _ = icosphere(3)
    results = {
        "verts": rng.normal(0, 30, (2, 778, 3)).astype(np.float32)
        + np.array([500, 0, 0], np.float32),
        "objpoints3d": (overts * 30).astype(np.float32)[None].repeat(2, 0),
    }
    with open(tmp_path / "batch_000000.pkl", "wb") as f:
        pickle.dump({"batch": {}, "results": results, "root": "wrist"}, f)
    summary = simulate.full_simul(str(tmp_path), workers=1, device="cpu")
    assert summary["sample_nb"] == 2
    assert summary["mean_dist"] > 0
    with open(tmp_path / "simulation_results" / "results.json") as f:
        assert len(json.load(f)["per_sample"]) == 2


def test_intersect_vox():
    verts, faces = icosphere(2)
    a = verts * 0.05
    vol = intersect.intersect_vox(a, faces, a.copy(), faces, pitch=0.01, device="cpu")
    assert vol == pytest.approx(4 / 3 * np.pi * 0.05**3, rel=0.35)
    b = a + np.array([1.0, 0, 0])
    assert intersect.intersect_vox(a, faces, b, faces, pitch=0.01, device="cpu") == 0.0


def test_max_penetration_depth():
    overts, ofaces = icosphere(2)
    hand = np.array([[0.0, 0, 0], [10.0, 0, 0], [200.0, 0, 0]])
    depth = savemano.max_penetration_depth(hand, overts * 50.0, ofaces, device="cpu")
    assert depth == pytest.approx(50.0, rel=0.1)


def test_save_obj_roundtrip(tmp_path):
    from obman_train_tpu_torch.data.transforms import fast_load_obj

    verts, faces = icosphere(1)
    p = str(tmp_path / "m.obj")
    savemano.save_obj(p, verts, faces)
    mesh = fast_load_obj(p)[0]
    # the loader reorders vertices by the lexicographic face-token sort
    np.testing.assert_allclose(mesh["vertices"][mesh["faces"]], verts[faces], atol=1e-6)


def _plane_mesh(y, half=0.1, n=8, tilt=0.0):
    """Triangulated plane at height y (metres), tilted about z by ``tilt``."""
    xs = np.linspace(-half, half, n)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    gy = np.full_like(gx, y) + np.tan(tilt) * gx
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b, c, d = i * n + j, (i + 1) * n + j, (i + 1) * n + j + 1, i * n + j + 1
            faces += [[a, b, c], [a, c, d]]
    return verts, np.asarray(faces, np.int32)


def test_restitution_bounce_heights():
    """Elastic contact (1 x 1) rebounds most of the drop; the reference
    protocol (hand 0 x obj 0.5 -> 0) kills the bounce."""
    plane_v, plane_f = _plane_mesh(y=0.023)
    ball, _ = icosphere(2)

    def min_y_after_contact(**kw):
        _, traj = simulate.run_simulation(plane_v * 1000.0, plane_f, ball * 20.0,
                                          return_trajectory=True, **kw)
        y = traj[:, 1]
        hit = int(np.argmax(y))
        return float(y[hit:].min()), float(y.max())

    rebound_el, peak_el = min_y_after_contact(hand_restitution=1.0, obj_restitution=1.0)
    rebound_ref, peak_ref = min_y_after_contact()
    assert rebound_el < 0.4 * peak_el
    assert rebound_ref > 0.7 * peak_ref


BOX_FACES = np.array(
    [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
     [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)


def test_incline_friction():
    """A box on a 20-degree incline: friction 3x3 holds it; none lets it slide."""
    tilt = np.deg2rad(20.0)
    plane_v, plane_f = _plane_mesh(y=0.0155, half=0.2, n=12, tilt=tilt)
    h = 0.015
    corners = np.array([[sx * h, sy * h, sz * h]
                        for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    c, s = np.cos(tilt), np.sin(tilt)
    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]]).T
    box_mm = (corners @ rot.T) * 1000.0
    d_grip = simulate.run_simulation(plane_v * 1000.0, plane_f, box_mm, BOX_FACES)
    d_slide = simulate.run_simulation(plane_v * 1000.0, plane_f, box_mm, BOX_FACES,
                                      hand_friction=0.0, obj_friction=0.0)
    t = simulate.DT * simulate.N_STEPS
    assert d_grip < 0.01
    assert d_slide > 0.5 * (0.5 * simulate.GRAVITY_Y * np.sin(tilt) * t**2)
    assert d_slide > 3 * max(d_grip, 1e-4)


def test_rolling_sphere_inertia():
    """High friction cannot hold a sphere on an incline: it rolls, slower
    than frictionless sliding (the friction-torque + inertia path)."""
    tilt = np.deg2rad(25.0)
    y0 = (0.020 + 0.0005) / np.cos(tilt)
    plane_v, plane_f = _plane_mesh(y=y0, half=0.25, n=14, tilt=tilt)
    ball, _ = icosphere(2)
    d_roll = simulate.run_simulation(plane_v * 1000.0, plane_f, ball * 20.0)
    d_slide = simulate.run_simulation(plane_v * 1000.0, plane_f, ball * 20.0,
                                      hand_friction=0.0, obj_friction=0.0)
    t = simulate.DT * simulate.N_STEPS
    assert d_slide == pytest.approx(0.5 * simulate.GRAVITY_Y * np.sin(tilt) * t**2, rel=0.1)
    assert d_roll > 0.25 * d_slide
    assert d_roll < 0.95 * d_slide


def test_grasp_displacement_fixture():
    """The 20 deterministic grasps against the committed golden displacements
    and final positions, at the JAX test's tolerance (compiler/libm variation)."""
    from obman_train_tpu_torch.simulation.fixtures import grasp_set

    golden = np.load(os.path.join(os.path.dirname(__file__), "goldens", "grasp_fixture.npz"))
    disps, finals = [], []
    for g in grasp_set():
        dist, traj = simulate.run_simulation(
            g["hand_verts"], g["hand_faces"], g["obj_verts"], g["obj_faces"],
            backend="native", return_trajectory=True)
        disps.append(dist)
        finals.append(traj[-1])
    np.testing.assert_allclose(np.asarray(disps), golden["displacements"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(finals), golden["final_positions"],
                               rtol=1e-6, atol=1e-9)
    assert np.asarray(disps).min() < 0.02
    assert np.asarray(disps).max() > 0.1


def test_intersect_engines_exact_volume():
    pytest.importorskip("trimesh")
    corners = np.array([[sx, sy, sz] for sx in (0, 1) for sy in (0, 1) for sz in (0, 1)],
                       np.float64)
    vol = intersect.intersect_engines(corners, BOX_FACES, corners + 0.5, BOX_FACES)
    if vol is not None:  # engines may be absent even with trimesh present
        assert vol == pytest.approx(0.125, rel=1e-3)


def test_intersect_engines_missing_trimesh_errors_cleanly(tmp_path):
    import importlib.util

    if importlib.util.find_spec("trimesh") is not None:
        pytest.skip("trimesh installed; the engines path runs for real")
    with pytest.raises(RuntimeError, match="trimesh"):
        intersect.full_intersect(str(tmp_path), mode="engines")
    with pytest.raises(RuntimeError, match="trimesh"):
        intersect.intersect_engines(np.zeros((3, 3)), BOX_FACES[:1], np.zeros((3, 3)),
                                    BOX_FACES[:1])


def test_compare_solvers_machinery():
    a = compare.random_grasps(5, seed=3)
    b = compare.random_grasps(5, seed=3)
    assert len(a) == 5
    for ga, gb in zip(a, b):
        np.testing.assert_array_equal(ga["obj_verts"], gb["obj_verts"])
        assert ga["hand_verts"].shape[1] == 3
        assert ga["obj_faces"].dtype == np.int32
    assert compare._spearman(np.arange(10.0), np.arange(10.0) * 3 + 1) == pytest.approx(1.0)
    assert compare._spearman(np.arange(10.0), -np.arange(10.0)) == pytest.approx(-1.0)
    assert compare._spearman(np.array([0.0, 0.0, 1.0, 2.0]),
                             np.array([0.1, 0.2, 0.5, 0.9])) > 0.9


def test_compare_solvers_cross_validation():
    pytest.importorskip("pybullet")
    from obman_train_tpu_torch.simulation.fixtures import grasp_set

    report = compare.compare_backends(grasp_set() + compare.random_grasps(10, seed=0))
    assert report["rank_correlation"] >= 0.8
    assert report["stability_agreement"] >= 0.9


def test_pybullet_backend_matches_protocol():
    pytest.importorskip("pybullet")
    from obman_train_tpu_torch.simulation.fixtures import grasp_set

    grasps = grasp_set()
    stable, falling = grasps[0], grasps[3]
    d_stable = simulate.run_simulation(stable["hand_verts"], stable["hand_faces"],
                                       stable["obj_verts"], stable["obj_faces"],
                                       backend="pybullet")
    d_fall = simulate.run_simulation(falling["hand_verts"], falling["hand_faces"],
                                     falling["obj_verts"], falling["obj_faces"],
                                     backend="pybullet")
    assert d_stable < 0.05
    assert d_fall > 0.08


def _artifact_sample():
    hand_v, hand_f = make_bowl(radius=0.08)
    obj_v, obj_f = icosphere(1)
    return {"hand_verts": hand_v * 1000.0, "hand_faces": hand_f,
            "obj_verts": obj_v * 30.0 + np.array([0.0, 40.0, 0.0]),
            "obj_faces": obj_f.astype(np.int32)}


@pytest.mark.parametrize("matplotlib", [True, False], ids=["matplotlib", "PIL"])
def test_process_sample_artifacts(tmp_path, monkeypatch, matplotlib):
    """save_artifacts writes obj dumps, the trajectory, a gif and an mp4,
    with matplotlib and, where it is missing, with PIL."""
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a failed render warns
        out = simulate.process_sample(7, _artifact_sample(), save_dir=str(tmp_path),
                                      save_artifacts=True)
    assert out["backend"] == "native"
    for suffix in (".json", "_hand.obj", "_obj.obj", "_traj.npy", ".gif", ".mp4"):
        assert (tmp_path / f"000007{suffix}").exists(), suffix
    assert np.load(tmp_path / "000007_traj.npy").shape == (35, 3)
    from PIL import Image

    with Image.open(tmp_path / "000007.gif") as gif:
        # one frame a step; PIL merges equal consecutive frames (a settled object)
        assert 1 < gif.n_frames <= simulate.N_STEPS


def test_fast_load_obj_ngon_fan(tmp_path):
    """>4-corner faces fan-triangulate (the reference's reshape would misalign)."""
    from obman_train_tpu_torch.data.transforms import fast_load_obj

    p = tmp_path / "pent.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0.5 1.5 0\nv 0 1 0\nf 1 2 3 4 5\n")
    mesh = fast_load_obj(str(p))[0]
    assert mesh["faces"].shape == (3, 3)
    np.testing.assert_allclose(mesh["vertices"][mesh["faces"][:, 0]], np.zeros((3, 3)),
                               atol=1e-12)


def test_fast_load_obj_matches_jax(tmp_path):
    """The port's loader is the JAX package's, quirks included: face tokens
    with normals and uvs, quads, 'o' splits, vertex order by token sort."""
    from obman_train_tpu.data.transforms import fast_load_obj as jload
    from obman_train_tpu_torch.data.transforms import fast_load_obj

    p = tmp_path / "m.obj"
    p.write_text(
        "o a\n" + "".join(f"v {i} {i * i % 7} {i % 3}\n" for i in range(12))
        + "vn 0 0 1\nvt 0 0\nf 1/1/1 2/1/1 3/1/1 4/1/1\nf 10 11 12\nf 1 2 3\n"
        + "o b\nf 5 6 7 8 9\nf 5/1 6/1 7/1\n")
    want, got = jload(str(p)), fast_load_obj(str(p))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["vertices"], w["vertices"])
        np.testing.assert_array_equal(g["faces"], w["faces"])


# -- parity with the JAX package ---------------------------------------------


def test_stepper_equals_jax():
    """The fixture grasps and 10 random ones: displacements and trajectories
    equal to the JAX package's (the same source and flags, both float64)."""
    from obman_train_tpu_torch.simulation.fixtures import grasp_set

    for g in grasp_set() + compare.random_grasps(10, seed=0):
        args = (g["hand_verts"], g["hand_faces"], g["obj_verts"], g["obj_faces"])
        d, traj = simulate.run_simulation(*args, return_trajectory=True)
        jd, jtraj = jsimulate.run_simulation(*args, return_trajectory=True)
        assert d == jd
        np.testing.assert_array_equal(traj, jtraj)


def test_random_grasps_equal_jax():
    for g, w in zip(compare.random_grasps(6, seed=4), jcompare.random_grasps(6, seed=4)):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.fixture(scope="module")
def depth_scenes():
    return hand_scenes(4, seed=0)


def test_exterior_masks_equal_jax(depth_scenes):
    import jax.numpy as jnp

    from obman_train_tpu.ops.inside import batch_mesh_contains_points
    from obman_train_tpu_torch.ops.raytri import mesh_contains_points

    hands, objs, faces = depth_scenes
    got = mesh_contains_points(torch.from_numpy(hands), torch.from_numpy(objs)[:, faces])
    want = np.asarray(batch_mesh_contains_points(jnp.asarray(hands), jnp.asarray(objs)[:, faces]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int((~want).sum(1).min())  # every scene has interior vertices


def test_penetration_depths_match_jax(depth_scenes):
    hands, objs, faces = depth_scenes
    got = savemano.max_penetration_depths(hands, objs, faces, device="cpu")
    assert got.dtype == np.float32 and got.shape == (4,)
    want = [jsavemano.max_penetration_depth(h, o, faces) for h, o in zip(hands, objs)]
    assert min(want) > 1.0  # mm: the scenes overlap
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    one_by_one = [savemano.max_penetration_depth(h, o, faces, device="cpu")
                  for h, o in zip(hands, objs)]
    np.testing.assert_array_equal(got, np.asarray(one_by_one, np.float32))


def _sphere_pair():
    verts, faces = icosphere(3)
    return verts * 0.04, faces, verts * 0.03 + np.array([0.035, 0.01, -0.005]), faces


def _hand_object_pair():
    hands, objs, faces = hand_scenes(1, seed=5)
    return (hands[0].astype(np.float64) * 0.001, savemano._hand_faces(),
            objs[0].astype(np.float64) * 0.001, faces)


@pytest.mark.parametrize("pitch", [0.005, 0.01])
@pytest.mark.parametrize("scene", [_sphere_pair, _hand_object_pair], ids=["spheres", "hand"])
def test_intersect_vox_equals_jax(scene, pitch):
    hv, hf, ov, of = scene()
    got = intersect.intersect_vox(hv, hf, ov, of, pitch=pitch, device="cpu")
    want = jintersect.intersect_vox(hv, hf, ov, of, pitch=pitch)
    assert want > 0
    assert got == want
    far = ov + np.array([1.0, 0, 0])
    assert intersect.intersect_vox(hv, hf, far, of, pitch=pitch, device="cpu") == 0.0


def test_occupancy_equals_jax_on_the_lattice():
    """Voxel centres on a regular lattice, where ties on a triangle's plane
    could split the two inside tests: the masks are equal point for point."""
    hv, hf, ov, of = _hand_object_pair()
    grid = intersect.voxel_grid(hv, ov, 0.005)
    got = intersect._occupancy(grid, hv, hf, torch.device("cpu"))
    want = jintersect._occupancy(grid, hv, hf)
    assert len(grid) > 1000 and got.any()
    np.testing.assert_array_equal(got, want)


def _summaries_equal(sim_dir, workers):
    got = simulate.full_simul(sim_dir, workers=workers, device="cpu")
    want = jsimulate.full_simul(sim_dir, workers=workers)
    assert got["sample_nb"] == want["sample_nb"]
    assert got["backend"] == want["backend"] == "native"
    assert got["mean_dist"] == want["mean_dist"]
    assert got["std_dist"] == want["std_dist"]
    np.testing.assert_allclose(got["max_depths"], want["max_depths"], rtol=1e-5, atol=1e-4)
    gi = intersect.full_intersect(sim_dir, device="cpu")
    wi = jintersect.full_intersect(sim_dir)
    assert gi == wi
    return got, gi


@pytest.fixture(scope="module")
def traineval_dir(tmp_path_factory):
    """``cli.traineval --evaluate --save_results`` of the port at test size
    (its own simulation on, as the CLI runs it)."""
    from obman_train_tpu_torch.cli import traineval

    exp = str(tmp_path_factory.mktemp("sim") / "exp")
    argv = ["--train_datasets", "synthetic", "--val_datasets", "synthetic",
            "--mano_assets", "synthetic", "--synthetic_size", "8", "--image_size", "64",
            "--train_batch", "4", "--test_batch", "4", "--workers", "2",
            "--display_freq", "0", "--atlas_predict_trans", "--exp_id", exp]
    old = os.environ.get("OBMAN_PLATFORM")
    os.environ["OBMAN_PLATFORM"] = "cpu"
    try:
        traineval.main(argv + ["--epochs", "1"])
        traineval.main(argv + ["--resume", exp, "--evaluate", "--save_results"])
        for name in os.listdir(exp):  # only the saved results are read
            if name.endswith(".pth.tar"):
                os.remove(os.path.join(exp, name))
    finally:
        if old is None:
            os.environ.pop("OBMAN_PLATFORM")
        else:
            os.environ["OBMAN_PLATFORM"] = old
    return os.path.join(exp, "save_results", "val", "epoch_1")


def test_full_simul_on_a_traineval_dir_equals_jax(traineval_dir):
    with open(os.path.join(traineval_dir, "simulation_results", "results.json")) as f:
        assert json.load(f)["summary"]["sample_nb"] == 8  # the CLI's own run
    got, _ = _summaries_equal(traineval_dir, workers=2)
    assert got["sample_nb"] == 8


def test_jax_reads_the_port_pickles(traineval_dir):
    """The pickles hold numpy and plain Python only, and the JAX package's
    ``load_batch_info`` rebuilds the port's samples from them."""
    names = sorted(n for n in os.listdir(traineval_dir) if n.startswith("batch_"))
    assert len(names) == 2

    def plain(x):
        if isinstance(x, dict):
            return all(isinstance(k, str) and plain(v) for k, v in x.items())
        return isinstance(x, (np.ndarray, str, int, float, bool, type(None)))

    for name in names:
        path = os.path.join(traineval_dir, name)
        with open(path, "rb") as f:
            assert plain(pickle.load(f))
        got = savemano.load_batch_info(path, device="cpu")
        want = jsavemano.load_batch_info(path)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            for k in ("hand_verts", "hand_faces", "obj_verts", "obj_faces"):
                np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_allclose(g["max_depth"], w["max_depth"], rtol=1e-5, atol=1e-4)


def test_full_simul_and_intersect_on_overlapping_scenes_equal_jax(tmp_path):
    """Two saved batches of overlapping hand-object scenes: non-zero depths
    and volumes, the summaries of both packages."""
    for i, seed in enumerate((1, 2)):
        hands, objs, _ = hand_scenes(2, seed)
        with open(tmp_path / f"batch_{i:06d}.pkl", "wb") as f:
            pickle.dump({"batch": {"objpoints3d": objs}, "root": "wrist",
                         "results": {"verts": hands, "objpoints3d": objs}}, f)
    got, inter = _summaries_equal(str(tmp_path), workers=3)
    assert got["sample_nb"] == 4 and got["max_depths"] > 1.0
    assert inter["sample_nb"] == 4 and inter["mean_volume"] > 0
