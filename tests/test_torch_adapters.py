"""The port's real-dataset adapters (``data/obman.py``, ``fhbhands.py``,
``stereohands.py``, ``core50.py``, ``plyio.py``, ``cacheutil.py``,
``fabricate.py``, ``visualize.py``, the mesh branch of ``HandDataset``)
against the JAX package's on the CPU, on trees fabricated in temporary
directories: ObMan by ``fabricate_obman`` (the JAX package's, and the
port's own copy), FHB by the port's ``fabricate_fhb`` (the layout of
``tests/test_adapters.py``'s ``fhb_root``: the 599/575 split file, object
poses only on the frames it writes), StereoHands, Core50 and YanaDemo
written here.

Decoders: cv2 is importable here, as on the GPU machine, so both packages
decode JPEGs with cv2 and take the uint8 image chain; one test hides cv2
from both (PIL decode, the float chain). Every adapter gets its own
temporary annotation cache per package: a test never passes by reading the
other package's cache. ``get_dataset`` builds its adapter with the default
cache folder (``data/cache/<name>``, relative to the working directory), so
each package's is built in a working directory of its own.

Tolerances: images, annotations, cache pickles and samples bitwise (0); the
fabricated trees byte for byte; the one-step losses on a loader batch
within rtol 1e-4 (the total loss's tolerance in
``tests/test_torch_train_step.py``), atol 1e-6.
"""

import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

from obman_train_tpu.data import factory as jfactory
from obman_train_tpu.data import loader as jloader
from obman_train_tpu.data import transforms as JT
from obman_train_tpu.data.core50 import Core50 as JCore50
from obman_train_tpu.data.core50 import YanaDemo as JYanaDemo
from obman_train_tpu.data.fabricate import fabricate_obman as jfabricate_obman
from obman_train_tpu.data.fhbhands import FHBHands as JFHBHands
from obman_train_tpu.data.obman import ObMan as JObMan
from obman_train_tpu.data.plyio import load_ply as jload_ply
from obman_train_tpu.data.stereohands import StereoHands as JStereoHands
from obman_train_tpu_torch.data import factory, loader
from obman_train_tpu_torch.data import transforms as T
from obman_train_tpu_torch.data.core50 import Core50, YanaDemo
from obman_train_tpu_torch.data.fabricate import fabricate_fhb, fabricate_obman
from obman_train_tpu_torch.data.fhbhands import FHBHands
from obman_train_tpu_torch.data.obman import ObMan
from obman_train_tpu_torch.data.plyio import load_ply
from obman_train_tpu_torch.data.stereohands import StereoHands

cv2 = pytest.importorskip("cv2")
from PIL import Image  # noqa: E402

torch.set_num_threads(2)


def assert_same(a, b, what=""):
    """Exact equality of two getter results: arrays (dtype, shape, bits),
    tuples/lists, dicts and scalars."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what
    elif isinstance(a, dict):
        assert {str(k) for k in a} == {str(k) for k in b}, what
        bmap = {str(k): v for k, v in b.items()}
        for k, v in a.items():
            assert_same(v, bmap[str(k)], f"{what}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


def _values(queries):
    return sorted(q.value for q in queries)


def _cache_file(folder):
    (name,) = os.listdir(folder)
    with open(os.path.join(folder, name), "rb") as f:
        return name, pickle.load(f)


# --------------------------------------------------------------------------
# trees
# --------------------------------------------------------------------------

N_OBMAN = 4
SIZE = 64  # the crops
OBMAN_IMG = 128  # the fabricated ObMan frames (fabricate_obman draws joints in [40, size - 56])


def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.ascontiguousarray(arr)).save(path)


def obman_extras(obman_root, n, size, split="train"):
    """What ``fabricate_obman`` leaves out for the other modes: segmentation
    PNGs with the adapter's labels (channel 0 for mode all, 1 hand, 2 obj),
    the ``rgb_obj``/``rgb_hand`` frames and the depth PNGs."""
    base = os.path.join(obman_root, split)
    rng = np.random.default_rng(7)
    for i in range(n):
        prefix = f"{i:08d}"
        with open(os.path.join(base, "meta", f"{prefix}.pkl"), "rb") as f:
            side = pickle.load(f)["side"]
        hand = (22, 24) if side == "right" else (21, 23)
        seg = np.zeros((size, size, 3), np.uint8)
        y0, x0 = rng.integers(4, size // 2, 2)
        seg[y0:y0 + size // 4, x0:x0 + size // 3, [0, 2]] = 100       # object
        seg[size // 2:size // 2 + 12, 8:30, [0, 1]] = hand[i % 2]       # hand
        _png(os.path.join(base, "segm", f"{prefix}.png"), seg)
        depth = rng.integers(1, 255, (size, size, 3)).astype(np.uint8)
        depth[0, 0] = 255
        _png(os.path.join(base, "depth", f"{prefix}.png"), depth)
        for folder in ("rgb_obj", "rgb_hand"):
            os.makedirs(os.path.join(base, folder), exist_ok=True)
            shutil.copy(os.path.join(base, "rgb", f"{prefix}.jpg"),
                        os.path.join(base, folder, f"{prefix}.jpg"))


@pytest.fixture(scope="module")
def obman_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("obman_tree")
    obman_root, shapenet_root = fabricate_obman(str(root), N_OBMAN, img_size=OBMAN_IMG, seed=5)
    obman_extras(obman_root, N_OBMAN, OBMAN_IMG)
    return obman_root, shapenet_root


@pytest.fixture(scope="module")
def fhb_tree(tmp_path_factory):
    return fabricate_fhb(str(tmp_path_factory.mktemp("fhb_tree")), n_train=6, n_test=4,
                         frames_per_seq=2, seed=1)


STEREO_SEQS = ("B1Counting", "B1Random")
STEREO_FRAMES = 4  # frames with an image on disk, per sequence


def write_stereohands(root, frames=STEREO_FRAMES):
    """Two test sequences: 1500 labelled frames each (``handPara`` in mm,
    joints tip first), the first ``frames`` with a 640x480 PNG, and the
    detector files of the ``test`` split."""
    rng = np.random.default_rng(3)
    for seq in STEREO_SEQS:
        os.makedirs(os.path.join(root, "labels"), exist_ok=True)
        para = rng.normal(0, 30, (3, 21, 1500)) + np.array([0, 0, 450])[:, None, None]
        from scipy.io import savemat

        savemat(os.path.join(root, "labels", f"{seq}_BB.mat"), {"handPara": para})
        for i in range(frames):
            _png(os.path.join(root, "images", seq, f"BB_left_{i}.png"),
                 rng.integers(0, 256, (480, 640, 3)).astype(np.uint8))
    os.makedirs(os.path.join(root, "detections"), exist_ok=True)
    np.savetxt(os.path.join(root, "detections", "centers_test.txt"),
               rng.uniform(200, 400, (3000, 2)))
    np.savetxt(os.path.join(root, "detections", "scales_test.txt"), rng.uniform(100, 200, 3000))
    return root


CORE50 = {"s1": {"o6": 3, "o31": 1}, "s2": {"o7": 2}}  # session -> object -> frames


def write_core50(root, sessions=CORE50):
    """Per-frame bbox/side annotations (.mat) and 350x350 PNG frames; the
    ``mobile_phone`` class is o6-o10, ``ball`` o31-o35."""
    from scipy.io import savemat

    rng = np.random.default_rng(4)
    for sess, objs in sessions.items():
        for obj, n in objs.items():
            for k in range(n):
                prefix = f"{sess[1:]:0>2}_{obj[1:]:0>2}_{k:03d}"
                x0, y0 = rng.uniform(20, 150, 2)
                annot = {"crop": np.array([[x0, y0, x0 + rng.uniform(40, 150),
                                            y0 + rng.uniform(40, 150)]]),
                         "hand": {"side": np.array(["R" if k % 2 else "L"])}}
                d = os.path.join(root, "core50_350x350_Annot", sess, obj)
                os.makedirs(d, exist_ok=True)
                savemat(os.path.join(d, f"A_{prefix}.mat"), {"annot": annot})
                _png(os.path.join(root, "core50_350x350", sess, obj, f"C_{prefix}.png"),
                     rng.integers(0, 256, (350, 350, 3)).astype(np.uint8))
    return root


def write_yanademo(root):
    rng = np.random.default_rng(5)
    for seq, n in (("seq_a", 2), ("seq_b", 1)):
        for k in range(n):
            _png(os.path.join(root, seq, f"{k:04d}.png"),
                 rng.integers(0, 256, (120, 160, 3)).astype(np.uint8))
    return root


def real_trees(tmp):
    """A tree of every real adapter under ``tmp``: the ``meta`` of
    ``get_dataset`` for each name (cv2 must import: the fabricators encode
    with it)."""
    tmp = str(tmp)
    obman_root, shapenet_root = fabricate_obman(os.path.join(tmp, "o"), 4, img_size=OBMAN_IMG)
    return {
        "obman": {"obman_root": obman_root, "shapenet_root": shapenet_root},
        "fhbhands": {"fhb_root": fabricate_fhb(os.path.join(tmp, "f"), 4, 2)},
        "stereohands": {"stereo_root": write_stereohands(os.path.join(tmp, "s"))},
        "core50": {"core50_root": write_core50(os.path.join(tmp, "c"))},
        "yanademo": {"yana_root": write_yanademo(os.path.join(tmp, "y"))},
    }


# --------------------------------------------------------------------------
# fabricate, ply, mesh sampling
# --------------------------------------------------------------------------


def _tree_bytes(root):
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("kw", [dict(n_samples=3, img_size=OBMAN_IMG, seed=2),
                                dict(n_samples=2, split="val", write_segm=False, seed=9)],
                         ids=["train_segm", "val_no_segm"])
def test_fabricate_obman_is_byte_identical_to_jax(tmp_path, kw):
    n = kw.pop("n_samples")
    jroots = jfabricate_obman(str(tmp_path / "jax"), n, **kw)
    proots = fabricate_obman(str(tmp_path / "port"), n, **kw)
    assert [os.path.relpath(r, tmp_path / "jax") for r in jroots] == \
        [os.path.relpath(r, tmp_path / "port") for r in proots]
    want, got = _tree_bytes(tmp_path / "jax"), _tree_bytes(tmp_path / "port")
    split = kw.get("split", "train")
    assert sum(k.startswith(os.path.join("obman", split, "rgb")) for k in got) == n
    assert sum(k.endswith(".png") for k in got) == (n if kw.get("write_segm", True) else 0)
    assert {"model_normalized.pkl", "surface_points.pkl"} <= {os.path.basename(k) for k in got}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


def _write_plys(tmp_path):
    """An ascii PLY with a quad, normals and a comment, and a binary one
    with a colour property and a polygon."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 0.5, 1]], np.float32)
    ascii_path = tmp_path / "a.ply"
    lines = ["ply", "format ascii 1.0", "comment written by a test", "element vertex 5",
             "property float x", "property float y", "property float z",
             "property float nx", "property float ny", "property float nz",
             "element face 3", "property list uchar int vertex_indices", "end_header"]
    lines += [" ".join(f"{x:.3f}" for x in v) + " 0 0 1" for v in verts]
    lines += ["4 0 1 2 3", "3 0 1 4", "3 1 2 4"]
    ascii_path.write_text("\n".join(lines) + "\n")
    binary_path = tmp_path / "b.ply"
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 5\n"
              "property double x\nproperty double y\nproperty double z\n"
              "property uchar red\nelement face 2\n"
              "property list uchar uint vertex_indices\nend_header\n")
    vdt = np.dtype([("x", "<f8"), ("y", "<f8"), ("z", "<f8"), ("red", "u1")])
    rows = np.zeros(5, vdt)
    for i, c in enumerate("xyz"):
        rows[c] = verts[:, i]
    rows["red"] = np.arange(5)
    with open(binary_path, "wb") as f:
        f.write(header.encode())
        f.write(rows.tobytes())
        for face in ([0, 1, 4], [1, 2, 3, 4]):
            f.write(np.uint8(len(face)).tobytes() + np.asarray(face, "<u4").tobytes())
    return verts, str(ascii_path), str(binary_path)


def test_load_ply_ascii_and_binary_match_jax(tmp_path, fhb_tree):
    verts, ascii_path, binary_path = _write_plys(tmp_path)
    v, f = load_ply(ascii_path)
    np.testing.assert_allclose(v, verts, rtol=0, atol=1e-6)
    assert f.tolist() == [[0, 1, 2], [0, 2, 3], [0, 1, 4], [1, 2, 4]]  # the quad fanned
    v, f = load_ply(binary_path)
    assert v.dtype == np.float64 and np.array_equal(v, verts.astype(np.float64))
    assert f.tolist() == [[0, 1, 4], [1, 2, 3], [1, 3, 4]]
    models = [os.path.join(fhb_tree, "Object_models", d, f"{d}.ply")
              for d in sorted(os.listdir(os.path.join(fhb_tree, "Object_models")))]
    for path in [ascii_path, binary_path] + models:
        assert_same(load_ply(path), jload_ply(path), path)
    with open(models[0], "rb") as a, open(models[1], "rb") as b:
        assert b"format ascii" in a.read(64) and b"binary_little_endian" in b.read(64)


def test_points_from_mesh_and_load_obj_normalized_match_jax(tmp_path):
    from obman_train_tpu_torch.assets import icosphere

    verts, faces = icosphere(2)
    verts = verts * [1.0, 2.0, 0.5]
    for seed in (0, 1):
        got = T.points_from_mesh(faces, verts, vertex_nb=300,
                                 rng=np.random.default_rng(seed))
        want = JT.points_from_mesh(faces, verts, vertex_nb=300,
                                   rng=np.random.default_rng(seed))
        assert got.dtype == np.float32 and np.array_equal(got, want)
    # the same generator afterwards: the port drew as many values as JAX
    gp, gj = np.random.default_rng(4), np.random.default_rng(4)
    T.points_from_mesh(faces, verts, vertex_nb=10, rng=gp)
    JT.points_from_mesh(faces, verts, vertex_nb=10, rng=gj)
    assert gp.random() == gj.random()
    obj = tmp_path / "m.obj"
    obj.write_text("v 0 0 0\nv 2 0 0\nv 2 3 0\nv 0 3 1\nv 1 1 4\n"
                   "f 1 2 3 4\nf 1/1 2/2 5/3\no second\nf 2 3 5\n")
    got, want = T.load_obj_normalized(str(obj)), JT.load_obj_normalized(str(obj))
    assert_same(got, want)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    np.testing.assert_allclose(np.abs(got[0]).max(), 1.0, rtol=1e-6)


def test_points_from_mesh_on_surface():
    """Twin of ``tests/test_data.py::test_points_from_mesh_on_surface``."""
    from obman_train_tpu_torch.assets import icosphere

    verts, faces = icosphere(1)
    pts = T.points_from_mesh(faces, verts, vertex_nb=500, rng=np.random.default_rng(0))
    norms = np.linalg.norm(pts, axis=1)
    assert norms.max() <= 1.0 + 1e-5
    assert norms.min() > 0.8


# --------------------------------------------------------------------------
# ObMan
# --------------------------------------------------------------------------

OBMAN_MODES = {
    "all": {},
    "obj": {"mode": "obj"},
    "hand": {"mode": "hand", "root_palm": True},
    "override_scale": {"override_scale": True},
    "segment": {"segment": True},
}


def _obman_pair(tree, tmp_path, **kw):
    obman_root, shapenet_root = tree
    common = dict(split="train", obman_root=obman_root, shapenet_root=shapenet_root, **kw)
    return (JObMan(cache_folder=str(tmp_path / "jax_cache"), **common),
            ObMan(cache_folder=str(tmp_path / "port_cache"), **common))


@pytest.mark.parametrize("mode", list(OBMAN_MODES))
def test_obman_getters_match_jax(obman_tree, tmp_path, mode):
    """Every getter equal to JAX's bit for bit, the object points drawn in
    turn from each adapter's own generator; the annotation caches hold the
    same keys and values, and a second construction reads them."""
    j, p = _obman_pair(obman_tree, tmp_path, **OBMAN_MODES[mode])
    assert len(j) == len(p) == N_OBMAN
    assert _values(p.all_queries) == _values(j.all_queries)
    jname, jann = _cache_file(tmp_path / "jax_cache")
    pname, pann = _cache_file(tmp_path / "port_cache")
    assert pname == jname
    assert_same(pann, jann, "cache")
    for attempt in range(2):
        for idx in range(N_OBMAN):
            for name in ("get_image", "get_segm", "get_joints2d", "get_joints3d",
                         "get_verts3d", "get_obj_verts_faces", "get_sides", "get_camintr",
                         "get_center_scale", "get_meta", "get_hand_pcas", "get_depth"):
                assert_same(getattr(p, name)(idx), getattr(j, name)(idx), f"{name}({idx})")
            assert_same(p.get_objpoints3d(idx, point_nb=50), j.get_objpoints3d(idx, point_nb=50),
                        f"get_objpoints3d({idx})")
        # from the cache
        j, p = _obman_pair(obman_tree, tmp_path, **OBMAN_MODES[mode])
    img = p.get_image(0)
    assert img.shape == (OBMAN_IMG, OBMAN_IMG, 3) and img.dtype == np.uint8
    if mode == "segment":
        assert (img == 0).any() and (img > 0).any()  # masked
    if mode in ("obj", "override_scale"):
        assert p.get_center_scale(0)[1] > 0 and 0 in p.center_scale_cache


def test_obman_images_without_cv2_decode_with_pil(obman_tree, tmp_path, monkeypatch):
    """cv2 hidden from both packages: both decode with PIL, bit for bit."""
    j, p = _obman_pair(obman_tree, tmp_path)
    with_cv2 = p.get_image(1)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got, want = p.get_image(1), j.get_image(1)
    assert_same(got, want)
    assert np.array_equal(got, np.asarray(Image.open(p.image_names[1]).convert("RGB")))
    # the two decoders agree to a few levels (they differ in IDCT rounding)
    assert np.abs(got.astype(int) - with_cv2.astype(int)).max() <= 8


def test_obman_object_model_from_obj(obman_tree, tmp_path):
    """Without the model pickle the adapters read the OBJ beside it
    (``fast_load_obj``); with neither they raise ``ValueError``."""
    shapenet = tmp_path / "shapenet"
    shutil.copytree(obman_tree[1], shapenet)
    (model_dir,) = {os.path.dirname(os.path.join(b, f)) for b, _, fs in os.walk(shapenet)
                    for f in fs if f == "model_normalized.pkl"}
    with open(os.path.join(model_dir, "model_normalized.pkl"), "rb") as f:
        mesh = pickle.load(f)
    os.remove(os.path.join(model_dir, "model_normalized.pkl"))
    with open(os.path.join(model_dir, "model_normalized.obj"), "w") as f:
        f.writelines(f"v {x} {y} {z}\n" for x, y, z in mesh["vertices"])
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in mesh["faces"])
    j, p = _obman_pair((obman_tree[0], str(shapenet)), tmp_path, use_cache=False)
    verts, faces = p.get_obj_verts_faces(2)
    assert_same((verts, faces), j.get_obj_verts_faces(2))
    assert verts.dtype == np.float32 and faces.dtype == np.int32 and len(faces) == 96
    os.remove(os.path.join(model_dir, "model_normalized.obj"))
    for ds in (j, p):
        with pytest.raises(ValueError, match="No model pkl/obj"):
            ds.get_obj_verts_faces(0)


def test_obman_missing_files_raise(tmp_path):
    for cls in (JObMan, ObMan):
        with pytest.raises(FileNotFoundError):
            cls(obman_root=str(tmp_path / "none"), cache_folder=str(tmp_path / cls.__module__))
    with pytest.raises(ValueError, match="Mode should be"):
        ObMan(mode="both", obman_root=str(tmp_path), cache_folder=str(tmp_path / "c"))


def test_obman_cache_keyed_by_root(tmp_path):
    """Twin of ``tests/test_adapters.py::test_obman_cache_keyed_by_root``:
    one cache folder, two roots, the second pass from the cache."""
    cache = str(tmp_path / "shared_cache")
    roots = []
    for name, n in (("a", 3), ("b", 5)):
        obman_root, shapenet_root = fabricate_obman(str(tmp_path / name), n,
                                                    img_size=OBMAN_IMG, write_segm=False)
        roots.append((obman_root, shapenet_root, n))
    for obman_root, shapenet_root, n in roots + roots:
        ds = ObMan(split="train", obman_root=obman_root, shapenet_root=shapenet_root,
                   cache_folder=cache, use_cache=True)
        assert len(ds) == n
        assert all(p.startswith(obman_root) for p in ds.image_names)
        assert ds.get_image(0).shape == (OBMAN_IMG, OBMAN_IMG, 3)
    assert len(os.listdir(cache)) == 2


# --------------------------------------------------------------------------
# FHB
# --------------------------------------------------------------------------

FHB_CONFIGS = {
    "action_train": dict(split="train"),
    "action_test": dict(split="test"),
    "subjects_train": dict(split="train", split_type="subjects"),
    "objects_test": dict(split="test", split_type="objects"),
    "topology0": dict(split="train", topology="0"),
    "all_mini": dict(split="all", mini_factor=0.5),
    "override_scale": dict(split="train", override_scale=True),
    "no_objects": dict(split="train", use_objects=False),
}


def _fhb_pair(root, tmp_path, **kw):
    return (JFHBHands(root=root, cache_folder=str(tmp_path / "jax_cache"), **kw),
            FHBHands(root=root, cache_folder=str(tmp_path / "port_cache"), **kw))


@pytest.mark.parametrize("config", list(FHB_CONFIGS))
def test_fhb_getters_match_jax(fhb_tree, tmp_path, config):
    kw = FHB_CONFIGS[config]
    j, p = _fhb_pair(fhb_tree, tmp_path, **kw)
    assert len(p) == len(j) > 0
    assert _values(p.all_queries) == _values(j.all_queries)
    jname, jann = _cache_file(tmp_path / "jax_cache")
    pname, pann = _cache_file(tmp_path / "port_cache")
    assert pname == jname
    assert_same(pann, jann, "cache")
    getters = ["get_image", "get_joints3d", "get_joints2d", "get_camintr", "get_sides",
               "get_meta", "get_center_scale"]
    if kw.get("use_objects", True):
        getters += ["get_obj_verts_faces", "get_objpoints2d"]
    if not kw.get("use_objects", True):
        # every listed frame, with or without a pose and an image on disk
        assert len(p) == 599 * 2
        getters.remove("get_image")
        for idx in range(6):
            assert_same(p.get_image(idx), j.get_image(idx), f"get_image({idx})")
    for idx in range(len(p)):
        for name in getters:
            assert_same(getattr(p, name)(idx), getattr(j, name)(idx), f"{name}({idx})")
    assert p.get_image(0).shape == (270, 480, 3)
    if kw.get("use_objects", True):
        # the contact filter kept the frames: an object vertex within 10 mm
        # of a joint
        verts, _ = p.get_obj_verts_faces(0)
        if not kw.get("override_scale"):
            d = np.linalg.norm(verts[:, None] - p.get_joints3d(0)[None], axis=2)
            assert d.min() <= 10.0


def test_fhb_split_assertions_fire(fhb_tree, tmp_path):
    """Twin of ``tests/test_adapters.py::test_fhb_split_invariant_violation``
    (and the train count)."""
    root = str(tmp_path / "fhb")
    shutil.copytree(fhb_tree, root)
    split = os.path.join(root, "data_split_action_recognition.txt")
    with open(split) as f:
        lines = f.readlines()
    test_at = next(i for i, line in enumerate(lines) if line.startswith("Test"))
    for cut, count in ((lines[:-3], "575"), (lines[:test_at - 2] + lines[test_at:], "599")):
        with open(split, "w") as f:
            f.writelines(cut)
        for cls in (JFHBHands, FHBHands):
            with pytest.raises(AssertionError, match=count):
                cls(split="train", root=root, use_cache=False,
                    cache_folder=str(tmp_path / "cache"))


def test_fhb_filter_drops_frames_out_of_contact(fhb_tree, tmp_path):
    """Moved 50 mm off every joint, no frame passes the 10 mm filter;
    with the filter off they all come back."""
    root = str(tmp_path / "fhb")
    shutil.copytree(fhb_tree, root)
    pose_root = os.path.join(root, "Object_6D_pose_annotation_v1")
    for base, _, files in os.walk(pose_root):
        for name in files:
            path = os.path.join(base, name)
            rows = np.loadtxt(path, ndmin=2)
            rows[:, 1 + 12:1 + 15] += 1e3  # the translation (the file holds the transpose)
            np.savetxt(path, rows, fmt=["%d"] + ["%.8f"] * 16)
    j, p = _fhb_pair(root, tmp_path, split="train", use_cache=False)
    assert len(p) == len(j) == 0
    j, p = _fhb_pair(root, tmp_path, split="train", use_cache=False, filter_no_contact=False)
    assert len(p) == len(j) == 6
    assert_same(p.get_obj_verts_faces(1), j.get_obj_verts_faces(1))


# --------------------------------------------------------------------------
# StereoHands, Core50, YanaDemo
# --------------------------------------------------------------------------


@pytest.mark.parametrize("gt_detections", [True, False], ids=["gt", "detections"])
def test_stereohands_getters_match_jax(tmp_path, gt_detections):
    root = write_stereohands(str(tmp_path / "stereo"))
    kw = dict(split="test", root=root, gt_detections=gt_detections)
    j = JStereoHands(cache_folder=str(tmp_path / "jax_cache"), **kw)
    p = StereoHands(cache_folder=str(tmp_path / "port_cache"), **kw)
    assert len(p) == len(j) == 3000
    assert _values(p.all_queries) == _values(j.all_queries)
    assert_same(_cache_file(tmp_path / "port_cache"), _cache_file(tmp_path / "jax_cache"))
    for idx in (0, 1, 1499, 1500, 1503, 2999):
        for name in ("get_joints3d", "get_joints2d", "get_sides", "get_manoidxs",
                     "get_camintr", "get_center_scale"):
            assert_same(getattr(p, name)(idx), getattr(j, name)(idx), f"{name}({idx})")
    for idx in (0, 3, 1500):
        assert_same(p.get_image(idx), j.get_image(idx))
    # tip-first labels reordered base-first: the label's joint 17 is the
    # adapter's joint 1 (REORDER_IDX)
    from scipy.io import loadmat

    para = loadmat(os.path.join(root, "labels", "B1Counting_BB.mat"))["handPara"]
    np.testing.assert_array_equal(p.get_joints3d(0)[1], para[:, 17, 0].astype(np.float32))
    with pytest.raises(ValueError, match="split"):
        StereoHands(split="nope", root=root)


def test_core50_and_yanademo_match_jax(tmp_path):
    root = write_core50(str(tmp_path / "core50"))
    for cls_name, n in (("mobile_phone", 5), ("ball", 1)):
        kw = dict(root=root, class_name=cls_name)
        j = JCore50(cache_folder=str(tmp_path / "jax_cache" / cls_name), **kw)
        p = Core50(cache_folder=str(tmp_path / "port_cache" / cls_name), **kw)
        assert len(p) == len(j) == n
        assert _values(p.all_queries) == _values(j.all_queries)
        assert_same(_cache_file(tmp_path / "port_cache" / cls_name)[1],
                    _cache_file(tmp_path / "jax_cache" / cls_name)[1])
        for idx in range(n):
            for name in ("get_image", "get_joints3d", "get_camintr", "get_sides",
                         "get_center_scale"):
                assert_same(getattr(p, name)(idx), getattr(j, name)(idx), f"{name}({idx})")
            assert_same(p.get_objpoints3d(idx, 7), j.get_objpoints3d(idx, 7))
    with pytest.raises(ValueError, match="should be in"):
        Core50(root=root, class_name="spoon")
    yroot = write_yanademo(str(tmp_path / "yana"))
    j, p = JYanaDemo(root=yroot, side="left"), YanaDemo(root=yroot, side="left")
    assert len(p) == len(j) == 3 and p.name == "yanademo"
    assert _values(p.all_queries) == _values(j.all_queries)
    for idx in range(3):
        for name in ("get_image", "get_joints3d", "get_sides", "get_center_scale"):
            assert_same(getattr(p, name)(idx), getattr(j, name)(idx), f"{name}({idx})")
    with pytest.raises(FileNotFoundError):
        YanaDemo(root=str(tmp_path / "none"))


def test_core50_cache_keyed_by_root(tmp_path):
    """The port keys Core50's cache by root too (the JAX package's key is
    the class and ``mini_factor``): a second root in the same cache folder
    reads its own frames."""
    cache = str(tmp_path / "cache")
    a = write_core50(str(tmp_path / "a"), {"s1": {"o6": 2}})
    b = write_core50(str(tmp_path / "b"), {"s1": {"o6": 3}})
    for root, n in ((a, 2), (b, 3), (a, 2)):
        ds = Core50(root=root, cache_folder=cache)
        assert len(ds) == n and all(p.startswith(root) for p in ds.image_names)
    assert len(os.listdir(cache)) == 2


# --------------------------------------------------------------------------
# get_dataset, loaders, the train step
# --------------------------------------------------------------------------


def _get_pair(name, split, meta, tmp_path, monkeypatch, **kw):
    """``get_dataset`` of both packages, each built in a working directory
    of its own (the adapters' default cache folder is relative)."""
    out = []
    for pkg, fac in (("jax", jfactory), ("port", factory)):
        os.makedirs(tmp_path / pkg, exist_ok=True)
        monkeypatch.chdir(tmp_path / pkg)
        out.append(fac.get_dataset(name, split, meta=meta, inp_res=SIZE, **kw))
    assert os.path.isdir(tmp_path / "port" / "data" / "cache")
    return out


@pytest.mark.parametrize("train", [True, False], ids=["train_jitter", "val"])
@pytest.mark.parametrize("name", ["obman", "fhbhands"])
def test_get_dataset_samples_match_jax(obman_tree, fhb_tree, tmp_path, monkeypatch, name,
                                       train):
    """Every key of ``get_dataset(...)[i]`` equal, over three epochs of the
    augmentation stream with the train jitter (``reseed``) and without;
    FHB's object points come from the mesh branch (``points_from_mesh``
    with the sample's generator), ObMan's from the shared generator, read
    in the same order."""
    meta = ({"obman_root": obman_tree[0], "shapenet_root": obman_tree[1]}
            if name == "obman" else {"fhb_root": fhb_tree})
    split = "train"
    j, p = _get_pair(name, split, meta, tmp_path, monkeypatch, train_it=train)
    assert len(p) == len(j) > 0
    assert _values(p.queries) == _values(j.queries)
    for epoch in (1, 2, 5):
        j.reseed(epoch)
        p.reseed(epoch)
        for idx in range(len(p)):
            a, b = j[idx], p[idx]
            assert_same(b, a, f"epoch {epoch} sample {idx}")
            assert b["trans_images"].dtype == np.uint8
            assert b["trans_objpoints3d"].shape == (600, 3)


def test_factory_names_and_missing_roots(tmp_path, monkeypatch):
    """``get_dataset`` loads every JAX name; an unknown one raises
    ``ValueError``; a missing root ``FileNotFoundError``, as in JAX."""
    trees = real_trees(tmp_path / "trees")
    monkeypatch.chdir(tmp_path)
    for name, meta in trees.items():
        split = "test" if name == "stereohands" else "train"
        ds = factory.get_dataset(name, split, meta=meta, inp_res=SIZE)
        assert len(ds) > 0, name
        sample = ds[0]
        assert sample["trans_images"].shape == (SIZE, SIZE, 3), name
    for fac in (factory, jfactory):
        with pytest.raises(ValueError, match="Unrecognized dataset"):
            fac.get_dataset("nope", "train")
        for name, key in (("obman", "obman_root"), ("fhbhands", "fhb_root"),
                          ("stereohands", "stereo_root"), ("yanademo", "yana_root")):
            with pytest.raises(FileNotFoundError):
                fac.get_dataset(name, "test", meta={key: str(tmp_path / "none")})


def test_slice_loader_batches_and_train_step_match_jax(obman_tree, tmp_path, monkeypatch):
    """One-worker loaders of both packages over the fabricated ObMan tree
    yield equal model batches (one worker: the adapter's shared generator
    is then read in the sample order), and one contact-config train step of
    the port from the JAX weights gives the JAX package's losses on it."""
    import jax

    from obman_train_tpu.data.loader import derive_spec as jderive_spec
    from obman_train_tpu_torch import train
    from obman_train_tpu_torch.config import TrainConfig
    from tests.test_torch_handnet import CONTACT
    from tests.test_torch_losses import loss_pair

    meta = {"obman_root": obman_tree[0], "shapenet_root": obman_tree[1]}
    jds, pds = _get_pair("obman", "train", meta, tmp_path, monkeypatch, train_it=True)
    jb = next(iter(jloader.BatchLoader(jds, batch_size=2, num_workers=1, seed=0)))
    pb = next(iter(loader.BatchLoader(pds, batch_size=2, num_workers=1, seed=0)))
    assert_same(pb, jb, "batch")
    assert all(v.flags.c_contiguous for v in pb.values())
    assert {"images", "joints3d", "verts3d", "objpoints3d", "camintrs", "center3d",
            "sides"} <= set(pb)

    jnet, variables, pnet, _ = loss_pair(CONTACT, 2, SIZE, 0)
    jspec = jderive_spec(jb)
    apply = jax.jit(lambda v, b: jnet.apply(v, b, jspec, rngs={"points": jax.random.PRNGKey(0)}))
    jtotal, _, jlosses = apply(variables, jb)
    opt = train.make_optimizer(TrainConfig(), pnet)
    state = train.create_train_state(pnet, opt, TrainConfig())
    step = train.make_train_step(pnet, opt, loader.derive_spec(pb), device="cpu")
    state, losses = step(state, pb)
    assert state.step == 1
    assert set(losses) == set(jlosses)
    assert {"contact_loss", "atlas_objpoints3d", "mano_joints3d"} <= set(losses)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(losses["total_loss"]), float(jtotal), rtol=1e-4)


def test_mixed_spec_epoch_obman_and_stereohands(obman_tree, tmp_path, monkeypatch):
    """Twin of ``tests/test_mixed_training.py::test_mixed_spec_epoch`` on
    real-layout trees: obman and stereohands round-robin through
    ``ConcatLoader`` (batches equal to the JAX package's), stereohands with
    the palm root, one step per ``BatchSpec``."""
    from obman_train_tpu_torch.assets import synthetic_mano_assets
    from obman_train_tpu_torch.config import ModelConfig, TrainConfig
    from obman_train_tpu_torch.models import build_handnet
    from obman_train_tpu_torch.train import create_train_state, loop, make_optimizer
    from obman_train_tpu_torch.weights import init_weights

    stereo = write_stereohands(str(tmp_path / "stereo"))
    metas = {"obman": {"obman_root": obman_tree[0], "shapenet_root": obman_tree[1]},
             "stereohands": {"stereo_root": stereo}}
    streams = {}
    for pkg, fac, ld in (("jax", jfactory, jloader), ("port", factory, loader)):
        os.makedirs(tmp_path / pkg, exist_ok=True)
        monkeypatch.chdir(tmp_path / pkg)
        loaders, lmetas = [], []
        for name, split in (("obman", "train"), ("stereohands", "test")):
            ds = fac.get_dataset(name, split, meta=metas[name], inp_res=SIZE,
                                 limit_size=STEREO_FRAMES)
            loaders.append(ld.BatchLoader(ds, 2, num_workers=1, seed=0))
            lmetas.append(ld.loader_meta(name, split))
        streams[pkg] = ld.ConcatLoader(loaders, lmetas)
    for a, b in zip(streams["jax"], streams["port"]):
        assert_same(b, a)
    assert [b["root"] for b in streams["port"]] == ["wrist", "palm"] * 2

    net = init_weights(build_handnet(ModelConfig(), synthetic_mano_assets("right"),
                                     synthetic_mano_assets("left"), device="cpu"), 0)
    opt = make_optimizer(TrainConfig(lr=1e-3), net)
    state = create_train_state(net, opt, TrainConfig(lr=1e-3))
    specs = []
    original = loop.make_train_step

    def recording(net, optimizer, spec, **kw):
        specs.append(spec)
        return original(net, optimizer, spec, **kw)

    monkeypatch.setattr(loop, "make_train_step", recording)
    state, meters, _ = loop.epoch_pass(streams["port"], state, epoch=0, train=True)
    assert [s.root for s in specs] == ["wrist", "palm"]
    assert specs[0].has_objpoints3d and not specs[1].has_objpoints3d
    avgs = meters.averages()
    assert "mano_joints3d" in avgs and "atlas_objpoints3d" in avgs
    assert np.isfinite(avgs["total_loss"])
    assert state.step == 4


# --------------------------------------------------------------------------
# visualize
# --------------------------------------------------------------------------

VISUALIZERS = ("visualize_original", "visualize_transformed", "visualize_3d_transformed",
               "visualize_3d_proj")


@pytest.fixture
def no_matplotlib(monkeypatch):
    for name in ("matplotlib", "matplotlib.pyplot", "mpl_toolkits", "mpl_toolkits.mplot3d"):
        monkeypatch.setitem(sys.modules, name, None)


def _draw_all(module, ds, tmp_path, tag):
    paths = []
    for fn in VISUALIZERS:
        p = getattr(module, fn)(ds, 1, str(tmp_path / f"{tag}_{fn}.png"))
        assert os.path.getsize(p) > 1000, fn
        paths.append(p)
    return paths


def test_dataset_visualizers(tmp_path):
    """Twin of ``tests/test_data.py::test_dataset_visualizers``, with
    matplotlib: the port's figures equal the JAX package's pixel for pixel."""
    from obman_train_tpu.data import visualize as jvis
    from obman_train_tpu_torch.data import visualize as pvis

    pytest.importorskip("matplotlib")
    ds = factory.get_dataset("synthetic", "train", meta={"size": 4})
    jds = jfactory.get_dataset("synthetic", "train", meta={"size": 4})
    ds.reseed(1)
    jds.reseed(1)
    for got, want in zip(_draw_all(pvis, ds, tmp_path, "port"),
                         _draw_all(jvis, jds, tmp_path, "jax")):
        assert np.array_equal(np.asarray(Image.open(got)), np.asarray(Image.open(want))), got


@pytest.mark.parametrize("name", ["synthetic", "fhbhands"])
def test_dataset_visualizers_without_matplotlib(fhb_tree, tmp_path, monkeypatch,
                                                no_matplotlib, name):
    """Without matplotlib (some GPU hosts have PIL only) the four
    harnesses draw PIL raster panels: the image with its joints, the 3D
    points' projections."""
    from obman_train_tpu_torch.data import visualize as pvis

    monkeypatch.chdir(tmp_path)
    meta = {"size": 4} if name == "synthetic" else {"fhb_root": fhb_tree}
    ds = factory.get_dataset(name, "train", meta=meta, inp_res=SIZE)
    ds.reseed(1)
    paths = _draw_all(pvis, ds, tmp_path, name)
    sizes = [Image.open(p).size for p in paths]
    assert sizes[0][1] == sizes[1][1] and sizes[3][0] == 4 * sizes[1][0]
