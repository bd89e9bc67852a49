"""The port's data pipeline (``data/``, ``native/``) against the JAX
package's on the CPU: the synthetic adapter, ``HandDataset`` samples
(train and val, several epochs and indices, ``device_augment`` on and off),
the ``BatchLoader``/``ConcatLoader`` streams over two epochs, and the host
C++ warp against its numpy version.

Both packages run the cv2-free float chain here, the fallback each picks
when cv2 does not import: the tests hide cv2 (``sys.modules["cv2"] =
None``); ``test_torch_data_cv2.py`` holds the uint8 cv2 chain and the
process loader workers. Tolerances: uint8
images, integer orders and float32 geometry bitwise (the geometry to 1e-6
as a bound); the C++ warp against the numpy gather to 2e-5 of the value
range (the same taps summed in another order).
"""

import sys

import numpy as np
import pytest
import torch

from obman_train_tpu.data import factory as jfactory
from obman_train_tpu.data import loader as jloader
from obman_train_tpu.data import transforms as JT
from obman_train_tpu.data.queries import get_trans_queries as j_trans_queries
from obman_train_tpu.data.synthetic import SyntheticDataset as JSynthetic
from obman_train_tpu_torch.data import factory, loader
from obman_train_tpu_torch.data import transforms as T
from obman_train_tpu_torch.data.queries import BaseQueries, get_trans_queries
from obman_train_tpu_torch.data.synthetic import SyntheticDataset
from obman_train_tpu_torch.native import load_imageproc_lib
from tests.test_torch_adapters import real_trees

try:  # the module as installed, before the fixture below hides it
    import cv2 as _CV2
except ImportError:
    _CV2 = None

META = {"size": 12, "img_res": 64}


@pytest.fixture(autouse=True)
def no_cv2(monkeypatch):
    """Both packages' cv2-free chain, the fallback without cv2."""
    monkeypatch.setitem(sys.modules, "cv2", None)


def _pair(split, train, device_augment, meta=META):
    kw = dict(meta=meta, train_it=train, inp_res=64, device_augment=device_augment)
    return (jfactory.get_dataset("synthetic", split, **kw),
            factory.get_dataset("synthetic", split, **kw))


def _assert_sample_equal(a, b):
    assert {str(k) for k in a} == {str(k) for k in b}
    for k, va in a.items():
        vb = b[k]
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, k
            if va.dtype.kind in "iub":
                assert np.array_equal(va, vb), k
            else:
                np.testing.assert_allclose(vb, va, rtol=0, atol=1e-6, err_msg=str(k))
        else:
            assert va == vb, k


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("device_augment", [False, True], ids=["host_jitter", "device_augment"])
def test_samples_match_jax(train, device_augment):
    jds, pds = _pair("train" if train else "val", train, device_augment)
    for epoch in (1, 2, 5):
        jds.reseed(epoch)
        pds.reseed(epoch)
        for idx in (0, 3, 11):
            a, b = jds[idx], pds[idx]
            _assert_sample_equal(a, b)
            assert ("aug_factors" in b) == (train and device_augment)
            assert b["trans_images"].dtype == np.uint8


def test_synthetic_adapter_matches_jax():
    for split in ("train", "val", "test"):
        j = JSynthetic(size=5, img_res=64, split=split)
        p = SyntheticDataset(size=5, img_res=64, split=split)
        for idx in range(5):
            assert np.array_equal(j.get_image(idx), p.get_image(idx))
            for name in ("get_joints3d", "get_verts3d", "get_joints2d", "get_camintr"):
                assert np.array_equal(getattr(j, name)(idx), getattr(p, name)(idx)), name
            assert np.array_equal(j.get_objpoints3d(idx, 100), p.get_objpoints3d(idx, 100))
            jc, js = j.get_center_scale(idx)
            pc, ps = p.get_center_scale(idx)
            assert np.array_equal(jc, pc) and js == ps
    base = [BaseQueries.images, BaseQueries.joints3d, BaseQueries.objverts3d,
            BaseQueries.camintrs, BaseQueries.segms]
    assert [str(q.value) for q in get_trans_queries(base)] == [
        str(q.value) for q in j_trans_queries([q.value for q in base])]


def _streams(device_augment):
    """Two-dataset ConcatLoaders of both packages (train + a second split)."""
    out = []
    for mod, fac in ((jloader, jfactory), (loader, factory)):
        loaders, metas = [], []
        for split in ("train", "test"):
            ds = fac.get_dataset("synthetic", split, meta=META, train_it=True, inp_res=64,
                                 device_augment=device_augment)
            loaders.append(mod.BatchLoader(ds, batch_size=4, seed=3, num_workers=2))
            metas.append(mod.loader_meta("synthetic", split))
        out.append(mod.ConcatLoader(loaders, metas))
    return out


@pytest.mark.parametrize("device_augment", [False, True], ids=["host_jitter", "device_augment"])
def test_loader_streams_match_jax_over_two_epochs(device_augment):
    jl, pl = _streams(device_augment)
    assert len(jl) == len(pl) == 6
    for _ in range(2):
        n = 0
        for a, b in zip(jl, pl):
            assert a.keys() == b.keys()
            for k, va in a.items():
                if isinstance(va, np.ndarray):
                    assert va.dtype == b[k].dtype and np.array_equal(va, b[k]), k
                else:
                    assert va == b[k], k
            assert ("aug_order" in b) == device_augment
            n += 1
        assert n == 6
    spec = loader.derive_spec(b, root=b["root"])
    assert spec.has_camintrs and spec.has_center3d and not spec.has_joints2d


def test_set_epoch_replays_the_seeded_stream():
    ds = factory.get_dataset("synthetic", "train", meta=META, train_it=True, inp_res=64,
                             device_augment=True)
    straight = loader.BatchLoader(ds, batch_size=4, seed=1, num_workers=2)
    epochs = [list(straight) for _ in range(3)]
    resumed = loader.BatchLoader(ds, batch_size=4, seed=1, num_workers=2)
    resumed.set_epoch(2)
    for a, b in zip(epochs[2], resumed):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(epochs[0][0]["images"], epochs[1][0]["images"])


def test_unported_paths_raise(monkeypatch, tmp_path):
    """Process-sliced loading is ported: with ``process_count=2`` each
    rank loads its contiguous half of every global batch, the two halves
    are the one-process batch, and a global batch that does not divide
    raises. The real datasets are ported: ``get_dataset`` loads each name
    on a fabricated tree (read here with cv2 hidden: PIL decode, the float
    chain), and an unknown name raises ``ValueError``."""
    ds = factory.get_dataset("synthetic", "train", meta=META)
    whole = next(iter(loader.BatchLoader(ds, batch_size=4, num_workers=1)))
    halves = [next(iter(loader.BatchLoader(ds, batch_size=4, num_workers=1, process_rank=r,
                                           process_count=2))) for r in range(2)]
    for k, v in whole.items():
        if v.ndim and v.shape[0] == 4:
            assert np.array_equal(np.concatenate([h[k] for h in halves]), v), k
        else:
            assert all(np.array_equal(h[k], v) for h in halves), k
    with pytest.raises(ValueError, match="divisible"):
        loader.BatchLoader(ds, batch_size=5, process_count=2)
    # the fabricators encode with cv2
    monkeypatch.setitem(sys.modules, "cv2", _CV2)
    trees = real_trees(tmp_path / "trees")
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.chdir(tmp_path)  # the adapters' annotation caches
    for name, meta in trees.items():
        split = "test" if name == "stereohands" else "train"
        ds = factory.get_dataset(name, split, meta=meta, inp_res=64)
        batch = next(iter(loader.BatchLoader(ds, batch_size=2, shuffle=False, num_workers=1)))
        assert batch["images"].shape == (2, 64, 64, 3), name
        assert np.isfinite(batch["joints3d"]).all(), name
    with pytest.raises(ValueError, match="Unrecognized dataset"):
        factory.get_dataset("coco", "train")
    assert len(factory.get_dataset("synthetic", "train", meta=META, limit_size=5)) == 5


def _affine(rng, S):
    aff, _ = T.get_affine_transform(np.array([S / 2 + 3.0, S / 2 - 5.0]), S * 0.8,
                                    (48, 40), rot=float(rng.uniform(-1, 1)))
    return aff


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_native_warp_matches_its_numpy_version(dtype):
    rng = np.random.default_rng(0)
    S = 64
    img = rng.uniform(0, 255 if dtype == np.uint8 else 1, (S, S + 7, 3)).astype(dtype)
    vmax = 255.0 if dtype == np.uint8 else 1.0
    for _ in range(3):
        aff = _affine(rng, S)
        native = T.transform_img(img, aff, (48, 40))
        plain = T.transform_img(img, aff, (48, 40), use_native=False)
        assert native.shape == plain.shape == (48, 40, 3)
        np.testing.assert_allclose(native, plain, rtol=0, atol=2e-5 * vmax)
        assert (native == 0).any() and (native > 0).any()  # black fill and content
        # the same C++ source as the JAX package's: bitwise equal
        assert np.array_equal(native, JT.transform_img(img, aff, (48, 40)))
    gray = img[..., 0]
    np.testing.assert_allclose(T.transform_img(gray, aff, (48, 40)),
                               T.transform_img(gray, aff, (48, 40), use_native=False),
                               rtol=0, atol=2e-5 * vmax)
    assert load_imageproc_lib() is load_imageproc_lib()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    from obman_train_tpu_torch.native import build

    monkeypatch.setattr(build, "_LIB_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++
    with pytest.raises(RuntimeError, match="native build failed"):
        build._build("imageproc.cpp", "libtest")


def test_host_transforms_match_jax():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (32, 30, 3)).astype(np.float32)
    for seed in range(3):
        a = JT.color_jitter(img, np.random.default_rng(seed), 0.5, 0.5, 0.5, 0.15)
        b = T.color_jitter(img, np.random.default_rng(seed), 0.5, 0.5, 0.5, 0.15)
        assert np.array_equal(a, b)
    assert np.array_equal(JT.gaussian_blur(img, 0.4), T.gaussian_blur(img, 0.4))
    pts = rng.uniform(0, 64, (21, 2))
    assert np.array_equal(JT.get_annot_center(pts), T.get_annot_center(pts))
    assert JT.get_annot_scale(pts) == T.get_annot_scale(pts)
    for rot in (0.0, 0.7):
        ja = JT.get_affine_transform([30.0, 20.0], 50.0, (64, 64), rot=rot)
        pa = T.get_affine_transform([30.0, 20.0], 50.0, (64, 64), rot=rot)
        assert all(np.array_equal(x, y) for x, y in zip(ja, pa))
        assert np.array_equal(JT.transform_coords(pts, ja[0]), T.transform_coords(pts, pa[0]))
        assert np.array_equal(JT.transform_coords(pts, ja[0], invert=True),
                              T.transform_coords(pts, pa[0], invert=True))


def test_collate_and_model_batch():
    samples = [{"a": np.ones(2), "s": "left"}, {"a": np.zeros(2), "s": "right"}]
    out = loader.collate(samples)
    assert out["a"].shape == (2, 2) and out["s"] == ["left", "right"]
    mb = loader.to_model_batch({"sides": ["left", "right"], "trans_images":
                                np.zeros((2, 4, 4, 3), np.uint8)})
    assert mb["sides"].tolist() == [1, 0] and mb["images"].dtype == np.uint8
    assert torch.from_numpy(mb["sides"]).dtype == torch.int32
