"""The port's cv2 uint8 image chain and its process loader workers against
the JAX package on the CPU, with cv2 importable as it is on both machines
(the JAX package then takes its uint8 chain, ``data/dataset.py:350-416``;
``tests/test_torch_data.py`` hides cv2 and holds the float fallback).

Both packages call the same cv2 in one process, so every uint8 output is
held with tolerance 0: the chain's ops (``color_jitter_u8``,
``warp_affine_u8``, the uint8 blur, the cv2 hue of the float chain),
``HandDataset`` samples on train and val with the host jitter and with
``--device_augment``, and the loader streams over two epochs. The process
loader (``use_processes=True``, 2 spawned workers) yields the threaded
loader's batches bit for bit over two epochs.
"""

import numpy as np
import pytest

from obman_train_tpu.data import factory as jfactory
from obman_train_tpu.data import loader as jloader
from obman_train_tpu.data import transforms as JT
from obman_train_tpu_torch.data import factory, loader
from obman_train_tpu_torch.data import transforms as T

cv2 = pytest.importorskip("cv2")

META = {"size": 12, "img_res": 64}


def _image(seed, shape=(40, 44, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def test_uint8_ops_match_jax_bitwise():
    img = _image(0)
    assert T._have_cv2() and JT._have_cv2()
    for f in (0.3, 1.0, 1.7):
        for name in ("adjust_brightness_u8", "adjust_contrast_u8", "adjust_saturation_u8"):
            assert np.array_equal(getattr(T, name)(img, f), getattr(JT, name)(img, f)), name
    for f in (-0.15, 0.0, 0.07, 0.5):
        assert np.array_equal(T.adjust_hue_u8(img, f), JT.adjust_hue_u8(img, f))
        x = img.astype(np.float32) / 255.0
        assert np.array_equal(T.adjust_hue(x, f), JT.adjust_hue(x, f))  # the cv2 hue
    for seed in range(4):
        a = JT.color_jitter_u8(img, np.random.default_rng(seed), 0.5, 0.5, 0.5, 0.15)
        b = T.color_jitter_u8(img, np.random.default_rng(seed), 0.5, 0.5, 0.5, 0.15)
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
    for radius in (0.2, 0.5):
        assert np.array_equal(T.gaussian_blur(img, radius), JT.gaussian_blur(img, radius))
        x = img.astype(np.float32) / 255.0
        assert np.array_equal(T.gaussian_blur(x, radius), JT.gaussian_blur(x, radius))
    rng = np.random.default_rng(1)
    for _ in range(3):
        aff, _ = T.get_affine_transform(np.array([23.0, 18.0]), 70.0, (32, 30),
                                        rot=float(rng.uniform(-1, 1)))
        a, b = JT.warp_affine_u8(img, aff, (32, 30)), T.warp_affine_u8(img, aff, (32, 30))
        assert b.shape == (32, 30, 3) and np.array_equal(a, b)
        assert (b == 0).any() and (b > 0).any()  # black fill and content


def test_same_factor_draws_on_either_chain():
    """One seed gives the same factors and order on the uint8 and float
    chains: both leave ``rng`` in the same state."""
    img = _image(2)
    for seed in range(3):
        r8, rf = np.random.default_rng(seed), np.random.default_rng(seed)
        T.color_jitter_u8(img, r8, 0.5, 0.5, 0.5, 0.15)
        T.color_jitter(img.astype(np.float32) / 255.0, rf, 0.5, 0.5, 0.5, 0.15)
        assert r8.random() == rf.random()


def _assert_sample_equal(a, b):
    assert {str(k) for k in a} == {str(k) for k in b}
    for k, va in a.items():
        vb = b[k]
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, k
            assert np.array_equal(va, vb), k
        else:
            assert va == vb, k


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("device_augment", [False, True], ids=["host_jitter", "device_augment"])
def test_samples_match_jax_with_cv2(train, device_augment):
    kw = dict(meta=META, train_it=train, inp_res=64, device_augment=device_augment)
    split = "train" if train else "val"
    jds = jfactory.get_dataset("synthetic", split, **kw)
    pds = factory.get_dataset("synthetic", split, **kw)
    for epoch in (1, 2, 5):
        jds.reseed(epoch)
        pds.reseed(epoch)
        for idx in (0, 3, 11):
            a, b = jds[idx], pds[idx]
            _assert_sample_equal(a, b)
            assert b["trans_images"].dtype == np.uint8
            assert ("aug_factors" in b) == (train and device_augment)


@pytest.mark.parametrize("emit_uint8", [True, False], ids=["uint8", "float"])
def test_uint8_chain_outputs(emit_uint8):
    """Without ``emit_uint8`` the uint8 warp goes out as x/255 - 0.5, as in
    the JAX package; the float chain (nearest resample) stays float."""
    kw = dict(meta=META, train_it=True, inp_res=64)
    jds = jfactory.get_dataset("synthetic", "train", **kw)
    pds = factory.get_dataset("synthetic", "train", **kw)
    for ds in (jds, pds):
        ds.emit_uint8 = emit_uint8
    a, b = jds[4], pds[4]
    _assert_sample_equal(a, b)
    img = b["trans_images"]
    if emit_uint8:
        assert img.dtype == np.uint8
    else:
        assert img.dtype == np.float32 and img.min() >= -0.5 and img.max() <= 0.5
    for ds in (jds, pds):
        ds.resample = "nearest"
    _assert_sample_equal(jds[4], pds[4])


@pytest.mark.parametrize("device_augment", [False, True], ids=["host_jitter", "device_augment"])
def test_loader_streams_match_jax_with_cv2(device_augment):
    streams = []
    for mod, fac in ((jloader, jfactory), (loader, factory)):
        ds = fac.get_dataset("synthetic", "train", meta=META, train_it=True, inp_res=64,
                             device_augment=device_augment)
        streams.append(mod.BatchLoader(ds, batch_size=4, seed=3, num_workers=2))
    for _ in range(2):
        n = 0
        for a, b in zip(*streams):
            assert a.keys() == b.keys()
            assert all(np.array_equal(v, b[k]) for k, v in a.items())
            n += 1
        assert n == 3


@pytest.mark.parametrize("device_augment", [False, True], ids=["host_jitter", "device_augment"])
def test_process_loader_matches_threads_over_two_epochs(device_augment):
    def make(use_processes):
        ds = factory.get_dataset("synthetic", "train", meta=META, train_it=True, inp_res=64,
                                 device_augment=device_augment)
        return loader.BatchLoader(ds, batch_size=4, seed=3, num_workers=2,
                                  use_processes=use_processes)

    threads, procs = make(False), make(True)
    try:
        for _ in range(2):
            n = 0
            for a, b in zip(threads, procs):
                assert a.keys() == b.keys()
                for k, v in a.items():
                    assert v.dtype == b[k].dtype and np.array_equal(v, b[k]), k
                n += 1
            assert n == 3
        pool = procs._pool
        assert pool is not None and len(pool._processes) == 2
    finally:
        procs.close()
    assert procs._pool is None
    procs.close()  # a second close is a no-op
