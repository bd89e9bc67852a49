"""The demo preprocessing of the port against the JAX package's, on the CPU.

- ``ops/image.preprocess_frames`` against JAX's on seeded uint8 frames when
  it shrinks, enlarges and keeps the size, with and without the per-sample
  flip and BGR: to 1e-3 on the 0-255 scale (measured: 7.6e-5). The resize
  must antialias as ``jax.image.resize`` does; without it the difference
  reaches ~100.
- ``center_crop_square``, ``normalize_frames``, ``bgr_to_rgb`` and
  ``flip_horizontal`` exactly.
- ``affine_warp`` against JAX's (1e-4) and against the port's host warp
  ``data/transforms.transform_img`` (2e-2, the JAX test's bound).
- ``demo/preprocess.py`` (host numpy) against JAX's: ``squarify``,
  ``prepare_input`` exactly, ``preprocess_frame`` to 1 grey level.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obman_train_tpu.data import transforms as jtransforms
from obman_train_tpu.demo import preprocess as jpre
from obman_train_tpu.ops import image as jimage
from obman_train_tpu_torch.data import transforms as ptransforms
from obman_train_tpu_torch.demo import preprocess as ppre
from obman_train_tpu_torch.ops import image as pimage

torch.set_num_threads(2)


def _frames(seed, B, H, W):
    return np.random.default_rng(seed).integers(0, 256, (B, H, W, 3)).astype(np.uint8)


@pytest.mark.parametrize("H,W,size", [
    (100, 140, 64),   # crop + shrink
    (120, 90, 64),    # portrait crop + shrink
    (48, 64, 128),    # crop + enlarge
    (64, 64, 64),     # same size
])
@pytest.mark.parametrize("flip,bgr", [(False, False), (True, False), (True, True)])
def test_preprocess_frames_matches_jax(H, W, size, flip, bgr):
    frames = _frames(H + W, 3, H, W)
    mask = np.array([True, False, True]) if flip else None
    want = np.asarray(jimage.preprocess_frames(
        jnp.asarray(frames, jnp.float32), size=size,
        flip=None if mask is None else jnp.asarray(mask), bgr=bgr))
    got = pimage.preprocess_frames(
        torch.from_numpy(frames).to(torch.float32), size=size,
        flip=None if mask is None else torch.from_numpy(mask), bgr=bgr).numpy()
    assert got.shape == want.shape == (3, size, size, 3) and got.dtype == np.float32
    np.testing.assert_allclose((got + 0.5) * 255, (want + 0.5) * 255, rtol=0, atol=1e-3)
    assert got.min() >= -0.5 and got.max() <= 0.5


def test_resize_needs_antialias_when_shrinking():
    """What ``antialias=True`` buys: at 480 -> 256 the plain bilinear
    resize is far from JAX's."""
    frames = _frames(7, 1, 480, 480).astype(np.float32)
    want = np.asarray(jimage.resize_bilinear(jnp.asarray(frames), 256))
    got = pimage.resize_bilinear(torch.from_numpy(frames), 256).numpy()
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(frames).permute(0, 3, 1, 2), size=(256, 256), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() < 1e-3
    assert np.abs(plain - want).max() > 10


def test_crop_normalize_bgr_flip_exact():
    frames = _frames(1, 2, 100, 140)
    t = torch.from_numpy(frames)
    np.testing.assert_array_equal(pimage.center_crop_square(t).numpy(), frames[:, :, 20:120])
    np.testing.assert_array_equal(pimage.center_crop_square(t).numpy(),
                                  np.asarray(jimage.center_crop_square(jnp.asarray(frames))))
    np.testing.assert_array_equal(pimage.normalize_frames(t).numpy(),
                                  np.asarray(jimage.normalize_frames(jnp.asarray(frames))))
    np.testing.assert_array_equal(pimage.normalize_frames(t).numpy(),
                                  frames.astype(np.float32) / 255 - 0.5)
    np.testing.assert_array_equal(pimage.bgr_to_rgb(t).numpy(), frames[..., ::-1])
    mask = np.array([True, False])
    got = pimage.flip_horizontal(t, torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got[0], frames[0, :, ::-1])
    np.testing.assert_array_equal(got[1], frames[1])
    np.testing.assert_array_equal(got, np.asarray(
        jimage.flip_horizontal(jnp.asarray(frames), jnp.asarray(mask))))


def _affines(seed, B, res):
    rng = np.random.default_rng(seed)
    return np.stack([
        jtransforms.get_affine_transform(
            rng.uniform(30, 50, 2), rng.uniform(40, 80), (res, res),
            rot=rng.uniform(-np.pi, np.pi))[0]
        for _ in range(B)])


@pytest.mark.parametrize("C", [3, 1])
def test_affine_warp_matches_jax_and_host_warp(C):
    rng = np.random.default_rng(C)
    images = rng.random((3, 80, 72, C)).astype(np.float32)
    aff = _affines(C, 3, 64)
    want = np.asarray(jimage.affine_warp(jnp.asarray(images), jnp.asarray(aff), 64))
    got = pimage.affine_warp(torch.from_numpy(images), torch.from_numpy(aff), 64).numpy()
    assert got.shape == (3, 64, 64, C)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for i in range(3):
        host = ptransforms.transform_img(images[i], aff[i], (64, 64))
        np.testing.assert_allclose(got[i], host.reshape(got[i].shape), rtol=0, atol=2e-2)
    assert (got == 0).any()  # some taps fall outside the image


@pytest.fixture
def no_cv2(monkeypatch):
    """The JAX package takes cv2's resize when it imports; the port has the
    host warp only."""
    monkeypatch.setitem(sys.modules, "cv2", None)


def test_host_preprocess_matches_jax(no_cv2):
    frame = _frames(3, 1, 90, 130)[0]
    np.testing.assert_array_equal(ppre.squarify(frame), jpre.squarify(frame))
    got, want = ppre.preprocess_frame(frame, 64), jpre.preprocess_frame(frame, 64)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (64, 64, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    for flip in (False, True):
        for bgr in (False, True):
            np.testing.assert_array_equal(
                ppre.prepare_input(frame, flip_left_right=flip, bgr=bgr),
                jpre.prepare_input(frame, flip_left_right=flip, bgr=bgr))
