"""The port's device-side colour jitter (``ops/image.py``) and HandNet's
``aug_factors`` branch against the JAX package's on the CPU.

- ``batched_color_jitter`` and each ``adjust_*_batch`` on random images and
  factors, for several of the 24 orders: 1e-5 (float32, [0, 1] images).
- A HandNet forward with ``aug_factors``/``aug_order`` against JAX's on the
  same weights: outputs and losses to 1e-4 (relative for the losses); the
  factors change the output, and neutral factors equal no jitter.

The reference for the jitter is the JAX operations composed one by one.
Compiled as one program on the CPU (``lax.switch`` compiles each branch,
HandNet is jitted), XLA fuses the operation before the hue shift into it
and may round the recomputed channels differently in the ``r == max``
tests, so where hue is not the first operation the JAX output can leave
its own operations' semantics at some pixels (0.87 at a pixel of order 0
here). Where hue comes first (orders 12-17) the compiled JAX jitter is
exact, and those orders hold the port against it directly.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from obman_train_tpu.models import BatchSpec as JSpec
from obman_train_tpu.ops import image as jimage
from obman_train_tpu_torch import train
from obman_train_tpu_torch.config import TrainConfig
from obman_train_tpu_torch.models import BatchSpec
from obman_train_tpu_torch.ops import image
from tests.test_torch_losses import loss_pair

torch.set_num_threads(2)


def _images_and_factors(seed, B=3, S=16):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    imgs[0, :2] = 0.5   # gray pixels: zero saturation, hue undefined
    imgs[1, :1] = 0.0   # black pixels
    factors = np.stack([rng.uniform(0.5, 1.5, B), rng.uniform(0.5, 1.5, B),
                        rng.uniform(-0.15, 0.15, B), rng.uniform(0.5, 1.5, B)],
                       axis=1).astype(np.float32)
    return imgs, factors


@pytest.mark.parametrize("order", [0, 5, 11, 12, 17, 23])
def test_batched_color_jitter_matches_jax(order):
    imgs, factors = _images_and_factors(order)
    perm = list(itertools.permutations(range(4)))[order]
    want = imgs
    for op_i in perm:  # the JAX operations one by one
        want = np.asarray(jimage._JITTER_OPS[op_i](want, factors[:, op_i]))
    got = image.batched_color_jitter(torch.from_numpy(imgs), torch.from_numpy(factors),
                                     torch.tensor(order, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if perm[0] == 2:  # hue first
        compiled = np.asarray(jax.jit(jimage.batched_color_jitter)(
            imgs, factors, jnp.asarray(order, jnp.int32)))
        np.testing.assert_allclose(got.numpy(), compiled, rtol=0, atol=1e-5)


def test_each_jitter_op_matches_jax():
    imgs, factors = _images_and_factors(9)
    t_imgs = torch.from_numpy(imgs)
    for i, name in enumerate(("adjust_brightness_batch", "adjust_saturation_batch",
                              "adjust_hue_batch", "adjust_contrast_batch")):
        want = np.asarray(getattr(jimage, name)(imgs, factors[:, i]))
        got = getattr(image, name)(t_imgs, torch.from_numpy(factors[:, i]))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5, err_msg=name)
    assert image.PERMUTATIONS[23] == (3, 2, 1, 0) and len(image.PERMUTATIONS) == 24
    with pytest.raises(ValueError, match="aug_order"):
        image.batched_color_jitter(t_imgs, torch.from_numpy(factors), 24)


@pytest.fixture(scope="module")
def augmented():
    jnet, variables, pnet, batch = loss_pair({}, 2, 64, 3, uint8=True)
    rng = np.random.default_rng(3)
    batch["aug_factors"] = np.stack(
        [rng.uniform(0.5, 1.5, 2), rng.uniform(0.5, 1.5, 2), rng.uniform(-0.15, 0.15, 2),
         rng.uniform(0.5, 1.5, 2)], axis=1).astype(np.float32)
    batch["aug_order"] = np.asarray(13, np.int32)  # hue first: see the docstring
    return jnet, variables, pnet, batch


def _port(pnet, batch):
    with torch.no_grad():
        return pnet({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
                    BatchSpec())


def test_handnet_forward_with_aug_factors_matches_jax(augmented):
    jnet, variables, pnet, batch = augmented
    apply = jax.jit(lambda v, b: jnet.apply(v, b, JSpec(),
                                            rngs={"points": jax.random.PRNGKey(0)}))
    jtotal, jres, jl = apply(variables, batch)
    ttotal, tres, tl = _port(pnet, batch)
    for key in ("verts", "joints", "objpoints3d"):
        np.testing.assert_allclose(tres[key].numpy(), np.asarray(jres[key]), rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(jres[key]).max())),
                                   err_msg=key)
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    # the branch is live: without the factors the output differs
    plain = {k: v for k, v in batch.items() if not k.startswith("aug_")}
    _, pres, _ = _port(pnet, plain)
    assert not torch.allclose(pres["verts"], tres["verts"])
    # neutral factors leave the image as it was
    neutral = dict(batch, aug_factors=np.tile(np.float32([1, 1, 0, 1]), (2, 1)))
    _, nres, _ = _port(pnet, neutral)
    torch.testing.assert_close(nres["verts"], pres["verts"], rtol=0, atol=1e-4)


def test_train_step_keeps_the_order_on_the_host(augmented):
    _, _, pnet, batch = augmented
    opt = train.make_optimizer(TrainConfig(optimizer="sgd", lr=0.0), pnet)
    state = train.create_train_state(pnet, opt, TrainConfig(optimizer="sgd", lr=0.0))
    step = train.make_train_step(pnet, opt, BatchSpec(), device="cpu", return_joints=True)
    state, losses, joints = step(state, batch)
    assert joints.shape == (2, 21, 3) and not joints.requires_grad
    _, res, want = _port(pnet, batch)
    torch.testing.assert_close(joints, res["joints"])
    assert float(losses["total_loss"]) == float(want["total_loss"])
