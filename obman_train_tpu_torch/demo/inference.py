"""The demos' model: checkpoint reload and the single- and dual-frame
forward (the JAX package's ``demo/inference.py:23-205``; reference
``reload_model`` + ``forward_pass_3d``, mano_train/netscripts/
reload.py:35-111, image_demo.py:20-32).

Branch gating is static config, so no dummy GT switches branches on (the
reference passes ones() joints/objpoints for that). A raw uint8 frame goes
to the device and is cropped, resized, flipped and normalised there
(``ops/image.preprocess_frames``); the flipped and unflipped frames of
image_demo run as one batch of 2.

The demo path leaves out the contact block: it returns the JAX package's
keys (:95-99), none of which the block computes, and the JAX package's
jitted program drops the block as dead code. So a contact-config model
serves without launching the ray-parity or nearest-neighbour kernels.

Transfers: a call makes one host-to-device copy of its inputs
(:func:`to_device`) and one device-to-host copy of its outputs
(:class:`HostCopy`), the counterparts of the JAX package's one
``device_put`` and one ``device_get``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from obman_train_tpu_torch.config import ExperimentConfig
from obman_train_tpu_torch.device import DeviceLike, resolve_device
from obman_train_tpu_torch.models import resnet_fold
from obman_train_tpu_torch.models.handnet import INFER_SPEC, HandNet
from obman_train_tpu_torch.ops.image import preprocess_frames
from obman_train_tpu_torch.utils.tracing import span

# what the demo path returns (JAX demo/inference.py:95-99)
DEMO_KEYS = ("verts", "joints", "objpoints3d", "objtrans", "objscale", "joints2d")


class ServeNet(nn.Module):
    """``(frames_u8 (B, H, W, 3), sides (B,), flip (B,)) -> outputs``:
    preprocessing, encoder, MANO, atlas (+ trans/scale, + ``joints2d``
    where the config has them). The program that ``demo.export`` traces.

    On the card each encoder (``base_net``, and ``atlas_base_net`` where
    the config has a separate object encoder) runs with its frozen
    BatchNorms folded into its convolutions (:meth:`encode`)."""

    def __init__(self, net: HandNet, image_size: int):
        super().__init__()
        self.net = net
        self.image_size = int(image_size)
        # encoder module -> (sources, their keys, resnet_fold.Folded) of its last fold
        self._folds: Dict[nn.Module, tuple] = {}

    def forward(self, frames_u8, sides, flip) -> Dict[str, torch.Tensor]:
        with span("serve.preprocess"):
            images = preprocess_frames(frames_u8.to(torch.float32), size=self.image_size,
                                       flip=flip)
        _, results, _ = self.net(
            {"images": images, "sides": sides}, INFER_SPEC, no_loss=True,
            force_objects=True, force_hand=True, contact=False, encoder=self.encode,
        )
        return {k: results[k] for k in DEMO_KEYS if k in results}

    def encode(self, net: nn.Module, image: torch.Tensor):
        """The encoder ``net``'s ``(features, None)`` of the NCHW images
        (``HandNet.forward``'s ``encoder`` hook). Folded and run by cuDNN's
        fused convolution epilogue (``models/resnet_fold``) when the images
        are a CUDA float32 tensor, the encoder computes in its parameters'
        dtype and is in ``eval()``, autograd does not record and nothing is
        being compiled (``demo.export``'s trace keeps ``ResNet.forward``);
        else ``ResNet.forward``."""
        if not (image.is_cuda and image.dtype == torch.float32
                and net.conv1.compute_dtype is None and not net.training
                and not torch.is_grad_enabled() and not torch.compiler.is_compiling()):
            return net(image)
        return resnet_fold.features(self._folded(net), image)

    def _folded(self, net: nn.Module) -> "resnet_fold.Folded":
        """The fold of ``net``'s tensors as they are now, kept per encoder
        and made again only when one of its tensors is another tensor (a
        checkpoint assigned, ``functional_call``'s variables), was written
        in place (its version: ``load_state_dict``, an optimizer step) or
        holds other memory (a ``.data`` swap keeps the version). An
        inference tensor has no version: a source that is one folds at
        every call. Made outside inference mode, so the cache holds no
        inference tensor. The ``serve.fold`` span names the encoder."""
        src = resnet_fold.sources(net)
        keys = [None if t.is_inference() else (t._version, t.data_ptr()) for t in src]
        cached = self._folds.get(net)
        if (cached is None or None in keys or cached[1] != keys
                or any(a is not b for a, b in zip(cached[0], src))):
            name = next((n for n, m in self.net.named_children() if m is net), None)
            with span("serve.fold", name), torch.inference_mode(False), torch.no_grad():
                cached = self._folds[net] = (src, keys, resnet_fold.fold(net))
        return cached[2]


def to_device(device: torch.device, *arrays: np.ndarray):
    """numpy arrays -> tensors on ``device``. On CUDA their bytes are packed
    into one pinned buffer, copied once without blocking, and viewed back
    in their dtypes and shapes on the device (each at an 8-byte offset)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    if device.type != "cuda":
        return tuple(torch.tensor(a, device=device) for a in arrays)
    offsets, n = [], 0
    for a in arrays:
        n = -(-n // 8) * 8
        offsets.append(n)
        n += a.nbytes
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    flat = host.numpy()
    for a, o in zip(arrays, offsets):
        flat[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    dev = host.to(device, non_blocking=True)
    return tuple(
        dev[o:o + a.nbytes].view(torch.from_numpy(a[:0]).dtype).view(a.shape)
        for a, o in zip(arrays, offsets))


def _host_dtype(dtype: torch.dtype) -> torch.dtype:
    # numpy has no bfloat16: a bf16 output (a bf16 net's object points)
    # reaches the host as float32, which holds its values exactly
    return torch.float32 if dtype == torch.bfloat16 else dtype


class HostCopy:
    """A dict of output tensors copied to the host without blocking: on
    CUDA they are flattened into one float32 buffer on the device, copied
    in one go into pinned memory, and an event is recorded after the copy;
    :meth:`get` waits on that event and returns numpy arrays (bf16 ones as
    float32)."""

    def __init__(self, out: Dict[str, torch.Tensor]):
        self.meta = [(k, tuple(v.shape), _host_dtype(v.dtype)) for k, v in out.items()]
        self.event = None
        if any(v.is_cuda for v in out.values()):
            with span("serve.copy_pack"):
                packed = torch.cat([v.detach().reshape(-1).to(torch.float32)
                                    for v in out.values()])
                self.host = torch.empty(packed.shape, dtype=torch.float32, pin_memory=True)
                self.host.copy_(packed, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record()
        else:
            self.out = {k: v.detach().to(_host_dtype(v.dtype)) for k, v in out.items()}

    def get(self) -> Dict[str, np.ndarray]:
        if self.event is None:
            return {k: v.numpy() for k, v in self.out.items()}
        with span("serve.copy_wait"):
            self.event.synchronize()
        flat, res, i = self.host.numpy(), {}, 0
        for k, shape, dtype in self.meta:
            n = int(np.prod(shape))
            res[k] = flat[i:i + n].reshape(shape).astype(
                torch.empty((), dtype=dtype).numpy().dtype, copy=False)
            i += n
        return res


class DemoModel:
    """The demos' model, from an experiment directory or a config.

    ``image_size=None`` runs at the experiment's ``config.model.image_size``
    (the resolution the checkpoint was trained at); an int overrides it.
    ``device``: CUDA unless the caller passes ``"cpu"`` (raises without a
    GPU). Without a checkpoint the weights are the seeded init
    (``weights.init_weights`` at ``config.train.manual_seed``) and the
    epoch is 0.
    """

    def __init__(
        self,
        exp_dir: Optional[str] = None,
        config: Optional[ExperimentConfig] = None,
        mano_assets: Optional[str] = None,
        image_size: Optional[int] = None,
        device: DeviceLike = None,
    ):
        from obman_train_tpu_torch.cli.traineval import load_mano_pair
        from obman_train_tpu_torch.models import build_handnet
        from obman_train_tpu_torch.train import create_train_state, make_optimizer
        from obman_train_tpu_torch.train.checkpoint import (
            CHECKPOINT_NAME,
            load_checkpoint,
            load_config,
        )
        from obman_train_tpu_torch.weights import init_weights

        if config is None:
            if exp_dir is None:
                raise ValueError("DemoModel needs exp_dir or config")
            config = load_config(exp_dir)
        self.cfg = config
        self.image_size = int(config.model.image_size if image_size is None else image_size)
        self.device = resolve_device(device)
        right, left = load_mano_pair(mano_assets or config.mano_assets)
        net = build_handnet(config.model, right, left, device="cpu")
        self.net = init_weights(net, seed=config.train.manual_seed).to(self.device)
        self.epoch = 0
        if exp_dir is not None and os.path.exists(os.path.join(exp_dir, CHECKPOINT_NAME)):
            state = create_train_state(self.net, make_optimizer(config.train, self.net),
                                       config.train)
            _, self.epoch = load_checkpoint(exp_dir, state)
        self._serve = ServeNet(self.net, self.image_size).eval()
        # the live parameters and buffers: _infer is a function of them, as
        # the JAX package's jitted infer is of its variables
        self._variables = self._serve.state_dict(keep_vars=True)
        self.hand_faces = np.asarray(right.faces)
        self.obj_faces = self.net.ico_faces_np

    def _infer(self, variables, frames_u8, sides, flip) -> Dict[str, torch.Tensor]:
        """Device tensors in, device tensors out (the outputs of DEMO_KEYS
        that the config computes)."""
        with span("serve.infer"), torch.inference_mode():
            if variables is self._variables:  # the live weights: no reparametrisation
                return self._serve(frames_u8, sides, flip)
            return torch.func.functional_call(self._serve, variables, (frames_u8, sides, flip))

    def predict(self, frame: np.ndarray, hand_side: str = "left", flip: bool = False):
        """One (H, W, 3) uint8 frame -> the outputs as numpy, batch axis 1."""
        if np.ndim(frame) != 3:
            raise ValueError(
                f"predict takes ONE (H, W, 3) frame, got shape {np.shape(frame)}; for "
                "batches call predict_dual per frame or model._infer directly")
        frames, sides, flips = to_device(
            self.device, frame[None], np.asarray([0 if hand_side == "right" else 1], np.int32),
            np.asarray([flip], bool))
        return HostCopy(self._infer(self._variables, frames, sides, flips)).get()

    def predict_dual(self, frame: np.ndarray, hand_side: str = "left"):
        """The image_demo path: the frame and its mirror image (taken as the
        other side) in one batch of 2."""
        side_idx = 0 if hand_side == "right" else 1
        frames, sides, flips = to_device(
            self.device, np.stack([frame, frame]),
            np.asarray([side_idx, 1 - side_idx], np.int32), np.asarray([False, True]))
        return HostCopy(self._infer(self._variables, frames, sides, flips)).get()

    def attention_maps(self, frames: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 frames -> (B, size, size) attention in [0, 1]
        (the webcam demo's activation heat maps, webcam_demo.py:90-131)."""
        from obman_train_tpu_torch.demo.attention import stage_attention

        (frames_t,) = to_device(self.device, frames)
        with torch.inference_mode():
            images = preprocess_frames(frames_t.to(torch.float32), size=self.image_size)
            _, inters = self.net.base_net(images.permute(0, 3, 1, 2), return_inter=True)
            return stage_attention(inters, (self.image_size, self.image_size))
