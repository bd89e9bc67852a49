"""Plain float32 training reference of the separate-encoder ResNet-50
hand-object network with the contact losses (Hasson et al., CVPR 2019,
arXiv:1904.05767, §3 and §3.3; the release's ``--atlas_separate_encoder
--resnet_version 50 --mano_use_shape`` trained with ``--contact_lambda
--collision_lambda``): the forward of ``reference/handnet_sep.py`` (two
ResNet-50 encoders, the shape blend, the 2051-wide point decoder and the
heads), the branch, contact and collision losses of
``reference/handnet.py``, and the shape term.

Plain ``torch``, float32, run with TF32 off by the checks; it imports
nothing of the program under test. Departures from the published
description, besides ``handnet_sep.py``'s:

- the shape term is ``lambda_shape * mean(betas ** 2)``, the release's
  ``mse(shape, zeros)`` (manobranch.py), which the paper does not write
  out;
- each encoder runs over the batch in blocks of ``block`` samples, each
  block under ``torch.utils.checkpoint``, so that the backward keeps one
  block's activations at a time. With frozen BatchNorm (running
  statistics) an encoder is a function of each sample alone, so the
  blocks change no value, only what is kept for the backward; the losses
  then run on the whole batch, so every mean (the penetration mean's count
  among them) is the batch's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import handnet, handnet_sep

# the terms compared: the ResNet-18 reference's and the shape term
LOSS_TERMS = handnet.LOSS_TERMS + ("mano_shape",)
CONTINUOUS_TERMS = tuple(k for k in LOSS_TERMS if k != "penetration_loss")
ENCODER_BLOCK = 32  # samples a checkpointed block of an encoder

param_specs = handnet_sep.param_specs
trainable = handnet.trainable
normalize = handnet.normalize


class Model(handnet_sep.Model):
    """``handnet_sep.Model`` with blocked encoders, the predicted betas in
    its outputs (``shape``) and the training losses."""

    def __init__(self, cfg: Dict, mano_files: Dict[str, str], device: str,
                 block: Optional[int] = ENCODER_BLOCK):
        super().__init__(cfg, mano_files, device)
        self.block = block
        self._betas = None

    def encode(self, p, x: torch.Tensor, prefix: str = "base_net") -> torch.Tensor:
        plain = super().encode
        if not self.block or x.shape[0] <= self.block:
            return plain(p, x, prefix)
        return torch.cat([checkpoint(plain, p, x[i:i + self.block], prefix, use_reentrant=False)
                          for i in range(0, x.shape[0], self.block)])

    def mano_forward(self, t, pose, betas=None):
        self._betas = betas  # both sides get the same betas
        return super().mano_forward(t, pose, betas)

    def forward(self, p, images, sides):
        out = super().forward(p, images, sides)
        out["shape"], self._betas = self._betas, None
        return out

    def losses(self, out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]) -> Dict:
        L = super().losses(out, batch)
        m = self.cfg["mano"]
        if m["lambda_shape"] and out["shape"] is not None:
            L["mano_shape"] = (out["shape"] ** 2).mean()
            L["total_loss"] = L["total_loss"] + m["lambda_shape"] * L["mano_shape"]
        return L
