"""Weights: JAX variables to the port's state_dict, and a seeded init.

:func:`state_dict_from_jax` is the inverse of the JAX package's torch
importers (train/checkpoint.py:200-354 ``import_torch_handnet`` and
models/resnet.py:209-284): it turns ``{"params", "batch_stats"}`` (nested
dicts of numpy arrays, as ``net.init`` gives them) into the reference torch
HandNet key names that the port's modules carry:

- conv kernels HWIO -> OIHW; Dense ``(in, out)`` -> Linear ``(out, in)``;
  PointGenCon Dense -> Conv1d ``(out, in, 1)``;
- BatchNorm ``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``;
- ``layer{s}_{b}/...`` -> ``layer{s}.{b}....``, ``downsample_conv`` /
  ``downsample_bn`` -> ``downsample.0`` / ``downsample.1``.

Nothing here imports JAX: the variables arrive as plain numpy.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping

import numpy as np
import torch
from torch import nn

_ENCODERS = ("base_net", "atlas_base_net")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _resnet_module(path: str) -> str:
    """``layer2_0/downsample_bn`` -> ``layer2.0.downsample.1``."""
    parts = path.split("/")
    if parts[0].startswith("layer"):
        stage, block = parts[0].split("_")
        rest = {"downsample_conv": "downsample.0",
                "downsample_bn": "downsample.1"}.get(parts[1], parts[1])
        return f"{stage}.{block}.{rest}"
    return parts[0]


# flax module path (under the top level) -> torch module name
_HEADS = {
    "mano_branch/pose_reg": "mano_branch.pose_reg",
    "mano_branch/shape_reg": "mano_branch.shape_reg.0",
    "mano_branch/trans_reg": "mano_branch.trans_reg",
    "atlas_branch/decode_trans/dense_0": "atlas_branch.decode_trans.0",
    "atlas_branch/decode_trans/final": "atlas_branch.decode_trans.2",
    "atlas_branch/decode_scale_hidden": "atlas_branch.decode_scale.0",
    "atlas_branch/decode_scale_out": "atlas_branch.decode_scale.2",
    "absolute_branch/dense_0": "absolute_branch.decoder.0",
    "absolute_branch/final": "absolute_branch.final_layer",
    "scaletrans_branch/dense_0": "scaletrans_branch.decoder.0",
    "scaletrans_branch/final": "scaletrans_branch.final_layer",
    "atlas_adapter": "atlas_adapter",
}


def _torch_module(path: str, base_layer_index: Callable[[int], int]) -> str:
    """Torch module name of a flax module path (without the leaf)."""
    top = path.split("/")[0]
    if top in _ENCODERS:
        return f"{top}.{_resnet_module(path[len(top) + 1:])}"
    if path in _HEADS:
        return _HEADS[path]
    if path.startswith("mano_branch/base/dense_"):
        i = int(path.rsplit("_", 1)[1])
        return f"mano_branch.base_layer.{base_layer_index(i)}"
    if path.startswith("atlas_branch/decoder/"):
        return "atlas_branch.decoder." + ".".join(path.split("/")[2:])
    raise KeyError(f"no torch counterpart for flax module {path!r}")


def state_dict_from_jax(variables: Mapping, dropout: float = 0.0) -> Dict[str, torch.Tensor]:
    """JAX HandNet variables -> the port's ``HandNet`` state_dict.

    ``dropout`` is the model's ``fc_dropout``: with dropout the reference's
    MANO MLP interleaves ``Dropout`` modules, which shifts the Linear
    indices of ``mano_branch.base_layer``.

    Gradients have the parameters' tree, so ``{"params": grads}`` converts
    JAX gradients to the port's keys and layouts the same way.
    """
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    # Linear i of the MLP: [Linear, ReLU] or [Dropout, Linear, ReLU] per layer
    base_layer_index = (lambda i: 3 * i + 1) if dropout else (lambda i: 2 * i)

    out: Dict[str, torch.Tensor] = {}
    for path, val in params.items():
        module, leaf = path.rsplit("/", 1)
        if leaf.endswith("_skeleton_reg"):
            # a bare (21, 21) param used as W[j, k], the torch weight itself
            out[f"mano_branch.{leaf}.weight"] = torch.from_numpy(val.copy())
            continue
        name = _torch_module(module, base_layer_index)
        if leaf == "kernel":
            if val.ndim == 4:      # conv HWIO -> OIHW
                w = np.transpose(val, (3, 2, 0, 1))
            elif module.startswith("atlas_branch/decoder/"):
                w = val.T[:, :, None]  # per-point Dense -> Conv1d (out, in, 1)
            else:
                w = val.T           # Dense (in, out) -> Linear (out, in)
            out[f"{name}.weight"] = torch.from_numpy(np.array(w))
        elif leaf == "scale":
            out[f"{name}.weight"] = torch.from_numpy(val.copy())
        elif leaf == "bias":
            out[f"{name}.bias"] = torch.from_numpy(val.copy())
        else:
            raise KeyError(f"unexpected flax param {path!r}")
    for path, val in stats.items():
        module, leaf = path.rsplit("/", 1)
        name = _torch_module(module, base_layer_index)
        field = {"mean": "running_mean", "var": "running_var"}[leaf]
        out[f"{name}.{field}"] = torch.from_numpy(val.copy())
        out[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return out


@torch.no_grad()
def init_weights(net: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from a seeded ``torch.Generator``, drawn on the CPU so
    a seed gives the same model on every device.

    Conv/Linear weights are LeCun-normal (the flax default), biases 0, BN
    identity with running stats (0, 1); the AtlasNet scale head's final bias
    is 1 (atlasbranch.py:61).
    """
    gen = torch.Generator().manual_seed(seed)
    for mod in net.modules():
        if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            w = torch.randn(mod.weight.shape, generator=gen) / math.sqrt(fan_in)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.reset_parameters()
    scale_head = getattr(getattr(net, "atlas_branch", None), "decode_scale", None)
    if scale_head is not None:
        scale_head[2].bias.fill_(1.0)
    return net
