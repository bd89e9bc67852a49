"""Checkpoints (the JAX package's ``train/checkpoint.py:37-175``;
reference mano_train/modelutils/modelio.py:10-105).

- ``<exp>/checkpoint.pth.tar`` always holds the latest state; every
  ``snapshot`` epochs a ``checkpoint_<N>.pth.tar`` copy is kept, and a new
  best goes to ``model_best.pth.tar``; ``opt.json`` travels beside them.
- Each file is ``torch.save({"epoch", "state_dict", "optimizer", "step",
  "regul_scale"})``. ``state_dict`` carries the reference HandNet key
  names, so the JAX package's ``import_torch_handnet`` (and
  ``cli/import_torch.py``, which take ``payload.get("state_dict",
  payload)``) read a port checkpoint unchanged.
- Strict and lax loads, eval-time weight averaging, and the reference's
  ``module.`` prefix strip and ``base_net.* -> atlas_base_net.*`` remap.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from obman_train_tpu_torch.config import ExperimentConfig
from obman_train_tpu_torch.train.steps import TrainState

CONFIG_NAME = "opt.json"
CHECKPOINT_NAME = "checkpoint.pth.tar"
BEST_NAME = "model_best.pth.tar"


def _payload(state: TrainState, epoch: int) -> Dict:
    return {
        "epoch": int(epoch),
        "state_dict": state.net.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "regul_scale": float(state.regul_scale),
    }


def save_checkpoint(
    exp_dir: str,
    state: TrainState,
    epoch: int,
    config: Optional[ExperimentConfig] = None,
    is_best: bool = False,
    snapshot: int = 0,
) -> str:
    """Write ``<exp_dir>/checkpoint.pth.tar`` (+ snapshot and best copies,
    + ``opt.json``); returns its path. The file is written under a
    temporary name and renamed, so a run cut mid-write leaves the previous
    checkpoint whole."""
    os.makedirs(exp_dir, exist_ok=True)
    path = os.path.join(exp_dir, CHECKPOINT_NAME)
    tmp = path + ".tmp"
    torch.save(_payload(state, epoch), tmp)
    os.replace(tmp, path)
    if snapshot and epoch % snapshot == 0:
        shutil.copyfile(path, os.path.join(exp_dir, f"checkpoint_{epoch}.pth.tar"))
    if is_best:
        shutil.copyfile(path, os.path.join(exp_dir, BEST_NAME))
    if config is not None:
        config.to_json(os.path.join(exp_dir, CONFIG_NAME))
    return path


def _resolve(path: str) -> str:
    """An experiment dir names its latest checkpoint."""
    if os.path.isdir(path):
        return os.path.join(path, CHECKPOINT_NAME)
    return path


def _read(path: str, device) -> Dict:
    payload = torch.load(_resolve(path), map_location=device, weights_only=True)
    if "state_dict" not in payload:  # a bare state_dict (a released model)
        payload = {"state_dict": payload}
    payload["state_dict"] = strip_module_prefix(payload["state_dict"])
    return payload


def _device(state: TrainState) -> torch.device:
    return next(state.net.parameters()).device


def load_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, int]:
    """Strict restore into ``state`` (weights, optimizer moments, update
    count, regul scale); ``path`` may be the experiment dir or a file.
    Raises ``RuntimeError``/``ValueError``/``KeyError`` on a structure
    mismatch (the CLI then falls back to :func:`load_checkpoint_lax`)."""
    payload = _read(path, _device(state))
    state.net.load_state_dict(payload["state_dict"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    state.regul_scale = float(payload["regul_scale"])
    return state, int(payload["epoch"])


def _optimizer_fits(opt_sd: Dict, optimizer: torch.optim.Optimizer) -> bool:
    """The saved optimizer state has the template's groups and, per
    parameter, tensors of its shape."""
    groups = optimizer.param_groups
    saved = opt_sd.get("param_groups", [])
    if len(saved) != len(groups) or any(
            len(s["params"]) != len(g["params"]) for s, g in zip(saved, groups)):
        return False
    params = [p for g in groups for p in g["params"]]
    ids = [i for s in saved for i in s["params"]]
    for p, i in zip(params, ids):
        for v in opt_sd.get("state", {}).get(i, {}).values():
            if torch.is_tensor(v) and v.dim() and v.shape != p.shape:
                return False
    return True


def load_checkpoint_lax(
    path: str, state: TrainState,
    remap: Optional[Callable[[Dict], Dict]] = None,
) -> Tuple[TrainState, int]:
    """Non-strict restore (reference reload.py:103-110): take every weight
    whose name and shape match the template, keep the template's elsewhere,
    and print how many were kept. The optimizer state is taken when its
    structure fits the template's, else kept fresh. ``remap`` rewrites the
    checkpoint's state_dict first (``--atlas_resume``)."""
    payload = _read(path, _device(state))
    saved = payload["state_dict"]
    if remap is not None:
        saved = remap(saved)
    template = state.net.state_dict()
    merged, kept = {}, []
    for k, v in template.items():
        if k in saved and saved[k].shape == v.shape:
            merged[k] = saved[k]
        else:
            merged[k] = v
            kept.append(k)
    state.net.load_state_dict(merged, strict=True)
    opt_sd = payload.get("optimizer")
    if opt_sd is not None and _optimizer_fits(opt_sd, state.optimizer):
        state.optimizer.load_state_dict(opt_sd)
    elif opt_sd is not None:
        kept.append("<optimizer state>")
    state.step = int(payload.get("step", 0))
    state.regul_scale = float(payload.get("regul_scale", 1.0))
    if kept:
        print(f"load_checkpoint_lax: kept {len(kept)} template entries "
              f"(first: {kept[:3]})")
    return state, int(payload.get("epoch", 0))


def load_config(exp_dir: str) -> ExperimentConfig:
    return ExperimentConfig.from_json(os.path.join(exp_dir, CONFIG_NAME))


@torch.no_grad()
def load_checkpoints_averaged(paths: Sequence[str], state: TrainState) -> Tuple[TrainState, int]:
    """Average the parameters of several checkpoints (eval-time weight
    averaging, modelio.py:10-28); buffers (BN statistics), the optimizer and
    the counters come from the first. Returns the largest epoch."""
    device = _device(state)
    payloads = [_read(p, device) for p in paths]
    first = payloads[0]
    state.net.load_state_dict(first["state_dict"], strict=True)
    state.optimizer.load_state_dict(first["optimizer"])
    state.step = int(first["step"])
    state.regul_scale = float(first["regul_scale"])
    n = float(len(payloads))
    for name, p in state.net.named_parameters():
        p.copy_(sum(pl["state_dict"][name] for pl in payloads) / n)
    return state, max(int(pl["epoch"]) for pl in payloads)


def strip_module_prefix(state_dict: Dict) -> Dict:
    """Remove DataParallel ``module.`` prefixes (modelio.py:35-41)."""
    return {re.sub(r"^module\.", "", k): v for k, v in state_dict.items()}


def remap_atlas_resume(state_dict: Dict) -> Dict:
    """``base_net.* -> atlas_base_net.*`` remap (modelio.py:47-55)."""
    out = dict(state_dict)
    for k, v in state_dict.items():
        if k.startswith("base_net."):
            out["atlas_base_net." + k[len("base_net."):]] = v
    return out
