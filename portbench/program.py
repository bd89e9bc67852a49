"""The system under test, as the drivers build it: the port's own entry
points (``models.build_handnet``, ``train.make_optimizer``,
``train.make_train_step``, ``demo.DemoModel``), fed the benchmark's
weights, MANO files and inputs. Nothing else of the port is taken."""

from __future__ import annotations

import json
from typing import Dict, Tuple

import torch

from obman_train_tpu_torch.assets import load_mano_assets
from obman_train_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from obman_train_tpu_torch.models import build_handnet


def model_config(config: Dict, **override) -> ModelConfig:
    cfg = ModelConfig.from_json(json.dumps(config["model"]))
    return cfg.replace(**override) if override else cfg


def train_config(config: Dict) -> TrainConfig:
    return TrainConfig.from_json(json.dumps(config["train"]))


def mano_pair(mano_dir: str):
    return load_mano_assets(mano_dir, "right"), load_mano_assets(mano_dir, "left")


def handnet(cfg: ModelConfig, mano_dir: str, weights: Dict[str, torch.Tensor], device: str):
    net = build_handnet(cfg, *mano_pair(mano_dir), device=device)
    net.load_state_dict(weights, strict=True)
    return net


def train_state(net, config: Dict):
    from obman_train_tpu_torch.train import create_train_state, make_optimizer

    tcfg = train_config(config)
    opt = make_optimizer(tcfg, net)
    return create_train_state(net, opt, tcfg), opt


def adam_first_gradient(opt: torch.optim.Optimizer, names: Dict[int, str]) -> Dict[str, torch.Tensor]:
    """The gradient the optimizer got at its first update, from its state:
    Adam's first moment after one update from zero is (1 - beta1) g."""
    out = {}
    for group in opt.param_groups:
        beta1 = group["betas"][0]
        for p in group["params"]:
            st = opt.state.get(p, {})
            if "exp_avg" in st:
                out[names[id(p)]] = (st["exp_avg"] / (1.0 - beta1)).detach().cpu()
    return out


def param_names(net) -> Dict[int, str]:
    return {id(p): n for n, p in net.named_parameters()}


def demo_model(config: Dict, mano_dir: str, weights: Dict[str, torch.Tensor], device: str,
               **override) -> Tuple[object, int]:
    from obman_train_tpu_torch.demo import DemoModel

    exp = ExperimentConfig(model=model_config(config, **override), mano_assets=mano_dir)
    model = DemoModel(config=exp, device=device)
    model.net.load_state_dict(weights, strict=True)
    return model, exp.model.image_size
