"""The port's training run (``train/loop.fit``) against the JAX package's
``fit`` on the CPU, from the same initial weights (``state_dict_from_jax``
of the JAX state), the default CLI config at 64 px, B=4, synthetic data,
2 epochs of 2 train and 2 val steps, adam at lr 1e-4, no figures. Both
packages run the cv2-free data chain (cv2 hidden from both; the uint8 cv2
chain is held bitwise in ``test_torch_data_cv2.py``), so they see the same
batches bitwise.

Tolerances, and the worst case measured when they were set:

- epoch 1 (2 updates): every logged loss within 1e-4 relative, val EPE
  within 1e-3 mm, AUC within 1e-3 (measured: 1.8e-6 relative, 7e-5 mm,
  AUC equal);
- epoch 2 (updates 3-4): the total loss within 1e-4 relative (measured
  2.9e-5); every other loss within 5e-3 relative, val EPE within 0.05 mm
  and AUC within 1e-3 (measured: 1.5e-3 on ``atlas_edge_regul``, under
  1e-4 on the rest; EPE 0.012 mm; AUC equal). From the third update adam
  turns float32 rounding differences of near-zero gradient entries into
  updates of up to ~lr that differ, and the edge regularizer of the
  decoded mesh reads them most (one step's gradients agree to 1e-3 of each
  tensor's largest entry, ``test_torch_train_step.py``).
"""

import sys

import jax
import numpy as np
import pytest
import torch

from obman_train_tpu.cli import traineval as jcli
from obman_train_tpu_torch.cli import traineval as pcli

torch.set_num_threads(2)

ARGV = ["--train_datasets", "synthetic", "--val_datasets", "synthetic",
        "--mano_assets", "synthetic", "--synthetic_size", "8", "--image_size", "64",
        "--train_batch", "4", "--test_batch", "4", "--epochs", "2", "--display_freq", "0",
        "--workers", "2"]
META = {"size": 8, "img_res": 64}


def _loaders(factory, loader):
    def make(split, train):
        ds = factory.get_dataset("synthetic", split=split, meta=META, train_it=train,
                                 inp_res=64)
        return loader.ConcatLoader(
            [loader.BatchLoader(ds, batch_size=4, shuffle=train, num_workers=2, seed=0)],
            [loader.loader_meta("synthetic", split)])
    return make("train", True), make("val", False)


def _jax_fit(exp):
    from obman_train_tpu.data import factory, loader
    from obman_train_tpu.models import build_handnet
    from obman_train_tpu.train import create_train_state, make_optimizer
    from obman_train_tpu.train.loop import _to_device, fit

    cfg = jcli.args_to_config(jcli.build_parser().parse_args(ARGV + ["--exp_id", exp]))
    net = build_handnet(cfg.model, *jcli.load_mano_pair("synthetic"))
    train_loader, val_loader = _loaders(factory, loader)
    first = next(iter(val_loader))
    tx = make_optimizer(cfg.train, steps_per_epoch=len(train_loader))
    state = create_train_state(net, tx, _to_device(first), loader.derive_spec(first), seed=0)
    variables = {"params": jax.tree_util.tree_map(np.asarray, state.params),
                 "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}
    _, metrics = fit(cfg, net, state, tx, train_loader, val_loader)
    return variables, metrics


def _port_fit(exp, variables):
    from obman_train_tpu_torch.data import factory, loader
    from obman_train_tpu_torch.models import build_handnet
    from obman_train_tpu_torch.train import create_train_state, make_optimizer
    from obman_train_tpu_torch.train.loop import fit
    from obman_train_tpu_torch.weights import state_dict_from_jax

    cfg = pcli.args_to_config(pcli.build_parser().parse_args(ARGV + ["--exp_id", exp]))
    net = build_handnet(cfg.model, *pcli.load_mano_pair("synthetic"), device="cpu")
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    train_loader, val_loader = _loaders(factory, loader)
    opt = make_optimizer(cfg.train, net)
    state = create_train_state(net, opt, cfg.train, steps_per_epoch=len(train_loader))
    _, metrics = fit(cfg, state, train_loader, val_loader)
    return metrics


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    saved = sys.modules.get("cv2", 0)
    sys.modules["cv2"] = None  # both packages' cv2-free data chain
    try:
        variables, jm = _jax_fit(str(tmp_path_factory.mktemp("jax")))
        pm = _port_fit(str(tmp_path_factory.mktemp("port")), variables)
    finally:
        if saved == 0:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved
    return jm, pm


LOSS_TOL = {1: 1e-4, 2: 5e-3}
EPE_TOL = {1: 1e-3, 2: 5e-2}


def test_fit_matches_jax_epoch_by_epoch(both):
    jm, pm = both
    assert set(pm) == set(jm)
    checked = 0
    for key, splits in jm.items():
        assert set(pm[key]) == set(splits), key
        for split, series in splits.items():
            assert set(pm[key][split]) == set(series) == {1, 2}, (key, split)
            for epoch, want in series.items():
                got = pm[key][split][epoch]
                if key in ("data_time", "batch_time"):
                    continue
                if key == "auc":
                    tol = 1e-3
                elif key.startswith("epe"):
                    tol = EPE_TOL[epoch]
                elif key == "total_loss":
                    tol = 1e-4 * abs(want)
                elif key == "lr":
                    tol = 1e-6 * want  # optax's float32 against a float
                else:
                    tol = LOSS_TOL[epoch] * max(abs(want), 1e-6)
                assert abs(got - want) <= tol, (key, split, epoch, got, want)
                checked += 1
    assert checked >= 30
    assert pm["regul_scale"]["train"] == {1: 1.0, 2: 1.0}
    # the val pass feeds the evaluator: AUC and EPE are logged
    assert {"auc", "epe_mean", "epe_median"} <= set(pm)
