"""The port's training run (``train/loop.fit``) against the JAX package's
``fit`` on the CPU, from the same initial weights (``state_dict_from_jax``
of the JAX state), the default CLI config at 64 px, B=4, synthetic data,
2 epochs of 2 train and 2 val steps, adam at lr 1e-5, no figures. Both
packages run the cv2-free data chain (cv2 hidden from both; the uint8 cv2
chain is held bitwise in ``test_torch_data_cv2.py``), so they see the same
batches bitwise.

Tolerances, both epochs: every logged loss within 1e-4 relative, val EPE
within 1e-3 mm, AUC within 1e-3. Measured (one AVX-512 host): worst 2.0e-6
relative and 3.5e-5 mm, AUC equal; with the port's CPU kernels held to
AVX2 (``ATEN_CPU_CAPABILITY=avx2 ONEDNN_MAX_CPU_ISA=AVX2``, as on a host
without AVX-512) 2.9e-5 relative and 1.1e-4 mm.

Why lr 1e-5 and not the CLI's 1e-4: at 1e-4 the four adam updates turn
float32 rounding differences into different weights fast enough that the
comparison hinges on which CPU kernels each package runs. There the
measured gap was 1.5e-3 relative at epoch 2 (``atlas_edge_regul``) on the
AVX-512 kernels, but 7.3e-4 at epoch 1 and 0.059 mm of val EPE at epoch 2
on the AVX2 kernels, over tolerances of 1e-4 and 0.05 mm that then held
epoch 2 only to 5e-3. ``test_torch_train_step.py`` holds one step to JAX;
what this file checks is the loop's parity, at a rate where rounding stays
rounding. The run still trains (the train loss falls from epoch 1 to 2).

``python -m tests.test_torch_fit [--lr 1e-4]`` prints each metric's gap
against its tolerance, worst first (the figures above, with and without
the two variables).
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
        "--workers", "2", "--lr", "1e-5"]
META = {"size": 8, "img_res": 64}


def _loaders(factory, loader):
    def make(split, train):
        ds = factory.get_dataset("synthetic", split=split, meta=META, train_it=train,
                                 inp_res=64)
        return loader.ConcatLoader(
            [loader.BatchLoader(ds, batch_size=4, shuffle=train, num_workers=2, seed=0)],
            [loader.loader_meta("synthetic", split)])
    return make("train", True), make("val", False)


def _jax_fit(exp, argv):
    from obman_train_tpu.data import factory, loader
    from obman_train_tpu.models import build_handnet
    from obman_train_tpu.train import create_train_state, make_optimizer
    from obman_train_tpu.train.loop import _to_device, fit

    cfg = jcli.args_to_config(jcli.build_parser().parse_args(argv + ["--exp_id", exp]))
    net = build_handnet(cfg.model, *jcli.load_mano_pair("synthetic"))
    train_loader, val_loader = _loaders(factory, loader)
    first = next(iter(val_loader))
    tx = make_optimizer(cfg.train, steps_per_epoch=len(train_loader))
    state = create_train_state(net, tx, _to_device(first), loader.derive_spec(first), seed=0)
    variables = {"params": jax.tree_util.tree_map(np.asarray, state.params),
                 "batch_stats": jax.tree_util.tree_map(np.asarray, state.batch_stats)}
    _, metrics = fit(cfg, net, state, tx, train_loader, val_loader)
    return variables, metrics


def _port_fit(exp, variables, argv):
    from obman_train_tpu_torch.data import factory, loader
    from obman_train_tpu_torch.models import build_handnet
    from obman_train_tpu_torch.train import create_train_state, make_optimizer
    from obman_train_tpu_torch.train.loop import fit
    from obman_train_tpu_torch.weights import state_dict_from_jax

    cfg = pcli.args_to_config(pcli.build_parser().parse_args(argv + ["--exp_id", exp]))
    net = build_handnet(cfg.model, *pcli.load_mano_pair("synthetic"), device="cpu")
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    train_loader, val_loader = _loaders(factory, loader)
    opt = make_optimizer(cfg.train, net)
    state = create_train_state(net, opt, cfg.train, steps_per_epoch=len(train_loader))
    _, metrics = fit(cfg, state, train_loader, val_loader)
    return metrics


def run_both(jax_exp, port_exp, argv=ARGV):
    """Both packages' ``fit`` metrics, ``(jax, port)``."""
    saved = sys.modules.get("cv2", 0)
    sys.modules["cv2"] = None  # both packages' cv2-free data chain
    try:
        variables, jm = _jax_fit(jax_exp, argv)
        pm = _port_fit(port_exp, variables, argv)
    finally:
        if saved == 0:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved
    return jm, pm


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return run_both(str(tmp_path_factory.mktemp("jax")), str(tmp_path_factory.mktemp("port")))


LOSS_TOL = 1e-4  # relative
EPE_TOL = 1e-3  # mm


def tolerance(key, want):
    """The allowed ``|port - jax|`` of a logged metric; None for timings."""
    if key in ("data_time", "batch_time"):
        return None
    if key == "auc":
        return 1e-3
    if key.startswith("epe"):
        return EPE_TOL
    if key == "lr":
        return 1e-6 * want  # optax's float32 against a float
    return LOSS_TOL * max(abs(want), 1e-6)


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
                tol = tolerance(key, want)
                if tol is None:
                    continue
                assert abs(got - want) <= tol, (key, split, epoch, got, want)
                checked += 1
    assert checked >= 30
    assert pm["regul_scale"]["train"] == {1: 1.0, 2: 1.0}
    for m in (jm, pm):  # the four updates train
        assert m["total_loss"]["train"][2] < 0.95 * m["total_loss"]["train"][1]
    # the val pass feeds the evaluator: AUC and EPE are logged
    assert {"auc", "epe_mean", "epe_median"} <= set(pm)


if __name__ == "__main__":
    # python -m tests.test_torch_fit [flags appended to ARGV, e.g. --lr 1e-4]:
    # each metric's gap against its tolerance, worst first, and the train loss
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        jm, pm = run_both(tmp + "/jax", tmp + "/port", ARGV + sys.argv[1:])
    rows = []
    for key, splits in jm.items():
        for split, series in splits.items():
            for epoch, want in series.items():
                tol = tolerance(key, want)
                if tol is not None:
                    got = pm[key][split][epoch]
                    rows.append((abs(got - want) / tol, key, split, epoch, got, want))
    for ratio, key, split, epoch, got, want in sorted(rows, reverse=True)[:12]:
        print(f"{key}/{split}/{epoch}: port {got!r} jax {want!r} |diff| {abs(got - want):.3g}"
              f" rel {abs(got - want) / max(abs(want), 1e-6):.3g}, {ratio:.3f} of its tolerance")
    print("train total_loss by epoch: jax", jm["total_loss"]["train"], "port",
          pm["total_loss"]["train"])
