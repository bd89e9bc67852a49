"""Re-assert the port's committed convergence artifact
(``docs/convergence_torch/``, written by ``tools/torch_convergence_run.py``
from a run on the GPU): the full flagship recipe of
``tools/convergence_run.py`` through the port's ``cli.traineval`` with
unfrozen BN, and the ten checks of ``docs/convergence/README.md``.

The checks are recomputed here from the committed ``metrics.json`` (the
run's Monitor output), independently of the tool's code, and must all be
true and equal to the ones ``summary.json`` recorded. Nothing here runs a
model: it needs neither a GPU nor JAX.
"""

import json
import math
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "docs", "convergence_torch")
CHECKS = ("auc_improves", "best_auc_improves_on_first", "best_ckpt_matches_auc_argmax",
          "lr_logged_decayed", "lr_logged_matches_intended_steplr",
          "regul_logged_matches_intended_decay", "contact_metrics_logged_every_epoch",
          "contact_metrics_finite", "contact_terms_nonzero", "contact_auc_improves")


def _load(name):
    path = os.path.join(OUT, name)
    assert os.path.exists(path), f"{path} missing: run tools/torch_convergence_run.py"
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def summary():
    return _load("summary.json")


@pytest.fixture(scope="module")
def metrics():
    return _load("metrics.json")


def _val(metrics, key):
    return {int(e): v for e, v in metrics.get(key, {}).get("val", {}).items()}


def _recomputed(metrics, best_ckpt):
    auc = _val(metrics, "auc")
    epochs = sorted(auc)
    first, last = epochs[0], epochs[-1]
    best = max(epochs, key=lambda e: auc[e])
    lr = {int(e): v for e, v in metrics["lr"]["train"].items()}
    regul = {int(e): v for e, v in metrics["regul_scale"]["train"].items()}
    cauc, maxp, meanp = (_val(metrics, k) for k in ("contact_auc", "max_penetr",
                                                     "mean_penetr"))
    attr, pen = _val(metrics, "attraction_loss"), _val(metrics, "penetration_loss")
    finite = lambda d: bool(d) and all(math.isfinite(v) for v in d.values())  # noqa: E731
    return {
        "auc_improves": auc[last] > auc[first],
        "best_auc_improves_on_first": auc[best] > auc[first],
        "best_ckpt_matches_auc_argmax": best_ckpt == best,
        "lr_logged_decayed": lr[last] < lr[first],
        "lr_logged_matches_intended_steplr": all(
            lr[e] == pytest.approx(1e-3 * 0.5 ** ((e - 1) // 15), rel=1e-6) for e in epochs),
        "regul_logged_matches_intended_decay": all(
            abs(regul[e] - 0.9 ** (e - 1)) <= 1e-6 for e in epochs),
        "contact_metrics_logged_every_epoch": len(cauc) == len(maxp) == len(epochs),
        "contact_metrics_finite": finite(cauc) and finite(maxp) and finite(meanp),
        "contact_terms_nonzero": any(v > 0 for v in attr.values())
        and any(v > 0 for v in pen.values()),
        "contact_auc_improves": cauc[last] > cauc[first],
    }


def test_the_ten_checks_hold_recomputed_from_metrics(summary, metrics):
    got = _recomputed(metrics, summary["best_epoch_from_checkpoint"])
    assert set(got) == set(CHECKS) == set(summary["checks"])
    failed = [k for k, ok in got.items() if not ok]
    assert not failed, f"convergence checks fail on metrics.json: {failed}"
    assert got == summary["checks"]


def test_the_run_is_the_full_recipe(summary):
    args = summary["args"]

    def value(flag):
        return args[args.index(flag) + 1]

    assert "--no_freeze_batchnorm" in args
    assert int(value("--epochs")) == 40 and int(value("--synthetic_size")) == 2560
    assert int(value("--train_batch")) == 16 and int(value("--test_batch")) == 16
    assert float(value("--contact_lambda")) == float(value("--collision_lambda")) == 0.167
    assert float(value("--lr")) == 1e-3 and int(value("--lr_decay_step")) == 15
    assert float(value("--regul_decay_gamma")) == 0.9
    assert "--image_size" not in args  # 256x256, the default
    assert summary["epochs"] == list(range(1, 41))


def test_it_ran_on_the_card(summary):
    inv = summary["invocations"]
    assert inv and all("H100" in i["card"] and i["card"].endswith("W") for i in inv)
    assert summary["wall_clock_s"] == pytest.approx(sum(i["wall_s"] for i in inv))
    assert [i["resume"] for i in inv] == [False] + [True] * (len(inv) - 1)
    assert 0 < summary["data_wait_share_median"] < 1
    assert summary["train_samples_per_s_median"] > 0


def test_summary_trajectories_are_the_metrics(summary, metrics):
    for key, series in (("auc", "val_auc_by_epoch"), ("epe_mean", "val_epe_by_epoch"),
                        ("contact_auc", "val_contact_auc_by_epoch"),
                        ("max_penetr", "val_max_penetr_by_epoch")):
        assert {int(e): v for e, v in summary[series].items()} == _val(metrics, key)
    assert summary["best_epoch_from_auc"] == summary["best_epoch_from_checkpoint"]


def test_jax_reference_is_the_committed_jax_artifact(summary):
    with open(os.path.join(REPO, "docs", "convergence", "summary.json")) as f:
        jax_summary = json.load(f)
    ref = summary["jax_reference"]
    for key in ("val_auc_by_epoch", "val_epe_by_epoch", "val_contact_auc_by_epoch"):
        assert ref[key] == jax_summary[key]


def test_readme_and_curves_exist(summary):
    for name in ("README.md", "auc.png", "contact.png"):
        assert os.path.getsize(os.path.join(OUT, name)) > 0
    with open(os.path.join(OUT, "README.md")) as f:
        text = f.read()
    assert summary["invocations"][0]["card"] in text
    assert f"{summary['val_auc_by_epoch']['40']:.3f}" in text
