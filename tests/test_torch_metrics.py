"""The port's metrics and logs (``train/metrics.py``, ``utils/logging.py``)
against the JAX package's on the CPU: ``EvalUtil.get_measures`` and the
meters exactly equal in float64 on the same errors, and the log lines,
jsonl records and ``metrics.json`` byte for byte at a fixed clock."""

import datetime as real_datetime
import os

import numpy as np
import pytest

from obman_train_tpu.train import metrics as jmetrics
from obman_train_tpu.utils import logging as jlogging
from obman_train_tpu_torch.train import metrics
from obman_train_tpu_torch.utils import logging as plogging


def _feeds(seed):
    rng = np.random.default_rng(seed)
    for b in (4, 4, 3):
        gt = rng.normal(0, 40, (b, 21, 3))
        pred = gt + rng.normal(0, 15, (b, 21, 3))
        vis = rng.uniform(size=(b, 21)) > 0.2
        yield gt, pred, vis


@pytest.mark.parametrize("with_vis", [False, True])
def test_eval_util_matches_jax_exactly(with_vis):
    j, p = jmetrics.EvalUtil(), metrics.EvalUtil()
    for gt, pred, vis in _feeds(1):
        j.feed(gt, pred, vis if with_vis else None)
        p.feed(gt, pred, vis if with_vis else None)
    j.feed(gt[0], pred[0])  # a single sample
    p.feed(gt[0], pred[0])
    p.merge_distributed()  # one process: a no-op
    for lo, hi, steps in ((0, 50, 20), (0, 30, 7)):
        want, got = j.get_measures(lo, hi, steps), p.get_measures(lo, hi, steps)
        assert got[0] == want[0] and got[2] == want[2] and got[3] == want[3]
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[4], want[4]) and np.array_equal(got[5], want[5])
    assert 0 < got[3] < 1


def test_empty_evaluator_is_nan():
    epe, per_kp, median, auc, curve, thres = metrics.EvalUtil().get_measures(0, 50, 20)
    assert np.isnan(epe) and np.isnan(auc) and per_kp == [] and np.isnan(curve).all()
    assert len(thres) == 20


def test_meters_match_jax():
    j, p = jmetrics.AverageMeters(), metrics.AverageMeters()
    rng = np.random.default_rng(2)
    for name in ("total_loss", "data_time", "total_loss", "mano_verts3d"):
        v, n = float(rng.normal()), int(rng.integers(1, 5))
        j.add_loss_value(name, v, n)
        p.add_loss_value(name, v, n)
    assert p.averages() == j.averages()
    assert list(p.averages()) == list(j.averages())


class _FixedClock:
    class datetime:
        @staticmethod
        def now():
            return real_datetime.datetime(2026, 1, 2, 3, 4, 5)


def test_log_lines_and_files_byte_identical(tmp_path, monkeypatch):
    monkeypatch.setattr(jlogging, "datetime", _FixedClock)
    monkeypatch.setattr(plogging, "datetime", _FixedClock)
    values = {"total_loss": 12.5, "auc": 0.25, "lr": 1e-4, "regul_scale": 1.0,
              "epe_mean": 3.0000000000000004}
    line = plogging.format_log_line(3, values)
    assert line == jlogging.format_log_line(3, values)
    assert line.startswith("(epoch: 3, time: 2026-01-02 03:04:05)total_loss:12.5,")
    assert plogging.parse_log_line(line) == jlogging.parse_log_line(line) == (3, values)
    dirs = {}
    for name, mod in (("jax", jlogging), ("port", plogging)):
        exp = str(tmp_path / name)
        mon = mod.Monitor(exp)
        mon.log_train(1, dict(values, skipped=None))
        mon.log_val(1, {"total_loss": 3.25})
        mon.log_train(2, values)
        mon.save_metrics()
        dirs[name] = exp
    for rel in ("logs/train.txt", "logs/val.txt", "logs/train.jsonl", "logs/val.jsonl",
                "metrics.json"):
        with open(os.path.join(dirs["jax"], rel), "rb") as a, \
                open(os.path.join(dirs["port"], rel), "rb") as b:
            assert a.read() == b.read(), rel
