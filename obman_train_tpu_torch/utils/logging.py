"""Experiment logging and monitoring (the JAX package's
``utils/logging.py``, the same log-line format byte for byte).

Replaces the reference's text logs + plotly dashboards
(mano_train/exputils/logutils.py:10-111, monitoring.py:10-66) with:
- the same line-format text logs ``(epoch: N, time)name1:val1,name2:val2``
  (kept parseable so the reference's cross-experiment table tooling has an
  equivalent input format), plus
- structured JSONL logs (one record per epoch per split), plus
- a Monitor that accumulates per-metric evolution to ``metrics.json`` and
  renders matplotlib curves when matplotlib is importable (plotly-free).
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Dict, Optional


def format_log_line(epoch: int, values: Dict[str, float]) -> str:
    now = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    body = ",".join(f"{k}:{v}" for k, v in values.items())
    return f"(epoch: {epoch}, time: {now})" + body


def parse_log_line(line: str):
    """Inverse of format_log_line (reference logutils.py parser role)."""
    head, _, body = line.partition(")")
    epoch = int(head.split("epoch:")[1].split(",")[0].strip())
    vals = {}
    for item in body.strip().split(","):
        if ":" in item:
            k, _, v = item.partition(":")
            try:
                vals[k.strip()] = float(v)
            except ValueError:
                pass
    return epoch, vals


class TrainLogger:
    """Per-split text + jsonl logs under <exp_id>/logs/."""

    def __init__(self, exp_id: str):
        self.exp_id = exp_id
        self.log_dir = os.path.join(exp_id, "logs")
        os.makedirs(self.log_dir, exist_ok=True)

    def log(self, split: str, epoch: int, values: Dict[str, float]):
        clean = {
            k: float(v) for k, v in values.items() if v is not None
        }
        with open(os.path.join(self.log_dir, f"{split}.txt"), "a") as f:
            f.write(format_log_line(epoch, clean) + "\n")
        record = {"epoch": epoch, "split": split, **clean}
        with open(os.path.join(self.log_dir, f"{split}.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")


class Monitor:
    """Accumulates metric evolution + optional matplotlib plots
    (reference monitoring.py:10-66 without the plotly/web-hosting parts)."""

    def __init__(self, exp_id: str, hosting_folder: Optional[str] = None):
        self.exp_id = exp_id
        self.hosting_folder = hosting_folder
        self.logger = TrainLogger(exp_id)
        self.metrics: Dict[str, Dict[str, Dict[int, float]]] = {}
        os.makedirs(exp_id, exist_ok=True)
        if hosting_folder:
            os.makedirs(hosting_folder, exist_ok=True)

    def log_train(self, epoch: int, values: Dict[str, float]):
        self._log("train", epoch, values)

    def log_val(self, epoch: int, values: Dict[str, float]):
        self._log("val", epoch, values)

    def _log(self, split: str, epoch: int, values: Dict[str, float]):
        self.logger.log(split, epoch, values)
        for k, v in values.items():
            if v is None:
                continue
            self.metrics.setdefault(k, {}).setdefault(split, {})[epoch] = float(v)

    def save_metrics(self):
        path = os.path.join(self.exp_id, "metrics.json")
        with open(path, "w") as f:
            json.dump(self.metrics, f, indent=1, sort_keys=True)
        return path

    def plot_metrics(self):
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return None
        plot_dir = os.path.join(self.exp_id, "plots")
        os.makedirs(plot_dir, exist_ok=True)
        for name, splits in self.metrics.items():
            fig, ax = plt.subplots(figsize=(6, 4))
            for split, series in splits.items():
                epochs = sorted(series)
                ax.plot(epochs, [series[e] for e in epochs], label=split)
            ax.set_title(name)
            ax.set_xlabel("epoch")
            ax.legend()
            safe = name.replace("/", "_")
            fig.savefig(os.path.join(plot_dir, f"{safe}.png"), dpi=80)
            plt.close(fig)
        if self.hosting_folder:
            import shutil

            dst = os.path.join(self.hosting_folder, "plots")
            shutil.rmtree(dst, ignore_errors=True)
            shutil.copytree(plot_dir, dst)
        return plot_dir
