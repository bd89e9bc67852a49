"""Cross-experiment results tables (the port's copy of the JAX package's
``utils/tables.py``; the port's ``metrics.json`` has the JAX layout, so the
same experiment directories give the same tables).

Equivalent of the reference's analyzlogutils + scripts/process_table.py
(best epoch per metric across experiments, rendered to HTML) without the
dominate dependency: reads each experiment's ``metrics.json``
(utils/logging.Monitor output) and emits a plain HTML + markdown table.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

# Metrics where lower is better; anything else is maximized.
LOWER_IS_BETTER_PREFIXES = (
    "total_loss", "epe", "mano_", "atlas_", "final_", "joints2d",
    "penetration", "attraction", "contact_loss", "absolute",
)


def metric_direction(name: str) -> str:
    if name == "auc" or name.endswith("auc"):
        return "max"
    for p in LOWER_IS_BETTER_PREFIXES:
        if name.startswith(p):
            return "min"
    return "max"


def best_epoch_values(metrics: Dict, split: str = "val") -> Dict[str, tuple]:
    """{metric: (best_value, best_epoch)} over the stored evolution."""
    out = {}
    for name, splits in metrics.items():
        series = splits.get(split)
        if not series:
            continue
        items = [(int(e), v) for e, v in series.items()]
        if metric_direction(name) == "min":
            epoch, val = min(items, key=lambda ev: ev[1])
        else:
            epoch, val = max(items, key=lambda ev: ev[1])
        out[name] = (val, epoch)
    return out


def load_experiment(exp_dir: str) -> Optional[Dict]:
    path = os.path.join(exp_dir, "metrics.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def make_table(
    exp_dirs: Sequence[str],
    metric_names: Optional[Sequence[str]] = None,
    split: str = "val",
) -> List[Dict]:
    rows = []
    for exp in exp_dirs:
        metrics = load_experiment(exp)
        if metrics is None:
            continue
        best = best_epoch_values(metrics, split)
        row = {"experiment": exp}
        for name, (val, epoch) in sorted(best.items()):
            if metric_names and name not in metric_names:
                continue
            row[name] = val
            row[f"{name}@epoch"] = epoch
        rows.append(row)
    return rows


def render_markdown(rows: List[Dict]) -> str:
    if not rows:
        return "(no experiments)"
    cols = ["experiment"] + sorted(
        {k for row in rows for k in row if k != "experiment" and "@" not in k}
    )
    lines = ["| " + " | ".join(cols) + " |",
             "|" + "---|" * len(cols)]
    for row in rows:
        cells = []
        for c in cols:
            v = row.get(c, "")
            cells.append(f"{v:.4f}" if isinstance(v, float) else str(v))
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def render_html(rows: List[Dict], title: str = "Results") -> str:
    if not rows:
        return f"<html><body><h1>{title}</h1>(no experiments)</body></html>"
    cols = ["experiment"] + sorted(
        {k for row in rows for k in row if k != "experiment" and "@" not in k}
    )
    html = [f"<html><head><title>{title}</title></head><body>",
            f"<h1>{title}</h1>", "<table border='1' cellpadding='4'>",
            "<tr>" + "".join(f"<th>{c}</th>" for c in cols) + "</tr>"]
    for row in rows:
        tds = []
        for c in cols:
            v = row.get(c, "")
            label = f"{v:.4f}" if isinstance(v, float) else str(v)
            epoch = row.get(f"{c}@epoch")
            if epoch is not None and c != "experiment":
                label += f" <small>(ep{epoch})</small>"
            tds.append(f"<td>{label}</td>")
        html.append("<tr>" + "".join(tds) + "</tr>")
    html += ["</table></body></html>"]
    return "\n".join(html)


def process_table(
    exp_dirs: Sequence[str], out_path: str, split: str = "val",
    metric_names=None,
) -> str:
    rows = make_table(exp_dirs, metric_names, split)
    html = render_html(rows)
    with open(out_path, "w") as f:
        f.write(html)
    return render_markdown(rows)
