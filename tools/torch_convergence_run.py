"""The port's convergence run: the flagship contact recipe of
``tools/convergence_run.py`` (40 epochs of 2560 synthetic samples at B=16,
6,400 optimizer steps, contact + collision losses, StepLR 15/0.5, regul
decay 0.9, unfrozen BN) through the port's ``cli.traineval``, then the ten
recipe checks of ``docs/convergence/README.md`` against the run's own logs.

    python3 tools/torch_convergence_run.py                 # on the GPU
    python3 tools/torch_convergence_run.py --out DIR --run_dir RUN
    python3 tools/torch_convergence_run.py --resume        # go on from RUN's checkpoint
    python3 tools/torch_convergence_run.py --resummarize   # re-distill RUN, no training

The run's experiment directory (``--run_dir``, default ``<out>/run``)
holds the checkpoints and logs; the distilled files go to ``--out``
(default ``docs/convergence_torch``):

  summary.json   the trajectories (val AUC, EPE, contact AUC, penetration,
                 attraction and repulsion), the lr and regul scale the run
                 logged, the best epoch read from the port's
                 ``model_best.pth.tar``, the ten checks, the card's name and
                 power limit, the wall clock, train samples/s and the
                 data-wait share, the number of invocations that trained,
                 and the JAX artifact's trajectories beside the port's
  metrics.json   the run's Monitor output
  README.md      the table of docs/convergence/README.md, port and JAX rows
  auc.png, contact.png   the val curves, port and JAX (matplotlib, else PIL)
  traineval.log  the training process's output

A run cut short goes on with ``--resume`` (the CLI's ``--auto_resume``:
the port's resume equals the run that never stopped, bit for bit). Nothing
is written into ``docs/convergence/``, the JAX package's artifact.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ARTIFACT = os.path.join(REPO, "docs", "convergence", "summary.json")
LR, LR_DECAY_STEP, LR_GAMMA, REGUL_GAMMA = 1e-3, 15, 0.5, 0.9
BATCH = 16


def recipe_args():
    """``tools/convergence_run.py:55-75``'s arguments, for the port's CLI."""
    return [
        "--train_datasets", "synthetic", "--val_datasets", "synthetic",
        "--mano_assets", "synthetic", "--synthetic_size", "2560",
        "--epochs", "40",
        "--train_batch", str(BATCH), "--test_batch", str(BATCH),
        "--atlas_predict_trans", "--atlas_predict_scale",
        "--atlas_lambda_regul_edges", "0.167",
        "--contact_lambda", "0.167", "--collision_lambda", "0.167",
        "--lr", str(LR), "--lr_decay_step", str(LR_DECAY_STEP),
        "--lr_decay_gamma", str(LR_GAMMA),
        "--regul_decay_step", "1", "--regul_decay_gamma", str(REGUL_GAMMA),
        "--display_freq", "0", "--epoch_display_freq", "1000",
        "--manual_seed", "0",
        # the reference's default (nets3dopts.py:176): from scratch, frozen
        # BN would pin the random init's statistics
        "--no_freeze_batchnorm",
    ]


def _card() -> str:
    """``nvidia-smi``'s name and power limit, or "not measured"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
        return out.splitlines()[0] if out else "not measured"
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def _train(run_dir: str, argv, log_path: str, resume: bool) -> dict:
    """The CLI in a child process; returns this invocation's record."""
    cmd = [sys.executable, "-u", "-m", "obman_train_tpu_torch.cli.traineval",
           "--exp_id", run_dir, *argv] + (["--auto_resume"] if resume else [])
    print("running:", " ".join(cmd), flush=True)
    t0 = time.time()
    with open(log_path, "a") as log:
        proc = subprocess.run(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                              env=dict(os.environ, PYTHONPATH=REPO + os.pathsep
                                       + os.environ.get("PYTHONPATH", "")))
    wall = time.time() - t0
    with open(log_path) as f:
        print("".join(f.readlines()[-15:]), flush=True)
    if proc.returncode:
        raise SystemExit(f"traineval exited with {proc.returncode}; see {log_path}")
    return {"argv": list(argv), "wall_s": wall, "resume": resume, "card": _card(),
            "cpu_count": os.cpu_count()}


def _series(metrics, key, split, epochs):
    vals = metrics.get(key, {}).get(split, {})
    return {str(e): vals[str(e)] for e in epochs if str(e) in vals}


def _finite_all(d) -> bool:
    return bool(d) and all(isinstance(v, (int, float)) and math.isfinite(v)
                           for v in d.values())


def checks_from_metrics(metrics: dict, best_epoch_ckpt: int) -> dict:
    """The ten checks of ``docs/convergence/README.md:21-33`` (the JAX
    tool's :183-223) on a run's Monitor output."""
    auc = {int(e): v for e, v in metrics["auc"]["val"].items()}
    epochs = sorted(auc)
    best = max(epochs, key=lambda e: auc[e])
    lr = {int(e): v for e, v in metrics["lr"]["train"].items()}
    regul = {int(e): v for e, v in metrics["regul_scale"]["train"].items()}
    lr_want = {e: LR * LR_GAMMA ** ((e - 1) // LR_DECAY_STEP) for e in epochs}
    contact_auc = _series(metrics, "contact_auc", "val", epochs)
    max_penetr = _series(metrics, "max_penetr", "val", epochs)
    mean_penetr = _series(metrics, "mean_penetr", "val", epochs)
    attraction = _series(metrics, "attraction_loss", "val", epochs)
    penetration = _series(metrics, "penetration_loss", "val", epochs)
    return {
        "auc_improves": auc[epochs[-1]] > auc[epochs[0]],
        "best_auc_improves_on_first": auc[best] > auc[epochs[0]],
        "best_ckpt_matches_auc_argmax": best_epoch_ckpt == best,
        "lr_logged_decayed": lr[epochs[-1]] < lr[epochs[0]],
        "lr_logged_matches_intended_steplr": all(
            abs(lr[e] - lr_want[e]) <= 1e-6 * lr_want[e] for e in epochs),
        "regul_logged_matches_intended_decay": all(
            abs(regul[e] - REGUL_GAMMA ** (e - 1)) <= 1e-6 for e in epochs),
        "contact_metrics_logged_every_epoch": (
            len(contact_auc) == len(epochs) and len(max_penetr) == len(epochs)),
        "contact_metrics_finite": (
            _finite_all(contact_auc) and _finite_all(max_penetr)
            and _finite_all(mean_penetr)),
        "contact_terms_nonzero": (
            any(v > 0 for v in attraction.values())
            and any(v > 0 for v in penetration.values())),
        "contact_auc_improves": bool(contact_auc) and (
            contact_auc[str(epochs[-1])] > contact_auc[str(epochs[0])]),
    }


def _read_best_epoch(run_dir: str) -> int:
    """The epoch stored in the port's ``model_best.pth.tar`` (torch)."""
    import torch

    payload = torch.load(os.path.join(run_dir, "model_best.pth.tar"), map_location="cpu",
                         weights_only=True)
    return int(payload["epoch"])


def _throughput(metrics: dict, epochs) -> dict:
    """Train samples/s and the data-wait share of each train epoch, from
    the loop's per-batch means of ``batch_time`` (one loop iteration) and
    ``data_time`` (its wait for the loader)."""
    bt = _series(metrics, "batch_time", "train", epochs)
    dt = _series(metrics, "data_time", "train", epochs)
    rate = {e: BATCH / v for e, v in bt.items() if v > 0}
    share = {e: dt[e] / bt[e] for e in bt if e in dt and bt[e] > 0}

    def median(d):
        vals = sorted(d.values())
        return vals[len(vals) // 2] if vals else None

    return {"train_samples_per_s_by_epoch": rate, "data_wait_share_by_epoch": share,
            "train_samples_per_s_median": median(rate),
            "data_wait_share_median": median(share)}


def _plot(path: str, title: str, ylabel: str, curves) -> None:
    """Line plot of ``curves`` = [(label, {epoch: value}, colour)]:
    matplotlib when it imports, else PIL."""
    curves = [(lbl, {int(e): v for e, v in d.items()}, c) for lbl, d, c in curves if d]
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4))
        for lbl, d, c in curves:
            es = sorted(d)
            ax.plot(es, [d[e] for e in es], "o-", ms=3, color=c, label=lbl)
        ax.set_xlabel("epoch")
        ax.set_ylabel(ylabel)
        ax.set_title(title)
        ax.legend(fontsize=8)
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return
    except ImportError:
        pass
    from PIL import Image, ImageDraw

    W, H, L, R, T, B = 770, 440, 70, 20, 40, 50
    img = Image.new("RGB", (W, H), "white")
    draw = ImageDraw.Draw(img)
    xs = [e for _, d, _ in curves for e in d]
    ys = [v for _, d, _ in curves for v in d.values()]
    x0, x1 = min(xs), max(max(xs), min(xs) + 1)
    y0, y1 = min(ys), max(ys)
    y0, y1 = (y0 - 0.05 * (y1 - y0 or 1), y1 + 0.05 * (y1 - y0 or 1))

    def px(e, v):
        return (L + (e - x0) / (x1 - x0) * (W - L - R),
                H - B - (v - y0) / (y1 - y0) * (H - T - B))

    draw.rectangle([L, T, W - R, H - B], outline="black")
    for k in range(5):
        v = y0 + k * (y1 - y0) / 4
        draw.text((4, px(x0, v)[1] - 6), f"{v:.3g}", fill="black")
        e = x0 + k * (x1 - x0) / 4
        draw.text((px(e, y0)[0] - 8, H - B + 6), f"{e:.0f}", fill="black")
    draw.text((L, 10), f"{title}  ({ylabel} by epoch)", fill="black")
    for i, (lbl, d, c) in enumerate(curves):
        pts = [px(e, d[e]) for e in sorted(d)]
        draw.line(pts, fill=c, width=2)
        draw.text((L + 10 + 230 * i, H - B + 26), f"-- {lbl}", fill=c)
    img.save(path)


def summarize(out: str, run_dir: str, invocations) -> int:
    with open(os.path.join(run_dir, "metrics.json")) as f:
        metrics = json.load(f)
    auc = {int(e): v for e, v in metrics["auc"]["val"].items()}
    epochs = sorted(auc)
    best_ckpt = _read_best_epoch(run_dir)
    best_auc = max(epochs, key=lambda e: auc[e])
    checks = checks_from_metrics(metrics, best_ckpt)
    jax_ref = None
    if os.path.exists(JAX_ARTIFACT):
        with open(JAX_ARTIFACT) as f:
            j = json.load(f)
        jax_ref = {k: j[k] for k in ("val_auc_by_epoch", "val_epe_by_epoch",
                                     "val_contact_auc_by_epoch", "val_max_penetr_by_epoch",
                                     "best_epoch_from_auc")}
    summary = {
        "args": invocations[0]["argv"],
        "epochs": epochs,
        "val_auc_by_epoch": {str(e): auc[e] for e in epochs},
        "val_epe_by_epoch": _series(metrics, "epe_mean", "val", epochs),
        "val_contact_auc_by_epoch": _series(metrics, "contact_auc", "val", epochs),
        "val_max_penetr_by_epoch": _series(metrics, "max_penetr", "val", epochs),
        "val_mean_penetr_by_epoch": _series(metrics, "mean_penetr", "val", epochs),
        "val_attraction_loss_by_epoch": _series(metrics, "attraction_loss", "val", epochs),
        "val_penetration_loss_by_epoch": _series(metrics, "penetration_loss", "val", epochs),
        "logged_lr_by_epoch": _series(metrics, "lr", "train", epochs),
        "logged_regul_scale_by_epoch": _series(metrics, "regul_scale", "train", epochs),
        "intended_lr_by_epoch": {str(e): LR * LR_GAMMA ** ((e - 1) // LR_DECAY_STEP)
                                 for e in epochs},
        "best_epoch_from_checkpoint": best_ckpt,
        "best_epoch_from_auc": best_auc,
        "checks": checks,
        "invocations": invocations,
        "wall_clock_s": sum(i["wall_s"] for i in invocations),
        **_throughput(metrics, epochs),
        "jax_reference": jax_ref,
    }
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    shutil.copy(os.path.join(run_dir, "metrics.json"), os.path.join(out, "metrics.json"))
    jr = jax_ref or {}
    _plot(os.path.join(out, "auc.png"), "val AUC (PCK 0-50 mm)", "AUC",
          [("port", summary["val_auc_by_epoch"], "#1f77b4"),
           ("JAX artifact", jr.get("val_auc_by_epoch", {}), "#7f7f7f")])
    _plot(os.path.join(out, "contact.png"), "val contact AUC", "contact AUC",
          [("port", summary["val_contact_auc_by_epoch"], "#1f77b4"),
           ("JAX artifact", jr.get("val_contact_auc_by_epoch", {}), "#7f7f7f")])
    _write_readme(out, summary)
    print(json.dumps(checks, indent=1))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        print("FAILED checks:", failed, file=sys.stderr)
        return 1
    print(f"artifact written to {out}")
    return 0


def _write_readme(out: str, s: dict) -> None:
    def row(name, key, fmt, src, best):
        d = src.get(key, {})
        e0, eN = min(int(e) for e in src["val_auc_by_epoch"]), \
            max(int(e) for e in src["val_auc_by_epoch"])
        cell = lambda e: fmt.format(d[str(e)]) if str(e) in d else "—"  # noqa: E731
        return f"| {name} | {cell(e0)} | {cell(eN)} | {cell(best)} (epoch {best}) |"

    jr = s["jax_reference"]
    rows = []
    for name, key, fmt in (("val AUC (PCK 0-50 mm)", "val_auc_by_epoch", "{:.3f}"),
                           ("val EPE mean (mm)", "val_epe_by_epoch", "{:.1f}"),
                           ("val contact AUC", "val_contact_auc_by_epoch", "{:.3f}"),
                           ("val max penetration (mm)", "val_max_penetr_by_epoch", "{:.2f}")):
        rows.append(row(f"port: {name}", key, fmt, s, s["best_epoch_from_auc"]))
        if jr:
            rows.append(row(f"JAX: {name}", key, fmt, jr, jr["best_epoch_from_auc"]))
    cards = sorted({i["card"] for i in s["invocations"]})
    e0, eN = s["epochs"][0], s["epochs"][-1]
    rate, share = s["train_samples_per_s_median"], s["data_wait_share_median"]
    text = f"""# The port's convergence run

`tools/torch_convergence_run.py` ran the flagship contact recipe of
`tools/convergence_run.py` (StepLR 15/0.5, edge-regularizer decay 0.9,
contact + collision losses at the reference defaults, unfrozen BN,
per-epoch val PCK/EPE/AUC, best checkpoint on val AUC) through the port's
`cli.traineval` on the synthetic dataset: {len(s["epochs"])} epochs of B=16,
K1 and `nn_dir` on every step. Card: {", ".join(cards)}
(`nvidia-smi --query-gpu=name,power.limit`). It took {len(s["invocations"])}
invocation(s) of the tool, {s["wall_clock_s"]:.1f} s of wall clock in all
(the training process, its start and every val pass included); train
samples/s, median over the epochs, {rate if rate is None else f"{rate:.1f}"}
(16 over the loop's mean iteration time); data-wait share of a train epoch,
median, {share if share is None else f"{share:.4f}"}.

| | epoch {e0} | epoch {eN} | best |
|---|---|---|---|
{chr(10).join(rows)}

The JAX rows are `docs/convergence/summary.json` (the JAX package's run of
the same recipe, not on this card). The two are not expected to be equal:
the initial weights and the random streams differ. The bar is the ten
checks below, recomputed from `metrics.json` by
`tests/test_torch_convergence_artifact.py`:
{json.dumps(s["checks"], indent=1)}

lr and regul_scale in `summary.json` are the values the run logged (the
schedule at the live update count, the scale each epoch's loss used). The
best epoch is read from the port's `model_best.pth.tar`. `auc.png` and
`contact.png` draw the port's val curves beside the JAX artifact's.
"""
    with open(os.path.join(out, "README.md"), "w") as f:
        f.write(text)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(REPO, "docs", "convergence_torch"))
    p.add_argument("--run_dir", default=None, help="default <out>/run")
    p.add_argument("--resume", action="store_true",
                   help="go on from the run directory's checkpoint")
    p.add_argument("--resummarize", action="store_true",
                   help="re-distill a finished run without training")
    args = p.parse_args(argv)
    out = os.path.abspath(args.out)
    if os.path.abspath(os.path.join(REPO, "docs", "convergence")) == out:
        raise SystemExit("docs/convergence/ is the JAX package's artifact")
    run_dir = os.path.abspath(args.run_dir or os.path.join(out, "run"))
    inv_path = os.path.join(run_dir, "invocations.json")
    os.makedirs(out, exist_ok=True)
    if not args.resummarize:
        if not args.resume:
            shutil.rmtree(run_dir, ignore_errors=True)
            log = os.path.join(out, "traineval.log")
            if os.path.exists(log):
                os.remove(log)
        os.makedirs(run_dir, exist_ok=True)
        invocations = []
        if args.resume and os.path.exists(inv_path):
            with open(inv_path) as f:
                invocations = json.load(f)
        invocations.append(_train(run_dir, recipe_args(), os.path.join(out, "traineval.log"),
                                  args.resume))
        with open(inv_path, "w") as f:
            json.dump(invocations, f, indent=1)
    with open(inv_path) as f:
        invocations = json.load(f)
    return summarize(out, run_dir, invocations)


if __name__ == "__main__":
    sys.exit(main())
