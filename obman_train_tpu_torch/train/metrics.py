"""Host-side metrics: running means and the PCK/EPE/AUC evaluator (the JAX
package's ``train/metrics.py:18-204``).

``EvalUtil`` implements the evaluation protocol of the reference's
``mano_train/evaluation/zimeval.py``: per-keypoint Euclidean error pools,
PCK at linspace thresholds, mean/median EPE per keypoint, AUC as the
normalized trapezoid of the mean PCK curve; vectorized numpy over batched
feeds, float64 as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# numpy < 2.0 names it trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class AverageMeter:
    """Running mean (reference: evaluation/evalutils.py:1-29)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class AverageMeters:
    def __init__(self):
        self.average_meters: Dict[str, AverageMeter] = {}

    def add_loss_value(self, name: str, val: float, n: int = 1):
        if name not in self.average_meters:
            self.average_meters[name] = AverageMeter()
        self.average_meters[name].update(val, n)

    def averages(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.average_meters.items()}


class EvalUtil:
    """Keypoint evaluator: feed batches of (gt, pred) joints in mm."""

    def __init__(self, num_kp: int = 21):
        self.num_kp = num_kp
        self._dists: List[np.ndarray] = []   # each (B, K) euclidean errors
        self._vis: List[np.ndarray] = []     # each (B, K) bool

    def feed(
        self,
        gt: np.ndarray,
        pred: np.ndarray,
        keypoint_vis: Optional[np.ndarray] = None,
    ):
        """Accepts a single sample (K, 3) or a batch (B, K, 3)."""
        gt = np.asarray(gt, np.float64)
        pred = np.asarray(pred, np.float64)
        if gt.ndim == 2:
            gt, pred = gt[None], pred[None]
            if keypoint_vis is not None:
                keypoint_vis = np.asarray(keypoint_vis)[None]
        dists = np.linalg.norm(gt - pred, axis=-1)  # (B, K)
        vis = (
            np.ones(dists.shape, bool)
            if keypoint_vis is None
            else np.asarray(keypoint_vis, bool).reshape(dists.shape)
        )
        self._dists.append(dists)
        self._vis.append(vis)

    def _pooled(self):
        if not self._dists:
            return None, None
        return np.concatenate(self._dists, 0), np.concatenate(self._vis, 0)

    def merge_distributed(self):
        """Pool the error shards of every process (the JAX package's
        all-gather, :85-169). A no-op in one process; the multi-process half
        comes with the DDP slice."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise NotImplementedError(
                "merging PCK pools across processes comes with the DDP slice")

    def get_measures(self, val_min: float, val_max: float, steps: int):
        """Returns (epe_mean_all, epe_mean_per_kp, epe_median_all, auc_all,
        pck_curve_all, thresholds) following the reference protocol
        (zimeval.py:80-129, called as epochpass3d.py:168-175)."""
        thresholds = np.linspace(val_min, val_max, steps)
        dists, vis = self._pooled()
        if dists is None:
            nan = float("nan")
            return nan, [], nan, nan, np.full(steps, np.nan), thresholds

        epe_means, epe_medians, pck_curves, aucs = [], [], [], []
        for k in range(self.num_kp):
            d = dists[:, k][vis[:, k]]
            if d.size == 0:
                continue
            epe_means.append(d.mean())
            epe_medians.append(np.median(d))
            pck = (d[None, :] <= thresholds[:, None]).mean(axis=1)
            pck_curves.append(pck)
            auc = _trapezoid(pck, thresholds) / (val_max - val_min)
            aucs.append(auc)

        if not aucs:
            nan = float("nan")
            return nan, [], nan, nan, np.full(steps, np.nan), thresholds
        pck_curve_all = np.mean(np.stack(pck_curves), axis=0)
        return (
            float(np.mean(epe_means)),
            epe_means,
            float(np.mean(epe_medians)),
            float(np.mean(aucs)),
            pck_curve_all,
            thresholds,
        )
