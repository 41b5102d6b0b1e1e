"""Standard 7-metric depth evaluation (port copy of
``copenerf_tpu/training/depth_metrics.py``).

Mirrors the reference's ``model/training.py:126-154`` / ``eval.py:223-244``:
nearest-resize pred to GT, valid mask [min_depth, max_depth], median scaling,
then abs_rel / sq_rel / rmse / rmse_log / a1 / a2 / a3.
"""

from __future__ import annotations

import numpy as np


def compute_depth_errors(gt_depth: np.ndarray, pred_depth: np.ndarray,
                         min_depth: float = 0.1, max_depth: float = 80.0,
                         clamp_pred: bool = False):
    import cv2

    pred = cv2.resize(pred_depth, (gt_depth.shape[1], gt_depth.shape[0]),
                      interpolation=cv2.INTER_NEAREST)
    valid = (gt_depth >= min_depth) & (gt_depth <= max_depth)
    pred = pred[valid]
    gt = gt_depth[valid]
    ratio = np.median(gt) / np.median(pred)
    pred = pred * ratio
    if clamp_pred:  # eval.py:239-240 clamps after median scaling
        pred = np.clip(pred, min_depth, max_depth)

    thresh = np.maximum(gt / pred, pred / gt)
    a1 = float((thresh < 1.25).mean())
    a2 = float((thresh < 1.25 ** 2).mean())
    a3 = float((thresh < 1.25 ** 3).mean())
    rmse = float(np.sqrt(((gt - pred) ** 2).mean()))
    rmse_log = float(np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean()))
    abs_rel = float(np.mean(np.abs(gt - pred) / gt))
    sq_rel = float(np.mean(((gt - pred) ** 2) / gt))
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3
