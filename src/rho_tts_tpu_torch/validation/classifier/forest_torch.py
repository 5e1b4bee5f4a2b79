"""Random-forest inference as tensor gathers.

Counterpart of ``rho_tts_tpu/validation/classifier/forest_jax.py``. A fitted
sklearn forest (optionally isotonic-calibrated) becomes flat tables —
per-tree node arrays padded to a common size — evaluated for trees ×
samples at once: a fixed-depth traversal of gathers, a mean over each
fold's trees, a piecewise-linear calibration per fold (:func:`interp`, the
semantics of ``jnp.interp``) and a mean over folds. The drift gate scores a
whole validation batch on the device this way; sklearn stays for training
and as the oracle.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

ForestArrays = Dict[str, Any]

_TABLES = ("left", "right", "feature", "threshold", "leaf_p1", "fold_onehot", "cal_x", "cal_y")


def convert_forest(model, device=None) -> Optional[ForestArrays]:
    """Tables of a RandomForestClassifier, or of a CalibratedClassifierCV
    wrapping one, on ``device`` (default the CPU). None when unsupported."""
    calibrators = []
    forests = []

    cls_name = type(model).__name__
    if cls_name == "CalibratedClassifierCV":
        for cc in model.calibrated_classifiers_:
            est = getattr(cc, "estimator", None)
            if est is None or type(est).__name__ != "RandomForestClassifier":
                return None
            forests.append(est)
            # Per-fold calibrator for the positive class (binary case)
            cal = cc.calibrators[-1]
            if type(cal).__name__ != "IsotonicRegression":
                return None
            calibrators.append((np.asarray(cal.X_thresholds_), np.asarray(cal.y_thresholds_)))
    elif cls_name == "RandomForestClassifier":
        forests.append(model)
    else:
        return None

    trees = [t.tree_ for f in forests for t in f.estimators_]
    if not trees:
        return None
    max_nodes = max(t.node_count for t in trees)
    n_trees = len(trees)

    left = np.full((n_trees, max_nodes), -1, np.int32)
    right = np.full((n_trees, max_nodes), -1, np.int32)
    feature = np.zeros((n_trees, max_nodes), np.int32)
    threshold = np.zeros((n_trees, max_nodes), np.float32)
    leaf_p1 = np.zeros((n_trees, max_nodes), np.float32)
    max_depth = 1

    for i, t in enumerate(trees):
        n = t.node_count
        left[i, :n] = t.children_left
        right[i, :n] = t.children_right
        feature[i, :n] = np.maximum(t.feature, 0)
        threshold[i, :n] = t.threshold
        counts = t.value[:, 0, :]  # (nodes, classes)
        totals = counts.sum(axis=1, keepdims=True)
        probs = counts / np.maximum(totals, 1e-12)
        leaf_p1[i, :n] = probs[:, 1] if probs.shape[1] > 1 else 0.0
        max_depth = max(max_depth, int(t.max_depth))

    fold_sizes = [len(f.estimators_) for f in forests]
    fold_id = np.concatenate([np.full(sz, i, np.int32) for i, sz in enumerate(fold_sizes)])
    cal = None
    if calibrators:
        cal_len = max(x.shape[0] for x, _ in calibrators)
        cal = tuple(
            np.stack([np.pad(c[j], (0, cal_len - c[j].shape[0]), mode="edge") for c in calibrators])
            for j in (0, 1)
        )
    return tables(left, right, feature, threshold, leaf_p1, fold_id, max_depth, cal, device)


def tables(left, right, feature, threshold, leaf_p1, fold_id, max_depth: int,
           cal=None, device=None) -> ForestArrays:
    """The forest's tables on ``device`` from numpy arrays: node tables
    (trees, nodes) with -1 children at leaves, each tree's fold, and, for a
    calibrated forest, ``cal = (cal_x, cal_y)`` of shape (folds, points),
    each row a non-decreasing isotonic table (edge-padded)."""
    dev = torch.device(device or "cpu")
    n_folds = int(np.max(fold_id)) + 1
    onehot = (np.arange(n_folds)[:, None] == np.asarray(fold_id)[None, :]).astype(np.float32)
    out: ForestArrays = {
        "left": torch.as_tensor(np.asarray(left, np.int64), device=dev),
        "right": torch.as_tensor(np.asarray(right, np.int64), device=dev),
        "feature": torch.as_tensor(np.asarray(feature, np.int64), device=dev),
        "threshold": torch.as_tensor(np.asarray(threshold, np.float32), device=dev),
        "leaf_p1": torch.as_tensor(np.asarray(leaf_p1, np.float32), device=dev),
        # (folds, trees): the per-fold tree mean as one product, in a fixed order
        "fold_onehot": torch.as_tensor(onehot / onehot.sum(axis=1, keepdims=True), device=dev),
        "n_folds": n_folds,
        "max_depth": int(max_depth),
    }
    if cal is not None:
        out["cal_x"] = torch.as_tensor(np.asarray(cal[0], np.float32), device=dev)
        out["cal_y"] = torch.as_tensor(np.asarray(cal[1], np.float32), device=dev)
    return out


def to_device(arrays: ForestArrays, device) -> ForestArrays:
    """The same tables on ``device``."""
    return {k: (v.to(device) if k in _TABLES else v) for k, v in arrays.items()}


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` batched over leading axes: x (..., B),
    xp and fp (..., N) with xp non-decreasing.

    The same formula as ``jnp.interp``: the right-side insertion index
    clipped to [1, N-1]; a segment whose width is within f32's smallest
    subnormal of zero takes its left value (so equal neighbours in ``xp``,
    which sklearn's isotonic fit produces, give no NaN); constant beyond
    both ends.
    """
    n = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(), right=True), 1, n - 1)
    j = torch.remainder(i - 1, n)  # a one-point table: i = 0, and jnp wraps -1 to 0
    x0, x1 = torch.gather(xp, -1, j), torch.gather(xp, -1, i)
    f0, f1 = torch.gather(fp, -1, j), torch.gather(fp, -1, i)
    dx = x1 - x0
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx)) * (f1 - f0))
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def _forest_proba(arrays: ForestArrays, x: torch.Tensor) -> torch.Tensor:
    """(B, F) features → (B,) P(class 1), on the tables' device."""
    left, right = arrays["left"], arrays["right"]
    feature, threshold = arrays["feature"], arrays["threshold"]
    n_trees, b = left.shape[0], x.shape[0]
    node = torch.zeros((n_trees, b), dtype=torch.int64, device=x.device)
    xt = x.T  # (F, B)
    cols = torch.arange(b, device=x.device)[None, :].expand(n_trees, b)
    for _ in range(arrays["max_depth"] + 1):
        feat = torch.gather(feature, 1, node)  # (T, B)
        thr = torch.gather(threshold, 1, node)
        go_left = xt[feat, cols] <= thr
        lft = torch.gather(left, 1, node)
        nxt = torch.where(go_left, lft, torch.gather(right, 1, node))
        node = torch.where(lft == -1, node, nxt)  # leaves stay put
    p1 = torch.gather(arrays["leaf_p1"], 1, node)  # (T, B)
    if "cal_x" not in arrays:
        return p1.mean(dim=0)
    fold_mean = arrays["fold_onehot"] @ p1  # (folds, B)
    return interp(fold_mean, arrays["cal_x"], arrays["cal_y"]).mean(dim=0)


def predict_proba(arrays: ForestArrays, features) -> torch.Tensor:
    """P(class 1) for a batch of feature vectors (B, F) or one (F,), computed
    on the tables' device; a (B,) float32 tensor there."""
    x = torch.as_tensor(features)
    x = (x[None] if x.ndim == 1 else x).to(device=arrays["left"].device, dtype=torch.float32)
    with torch.inference_mode():
        return _forest_proba(arrays, x)
