"""sklearn-free AUROC / AUPRC with sklearn-matching semantics: the port's
numpy copy of ``multimodal_edema_prediction_tpu/ops/metrics.py`` (the port
imports nothing of the JAX package).

The reference streams logits to host and calls sklearn
(``training_duett/evaluator.py``). The evaluator keeps the
streaming-accumulate design and computes metrics with rank statistics:

- AUROC = Mann-Whitney U with midrank tie handling — identical to
  ``sklearn.metrics.roc_auc_score``.
- Average precision follows sklearn: AP = Σ_n (R_n − R_{n−1}) · P_n over
  descending unique-score thresholds.

Both return NaN when a class is missing (sklearn raises ValueError; the
reference catches it and substitutes NaN — evaluator.py:28-35).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np


def _midranks(x: np.ndarray) -> np.ndarray:
    """Average ranks (1-based) with midrank ties."""
    order = np.argsort(x, kind="mergesort")
    xs = x[order]
    n = len(x)
    ranks = np.empty(n, dtype=np.float64)
    i = 0
    while i < n:
        j = i
        while j + 1 < n and xs[j + 1] == xs[i]:
            j += 1
        ranks[i:j + 1] = 0.5 * (i + j) + 1.0
        i = j + 1
    out = np.empty(n, dtype=np.float64)
    out[order] = ranks
    return out


def auroc(y_true: np.ndarray, scores: np.ndarray) -> float:
    y = np.asarray(y_true, dtype=np.float64).ravel()
    s = np.asarray(scores, dtype=np.float64).ravel()
    n_pos = float((y > 0.5).sum())
    n_neg = float(len(y) - n_pos)
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = _midranks(s)
    rank_sum_pos = ranks[y > 0.5].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def average_precision(y_true: np.ndarray, scores: np.ndarray) -> float:
    """sklearn ``average_precision_score`` semantics."""
    y = np.asarray(y_true, dtype=np.float64).ravel()
    s = np.asarray(scores, dtype=np.float64).ravel()
    n_pos = (y > 0.5).sum()
    if n_pos == 0 or len(y) == 0:
        return float("nan")
    order = np.argsort(-s, kind="mergesort")
    y_sorted = y[order] > 0.5
    s_sorted = s[order]
    tp = np.cumsum(y_sorted)
    fp = np.cumsum(~y_sorted)
    # Collapse tied scores: keep the last index of each unique threshold.
    last_of_tie = np.r_[s_sorted[1:] != s_sorted[:-1], True]
    tp, fp = tp[last_of_tie], fp[last_of_tie]
    precision = tp / (tp + fp)
    recall = tp / n_pos
    prev_recall = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - prev_recall) * precision))


def binary_metrics(y_true: np.ndarray, logits: np.ndarray) -> Dict[str, float]:
    """AUROC/AUPRC/n/pos_frac of one binary head (evaluator.py:10-37)."""
    probs = 1.0 / (1.0 + np.exp(-np.asarray(logits, dtype=np.float64)))
    y = np.asarray(y_true, dtype=np.float64)
    return {
        "auroc": auroc(y, probs),
        "auprc": average_precision(y, probs),
        "n": int(len(y)),
        "pos_frac": float(y.mean()) if len(y) else float("nan"),
    }


def masked_multilabel_metrics(
        y: np.ndarray, mask: np.ndarray,
        branches: Dict[str, np.ndarray]) -> List[Dict[str, float]]:
    """Per-label metrics for each logits branch.

    y/mask/branch logits: [N, K]. Returns a list of K dicts with
    ``{branch}_auroc`` / ``{branch}_auprc`` / n_valid / pos_frac.
    """
    K = y.shape[1]
    out = []
    for k in range(K):
        m = mask[:, k].astype(bool)
        yk = y[m, k]
        row: Dict[str, float] = {
            "n_valid": int(m.sum()),
            "pos_frac": float(yk.mean()) if len(yk) else float("nan"),
        }
        for name, logits in branches.items():
            p = 1.0 / (1.0 + np.exp(-logits[m, k].astype(np.float64)))
            row[f"{name}_auroc"] = auroc(yk, p)
            row[f"{name}_auprc"] = average_precision(yk, p)
        out.append(row)
    return out


def macro_mean(per_label: Sequence[Dict[str, float]], key: str) -> float:
    vals = [r[key] for r in per_label
            if key in r and not (isinstance(r[key], float) and math.isnan(r[key]))]
    return sum(vals) / len(vals) if vals else float("nan")


def bce_per_sample(logits: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Stable elementwise BCE (evaluator.py:181-183)."""
    l = np.asarray(logits, dtype=np.float64)
    return np.maximum(l, 0) - l * y + np.log1p(np.exp(-np.abs(l)))


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    if a.size < 2 or a.std() == 0 or b.std() == 0:
        return float("nan")
    return float(np.corrcoef(a, b)[0, 1])
