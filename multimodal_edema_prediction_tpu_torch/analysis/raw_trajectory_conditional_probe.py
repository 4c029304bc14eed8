"""Conditional-information probe on RAW time-series summaries: the
counterpart of
``multimodal_edema_prediction_tpu/analysis/raw_trajectory_conditional_probe.py``
(reference ``analysis/raw_trajectory_conditional_probe.py``). It asks the
conditional probe's question without the trained time-series encoder:
per-variable summary blocks of the window itself (:75-110, :329-483)

    level        last observed value, window mean
    trajectory   slope of observed values over time, last-minus-first
    observation  observed-hour count, time since last observation

feed a frozen-image offset-logistic correction with the reference's
model selection (:563-747): a grid of L2 strengths plus an exact-null
candidate (w = 0, the calibrated image predictor itself), a stratified
inner CV with per-fold median-impute and standardization fit on the fold's
train part, a null tolerance under which the null wins ties, and a final
refit on the whole train split. Inference: subject-cluster bootstrap CIs
(:760-801) and a conditional permutation within image-risk bins
(:804-840). Every pathology label is swept by default.

The teacher runs once per split (both collected before the label loop,
:303-338); the fits are JAX's numpy and ``scipy.optimize.minimize`` code
(scipy imported inside ``fit_offset_weights``).

    python -m multimodal_edema_prediction_tpu_torch.analysis.raw_trajectory_conditional_probe \\
        --ckpt runs/<run>/best-*.msgpack --device cuda [--cxr_feature_cache hbm]

Writes ``raw_trajectory_probe.json``, ``raw_trajectory_probe.csv`` and
``raw_trajectory_probe_predictions.npz``.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops import metrics as M
from ..train import engine
from .common import (add_analysis_flags, load_for_analysis, save_json,
                     subject_cluster_bootstrap, window_batch)
from .conditional_information_probe import slug

BLOCKS = ("level", "trajectory", "observation")
L2_GRID = (1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0)   # ref :225-227
NULL_TOLERANCE = 5e-4                                  # ref :229-236


def raw_summaries(x_ts: np.ndarray, blocks=BLOCKS) -> np.ndarray:
    """[N, T, 2V] windows → [N, F] raw per-variable summary features,
    unstandardized (standardization is fit on each training fold inside
    ``fit_offset_correction``)."""
    N, T, C = x_ts.shape
    V = C // 2
    values, counts = x_ts[..., :V], x_ts[..., V:]
    obs = counts > 0
    any_obs = obs.any(axis=1)                              # [N, V]
    last_idx = T - 1 - np.argmax(obs[:, ::-1, :], axis=1)
    last_val = np.take_along_axis(values, last_idx[:, None, :],
                                  axis=1)[:, 0, :]
    feats = []
    if "level" in blocks:
        denom = np.maximum(obs.sum(axis=1), 1)
        mean_val = (values * obs).sum(axis=1) / denom
        feats += [np.where(any_obs, last_val, 0.0), mean_val]
    if "trajectory" in blocks:
        t = np.arange(T, dtype=np.float64)[None, :, None]
        w = obs.astype(np.float64)
        sw = w.sum(axis=1)
        t_mean = (w * t).sum(axis=1) / np.maximum(sw, 1)
        v_mean = (w * values).sum(axis=1) / np.maximum(sw, 1)
        cov = (w * (t - t_mean[:, None, :])
               * (values - v_mean[:, None, :])).sum(axis=1)
        var = (w * (t - t_mean[:, None, :]) ** 2).sum(axis=1)
        slope = np.where(var > 0, cov / np.maximum(var, 1e-9), 0.0)
        first_val = np.take_along_axis(values, np.argmax(obs, axis=1)[
            :, None, :], axis=1)[:, 0, :]
        feats += [slope.astype(np.float32),
                  np.where(any_obs, last_val - first_val, 0.0)]
    if "observation" in blocks:
        n_obs = obs.sum(axis=1).astype(np.float32) / T
        recency = np.where(any_obs, (T - 1 - last_idx) / T, 1.0)
        feats += [n_obs, recency.astype(np.float32)]
    return np.concatenate(feats, axis=1).astype(np.float32)


# =============================================================================
# Offset-logistic correction with exact-null candidate search (ref :563-747)
# =============================================================================
def _bce_from_scores(y: np.ndarray, score: np.ndarray) -> float:
    s = np.asarray(score, np.float64)
    y = np.asarray(y, np.float64)
    return float(np.mean(np.maximum(s, 0) - s * y
                         + np.log1p(np.exp(-np.abs(s)))))


def fit_offset_weights(X: np.ndarray, y: np.ndarray, offset: np.ndarray,
                       l2: float, max_iter: int = 200) -> np.ndarray:
    """L-BFGS fit of w only in σ(offset + X·w) + ½·l2·‖w‖² (JAX's call)."""
    from scipy.optimize import minimize
    from scipy.special import expit
    X64 = np.asarray(X, np.float64)
    y64 = np.asarray(y, np.float64)
    o64 = np.asarray(offset, np.float64)
    n = len(y64)

    def obj(w):
        s = o64 + X64 @ w
        loss = _bce_from_scores(y64, s) + 0.5 * l2 * float(w @ w)
        grad = X64.T @ (expit(s) - y64) / n + l2 * w
        return loss, grad

    res = minimize(obj, np.zeros(X64.shape[1]), method="L-BFGS-B", jac=True,
                   options={"maxiter": max_iter, "ftol": 1e-11, "gtol": 1e-7})
    return np.asarray(res.x, np.float64)


@dataclass
class Standardizer:
    """Median-impute + z-score, fit on the training fold only."""
    median: np.ndarray
    mu: np.ndarray
    sd: np.ndarray

    @classmethod
    def fit(cls, X: np.ndarray) -> "Standardizer":
        med = np.nanmedian(X, axis=0)
        med = np.where(np.isfinite(med), med, 0.0)
        Xi = np.where(np.isfinite(X), X, med)
        sd = Xi.std(axis=0)
        return cls(median=med, mu=Xi.mean(axis=0),
                   sd=np.where(sd > 0, sd, 1.0))

    def __call__(self, X: np.ndarray) -> np.ndarray:
        Xi = np.where(np.isfinite(X), X, self.median)
        return (Xi - self.mu) / self.sd


def _stratified_folds(y: np.ndarray, n_folds: int, seed: int):
    """Class-stratified fold assignment (the reference's
    StratifiedKFold)."""
    rng = np.random.default_rng(seed)
    fold = np.empty(len(y), np.int64)
    for cls in np.unique(y):
        idx = rng.permutation(np.nonzero(y == cls)[0])
        fold[idx] = np.arange(len(idx)) % n_folds
    return [(np.nonzero(fold != f)[0], np.nonzero(fold == f)[0])
            for f in range(n_folds)]


@dataclass
class OffsetCorrection:
    standardizer: Standardizer
    weights: np.ndarray
    selected_l2: Optional[float]          # None → exact null won
    cv_results: Dict[str, float]          # candidate → mean inner-CV BCE

    @property
    def null_selected(self) -> bool:
        return self.selected_l2 is None

    def decision(self, offset: np.ndarray, X_raw: np.ndarray) -> np.ndarray:
        return offset + self.standardizer(X_raw) @ self.weights


def fit_offset_correction(X_raw: np.ndarray, y: np.ndarray,
                          offset: np.ndarray,
                          l2_grid: Sequence[float] = L2_GRID,
                          cv_folds: int = 5,
                          null_tolerance: float = NULL_TOLERANCE,
                          seed: int = 0) -> OffsetCorrection:
    """Inner-CV candidate search with an exact zero-correction null. The
    image offset is never re-estimated or regularized, so the null
    reproduces the calibrated image predictor exactly; ties (within
    ``null_tolerance``) go to the null."""
    names = ["null"] + [f"l2={v:g}" for v in l2_grid]
    losses: Dict[str, list] = {n: [] for n in names}
    for tr, va in _stratified_folds(y, cv_folds, seed):
        std = Standardizer.fit(X_raw[tr])
        Xtr, Xva = std(X_raw[tr]), std(X_raw[va])
        losses["null"].append(_bce_from_scores(y[va], offset[va]))
        for l2 in l2_grid:
            w = fit_offset_weights(Xtr, y[tr], offset[tr], l2)
            losses[f"l2={l2:g}"].append(
                _bce_from_scores(y[va], offset[va] + Xva @ w))
    mean_losses = {n: float(np.mean(v)) for n, v in losses.items()}
    best = min((n for n in names if n != "null"), key=mean_losses.__getitem__)
    sel_l2 = None if mean_losses["null"] <= mean_losses[best] \
        + null_tolerance else float(best.split("=", 1)[1])
    std = Standardizer.fit(X_raw)
    w = np.zeros(X_raw.shape[1], np.float64) if sel_l2 is None else \
        fit_offset_weights(std(X_raw), y, offset, sel_l2)
    return OffsetCorrection(standardizer=std, weights=w, selected_l2=sel_l2,
                            cv_results=mean_losses)


# =============================================================================
# Per-label probe
# =============================================================================
def run_label(xw_tr, img_tr, y_tr, xw_ev, img_ev, y_ev, sid_ev,
              args) -> tuple:
    results = {}
    X_tr_all = raw_summaries(xw_tr)
    X_ev_all = raw_summaries(xw_ev)
    base_auroc = M.auroc(y_ev, img_ev)
    results["image_only"] = {"auroc": base_auroc}

    corr = fit_offset_correction(X_tr_all, y_tr, img_tr,
                                 cv_folds=args.cv_folds,
                                 null_tolerance=args.null_tolerance,
                                 seed=args.seed)
    scores = corr.decision(img_ev, X_ev_all)
    auroc = M.auroc(y_ev, scores)

    def boot(idx):
        return M.auroc(y_ev[idx], scores[idx]) - M.auroc(y_ev[idx],
                                                         img_ev[idx])

    ci = subject_cluster_bootstrap(sid_ev, boot, args.n_boot, args.seed)

    # conditional permutation within image-risk quintiles (ref :804-840)
    rng = np.random.default_rng(args.seed)
    edges = np.quantile(img_tr, np.linspace(0, 1, 6))
    bins = np.clip(np.searchsorted(edges, img_tr) - 1, 0, 4)
    nulls = []
    for _ in range(args.n_perm):
        Xp = X_tr_all.copy()
        for bnum in range(5):
            sel = np.nonzero(bins == bnum)[0]
            Xp[sel] = X_tr_all[rng.permutation(sel)]
        cp = fit_offset_correction(Xp, y_tr, img_tr, seed=args.seed)
        nulls.append(M.auroc(y_ev, cp.decision(img_ev, X_ev_all)))
    p_perm = float((np.asarray(nulls) >= auroc).mean())

    results["offset_logistic"] = {
        "auroc": auroc, "delta_vs_image": auroc - base_auroc,
        "selected_l2": corr.selected_l2,
        "null_selected": corr.null_selected,
        "inner_cv_bce": corr.cv_results,
        "ci_lo": ci["lo"], "ci_hi": ci["hi"],
        "p_conditional_perm": p_perm,
        "evidence": ("supported" if not corr.null_selected and ci["lo"] > 0
                     and p_perm < 0.05 else
                     "suggestive" if not corr.null_selected
                     and auroc > base_auroc else
                     "not_detected"),
    }
    # per-block ablation, each with its own candidate search
    for block in BLOCKS:
        Xb_tr = raw_summaries(xw_tr, blocks=(block,))
        Xb_ev = raw_summaries(xw_ev, blocks=(block,))
        cb = fit_offset_correction(Xb_tr, y_tr, img_tr, seed=args.seed)
        results[f"block_{block}"] = {
            "auroc": M.auroc(y_ev, cb.decision(img_ev, Xb_ev)),
            "null_selected": cb.null_selected,
        }
    # per-sample eval predictions for the archive (reference
    # raw_trajectory_probe_predictions.npz, :1114)
    archive = {
        "y": y_ev.astype(np.float32),
        "subject_ids": sid_ev,
        "image_probability": (1.0 / (1.0 + np.exp(-img_ev))
                              ).astype(np.float32),
        "offset_logistic_probability": (1.0 / (1.0 + np.exp(-scores))
                                        ).astype(np.float32),
    }
    return results, archive


def collect(model, anchor_ds, split: str, batch_size: int, image_source,
            feature_source=None, dtype=torch.bfloat16) -> tuple:
    """One sweep of the split's full batches, every label's image logits
    kept: (windows, img logits, y, mask, subject ids)."""
    eval_step = engine.make_teacher_eval_from_windows(
        model, dtype, image_source=image_source,
        feature_source=feature_source)
    a = anchor_ds.anchor
    idx_all = anchor_ds.splits[split]
    xw, img, y, mask, sid = [], [], [], [], []
    bs = min(batch_size, max(len(idx_all), 1))  # tiny cohorts
    n = len(idx_all) - len(idx_all) % bs
    for i in range(0, n, bs):
        idx = idx_all[i:i + bs]
        x_ts, x_static, batch = window_batch(anchor_ds, idx)
        o = eval_step(x_ts, x_static, batch)
        xw.append(x_ts)
        img.append(o["img_logits"].cpu().numpy())
        y.append(a["y_multi"][idx])
        mask.append(a["y_multi_mask"][idx])
        sid.append(a["subject_ids"][idx])
    return (np.concatenate(xw), np.concatenate(img), np.concatenate(y),
            np.concatenate(mask), np.concatenate(sid))


def main(argv=None, dtype=torch.bfloat16) -> dict:
    """``dtype``: the evals' compute precision (the CLI's is bf16, as the
    JAX script's)."""
    p = argparse.ArgumentParser("raw-TS conditional probe")
    add_analysis_flags(p)
    p.add_argument("--label_idx", type=int, default=-1,
                   help="-1 (default) sweeps ALL pathology labels")
    p.add_argument("--n_perm", type=int, default=20)
    p.add_argument("--cv_folds", type=int, default=5)
    p.add_argument("--null_tolerance", type=float, default=NULL_TOLERANCE)
    args = p.parse_args(argv)
    model, _, anchor_ds, dcfg, image_source, feature_source = \
        load_for_analysis(args, dtype, grid_on_device=False)
    xw_tr, img_tr, y_tr, m_tr, _ = collect(
        model, anchor_ds, "train", args.batch_size, image_source,
        feature_source, dtype)
    xw_ev, img_ev, y_ev, m_ev, sid_ev = collect(
        model, anchor_ds, args.split, args.batch_size, image_source,
        feature_source, dtype)
    # feature schema equality guard (reference :888-889)
    assert xw_tr.shape[1:] == xw_ev.shape[1:], "train/eval schema mismatch"

    labels = dcfg.pathology_labels
    idxs = range(len(labels)) if args.label_idx < 0 else [args.label_idx]
    all_results, archives = {}, {}
    for li in idxs:
        ktr = m_tr[:, li] > 0
        kev = m_ev[:, li] > 0
        if ktr.sum() < 20 or kev.sum() < 20 or \
                len(np.unique(y_tr[ktr, li])) < 2:
            all_results[labels[li]] = {"skipped": "insufficient labels"}
            continue
        results, archive = run_label(
            xw_tr[ktr], img_tr[ktr, li], y_tr[ktr, li],
            xw_ev[kev], img_ev[kev, li], y_ev[kev, li],
            sid_ev[kev], args)
        all_results[labels[li]] = results
        for key, arr in archive.items():
            archives[f"{slug(labels[li])}_{key}"] = arr
        r = results["offset_logistic"]
        print(f"== {labels[li]} ==")
        print(f"{'image_only':<18s} {results['image_only']['auroc']:>7.4f}")
        print(f"{'offset_logistic':<18s} {r['auroc']:>7.4f} "
              f"{r['delta_vs_image']:>+8.4f}  {r['evidence']} "
              f"(l2={r['selected_l2']}, "
              f"CI [{r['ci_lo']:+.4f},{r['ci_hi']:+.4f}], "
              f"p={r['p_conditional_perm']:.3f})")
        for block in BLOCKS:
            print(f"{'block_' + block:<18s} "
                  f"{results['block_' + block]['auroc']:>7.4f}")
    save_json(all_results, args.out_dir, "raw_trajectory_probe.json")
    # reference file outputs (:1062-1114): flat per-probe CSV + per-sample
    # probability archive
    csv_rows = []
    for label, res in all_results.items():
        if "skipped" in res:
            csv_rows.append({"label": label, "probe": "skipped"})
            continue
        for probe, r in res.items():
            row = {"label": label, "probe": probe}
            for k, v in r.items():
                row[k] = (json.dumps(v, default=float)
                          if isinstance(v, (dict, list)) else v)
            csv_rows.append(row)
    fieldnames = sorted({k for row in csv_rows for k in row},
                        key=lambda k: (k not in ("label", "probe"), k))
    with open(os.path.join(args.out_dir, "raw_trajectory_probe.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        w.writerows(csv_rows)
    np.savez_compressed(
        os.path.join(args.out_dir, "raw_trajectory_probe_predictions.npz"),
        **archives)
    return all_results


if __name__ == "__main__":
    main()
