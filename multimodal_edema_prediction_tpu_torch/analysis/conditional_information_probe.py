"""Post-hoc conditional-information probes: does the time-series branch add
label information beyond the image? The counterpart of
``multimodal_edema_prediction_tpu/analysis/conditional_information_probe.py``
(reference ``analysis/conditional_information_probe.py``). Logistic probes
on the frozen teacher's outputs, per label:

    image_cal          1-feature recalibration of the image logit (base)
    logit_add          [img_logit, ts_logit]
    logit_interaction  [img, ts, img·ts]
    token_linear       [img_logit, fusion-token features]

with paired subject-cluster bootstrap CIs on ΔAUROC against
``image_cal``, a conditional permutation null (the time-series features
permuted within image-risk quantile bins, so the image's marginal
information stays, :311-351) and the evidence grade
supported / suggestive / not_detected (:488-574).

The probe is sklearn's ``LogisticRegression(max_iter=2000, C=1.0)``
(JAX ``:96``) as ``fit_logistic``: scipy's L-BFGS-B on sklearn's own
objective, precision and options, which stops where sklearn's stops (its
``gtol`` of 1e-4 is short of the optimum: an exact solve would move the
reports by up to ~1.6% of a score's scale). scipy is imported inside the
fit; where it cannot be imported the script raises.

    python -m multimodal_edema_prediction_tpu_torch.analysis.conditional_information_probe \\
        --ckpt runs/<run>/best-*.msgpack --device cuda [--cxr_feature_cache hbm]

Writes ``conditional_information_probe.json``, ``conditional_probe.csv``
and ``conditional_probe_predictions.npz``.
"""
from __future__ import annotations

import argparse
import csv
import os
import re
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import metrics as M
from ..train import engine
from .common import (add_analysis_flags, load_for_analysis, save_json,
                     subject_cluster_bootstrap, window_batch)

PROBES = ("image_cal", "logit_add", "logit_interaction", "token_linear")


def collect_with_tokens(model, anchor_ds, split: str, batch_size: int,
                        image_source, label_idx: int = 0,
                        feature_source=None, dtype=torch.bfloat16) -> dict:
    """img/ts logits, the main label's fusion token, y and subject ids of
    the split's full batches where label ``label_idx`` is known."""
    eval_step = engine.make_teacher_eval_from_windows(
        model, dtype, image_source=image_source,
        feature_source=feature_source, return_attn=True)
    a = anchor_ds.anchor
    idx_all = anchor_ds.splits[split]
    out = {"img": [], "ts": [], "tok": [], "y": [], "sid": []}
    if len(idx_all) == 0:
        raise ValueError(f"split {split!r} is empty")
    if len(idx_all) < batch_size:   # tiny cohort: one short batch
        batch_size = len(idx_all)
    n = len(idx_all) - (len(idx_all) % batch_size)
    for i in range(0, n, batch_size):
        idx = idx_all[i:i + batch_size]
        o = eval_step(*window_batch(anchor_ds, idx))
        keep = a["y_multi_mask"][idx][:, label_idx] > 0
        out["img"].append(o["img_logits"].cpu().numpy()[keep, label_idx])
        out["ts"].append(o["ts_logits"].cpu().numpy()[keep, label_idx])
        tok = o["fusion_tokens"].cpu().numpy() if "fusion_tokens" in o \
            else np.zeros((len(idx), 1, 1))
        out["tok"].append(tok[keep, label_idx])
        out["y"].append(a["y_multi"][idx][keep, label_idx])
        out["sid"].append(a["subject_ids"][idx][keep])
    return {k: np.concatenate(v) for k, v in out.items()}


def probe_features(name: str, d: dict) -> np.ndarray:
    img, ts = d["img"][:, None], d["ts"][:, None]
    if name == "image_cal":
        return img
    if name == "logit_add":
        return np.concatenate([img, ts], axis=1)
    if name == "logit_interaction":
        return np.concatenate([img, ts, img * ts], axis=1)
    if name == "token_linear":
        tok = d["tok"].reshape(len(d["y"]), -1)
        # standardize tokens to keep the logistic probe conditioned
        tok = (tok - tok.mean(0)) / (tok.std(0) + 1e-6)
        return np.concatenate([img, tok], axis=1)
    raise ValueError(name)


# sklearn's LogisticRegression(max_iter=2000, C=1.0), as JAX calls it
LOGISTIC_C = 1.0
LOGISTIC_MAX_ITER = 2000


def _half_binomial(y: np.ndarray, raw: np.ndarray):
    """Per-sample log-loss log(1 + e^raw) − y·raw and its gradient
    σ(raw) − y, in float64 by sklearn's branches
    (``closs_grad_half_binomial``)."""
    e_pos = np.exp(np.minimum(raw, 0.0))
    e_neg = np.exp(-np.maximum(raw, -37.0))
    loss = np.where(
        raw <= -37, e_pos - y * raw,
        np.where(raw <= -2, np.log1p(e_pos) - y * raw,
                 np.where(raw <= 18, np.log1p(e_neg) + (1 - y) * raw,
                          e_neg + (1 - y) * raw)))
    grad = np.where(raw <= -37, e_pos - y,
                    np.where(raw <= -2, ((1 - y) * e_pos - y) / (1 + e_pos),
                             ((1 - y) - y * e_neg) / (1 + e_neg)))
    return loss, grad


def fit_logistic(X: np.ndarray, y: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(w, b) of sklearn's ``LogisticRegression(max_iter=2000, C=1.0)``
    (lbfgs, L2, binary), in X's dtype: ``scipy.optimize.minimize(
    method="L-BFGS-B")`` from w = 0, b = 0 on the mean binary log-loss plus
    ½·(1/(C·n))·‖w‖² (the intercept not penalized), with sklearn's options
    (``maxiter`` 2000, ``maxls`` 50, ``gtol`` 1e-4, ``ftol`` 64·eps). A
    ``y`` of one class raises ``ValueError``, as sklearn does. As sklearn
    does, a float32 X keeps the start, the predictions X·w + b, the
    per-sample losses and gradients and their sums in float32 (each
    sample's loss taken in float64), the penalty in float64; any other X
    runs in float64. sklearn's search stops at its ``gtol``, short
    of the optimum, so the float32 rounding moves where it stops: on the
    same float32 input the two agree bit for bit."""
    from scipy.optimize import minimize
    if np.unique(y).size < 2:
        raise ValueError("fit_logistic needs samples of at least 2 classes; "
                         f"y holds only {np.unique(y)}")
    dt = np.float32 if np.asarray(X).dtype == np.float32 else np.float64
    X = np.ascontiguousarray(X, dtype=dt)
    y = np.asarray(y).astype(dt)
    y64 = y.astype(np.float64)
    n, f = X.shape
    l2 = 1.0 / (LOGISTIC_C * n)

    def obj(wb):
        w = wb[:f]
        raw = X @ w.astype(dt) + np.asarray(wb[f], dtype=dt)
        loss_i, grad_i = _half_binomial(y64, raw.astype(np.float64))
        loss = float(np.sum(loss_i.astype(dt)) / n) \
            + float(0.5 * l2 * (w @ w))
        g = grad_i.astype(dt)
        g /= n
        grad = np.empty(f + 1)
        grad[:f] = X.T @ g + l2 * w
        grad[f] = np.sum(g)
        return loss, grad

    # the start in X's dtype, as sklearn's: scipy keeps a float32 start's
    # iterates in float32
    res = minimize(obj, np.zeros(f + 1, dtype=dt), method="L-BFGS-B",
                   jac=True,
                   options={"maxiter": LOGISTIC_MAX_ITER, "maxls": 50,
                            "gtol": 1e-4, "ftol": 64 * np.finfo(float).eps})
    return res.x[:f].astype(dt), res.x[f:].astype(dt)


def logistic_decision(X: np.ndarray, w: np.ndarray, b: np.ndarray
                      ) -> np.ndarray:
    """sklearn's ``decision_function``: X·wᵀ + b, in w's dtype."""
    X = np.asarray(X, dtype=w.dtype)
    return (X @ w[None, :].T + b).ravel()


def fit_eval(name: str, tr: dict, ev: dict) -> Dict[str, float]:
    Xtr, Xev = probe_features(name, tr), probe_features(name, ev)
    w, b = fit_logistic(Xtr, tr["y"])
    s = logistic_decision(Xev, w, b)
    return {"auroc": M.auroc(ev["y"], s),
            "auprc": M.average_precision(ev["y"], s),
            "scores": s}


def conditional_permutation_null(tr: dict, ev: dict, probe: str = "logit_add",
                                 n_perm: int = 50, n_bins: int = 5,
                                 seed: int = 0) -> np.ndarray:
    """Permute TS features within image-risk quantile bins → AUROC null."""
    rng = np.random.default_rng(seed)
    edges = np.quantile(tr["img"], np.linspace(0, 1, n_bins + 1))
    bins_tr = np.clip(np.searchsorted(edges, tr["img"]) - 1, 0, n_bins - 1)
    nulls = []
    for _ in range(n_perm):
        tr_p = dict(tr)
        ts_p = tr["ts"].copy()
        tok_p = tr["tok"].copy()
        for b in range(n_bins):
            sel = np.nonzero(bins_tr == b)[0]
            perm = rng.permutation(sel)
            ts_p[sel] = tr["ts"][perm]
            tok_p[sel] = tr["tok"][perm]
        tr_p["ts"], tr_p["tok"] = ts_p, tok_p
        nulls.append(fit_eval(probe, tr_p, ev)["auroc"])
    return np.asarray(nulls)


def grade_evidence(delta: float, ci_lo: float, p_perm: float) -> str:
    if delta > 0 and ci_lo > 0 and p_perm < 0.05:
        return "supported"
    if delta > 0 and (ci_lo > -0.005 or p_perm < 0.15):
        return "suggestive"
    return "not_detected"


def run_label(model, anchor_ds, image_source, args, label_idx: int,
              feature_source=None, dtype=torch.bfloat16) -> tuple:
    """(the four probes' report, the eval split's per-sample archive) of
    one label; both splits are collected anew for each label, as in
    JAX."""
    tr = collect_with_tokens(model, anchor_ds, "train", args.batch_size,
                             image_source, label_idx, feature_source, dtype)
    ev = collect_with_tokens(model, anchor_ds, args.split, args.batch_size,
                             image_source, label_idx, feature_source, dtype)
    results, scores = {}, {}
    for name in PROBES:
        r = fit_eval(name, tr, ev)
        scores[name] = r.pop("scores")
        results[name] = r

    base_auroc = results["image_cal"]["auroc"]
    sid = ev["sid"]
    for name in PROBES[1:]:
        delta = results[name]["auroc"] - base_auroc

        def boot_stat(idx, name=name):
            return (M.auroc(ev["y"][idx], scores[name][idx])
                    - M.auroc(ev["y"][idx], scores["image_cal"][idx]))

        ci = subject_cluster_bootstrap(sid, boot_stat, args.n_boot, args.seed)
        nulls = conditional_permutation_null(tr, ev, name, args.n_perm,
                                             seed=args.seed)
        p_perm = float((nulls >= results[name]["auroc"]).mean())
        results[name].update({
            "delta_auroc_vs_image": delta,
            "ci_lo": ci["lo"], "ci_hi": ci["hi"],
            "p_conditional_perm": p_perm,
            "evidence": grade_evidence(delta, ci["lo"], p_perm)})
    # per-sample eval-split archive (reference prediction_archive,
    # conditional_information_probe.py:432, :555-557)
    archive = {"y": ev["y"].astype(np.float32), "subject_ids": ev["sid"]}
    for name in PROBES:
        archive[f"{name}_probability"] = (
            1.0 / (1.0 + np.exp(-scores[name]))).astype(np.float32)
    return results, archive


def slug(s: str) -> str:
    return re.sub(r"[^0-9A-Za-z._-]+", "_", s).strip("_") or "label"


def main(argv=None, dtype=torch.bfloat16) -> dict:
    """``dtype``: the evals' compute precision (the CLI's is bf16, as the
    JAX script's)."""
    p = argparse.ArgumentParser("conditional information probes")
    add_analysis_flags(p)
    p.add_argument("--n_perm", type=int, default=30)
    p.add_argument("--label_idx", type=int, default=-1,
                   help="-1 (default) sweeps ALL pathology labels, matching "
                        "the reference analysis scope")
    args = p.parse_args(argv)
    model, _, anchor_ds, dcfg, image_source, feature_source = \
        load_for_analysis(args, dtype, grid_on_device=False)
    labels = dcfg.pathology_labels
    idxs = range(len(labels)) if args.label_idx < 0 else [args.label_idx]
    all_results, csv_rows, archives = {}, [], {}
    for li in idxs:
        results, archive = run_label(model, anchor_ds, image_source, args,
                                     li, feature_source, dtype)
        all_results[labels[li]] = results
        for key, arr in archive.items():
            archives[f"{slug(labels[li])}_{key}"] = arr
        print(f"== {labels[li]} ==")
        print(f"{'probe':<18s} {'AUROC':>7s} {'dAUROC':>8s} "
              f"{'95% CI':>20s} {'p_perm':>7s}  evidence")
        for name in PROBES:
            r = results[name]
            csv_rows.append({"label": labels[li], "probe": name, **r})
            if name == "image_cal":
                print(f"{name:<18s} {r['auroc']:>7.4f}")
            else:
                print(f"{name:<18s} {r['auroc']:>7.4f} "
                      f"{r['delta_auroc_vs_image']:>+8.4f} "
                      f"[{r['ci_lo']:+.4f}, {r['ci_hi']:+.4f}] "
                      f"{r['p_conditional_perm']:>7.3f}  {r['evidence']}")
    save_json(all_results, args.out_dir, "conditional_information_probe.json")
    # reference file outputs: per-probe CSV + per-sample probability archive
    # (conditional_information_probe.py:575-582)
    fieldnames = sorted({k for row in csv_rows for k in row},
                        key=lambda k: (k not in ("label", "probe"), k))
    with open(os.path.join(args.out_dir, "conditional_probe.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        w.writerows(csv_rows)
    np.savez_compressed(
        os.path.join(args.out_dir, "conditional_probe_predictions.npz"),
        **archives)
    return all_results


if __name__ == "__main__":
    main()
