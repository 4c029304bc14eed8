"""Teacher evaluation: per-label 3-branch metrics of the residual-fusion
modes, stage 2 / stage 4 metrics of ``single``, and their console gap
tables; the port's counterpart of
``multimodal_edema_prediction_tpu/train/evaluator.py`` (reference
``training_duett/evaluator.py:101-175, :198-391``). Logits stream from
the eval step to host numpy; metrics are the sklearn-exact numpy
implementations in :mod:`..ops.metrics`.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from ..ops import metrics as M
from .engine import to_device


def collect_dual_outputs(eval_step, model, dataset, split: str,
                         batch_size: int, limit: int = 0) -> dict:
    """Stream a split through the teacher eval step → host arrays. The last
    batch is padded to ``batch_size`` (``AnchorDataset.iter_batches``); its
    padding rows are dropped through ``valid``."""
    device = dataset.grid.device
    acc = {k: [] for k in ("img", "ts", "fus", "corr", "y", "mask", "main")}
    for batch in dataset.iter_batches(split, batch_size, shuffle=False,
                                      limit=limit):
        valid = np.asarray(batch.pop("valid")) > 0
        out = eval_step(model, dataset.grid, dataset.static,
                        to_device(batch, device))
        for key, name in (("img", "img_logits"), ("ts", "ts_logits"),
                          ("fus", "fusion_logits"),
                          ("corr", "scaled_correction"),
                          ("main", "main_logit")):
            acc[key].append(out[name].cpu().numpy()[valid])
        acc["y"].append(np.asarray(batch["y_multi"])[valid])
        acc["mask"].append(np.asarray(batch["y_multi_mask"])[valid])
    return {k: np.concatenate(v) for k, v in acc.items()}


def evaluate_dual_pathology(eval_step, model, dataset, split: str,
                            batch_size: int,
                            pathology_labels: Sequence[str],
                            beta: Optional[np.ndarray] = None,
                            limit: int = 0) -> dict:
    """Per-label img/ts/fusion AUROC/AUPRC + BCE deltas + residual usage
    (evaluator.py:198-335). main metric = macro fusion AUROC. The collected
    host arrays ride along under ``outputs``."""
    o = collect_dual_outputs(eval_step, model, dataset, split, batch_size,
                             limit)
    y, mk = o["y"], o["mask"]
    per = M.masked_multilabel_metrics(
        y, mk, {"img": o["img"], "ts": o["ts"], "fus": o["fus"]})
    K = y.shape[1]
    for k in range(K):
        r = per[k]
        r["name"] = pathology_labels[k]
        m = mk[:, k].astype(bool)
        yk = y[m, k]
        li, lf = o["img"][m, k], o["fus"][m, k]
        r["gap_i2f"] = r["fus_auroc"] - r["img_auroc"]
        r["gap_t2f"] = r["fus_auroc"] - r["ts_auroc"]
        img_bce = float(M.bce_per_sample(li, yk).mean()) if yk.size \
            else float("nan")
        fus_bce = float(M.bce_per_sample(lf, yk).mean()) if yk.size \
            else float("nan")
        ts_bce = float(M.bce_per_sample(o["ts"][m, k], yk).mean()) \
            if yk.size else float("nan")
        r["img_bce"], r["ts_bce"], r["fus_bce"] = img_bce, ts_bce, fus_bce
        r["delta_bce"] = fus_bce - img_bce
        if yk.size:
            ck = o["corr"][m, k]
            pi = 1.0 / (1.0 + np.exp(-li))
            r["mean_abs_corr"] = float(np.abs(ck).mean())
            r["corr_residual"] = M.pearson(ck, yk - pi)
        else:
            r["mean_abs_corr"] = r["corr_residual"] = float("nan")
        r["beta"] = float(beta[k]) if beta is not None else float("nan")
    return {
        "labels": list(pathology_labels),
        "n": int(len(y)),
        "main_auroc": M.macro_mean(per, "fus_auroc"),
        "main_auprc": M.macro_mean(per, "fus_auprc"),
        "per_label": per,
        "outputs": o,
    }


def evaluate_pathology(eval_step, model, dataset, split: str,
                       batch_size: int, pathology_labels: Sequence[str],
                       limit: int = 0) -> dict:
    """``single`` mode (JAX ``evaluator.py:89-119``): per-label stage 2 /
    stage 4 AUROC and AUPRC and their gaps; main metric = macro stage 4
    AUROC. ``eval_step`` returns ``stage2_logits`` and
    ``stage4_logits``."""
    device = dataset.grid.device
    acc = {k: [] for k in ("s2", "s4", "y", "mask")}
    for batch in dataset.iter_batches(split, batch_size, shuffle=False,
                                      limit=limit):
        valid = np.asarray(batch.pop("valid")) > 0
        out = eval_step(model, dataset.grid, dataset.static,
                        to_device(batch, device))
        acc["s2"].append(out["stage2_logits"].cpu().numpy()[valid])
        acc["s4"].append(out["stage4_logits"].cpu().numpy()[valid])
        acc["y"].append(np.asarray(batch["y_multi"])[valid])
        acc["mask"].append(np.asarray(batch["y_multi_mask"])[valid])
    o = {k: np.concatenate(v) for k, v in acc.items()}
    per = M.masked_multilabel_metrics(o["y"], o["mask"],
                                      {"stage2": o["s2"], "stage4": o["s4"]})
    for k, r in enumerate(per):
        r["name"] = pathology_labels[k]
        r["gap_auroc"] = r["stage4_auroc"] - r["stage2_auroc"]
        r["gap_auprc"] = r["stage4_auprc"] - r["stage2_auprc"]
    return {"labels": list(pathology_labels), "n": int(len(o["y"])),
            "main_auroc": M.macro_mean(per, "stage4_auroc"),
            "main_auprc": M.macro_mean(per, "stage4_auprc"),
            "per_label": per, "outputs": o}


def format_pathology_gap_table(result: dict) -> str:
    """Console stage 2 / stage 4 gap table (evaluator.py:163-175)."""
    header = (f"{'label':<22s} {'n':>6s} {'pos':>7s} "
              f"{'s2_auroc':>10s} {'s4_auroc':>10s} {'gap_ro':>8s} "
              f"{'s2_auprc':>10s} {'s4_auprc':>10s} {'gap_pr':>8s}")
    lines = [header]
    for r in result["per_label"]:
        lines.append(
            f"{r['name']:<22s} {r['n_valid']:>6d} {r['pos_frac']:>7.4f} "
            f"{r['stage2_auroc']:>10.4f} {r['stage4_auroc']:>10.4f} "
            f"{r['gap_auroc']:>+8.4f} "
            f"{r['stage2_auprc']:>10.4f} {r['stage4_auprc']:>10.4f} "
            f"{r['gap_auprc']:>+8.4f}")
    return "\n".join(lines)


def _fmt(v, spec="7.3f"):
    width = spec.split(".")[0].lstrip("+")
    try:
        if math.isnan(float(v)):
            return f"{'--':>{width}s}"
    except (TypeError, ValueError):
        return f"{'--':>{width}s}"
    return f"{v:{spec}}"


def format_dual_pathology_gap_table(result: dict) -> str:
    """Fixed-width residual-fusion table (evaluator.py:350-391)."""
    header = (f"{'label':<12s} "
              f"{'imgROC':>7s} {'tsROC':>7s} {'fusROC':>7s} {'gain':>7s}  "
              f"{'imgAP':>6s} {'tsAP':>6s} {'fusAP':>6s}  "
              f"{'dBCE':>7s}  {'|corr|':>7s} {'corr_r':>7s}  {'beta':>6s}")
    lines = [header, "-" * len(header)]
    for r in result["per_label"]:
        short = r["name"].replace("label_", "")
        lines.append(
            f"{short:<12s} "
            f"{_fmt(r['img_auroc'])} {_fmt(r['ts_auroc'])} "
            f"{_fmt(r['fus_auroc'])} {_fmt(r['gap_i2f'], '+7.3f')}  "
            f"{_fmt(r['img_auprc'], '6.3f')} {_fmt(r['ts_auprc'], '6.3f')} "
            f"{_fmt(r['fus_auprc'], '6.3f')}  "
            f"{_fmt(r['delta_bce'], '+7.4f')}  "
            f"{_fmt(r['mean_abs_corr'], '7.4f')} "
            f"{_fmt(r['corr_residual'], '+7.3f')}  "
            f"{_fmt(r['beta'], '6.3f')}")
    lines.append("-" * len(header))
    lines.append(
        f"{'mAP (macro)':<12s} {'':>7s} {'':>7s} {'':>7s} {'':>7s}  "
        f"{_fmt(M.macro_mean(result['per_label'], 'img_auprc'), '6.3f')} "
        f"{_fmt(M.macro_mean(result['per_label'], 'ts_auprc'), '6.3f')} "
        f"{_fmt(M.macro_mean(result['per_label'], 'fus_auprc'), '6.3f')}")
    return "\n".join(lines)
