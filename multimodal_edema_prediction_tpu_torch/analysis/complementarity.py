"""Complementarity: does the TS branch fix cases the image misses, and does
fusion keep those fixes? The counterpart of
``multimodal_edema_prediction_tpu/analysis/complementarity.py`` (reference
``analysis/complementarity.py``). Per pathology: Youden-J thresholds on the
validation split, then on the eval split the 2×2 (image-correct ×
ts-correct) contingency and its 3-way refinement with the fusion branch:

    ts_unique_gain     P(ts correct, image wrong)
    ts_redundancy      both_correct / (both_correct + ts_only)
    ts_gain_retention  of ts-only-correct cases, fraction fusion keeps
    fusion_harm_rate   of image-only-correct cases, fraction fusion loses
    emergent_gain      of both-wrong cases, fraction fusion saves
    kappa_img_ts       Cohen's κ between branch correctness indicators

    python -m multimodal_edema_prediction_tpu_torch.analysis.complementarity \\
        --ckpt runs/<run>/best-*.msgpack --device cuda [--cxr_feature_cache hbm]

Writes ``complementarity.json``, ``complementarity.csv`` and, where
matplotlib can be imported, one ``venn_<label>.png`` per label with
positives.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Dict

import numpy as np
import torch

from ..ops.metrics import pearson
from ..train import engine
from ..train.evaluator import collect_dual_outputs
from .common import (add_analysis_flags, load_for_analysis,
                     report_skipped_figures, save_json, write_figure)


def youden_threshold(logits: np.ndarray, y: np.ndarray) -> float:
    """Logit threshold maximizing TPR − FPR."""
    if len(np.unique(y)) < 2:
        return float("nan")
    order = np.argsort(-logits, kind="mergesort")
    ys = y[order] > 0.5
    tp = np.cumsum(ys)
    fp = np.cumsum(~ys)
    tpr = tp / max(ys.sum(), 1)
    fpr = fp / max((~ys).sum(), 1)
    j = tpr - fpr
    i = int(np.argmax(j))
    return float(logits[order][i])


def cohens_kappa(a: np.ndarray, b: np.ndarray) -> float:
    if len(a) == 0:
        return float("nan")
    po = float((a == b).mean())
    pa, pb = float(a.mean()), float(b.mean())
    pe = pa * pb + (1 - pa) * (1 - pb)
    return (po - pe) / (1 - pe) if pe != 1 else float("nan")


def _ratio(a, b):
    return a / b if b > 0 else float("nan")


def analyze_label(y: np.ndarray, img_ok: np.ndarray, ts_ok: np.ndarray,
                  fus_ok: np.ndarray) -> Dict[str, float]:
    n = len(y)
    if n == 0:
        return {"n": 0}
    cells3 = {}
    for name, sel in (
            ("ts_only_and_fus_ok", ~img_ok & ts_ok & fus_ok),
            ("ts_only_but_fus_lost_it", ~img_ok & ts_ok & ~fus_ok),
            ("image_only_and_fus_ok", img_ok & ~ts_ok & fus_ok),
            ("image_only_but_fus_lost_it", img_ok & ~ts_ok & ~fus_ok),
            ("both_wrong_but_fus_saved", ~img_ok & ~ts_ok & fus_ok),
            ("all_three_wrong", ~img_ok & ~ts_ok & ~fus_ok),
            ("both_correct_and_fus_ok", img_ok & ts_ok & fus_ok),
            ("both_correct_but_fus_broke_it", img_ok & ts_ok & ~fus_ok)):
        cells3[name] = int(sel.sum())
    both = int((img_ok & ts_ok).sum())
    img_only = int((img_ok & ~ts_ok).sum())
    ts_only = int((~img_ok & ts_ok).sum())
    both_wrong = int((~img_ok & ~ts_ok).sum())
    return {
        "n": n, "pos_frac": float(y.mean()),
        "img_acc": float(img_ok.mean()), "ts_acc": float(ts_ok.mean()),
        "fus_acc": float(fus_ok.mean()),
        "both_correct": both, "image_only_correct": img_only,
        "ts_only_correct": ts_only, "both_wrong": both_wrong,
        "ts_unique_gain": ts_only / n,
        "ts_redundancy": _ratio(both, both + ts_only),
        "coverage_gain": (both + img_only + ts_only) / n,
        "kappa_img_ts": cohens_kappa(img_ok, ts_ok),
        "err_corr": pearson((~img_ok).astype(float), (~ts_ok).astype(float)),
        **cells3,
        "ts_gain_retention": _ratio(
            cells3["ts_only_and_fus_ok"],
            cells3["ts_only_and_fus_ok"] + cells3["ts_only_but_fus_lost_it"]),
        "fusion_harm_rate": _ratio(
            cells3["image_only_but_fus_lost_it"],
            cells3["image_only_and_fus_ok"]
            + cells3["image_only_but_fus_lost_it"]),
        "emergent_gain": _ratio(
            cells3["both_wrong_but_fus_saved"],
            cells3["both_wrong_but_fus_saved"] + cells3["all_three_wrong"]),
        "both_agree_broken_rate": _ratio(
            cells3["both_correct_but_fus_broke_it"],
            cells3["both_correct_and_fus_ok"]
            + cells3["both_correct_but_fus_broke_it"]),
    }


def venn_counts(idx_pos: np.ndarray, img_ok: np.ndarray, ts_ok: np.ndarray,
                fus_ok: np.ndarray) -> Dict[str, int]:
    """Region counts of the 3-set Venn over the POSITIVES each branch
    catches (reference ``_plot_venn``, complementarity.py:305-341); keys are
    img/ts/fus membership bitstrings."""
    img = set(map(int, idx_pos[img_ok]))
    ts = set(map(int, idx_pos[ts_ok]))
    fus = set(map(int, idx_pos[fus_ok]))
    return {
        "100": len(img - ts - fus), "010": len(ts - img - fus),
        "110": len((img & ts) - fus), "001": len(fus - img - ts),
        "101": len((img & fus) - ts), "011": len((ts & fus) - img),
        "111": len(img & ts & fus),
        "none": len(set(map(int, idx_pos)) - img - ts - fus),
    }


def run(model, anchor_ds, labels, split: str, batch_size: int,
        image_source, threshold_method: str = "youden",
        feature_source=None, dtype=torch.bfloat16) -> dict:
    eval_step = engine.make_teacher_eval(anchor_ds.n_timesteps, dtype,
                                         image_source=image_source,
                                         feature_source=feature_source)
    val = collect_dual_outputs(eval_step, model, anchor_ds, "val",
                               batch_size)
    ev = collect_dual_outputs(eval_step, model, anchor_ds, split, batch_size)
    K = val["y"].shape[1]
    thr = {mod: np.full(K, np.nan) for mod in ("img", "ts", "fus")}
    if threshold_method == "fixed":
        thr = {mod: np.zeros(K) for mod in thr}
    else:
        for mod in thr:
            for k in range(K):
                m = val["mask"][:, k].astype(bool)
                if m.sum() >= 2:
                    thr[mod][k] = youden_threshold(val[mod][m, k],
                                                   val["y"][m, k])
    per_label = []
    for k in range(K):
        m = ev["mask"][:, k].astype(bool)
        y = ev["y"][m, k] > 0.5
        row = {"label": labels[k]}
        if m.sum() == 0 or np.isnan(thr["img"][k]):
            row["n"] = 0
        else:
            img_ok = (ev["img"][m, k] > thr["img"][k]) == y
            ts_ok = (ev["ts"][m, k] > thr["ts"][k]) == y
            fus_ok = (ev["fus"][m, k] > thr["fus"][k]) == y
            row.update(analyze_label(y, img_ok, ts_ok, fus_ok))
            # over positives, predicted-positive ⇔ correct (reference
            # :305-341)
            idx = np.where(m)[0]
            row["venn_positives"] = venn_counts(
                idx[y], img_ok[y], ts_ok[y], fus_ok[y])
        per_label.append(row)
    return {"labels": list(labels), "per_label": per_label,
            "thresholds": {m: t.tolist() for m, t in thr.items()}}


# three unit circles on an equilateral triangle and each region's label
# anchor (the reference's matplotlib_venn layout, equal-area circles)
_VENN_CENTERS = {"A": (-0.45, 0.3), "B": (0.45, 0.3), "C": (0.0, -0.5)}
_VENN_REGION_XY = {
    "100": (-0.75, 0.45), "010": (0.75, 0.45), "001": (0.0, -0.85),
    "110": (0.0, 0.55), "101": (-0.45, -0.25), "011": (0.45, -0.25),
    "111": (0.0, 0.05),
}


def plot_venn(counts: Dict[str, int], title: str, out_png: str) -> bool:
    """The Venn figure of one label's positives; False without
    matplotlib."""
    def draw(plt):
        from matplotlib.patches import Circle
        fig, ax = plt.subplots(figsize=(5, 5))
        for (cx, cy), color, name in zip(
                _VENN_CENTERS.values(), ("#E53935", "#1E88E5", "#43A047"),
                ("image", "TS", "fusion")):
            ax.add_patch(Circle((cx, cy), 0.9, alpha=0.25, color=color))
            ax.annotate(name, (cx * 1.9, cy * 1.9 + 0.05), ha="center",
                        fontsize=11, color=color)
        for region, (x, y) in _VENN_REGION_XY.items():
            ax.text(x, y, str(counts.get(region, 0)), ha="center",
                    va="center", fontsize=12)
        ax.text(1.3, -1.3, f"missed by all: {counts.get('none', 0)}",
                ha="right", fontsize=9)
        ax.set_xlim(-1.7, 1.7)
        ax.set_ylim(-1.7, 1.5)
        ax.set_aspect("equal")
        ax.axis("off")
        ax.set_title(title, fontsize=11)
        fig.tight_layout()
        fig.savefig(out_png, dpi=120, bbox_inches="tight")
        plt.close(fig)

    return write_figure(draw)


def format_table(result: dict) -> str:
    header = (f"{'label':<14s} {'n':>5s} {'imgAcc':>7s} {'tsAcc':>7s} "
              f"{'fusAcc':>7s} {'tsGain':>7s} {'retain':>7s} {'harm':>7s} "
              f"{'emerg':>7s} {'kappa':>7s}")
    lines = [header, "-" * len(header)]
    for r in result["per_label"]:
        if r.get("n", 0) == 0:
            lines.append(f"{r['label']:<14s}    --")
            continue
        lines.append(
            f"{r['label'].replace('label_', ''):<14s} {r['n']:>5d} "
            f"{r['img_acc']:>7.3f} {r['ts_acc']:>7.3f} {r['fus_acc']:>7.3f} "
            f"{r['ts_unique_gain']:>7.3f} {r['ts_gain_retention']:>7.3f} "
            f"{r['fusion_harm_rate']:>7.3f} {r['emergent_gain']:>7.3f} "
            f"{r['kappa_img_ts']:>7.3f}")
    return "\n".join(lines)


def main(argv=None, dtype=torch.bfloat16) -> dict:
    """``dtype``: the eval's compute precision (the CLI's is bf16, as the
    JAX script's)."""
    p = argparse.ArgumentParser("img × ts × fusion complementarity")
    add_analysis_flags(p)
    p.add_argument("--threshold_method", type=str, default="youden",
                   choices=["youden", "fixed"])
    args = p.parse_args(argv)
    model, _, anchor_ds, dcfg, image_source, feature_source = \
        load_for_analysis(args, dtype)
    result = run(model, anchor_ds, dcfg.pathology_labels, args.split,
                 args.batch_size, image_source, args.threshold_method,
                 feature_source=feature_source, dtype=dtype)
    print(format_table(result))
    out = save_json(result, args.out_dir, "complementarity.json")
    # the flat per-label CSV (reference complementarity.py:288-297)
    rows = [{k: (json.dumps(v, default=float) if isinstance(v, (dict, list))
                 else v) for k, v in r.items()}
            for r in result["per_label"]]
    fieldnames = sorted({k for r in rows for k in r},
                        key=lambda k: (k != "label", k))
    with open(os.path.join(args.out_dir, "complementarity.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        w.writerows(rows)
    skipped = []
    for r in result["per_label"]:
        vc = r.get("venn_positives")
        if vc and sum(vc.values()) > 0:
            name = r["label"].replace("label_", "")
            png = f"venn_{name}.png"
            if not plot_venn(vc, f"{name} — positives caught "
                                 f"(n_pos={sum(vc.values())})",
                             os.path.join(args.out_dir, png)):
                skipped.append(png)
    report_skipped_figures(skipped)
    print(f"saved → {out}")
    return result


if __name__ == "__main__":
    main()
