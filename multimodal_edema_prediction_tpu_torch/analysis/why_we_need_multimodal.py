"""ICU-hardness study of the CXR head: where does image-only break down?
The counterpart of
``multimodal_edema_prediction_tpu/analysis/why_we_need_multimodal.py``
(reference ``analysis/why_we_need_multimodal.py``). Scores the pretrained
CXR linear head on mutually exclusive slices of its own TEST split (the
aligned seed-42 subject split it was trained on, reference :156-165):

    G0  all test images
    G1  non-ICU subjects (no ICU stay in the cohort)
    G2  ICU subjects, image NOT anchored to a stay window
    G3  ICU anchor images (the multimodal cohort)

and asserts G1 + G2 + G3 == G0 (reference :208-210). A G3 worse than G1
is the case for fusing the temporal modality. The CLS features come from
the ViT that ``cli/train_cxr_head.py`` takes when it is given no weights
(``init_like_flax(vit, 0, ...)``), in float32 (K1's float32 forward), so
that a head the port trained is scored on the features it was trained on.

    python -m multimodal_edema_prediction_tpu_torch.analysis.why_we_need_multimodal \\
        --head_ckpt <ckpt_dir>/cxr_linear_head.msgpack --vit_size base \\
        --device cuda

Writes ``icu_hardness_summary.json``, ``icu_hardness_table_{main,7label}
.csv``, ``why_we_need_multimodal.json`` and, where matplotlib can be
imported, the figures ``icu_hardness_macro.png`` and
``icu_hardness_per_label_{main,7label}.png`` (reference :295-416).
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from ..config import DEFAULT_PATHOLOGY_LABELS
from ..ops import metrics as M
from .common import (add_analysis_flags, load_analysis_data,
                     report_skipped_figures, save_json, write_figure)

GROUP_ORDER = ("G0_all", "G1_non_icu", "G2_icu_unanchored", "G3_icu_anchor")
GROUP_LABELS = ("All studies", "No ICU history", "ICU history",
                "ICU imaging\n(research cohort)")
GROUP_COLORS = ("#808080", "#4CAF50", "#FF9800", "#E53935")


def evaluate_slices(catalog, anchors, head_logits: np.ndarray,
                    labels, test_sel: np.ndarray = None) -> dict:
    """Per-group per-label metrics over the G0 ⊃ G1 ⊔ G2 ⊔ G3
    decomposition. ``test_sel``: boolean selector restricting G0 to the
    head's test split (reference :156-165); None: the whole catalog."""
    icu_subjects = set(anchors.subject_ids.tolist())
    anchor_images = set(anchors.image_ids.tolist())
    base = np.ones(len(catalog.subject_ids), bool) if test_sel is None \
        else np.asarray(test_sel, bool)
    g1 = base & ~np.isin(catalog.subject_ids, list(icu_subjects))
    g3 = base & np.isin(catalog.image_ids, list(anchor_images))
    g2 = base & ~g1 & ~g3
    g0 = base
    assert (g1.sum() + g2.sum() + g3.sum()) == g0.sum(), \
        "G1+G2+G3 must decompose G0 exactly"

    y = catalog.labels
    mask = (~np.isnan(y)).astype(np.float32)
    y0 = np.nan_to_num(y, nan=0.0)
    out = {}
    for name, sel in zip(GROUP_ORDER, (g0, g1, g2, g3)):
        if sel.sum() == 0:
            out[name] = {"n": 0, "n_subj": 0, "macro_auroc": float("nan")}
            continue
        rows = M.masked_multilabel_metrics(
            y0[sel], mask[sel], {"head": head_logits[sel]})
        for k, r in enumerate(rows):
            r["label"] = labels[k]
            r["n_pos"] = int((y0[sel][:, k] * mask[sel][:, k]).sum())
        out[name] = {"n": int(sel.sum()),
                     "n_subj": int(len(np.unique(
                         catalog.subject_ids[sel]))),
                     "macro_auroc": M.macro_mean(rows, "head_auroc"),
                     "macro_auprc": M.macro_mean(rows, "head_auprc"),
                     "per_label": rows}
    return out


def _macro_for(result_group: dict, subset) -> tuple:
    rows = [r for r in result_group.get("per_label", [])
            if r["label"] in subset and np.isfinite(r["head_auroc"])]
    if not rows:
        return float("nan"), float("nan")
    return (float(np.mean([r["head_auroc"] for r in rows])),
            float(np.mean([r["head_auprc"] for r in rows])))


def write_artifacts(result: dict, labels, out_dir: str,
                    main_labels=None) -> list:
    """Reference :295-416: the JSON summary, one CSV per label set and the
    grouped-bar figures (macro, and per label for each set). Returns the
    figures it could not draw (no matplotlib)."""
    os.makedirs(out_dir, exist_ok=True)
    main_labels = list(main_labels
                       or labels[:3])        # '3-label (Research Label)'
    label_sets = {"main": main_labels, "7label": list(labels)}
    macros = {g: {s: _macro_for(result[g], ls)
                  for s, ls in label_sets.items()} for g in GROUP_ORDER}
    save_json({"groups": result, "label_sets": label_sets,
               "macros": macros,
               "notes": "same head + same pipeline; only the subset "
                        "filter varies"}, out_dir, "icu_hardness_summary.json")

    for set_name, lbls in label_sets.items():
        path = os.path.join(out_dir, f"icu_hardness_table_{set_name}.csv")
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=(
                "group", "label", "n_img", "n_subj", "n_valid", "n_pos",
                "pos_pct", "AUROC", "AUPRC"))
            w.writeheader()
            for g in GROUP_ORDER:
                r = result[g]
                by_label = {p["label"]: p for p in r.get("per_label", [])}
                for lbl in lbls:
                    s = by_label.get(lbl)
                    if s is None:
                        continue
                    w.writerow({
                        "group": g, "label": lbl, "n_img": r["n"],
                        "n_subj": r.get("n_subj", 0),
                        "n_valid": s["n_valid"], "n_pos": s["n_pos"],
                        "pos_pct": round(100 * s["n_pos"]
                                         / max(s["n_valid"], 1), 2),
                        "AUROC": s["head_auroc"], "AUPRC": s["head_auprc"]})
                au, pr = macros[g][set_name]
                w.writerow({"group": g, "label": "MACRO", "n_img": r["n"],
                            "n_subj": r.get("n_subj", 0), "n_valid": "",
                            "n_pos": "", "pos_pct": "", "AUROC": au,
                            "AUPRC": pr})

    def macro_figure(plt):
        from matplotlib.patches import Patch
        fig, axes = plt.subplots(1, 2, figsize=(13, 4.5))
        x = np.arange(len(GROUP_ORDER))
        width = 0.35
        for ax, (metric, idx, ylim) in zip(
                axes, (("AUROC", 0, (0.5, 1.0)), ("AUPRC", 1, (0.0, 1.0)))):
            for i, set_name in enumerate(label_sets):
                vals = [macros[g][set_name][idx] for g in GROUP_ORDER]
                bars = ax.bar(x - width / 2 + i * width, np.nan_to_num(vals),
                              width, color=list(GROUP_COLORS),
                              edgecolor="black", linewidth=0.8,
                              hatch="" if i == 0 else "///")
                for b, v in zip(bars, vals):
                    if np.isfinite(v):
                        ax.text(b.get_x() + b.get_width() / 2, v + 0.005,
                                f"{v:.3f}", ha="center", va="bottom",
                                fontsize=7)
            ax.set_xticks(x)
            ax.set_xticklabels([s.replace("\n", " ") for s in GROUP_LABELS],
                               fontsize=8)
            ax.set_ylabel(metric)
            ax.set_ylim(*ylim)
            ax.legend(handles=[
                Patch(facecolor="white", edgecolor="black", label="main set"),
                Patch(facecolor="white", edgecolor="black", hatch="///",
                      label="7-label")], loc="upper right", fontsize=8)
        fig.suptitle("Image-encoder performance by patient cohort")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "icu_hardness_macro.png"), dpi=200,
                    bbox_inches="tight")
        plt.close(fig)

    def per_label_figure(set_name, lbls):
        def draw(plt):
            fig, axes = plt.subplots(
                1, 2, figsize=(max(12, len(lbls) * 1.8), 4.5))
            xs = np.arange(len(lbls))
            w = 0.8 / len(GROUP_ORDER)
            for ax, (metric_key, metric, ylim) in zip(
                    axes, (("head_auroc", "AUROC", (0.5, 1.0)),
                           ("head_auprc", "AUPRC", (0.0, 1.0)))):
                for gi, g in enumerate(GROUP_ORDER):
                    by_label = {p["label"]: p
                                for p in result[g].get("per_label", [])}
                    vals = [by_label.get(lbl, {}).get(metric_key, np.nan)
                            for lbl in lbls]
                    ax.bar(xs - 0.4 + (gi + 0.5) * w, np.nan_to_num(vals), w,
                           color=GROUP_COLORS[gi], edgecolor="black",
                           linewidth=0.5,
                           label=GROUP_LABELS[gi].replace("\n", " "))
                ax.set_xticks(xs)
                ax.set_xticklabels([lbl.replace("label_", "")
                                    for lbl in lbls], rotation=15,
                                   fontsize=8)
                ax.set_ylabel(metric)
                ax.set_ylim(*ylim)
                ax.legend(fontsize=7, ncol=2)
            fig.tight_layout()
            fig.savefig(os.path.join(
                out_dir, f"icu_hardness_per_label_{set_name}.png"), dpi=200,
                bbox_inches="tight")
            plt.close(fig)
        return draw

    figures = [("icu_hardness_macro.png", macro_figure)] + [
        (f"icu_hardness_per_label_{s}.png", per_label_figure(s, lbls))
        for s, lbls in label_sets.items()]
    return [name for name, draw in figures if not write_figure(draw)]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("CXR-head ICU-hardness decomposition")
    add_analysis_flags(p, needs_ckpt=False)
    p.add_argument("--head_ckpt", type=str, required=True)
    p.add_argument("--vit_size", type=str, default="tiny",
                   choices=["tiny", "base"])
    p.add_argument("--full_catalog", action="store_true",
                   help="evaluate over the whole catalog instead of the "
                        "head's aligned test split")
    args = p.parse_args(argv)

    from ..config import ViTConfig
    from ..convert import load_flax
    from ..models.cxr_head import CXRLinearHead
    from ..models.layers import init_like_flax
    from ..models.vit import DinoViT
    from ..train.checkpoint import load_checkpoint
    from ..train.cxr_head_loop import (extract_cls_features,
                                       split_catalog_subjects)
    from ..train.teacher_loop import make_synthetic_pixel_hook
    from ..utils import resolve_device

    dev = resolve_device(args.device)
    ds, _, _, dcfg = load_analysis_data(args)
    catalog = ds.cxr_catalog
    ckpt = load_checkpoint(args.head_ckpt)
    label_cols = ckpt["config"]["label_cols"]
    vit_cfg = ViTConfig() if args.vit_size == "base" else ViTConfig(
        image_size=56, patch_size=14, d_model=64, n_layers=2, n_heads=2,
        d_feedforward=128)
    vit = init_like_flax(DinoViT(vit_cfg), 0, vit_cfg.layerscale_init)
    jpeg_store = None
    if getattr(args, "cxr_jpeg_root", ""):
        from ..data.images import JpegStore
        jpeg_store = JpegStore(root=args.cxr_jpeg_root)
    cls = extract_cls_features(
        vit.to(dev), make_synthetic_pixel_hook(vit_cfg.image_size),
        catalog.image_ids, catalog.labels, args.batch_size,
        jpeg_store=jpeg_store)
    head = CXRLinearHead(vit_cfg.d_model, len(label_cols))
    load_flax(head, {"linear": ckpt["params"]["linear"]})
    with torch.no_grad():
        logits = head.to(dev)(torch.from_numpy(cls).to(dev)).cpu().numpy()
    if args.full_catalog:
        test_sel = None
    else:
        # the head's own test split (the aligned seed-42 subject split the
        # reference reproduces at :156-165)
        splits = split_catalog_subjects(catalog.subject_ids, catalog.labels,
                                        seed=dcfg.split_seed)
        test_sel = np.zeros(len(catalog.subject_ids), bool)
        test_sel[splits["test"]] = True
    result = evaluate_slices(catalog, ds.anchors, logits, label_cols,
                             test_sel=test_sel)
    print(f"{'slice':<20s} {'n':>6s} {'macroROC':>9s}")
    for name, r in result.items():
        print(f"{name:<20s} {r['n']:>6d} {r['macro_auroc']:>9.4f}")
    report_skipped_figures(write_artifacts(
        result, list(label_cols), args.out_dir,
        main_labels=list(DEFAULT_PATHOLOGY_LABELS[:3])))
    save_json(result, args.out_dir, "why_we_need_multimodal.json")
    return result


if __name__ == "__main__":
    main()
