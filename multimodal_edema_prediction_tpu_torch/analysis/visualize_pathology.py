"""The figure suite of a trained teacher: the counterpart of
``multimodal_edema_prediction_tpu/analysis/visualize_pathology.py``
(reference ``analysis/visualize_pathology.py``), five artifact families:

1. patch-attention overlays on positive CXRs (:208-281)
2. K×T time-series attention heatmaps (:287-361)
3. query cosine-similarity matrices (:367-434), also as CSV
4. 2-D t-SNE of the main label's fusion tokens, raw and per-sample-centered
   (:440-510), and the projection of every sample's K fusion tokens
   (``--dim_reduce``: ``auto`` and ``umap`` take the port's UMAP,
   ``analysis/umap_impl.py``; ``tsne`` the exact t-SNE,
   ``analysis/tsne.py``)
5. per-label img/ts/fusion gap bars and CSV (:516-598)

Each family computes its data first (the attention maps, the cosine
matrices, the embeddings: the kNN and the t-SNE on the model's device)
and returns it, then draws through ``common.write_figure``. Where
matplotlib cannot be imported the CSVs are still written and one line
names the figures not drawn.

    python -m multimodal_edema_prediction_tpu_torch.analysis.visualize_pathology \\
        --ckpt runs/<run>/best-*.msgpack --device cuda [--dim_reduce tsne]
"""
from __future__ import annotations

import argparse
import csv
import math
import os
from typing import List

import numpy as np
import torch

from ..ops import metrics as M
from ..train import engine
from . import umap_impl
from .common import (add_analysis_flags, load_for_analysis,
                     report_skipped_figures, window_batch, write_figure)
from .tsne import TSNE


def _collect(model, anchor_ds, split: str, batch_size: int, image_source,
             max_batches: int = 8, feature_source=None,
             dtype=torch.bfloat16) -> dict:
    """Attentions, fusion tokens, the three branches' logits, labels and
    image ids of the split's first ``max_batches`` full batches (numpy)."""
    eval_step = engine.make_teacher_eval_from_windows(
        model, dtype, image_source=image_source,
        feature_source=feature_source, return_attn=True)
    a = anchor_ds.anchor
    idx_all = anchor_ds.splits[split]
    acc = {k: [] for k in ("img_attn", "ts_attn", "fus_tok", "img", "ts",
                           "fus", "y", "mask", "image_ids")}
    if 0 < len(idx_all) < batch_size:   # tiny cohort: one short batch
        batch_size = len(idx_all)
    n = min(len(idx_all) - len(idx_all) % batch_size,
            max_batches * batch_size)
    if n == 0:
        raise SystemExit(
            f"split '{split}' has {len(idx_all)} anchors < batch_size="
            f"{batch_size}: no full batch to visualize — lower --batch_size "
            f"or use a larger cohort")
    uses_event = False
    for i in range(0, n, batch_size):
        idx = idx_all[i:i + batch_size]
        o = {k: v.cpu().numpy() for k, v in
             eval_step(*window_batch(anchor_ds, idx)).items()}
        acc["img_attn"].append(o["img_attn"])
        # the event variant attends per variable (``event_attn``) instead
        # of per hour (reference visualize_pathology.py:291-292)
        acc["ts_attn"].append(o["event_attn"] if "event_attn" in o
                              else o["ts_attn"])
        acc["fus_tok"].append(o["fusion_tokens"])
        acc["img"].append(o["img_logits"])
        acc["ts"].append(o["ts_logits"])
        acc["fus"].append(o["fusion_logits"])
        acc["y"].append(a["y_multi"][idx])
        acc["mask"].append(a["y_multi_mask"][idx])
        acc["image_ids"].append(a["image_ids"][idx])
        uses_event = "event_attn" in o
    res = {k: np.concatenate(v) for k, v in acc.items()}
    res["attn_axis"] = "variable" if uses_event else "hour"
    return res


def plot_attention_overlays(data, labels, image_size, out_dir,
                            n_examples: int = 4, skipped=None) -> dict:
    """The main label's patch attention [g, g] of up to ``n_examples``
    positive anchors beside their procedural images."""
    from ..data.synthetic import synthetic_image_batch
    g = int(math.sqrt(data["img_attn"].shape[-1]))
    pos = np.nonzero(data["y"][:, 0] * data["mask"][:, 0])[0][:n_examples]
    if len(pos) == 0:
        return {}
    imgs = synthetic_image_batch(None, data["image_ids"][pos],
                                 data["y"][pos], size=image_size)
    maps = data["img_attn"][pos, 0].reshape(len(pos), g, g)

    def draw(plt):
        fig, axes = plt.subplots(len(pos), 2, figsize=(6, 3 * len(pos)),
                                 squeeze=False)
        for r, i in enumerate(pos):
            axes[r][0].imshow(imgs[r], cmap="gray")
            axes[r][0].set_title(f"id={data['image_ids'][i]}")
            axes[r][1].imshow(maps[r], cmap="viridis")
            axes[r][1].set_title(f"{labels[0]} attention")
            for ax in axes[r]:
                ax.axis("off")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "patch_attention_overlays.png"),
                    dpi=100)
        plt.close(fig)

    _draw(draw, ["patch_attention_overlays.png"], skipped)
    return {"rows": pos, "maps": maps}


def plot_ts_attention_heatmap(data, labels, out_dir, skipped=None
                              ) -> np.ndarray:
    """The mean time-series attention [K, T] (or [K, V], event mode)."""
    mean_attn = data["ts_attn"].mean(axis=0)

    def draw(plt):
        fig, ax = plt.subplots(figsize=(8, 4))
        im = ax.imshow(mean_attn, aspect="auto", cmap="magma")
        ax.set_yticks(range(len(labels)))
        ax.set_yticklabels([lb.replace("label_", "") for lb in labels])
        ax.set_xlabel("hour token" if data.get("attn_axis") != "variable"
                      else "clinical variable (full 24 h trajectory)")
        fig.colorbar(im)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "ts_attention_heatmap.png"),
                    dpi=100)
        plt.close(fig)

    _draw(draw, ["ts_attention_heatmap.png"], skipped)
    return mean_attn


def plot_query_cosine(model, labels, out_dir, skipped=None) -> dict:
    """Each query bank's cosine matrix [K, K] (``query_cosine{suffix}.csv``
    and its figure): the shared bank, or the image and temporal banks of
    ``dual_patch_event`` (the two-bank layout of the reference's
    ``_find_pathology_query_banks``, :70-90)."""
    perc = model.perceiver
    if hasattr(perc, "shared_queries"):
        banks = {"": perc.shared_queries}
    else:
        banks = {"_image": perc.image_queries,
                 "_temporal": perc.temporal_queries}
    names = [lb.replace("label_", "") for lb in labels]
    out = {}
    for suffix, bank in banks.items():
        q = bank.detach().float().cpu().numpy()
        qn = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-12)
        cos = out[suffix] = qn @ qn.T

        def draw(plt, cos=cos, suffix=suffix):
            fig, ax = plt.subplots(figsize=(5, 4))
            im = ax.imshow(cos, vmin=-1, vmax=1, cmap="coolwarm")
            ax.set_xticks(range(len(names)))
            ax.set_xticklabels(names, rotation=45, ha="right")
            ax.set_yticks(range(len(names)))
            ax.set_yticklabels(names)
            fig.colorbar(im)
            fig.tight_layout()
            fig.savefig(os.path.join(out_dir, f"query_cosine{suffix}.png"),
                        dpi=100)
            plt.close(fig)

        _draw(draw, [f"query_cosine{suffix}.png"], skipped)
        np.savetxt(os.path.join(out_dir, f"query_cosine{suffix}.csv"), cos,
                   delimiter=",")
    return out


def plot_token_embedding(data, labels, out_dir, perplexity: int = 15,
                         device="cpu", skipped=None) -> dict:
    """t-SNE of the main label's fusion tokens, raw and centered on each
    sample's mean token ({name: [N, 2]}; none where N ≤ perplexity + 1)."""
    tok = data["fus_tok"][:, 0, :]          # main-label query token
    y = data["y"][:, 0]
    out = {}
    for centered, name in ((False, "raw"), (True, "centered")):
        x = tok - data["fus_tok"].mean(axis=1) if centered else tok
        if len(x) <= perplexity + 1:
            continue
        emb = out[name] = TSNE(
            n_components=2, perplexity=min(perplexity, len(x) // 3),
            init="pca", random_state=0).fit_transform(
            torch.as_tensor(x, device=device))

        def draw(plt, emb=emb, name=name):
            fig, ax = plt.subplots(figsize=(5, 4))
            sc = ax.scatter(emb[:, 0], emb[:, 1], c=y, cmap="coolwarm", s=8)
            fig.colorbar(sc)
            ax.set_title(f"fusion tokens ({name})")
            fig.tight_layout()
            fig.savefig(os.path.join(out_dir, f"fusion_tokens_{name}.png"),
                        dpi=100)
            plt.close(fig)

        _draw(draw, [f"fusion_tokens_{name}.png"], skipped)
    return out


def projection_filename(mode: str) -> str:
    """Reference main() (:623-628): the figure's name follows the perceiver
    mode: fusion tokens for dual_patch, ts tokens for dual, stage4
    otherwise."""
    if mode in ("dual_patch", "dual_patch_event"):
        return "fusion_token_umap.png"
    if mode == "dual":
        return "ts_token_umap.png"
    return "stage4_token_umap.png"


def fit_projection(flat, dim_reduce: str = "auto", device="cpu"
                   ) -> np.ndarray:
    """[M, d] tokens → [M, 2]: the port's UMAP (``auto``, ``umap``;
    ``random_state`` 42) or the exact t-SNE (``tsne``: perplexity
    min(30, max(5, M // 4 − 1))), on ``device``."""
    x = torch.as_tensor(flat, device=device)
    if dim_reduce == "tsne":
        perp = min(30, max(5, flat.shape[0] // 4 - 1))
        return TSNE(n_components=2, random_state=42, init="pca",
                    perplexity=perp).fit_transform(x)
    return umap_impl.UMAP(n_components=2, random_state=42).fit_transform(x)


def plot_query_token_projection(data, labels, out_dir, dim_reduce="auto",
                                mode="dual_patch", device="cpu",
                                skipped=None) -> dict:
    """Reference ``viz_stage4_projection`` (:440-510): all N×K pathology
    query fusion tokens in 2-D, colored by pathology, raw and centered on
    each sample's mean side by side; centering removes the sample-level
    component, so the structure left is pathology-specific. Returns
    ``{"raw": [N·K, 2], "centered": [N·K, 2], "reducer": name}`` (empty
    below 12 tokens)."""
    tokens = data["fus_tok"]                       # [N, K, d]
    N, K, d = tokens.shape
    if N * K < 12:
        return {}
    color_ids = np.tile(np.arange(K), N)
    centered = tokens - tokens.mean(axis=1, keepdims=True)
    reducer = "tsne" if dim_reduce == "tsne" else "umap"
    out = {"reducer": reducer}
    for flat, tag in ((tokens.reshape(N * K, d), "raw"),
                      (centered.reshape(N * K, d), "centered")):
        out[tag] = fit_projection(flat, dim_reduce, device)
    names = [lb.replace("label_", "") for lb in labels]
    fname = projection_filename(mode)

    def draw(plt):
        cmap = plt.get_cmap("tab10")
        fig, axes = plt.subplots(1, 2, figsize=(12, 5))
        for ax, tag, title in zip(axes, ("raw", "centered"),
                                  ("raw", "per-sample centered")):
            proj = out[tag]
            for k in range(K):
                m = color_ids == k
                ax.scatter(proj[m, 0], proj[m, 1], s=10, alpha=0.5,
                           color=cmap(k % 10), label=names[k])
            ax.legend(fontsize=8, loc="best")
            ax.set_title(f"Fusion tokens — {title} ({reducer.upper()})")
            ax.set_xticks([])
            ax.set_yticks([])
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, fname), dpi=120,
                    bbox_inches="tight")
        # stable alias kept from earlier rounds' artifact layout
        fig.savefig(os.path.join(out_dir, "stage4_projection.png"), dpi=120,
                    bbox_inches="tight")
        plt.close(fig)

    _draw(draw, [fname, "stage4_projection.png"], skipped)
    return out


def gap_summary(data, labels, out_dir, skipped=None) -> List[dict]:
    """Per-label AUROC/AUPRC of the three branches (``gap_summary.csv``
    and its bar figure)."""
    rows = M.masked_multilabel_metrics(
        data["y"], data["mask"],
        {"img": data["img"], "ts": data["ts"], "fus": data["fus"]})
    names = [lb.replace("label_", "") for lb in labels]

    def draw(plt):
        x = np.arange(len(names))
        fig, ax = plt.subplots(figsize=(9, 4))
        for off, key in ((-0.25, "img_auroc"), (0.0, "ts_auroc"),
                         (0.25, "fus_auroc")):
            ax.bar(x + off, [r[key] for r in rows], width=0.25,
                   label=key.replace("_auroc", ""))
        ax.set_xticks(x)
        ax.set_xticklabels(names, rotation=30, ha="right")
        ax.set_ylabel("AUROC")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "gap_summary.png"), dpi=100)
        plt.close(fig)

    _draw(draw, ["gap_summary.png"], skipped)
    with open(os.path.join(out_dir, "gap_summary.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["label"] + list(rows[0].keys()))
        w.writeheader()
        for name, r in zip(labels, rows):
            w.writerow({"label": name, **r})
    return rows


def _draw(draw, names: List[str], skipped) -> None:
    """Draw one figure; where matplotlib is missing, add its files'
    names to ``skipped``."""
    if not write_figure(draw) and skipped is not None:
        skipped.extend(names)


def main(argv=None, dtype=torch.bfloat16) -> dict:
    """``dtype``: the evals' compute precision (the CLI's is bf16, as the
    JAX script's). Returns every family's data: ``gap_summary`` (JAX's
    return value), ``projection``, ``token_embedding``, ``query_cosine``,
    ``ts_attention`` and ``attention_overlays``."""
    p = argparse.ArgumentParser("teacher visualization suite")
    add_analysis_flags(p)
    p.add_argument("--dim_reduce", type=str, default="auto",
                   choices=["auto", "umap", "tsne"],
                   help="stage4 token projection reducer (reference "
                        "visualize_pathology.py:68-69); auto = umap = the "
                        "port's UMAP")
    args = p.parse_args(argv)
    model, cfg, anchor_ds, dcfg, image_source, feature_source = \
        load_for_analysis(args, dtype, grid_on_device=False)
    device = next(model.parameters()).device
    data = _collect(model, anchor_ds, args.split, args.batch_size,
                    image_source, args.max_batches or 8,
                    feature_source=feature_source, dtype=dtype)
    os.makedirs(args.out_dir, exist_ok=True)
    labels = dcfg.pathology_labels
    skipped: List[str] = []
    out = {
        "attention_overlays": plot_attention_overlays(
            data, labels, cfg.vit.image_size, args.out_dir, skipped=skipped),
        "ts_attention": plot_ts_attention_heatmap(data, labels, args.out_dir,
                                                  skipped),
        "query_cosine": plot_query_cosine(model, labels, args.out_dir,
                                          skipped),
        "token_embedding": plot_token_embedding(
            data, labels, args.out_dir, device=device, skipped=skipped),
        "projection": plot_query_token_projection(
            data, labels, args.out_dir, dim_reduce=args.dim_reduce,
            mode=cfg.perceiver_type, device=device, skipped=skipped),
        "gap_summary": gap_summary(data, labels, args.out_dir, skipped)}
    report_skipped_figures(skipped)
    print(f"figures + CSVs → {args.out_dir}")
    return out


if __name__ == "__main__":
    main()
