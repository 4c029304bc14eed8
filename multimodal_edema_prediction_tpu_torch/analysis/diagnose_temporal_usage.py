"""Counterfactual TS ablations through a trained teacher: the counterpart
of ``multimodal_edema_prediction_tpu/analysis/diagnose_temporal_usage.py``
(reference ``analysis/diagnose_temporal_usage.py``). Conditions
(CONDITIONS :38-45):

    full            original windows
    patient_shuffle whole EHR package (dynamic + static) cross-subject
                    derangement within batch
    ts_shuffle      dynamic measurements shuffled, static kept
    time_reverse    time axis flipped inside each window
    time_permute    random permutation of the time bins

Reports per-condition fusion/ts AUROC and their deltas, prediction-shift
statistics, the TS attention's entropy (``return_attn``), the
cross-subject shuffle audit, and subject-cluster paired bootstrap CIs on
the main label's Δ (full − ablated). With ``--cxr_feature_cache hbm`` the
frozen ViT runs once per unique image (the conditions perturb only the
windows) and every condition gathers the cached tokens (K2).

    python -m multimodal_edema_prediction_tpu_torch.analysis.diagnose_temporal_usage \\
        --ckpt runs/<run>/best-*.msgpack --device cuda [--cxr_feature_cache hbm]

Writes ``temporal_usage.json`` and the per-sample archive
``temporal_usage_predictions.npz``.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

from ..ops import metrics as M
from ..train import engine
from .common import (add_analysis_flags, attention_entropy,
                     different_subject_permutation, load_for_analysis,
                     save_json, subject_cluster_bootstrap, window_batch)

CONDITIONS = ("full", "patient_shuffle", "ts_shuffle", "time_reverse",
              "time_permute")


def collect_predictions(model, anchor_ds, split: str, batch_size: int,
                        seed: int, image_source, max_batches: int = 0,
                        feature_source=None, dtype=torch.bfloat16) -> dict:
    eval_step = engine.make_teacher_eval_from_windows(
        model, dtype, image_source=image_source,
        feature_source=feature_source, return_attn=True)
    a = anchor_ds.anchor
    idx_all = anchor_ds.splits[split]
    fus = {c: [] for c in CONDITIONS}
    ts = {c: [] for c in CONDITIONS}
    img, ys, masks, attns, subj = [], [], [], [], []
    same_subject = total = 0

    if len(idx_all) == 0:
        raise ValueError(f"split {split!r} is empty")
    if len(idx_all) < batch_size:   # tiny cohort: one short batch
        batch_size = len(idx_all)
    n = len(idx_all) - (len(idx_all) % batch_size)
    for bi, i in enumerate(range(0, n, batch_size)):
        if max_batches and bi >= max_batches:
            break
        idx = idx_all[i:i + batch_size]
        x_ts, x_static, batch = window_batch(anchor_ds, idx)
        sid = a["subject_ids"][idx]
        rng = np.random.default_rng(seed + 10007 * bi)
        perm = different_subject_permutation(sid, rng)
        same_subject += int(np.sum(sid[perm] == sid))
        total += len(idx)
        tperm = rng.permutation(anchor_ds.n_timesteps)

        variants = {
            "full": (x_ts, x_static),
            "patient_shuffle": (x_ts[perm], x_static[perm]),
            "ts_shuffle": (x_ts[perm], x_static),
            "time_reverse": (x_ts[:, ::-1].copy(), x_static),
            "time_permute": (x_ts[:, tperm].copy(), x_static),
        }
        for cond, (xt, xs) in variants.items():
            out = eval_step(xt, xs, batch)
            fus[cond].append(out["fusion_logits"].cpu().numpy())
            ts[cond].append(out["ts_logits"].cpu().numpy())
            if cond == "full":
                img.append(out["img_logits"].cpu().numpy())
                attns.append(out["ts_attn"].cpu().numpy())
        ys.append(batch["y_multi"])
        masks.append(batch["y_multi_mask"])
        subj.append(sid)

    return {
        "fus": {c: np.concatenate(v) for c, v in fus.items()},
        "ts": {c: np.concatenate(v) for c, v in ts.items()},
        "img": np.concatenate(img),
        "y": np.concatenate(ys), "mask": np.concatenate(masks),
        "subject_ids": np.concatenate(subj),
        "attention": np.concatenate(attns),
        "shuffle_same_subject": same_subject, "shuffle_total": total,
    }


def _prob(x):
    return 1.0 / (1.0 + np.exp(-x))


def summarize(pred: dict, labels, n_boot: int, seed: int) -> dict:
    y, mk = pred["y"], pred["mask"]
    report: Dict = {"conditions": {}, "labels": list(labels)}
    for cond in CONDITIONS:
        rows = M.masked_multilabel_metrics(
            y, mk, {"fus": pred["fus"][cond], "ts": pred["ts"][cond]})
        report["conditions"][cond] = {
            "fus_macro_auroc": M.macro_mean(rows, "fus_auroc"),
            "ts_macro_auroc": M.macro_mean(rows, "ts_auroc"),
            "fus_main_auroc": rows[0]["fus_auroc"],
            "ts_main_auroc": rows[0]["ts_auroc"],
        }
    # prediction-shift statistics (main label)
    p_full = _prob(pred["fus"]["full"][:, 0])
    for cond in CONDITIONS[1:]:
        p_c = _prob(pred["fus"][cond][:, 0])
        report["conditions"][cond]["mean_abs_dp_fus"] = float(
            np.mean(np.abs(p_full - p_c)))
        report["conditions"][cond]["corr_fus"] = float(
            np.corrcoef(p_full, p_c)[0, 1])
    ent = attention_entropy(pred["attention"])
    report["attention_entropy_per_label"] = ent.mean(axis=0).tolist()
    report["shuffle_audit"] = {
        "same_subject_pairs": pred["shuffle_same_subject"],
        "total": pred["shuffle_total"],
    }
    # subject-cluster paired bootstrap of the main label's Δ AUROC
    sid = pred["subject_ids"]
    m0 = mk[:, 0].astype(bool)
    boot = {}
    for cond in CONDITIONS[1:]:
        def delta(idx, cond=cond):
            idx = idx[m0[idx]]
            yk = y[idx, 0]
            a_full = M.auroc(yk, _prob(pred["fus"]["full"][idx, 0]))
            a_cond = M.auroc(yk, _prob(pred["fus"][cond][idx, 0]))
            return a_full - a_cond
        boot[cond] = subject_cluster_bootstrap(sid, delta, n_boot, seed)
    report["bootstrap_delta_auroc_main"] = boot
    return report


def format_report(report: dict) -> str:
    lines = ["condition           fusROC(macro)  tsROC(macro)  "
             "mean|dp|    corr"]
    for cond, r in report["conditions"].items():
        lines.append(
            f"{cond:<18s} {r['fus_macro_auroc']:>13.4f} "
            f"{r['ts_macro_auroc']:>13.4f} "
            f"{r.get('mean_abs_dp_fus', 0.0):>9.4f} "
            f"{r.get('corr_fus', 1.0):>7.4f}")
    b = report.get("bootstrap_delta_auroc_main", {})
    if b:
        lines.append("\nmain-label Δ(full − ablated) fusion AUROC, "
                     "subject-cluster bootstrap 95% CI:")
        for cond, s in b.items():
            lines.append(f"{cond:<18s} {s['mean']:+.4f} "
                         f"[{s['lo']:+.4f}, {s['hi']:+.4f}] "
                         f"(n={s['n_valid']})")
    sa = report["shuffle_audit"]
    lines.append(f"\nshuffle audit: same-subject pairs "
                 f"{sa['same_subject_pairs']}/{sa['total']}")
    return "\n".join(lines)


def main(argv=None, dtype=torch.bfloat16) -> dict:
    """``dtype``: the eval's compute precision (the CLI's is bf16, as the
    JAX script's)."""
    p = argparse.ArgumentParser("counterfactual temporal-usage diagnostics")
    add_analysis_flags(p)
    args = p.parse_args(argv)
    model, _, anchor_ds, dcfg, image_source, feature_source = \
        load_for_analysis(args, dtype, grid_on_device=False)
    pred = collect_predictions(model, anchor_ds, args.split,
                               args.batch_size, args.seed, image_source,
                               args.max_batches,
                               feature_source=feature_source, dtype=dtype)
    report = summarize(pred, dcfg.pathology_labels, args.n_boot, args.seed)
    print(format_report(report))
    out = save_json(report, args.out_dir, "temporal_usage.json")
    # the raw per-sample archive (reference --output_npz payload,
    # diagnose_temporal_usage.py:608-621): notebooks re-slice the
    # counterfactuals without re-running the model
    payload = {
        "subject_ids": pred["subject_ids"],
        "labels": np.asarray(list(dcfg.pathology_labels)),
        "y": pred["y"], "mask": pred["mask"],
        "img_full": pred["img"],
        "ts_attention_full": pred["attention"],
    }
    for cond in CONDITIONS:
        payload[f"fus_{cond}"] = pred["fus"][cond]
        payload[f"ts_{cond}"] = pred["ts"][cond]
    npz_path = os.path.join(args.out_dir, "temporal_usage_predictions.npz")
    np.savez_compressed(npz_path, **payload)
    print(f"\nsaved → {out}\nsaved raw predictions → {npz_path}")
    return report


if __name__ == "__main__":
    main()
