"""Residual direction and usefulness by image-confidence quartile: the
counterpart of
``multimodal_edema_prediction_tpu/analysis/residual_by_confidence.py``
(reference ``analysis/residual_by_confidence.py``). Buckets the split's
samples by the image branch's confidence |σ(img_logit) − 0.5| and reports
per quartile the mean |scaled_correction|, the fraction of corrections
that point toward the label (sign(corr) == sign(y − σ(img))) and the BCE
delta fusion − image.

    python -m multimodal_edema_prediction_tpu_torch.analysis.residual_by_confidence \\
        --ckpt runs/<run>/best-*.msgpack --device cuda [--cxr_feature_cache hbm]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.metrics import bce_per_sample
from ..train import engine
from ..train.evaluator import collect_dual_outputs
from .common import add_analysis_flags, load_for_analysis, save_json


def analyze(o: dict, label_idx: int = 0, n_bins: int = 4) -> dict:
    m = o["mask"][:, label_idx].astype(bool)
    y = o["y"][m, label_idx]
    img = o["img"][m, label_idx]
    fus = o["fus"][m, label_idx]
    corr = o["corr"][m, label_idx]
    p_img = 1 / (1 + np.exp(-img))
    conf = np.abs(p_img - 0.5)
    edges = np.quantile(conf, np.linspace(0, 1, n_bins + 1))
    rows = []
    for b in range(n_bins):
        sel = (conf >= edges[b]) & (conf <= edges[b + 1] if b == n_bins - 1
                                    else conf < edges[b + 1])
        if sel.sum() == 0:
            continue
        toward = np.sign(corr[sel]) == np.sign(y[sel] - p_img[sel])
        rows.append({
            "quartile": b, "n": int(sel.sum()),
            "conf_lo": float(edges[b]), "conf_hi": float(edges[b + 1]),
            "mean_abs_corr": float(np.abs(corr[sel]).mean()),
            "frac_toward_label": float(toward.mean()),
            "delta_bce": float(bce_per_sample(fus[sel], y[sel]).mean()
                               - bce_per_sample(img[sel], y[sel]).mean()),
        })
    return {"label_idx": label_idx, "quartiles": rows}


def main(argv=None, dtype=torch.bfloat16) -> dict:
    """``dtype``: the eval's compute precision (the CLI's is bf16, as the
    JAX script's)."""
    p = argparse.ArgumentParser("residual usage by image confidence")
    add_analysis_flags(p)
    p.add_argument("--label_idx", type=int, default=0)
    args = p.parse_args(argv)
    model, _, anchor_ds, _, image_source, feature_source = \
        load_for_analysis(args, dtype)
    eval_step = engine.make_teacher_eval(anchor_ds.n_timesteps, dtype,
                                         image_source=image_source,
                                         feature_source=feature_source)
    o = collect_dual_outputs(eval_step, model, anchor_ds, args.split,
                             args.batch_size)
    result = analyze(o, args.label_idx)
    print(f"{'Q':>2s} {'n':>5s} {'|corr|':>8s} {'toward':>7s} {'dBCE':>8s}")
    for r in result["quartiles"]:
        print(f"{r['quartile']:>2d} {r['n']:>5d} "
              f"{r['mean_abs_corr']:>8.4f} {r['frac_toward_label']:>7.3f} "
              f"{r['delta_bce']:>+8.4f}")
    save_json(result, args.out_dir, "residual_by_confidence.json")
    return result


if __name__ == "__main__":
    main()
