"""Inference CLI on the card: a teacher checkpoint (written by either
package) → one split's outputs in an NPZ (the counterpart of
``multimodal_edema_prediction_tpu/cli/predict.py``, the working equivalent
of the reference's absent ``inference.py``), with the same flags:

    python -m multimodal_edema_prediction_tpu_torch.cli.predict \\
        --ckpt runs/<run>/best-*.msgpack --device cuda \\
        [--cxr_feature_cache hbm] [--cxr_jpeg_root DIR] --out preds.npz

The split runs once through the teacher eval step (bf16, as the JAX CLI):
on procedural pixels through the ViT (K1), on real JPEGs with
``--cxr_jpeg_root``, or, with ``--cxr_feature_cache hbm``, on tokens
encoded once per unique image (K1 in the build) and gathered per batch
(K2). It prints the per-label gap table and writes ``img_logits``,
``ts_logits``, ``fusion_logits``, ``scaled_correction``, ``main_logit``,
``y_multi``, ``y_multi_mask``, ``labels`` and, where the perceiver has one
(not ``dual``), ``beta``: the file the analysis suite reads.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..analysis.common import (add_analysis_flags, load_analysis_data,
                               load_teacher, make_sources)
from ..train import engine
from ..train.evaluator import (evaluate_dual_pathology,
                               format_dual_pathology_gap_table)

RESIDUAL_MODES = ("dual_patch", "dual_patch_event", "dual")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("teacher inference → NPZ (PyTorch/CUDA)")
    add_analysis_flags(p)
    p.add_argument("--out", type=str, default="predictions.npz")
    return p


def predict(args, dtype=torch.bfloat16) -> dict:
    """The split's ``evaluate_dual_pathology`` result (its host arrays
    under ``outputs``, the perceiver's β under ``beta``, None for
    ``dual``), at the compute ``dtype``; writes nothing."""
    model, cfg, _ = load_teacher(args.ckpt, args.device)
    if cfg.perceiver_type not in RESIDUAL_MODES:
        raise ValueError(
            f"predict needs a residual-fusion teacher {RESIDUAL_MODES}, got "
            f"perceiver_type {cfg.perceiver_type!r}")
    _, _, anchor_ds, dcfg = load_analysis_data(
        args, n_variables=cfg.duett.n_variables)
    anchor_ds.to(next(model.parameters()).device)
    image_source, feature_source = make_sources(args, anchor_ds, model, cfg,
                                                dtype)
    eval_step = engine.make_teacher_eval(anchor_ds.n_timesteps, dtype,
                                         image_source=image_source,
                                         feature_source=feature_source)
    beta = getattr(model.perceiver, "beta", None)   # absent in 'dual' mode
    beta = None if beta is None else beta.detach().cpu().numpy()
    result = evaluate_dual_pathology(eval_step, model, anchor_ds, args.split,
                                     args.batch_size, dcfg.pathology_labels,
                                     beta)
    result["beta"] = beta
    return result


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    result = predict(args)
    print(format_dual_pathology_gap_table(result))
    o = result["outputs"]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    extra = {} if result["beta"] is None else {"beta": result["beta"]}
    np.savez_compressed(
        args.out, img_logits=o["img"], ts_logits=o["ts"],
        fusion_logits=o["fus"], scaled_correction=o["corr"],
        main_logit=o["main"], y_multi=o["y"], y_multi_mask=o["mask"],
        labels=np.asarray(result["labels"]), **extra)
    print(f"predictions → {args.out}")
    return result


if __name__ == "__main__":
    main()
