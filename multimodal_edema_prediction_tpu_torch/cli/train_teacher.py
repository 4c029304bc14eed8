"""Teacher training CLI on the card (the counterpart of
``multimodal_edema_prediction_tpu/cli/train_teacher.py``).

    python -m multimodal_edema_prediction_tpu_torch.cli.train_teacher \\
        --device cuda --cxr_feature_cache hbm --epochs 30 --batch_size 128

Trains the ``dual_patch`` teacher. With the RAD-DINO branch frozen (the
default), on the pixel tier (``--cxr_feature_cache none``: the ViT runs in
every step) or the encode-once tier (``hbm``: each image is encoded once,
steps gather cached tokens through K2). ``--unfreeze_cxr`` fine-tunes the
ViT too, on the pixel tier only, its attention's gradient through K1's
backward kernels; ``--vit_weights`` starts the ViT from a converted
RAD-DINO checkpoint (``scripts/convert_rad_dino.py``). Flags of what is not
ported yet raise ``NotImplementedError`` naming their ROADMAP item.

    python -m multimodal_edema_prediction_tpu_torch.cli.train_teacher \\
        --device cuda --unfreeze_cxr --vit_weights rad_dino_flax.msgpack
"""
from __future__ import annotations

import argparse

from ..config import PerceiverConfig, TeacherConfig, ViTConfig
from ..models.teacher import init_teacher
from ..models.vit import load_vit_params
from ..train.teacher_loop import train_teacher
from .common import (add_common_flags, configs_from_args, load_data,
                     make_run_dir, sync_duett_with_meta)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("teacher training (PyTorch/CUDA)")
    add_common_flags(p)
    p.add_argument("--perceiver_type", type=str, default="dual_patch",
                   choices=["dual_patch", "dual_patch_event", "dual",
                            "single", "legacy"])
    p.add_argument("--freeze_duett", action="store_true")
    p.add_argument("--unfreeze_cxr", action="store_true")
    p.add_argument("--vit_size", type=str, default="base",
                   choices=["tiny", "base"],
                   help="'tiny' for smoke runs without RAD-DINO weights")
    p.add_argument("--vit_quant", type=str, default="none",
                   choices=["none", "int8"])
    p.add_argument("--vit_weights", type=str, default="",
                   help="converted RAD-DINO checkpoint for the CXR branch "
                        "(scripts/convert_rad_dino.py)")
    p.add_argument("--duett_ckpt", type=str, default="",
                   help="SSL checkpoint to initialize the DuETT backbone")
    p.add_argument("--lp_only_correction", action="store_true")
    p.add_argument("--cxr_jpeg_root", type=str, default="")
    p.add_argument("--cxr_feature_cache", type=str, default="none",
                   choices=["none", "auto", "hbm", "host"],
                   help="encode-once tier: with the CXR branch frozen, "
                        "cache the ViT's (CLS, patch) tokens per unique "
                        "image on the card and gather them in every step "
                        "instead of running the ViT; 'auto' takes the bank "
                        "if it fits --hbm_feature_budget_gb")
    p.add_argument("--hbm_feature_budget_gb", type=float, default=8.0)
    p.add_argument("--resume_dir", type=str, default="")
    p.add_argument("--state_backend", type=str, default="msgpack",
                   choices=["msgpack", "orbax"])
    return p


# flag → (value that is not ported, ROADMAP item)
_QUEUED = (
    ("vit_quant", "int8", "P20"),
    ("duett_ckpt", None, "P12"),
    ("lp_only_correction", True, "P13"),
    ("cxr_jpeg_root", None, "P15"),
    ("resume_dir", None, "P16"),
    ("state_backend", "orbax", "P16"),
    ("cxr_feature_cache", "host", "P8"),
)


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.vit_quant != "none" and args.unfreeze_cxr:
        p.error("--vit_quant requires a frozen CXR branch (the quantized "
                "matmuls are inference-only)")
    for flag, value, item in _QUEUED:
        got = getattr(args, flag)
        if (got if value is None else got == value):
            raise NotImplementedError(
                f"--{flag} {got} is not ported yet (ROADMAP {item})")
    if args.perceiver_type != "dual_patch":
        raise NotImplementedError(
            f"--perceiver_type {args.perceiver_type} is not ported yet "
            "(ROADMAP P13)")

    dcfg, duett, tcfg = configs_from_args(args)
    vit = ViTConfig() if args.vit_size == "base" else ViTConfig(
        image_size=56, patch_size=14, d_model=64, n_layers=2, n_heads=2,
        d_feedforward=128)
    _, meta, anchor_ds = load_data(args, dcfg)
    teacher_cfg = TeacherConfig(
        duett=sync_duett_with_meta(duett, meta, print), vit=vit,
        perceiver=PerceiverConfig(
            n_pathologies=len(dcfg.pathology_labels),
            d_latent=args.d_latent, n_heads=args.n_perceiver_heads,
            dropout=args.perceiver_dropout, head_hidden=args.head_hidden,
            head_dropout=args.head_dropout),
        perceiver_type=args.perceiver_type,
        freeze_duett=args.freeze_duett, freeze_cxr=not args.unfreeze_cxr)

    model = None
    if args.vit_weights:
        model = init_teacher(teacher_cfg, tcfg.seed)
        model.cxr.load_state_dict(load_vit_params(args.vit_weights,
                                                  teacher_cfg.vit))
        print(f"CXR branch (RAD-DINO) from {args.vit_weights}", flush=True)
    run_dir = make_run_dir(args.ckpt_dir, tcfg)
    res = train_teacher(anchor_ds, teacher_cfg, tcfg, run_dir,
                        dcfg.pathology_labels, model=model,
                        device=args.device,
                        feature_cache=args.cxr_feature_cache,
                        hbm_feature_budget_gb=args.hbm_feature_budget_gb)
    print(f"best val macro fusion AUROC: {res.best_metric:.4f}  "
          f"ckpt: {res.best_path}", flush=True)
    return res


if __name__ == "__main__":
    main()
