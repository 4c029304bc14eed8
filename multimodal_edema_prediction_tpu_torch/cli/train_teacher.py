"""Teacher training CLI on the card (the counterpart of
``multimodal_edema_prediction_tpu/cli/train_teacher.py``).

    python -m multimodal_edema_prediction_tpu_torch.cli.train_teacher \\
        --device cuda --cxr_feature_cache hbm --epochs 30 --batch_size 128

Trains the ``dual_patch`` teacher, or the ``--perceiver_type`` of any
other mode: ``dual_patch_event``; ``single`` (``--aux_stage2_alpha``,
``--aux_stage4_alpha``); ``legacy`` (``--n_latents``,
``--n_perceiver_layers``, ``--use_aux_cxr --aux_cxr_alpha``; pixels only);
or with ``--pretrained_cxr_head_ckpt <cli.train_cxr_head's
cxr_linear_head.msgpack>`` ``dual``, whose image branch is that frozen CXR
linear head on the ViT's CLS token. ``--lp_only_correction --lp_ckpt
<a dual_patch or dual_patch_event checkpoint>`` trains only its correction
head and β (LP mode: ``--lp_beta_l2``, ``--lp_corr_l2``,
``--lp_correction_dropout``). With the RAD-DINO branch frozen (the
default), on the
pixel tier (``--cxr_feature_cache none``: the ViT runs in
every step) or an encode-once tier (``hbm``: each image is encoded once,
steps gather cached tokens through K2; ``host``: the tokens stay on the
host, in RAM or in a disk store at ``--cxr_feature_store_path``; ``auto``:
the card within ``--hbm_feature_budget_gb``, else the host).
``--unfreeze_cxr`` fine-tunes the ViT too, on the pixel tier only, its
attention's gradient through K1's
backward kernels; ``--vit_weights`` starts the ViT from a converted
RAD-DINO checkpoint (``cli/convert_rad_dino.py``, which needs no JAX, or
the JAX package's ``scripts/convert_rad_dino.py``); ``--duett_ckpt``
starts the DuETT backbone (weights and BatchNorm statistics) from an SSL
checkpoint of ``cli.train_ssl``, written by either package.
``--cxr_jpeg_root DIR`` trains on the chest X-rays ``DIR/{image_id}.jpg``
(decoded by the port's own decoder, ``data/native_loader.py``): decoded
once into a uint8 bank on the card (``--image_bank hbm``, or ``auto``
within ``--hbm_image_budget_gb``), into a disk memmap
(``--u8_store_path``), or for every batch (``--image_bank stream``); with
``--cxr_feature_cache`` they feed the encode-once build.
``--prefetch_depth`` (2) batches are hooked and copied ahead of the step by
a worker thread. ``--eval_train_batches N`` evaluates N train batches after
each epoch and prints their gap table, as the JAX loop does. By default
(``--save_state``) the full train state is written into the run directory
at every epoch boundary; ``--resume_dir <run dir>`` continues such a run
bit for bit, and a SIGTERM saves the state at the next epoch boundary and
exits cleanly. ``--vit_quant int8`` runs the frozen ViT's matmuls on int8
products (``ops/int8.py``; not with ``--unfreeze_cxr``).
``--wandb_project`` (unless ``--wandb_disabled``) and ``--wandb_run_name``
send the loop's telemetry to wandb, its per-step losses every
``--log_every`` steps. Every flag of the JAX CLI parses:
``--flash_block_b`` (a TPU tuning knob) is ignored, and the flags of what
is not ported yet raise ``NotImplementedError`` naming their ROADMAP item.

    python -m multimodal_edema_prediction_tpu_torch.cli.train_teacher \\
        --device cuda --unfreeze_cxr --vit_weights rad_dino_flax.msgpack
"""
from __future__ import annotations

import argparse

from ..config import PerceiverConfig, TeacherConfig, ViTConfig
from ..data.images import JpegStore
from ..models.teacher import init_teacher
from ..models.vit import load_vit_params
from ..train.ssl_loop import transplant_encoder
from ..train.teacher_loop import pretrained_head_spec, train_teacher
from ..utils.logging import Logger
from .common import (add_common_flags, configs_from_args, load_data,
                     join_process_group, make_run_dir,
                     sync_duett_with_meta, wandb_project)


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
                        "(python -m multimodal_edema_prediction_tpu_torch."
                        "cli.convert_rad_dino, or the JAX package's "
                        "scripts/convert_rad_dino.py)")
    p.add_argument("--duett_ckpt", type=str, default="",
                   help="SSL checkpoint to initialize the DuETT backbone")
    p.add_argument("--lp_only_correction", action="store_true")
    p.add_argument("--lp_ckpt", type=str, default="")
    p.add_argument("--lp_beta_l2", type=float, default=1e-3)
    p.add_argument("--lp_corr_l2", type=float, default=1e-2)
    p.add_argument("--lp_correction_dropout", type=float, default=0.3,
                   help="[LP mode] correction-head dropout override")
    p.add_argument("--n_latents", type=int, default=16,
                   help="[legacy] TemporalPerceiver latent-query count")
    p.add_argument("--n_perceiver_layers", type=int, default=2,
                   help="[legacy] TemporalPerceiver img/ts block pairs")
    p.add_argument("--aux_stage2_alpha", type=float, default=1.0,
                   help="[single] stage2 (image-only) loss weight")
    p.add_argument("--aux_stage4_alpha", type=float, default=0.5,
                   help="[single] stage4 (multimodal) loss weight")
    p.add_argument("--use_aux_cxr", action="store_true",
                   help="[legacy] auxiliary CXR-only head BCE")
    p.add_argument("--aux_cxr_alpha", type=float, default=0.0,
                   help="[legacy] total = main_bce + aux_cxr_alpha * aux_bce")
    p.add_argument("--cxr_jpeg_root", type=str, default="",
                   help="directory of {image_id}.jpg files: real chest "
                        "X-rays (the port's decoder) instead of the "
                        "synthetic cohort's procedural images")
    p.add_argument("--prefetch_depth", type=int, default=2,
                   help="train batches the prefetch worker keeps in flight "
                        "(hook and pinned copy overlap the step; 0 = "
                        "inline)")
    p.add_argument("--image_bank", type=str, default="auto",
                   choices=["auto", "hbm", "stream"],
                   help="real-image feeding: 'hbm' decodes every image once "
                        "into a uint8 bank on the card, 'stream' decodes "
                        "every batch on the host (or reads --u8_store_path),"
                        " 'auto' takes the bank within "
                        "--hbm_image_budget_gb")
    p.add_argument("--hbm_image_budget_gb", type=float, default=8.0)
    p.add_argument("--u8_store_path", type=str, default="",
                   help="decode every image once into a disk memmap of "
                        "uint8 rows at this path (reopened by later runs); "
                        "used when the card's bank is not")
    p.add_argument("--cxr_feature_cache", type=str, default="none",
                   choices=["none", "auto", "hbm", "host"],
                   help="encode-once tier: with the CXR branch frozen, "
                        "cache the ViT's (CLS, patch) tokens per unique "
                        "image, on the card ('hbm': gathered in every step "
                        "instead of running the ViT) or on the host "
                        "('host'); 'auto' takes the card if the bank fits "
                        "--hbm_feature_budget_gb, else the host")
    p.add_argument("--cxr_feature_store_path", type=str, default="",
                   help="the host tier's token store as a reusable disk "
                        "memmap at this path (reopened by later runs)")
    p.add_argument("--hbm_feature_budget_gb", type=float, default=8.0)
    p.add_argument("--pretrained_cxr_head_ckpt", type=str, default="",
                   help="--perceiver_type dual: the CXR linear head of "
                        "cli.train_cxr_head (either package's)")
    p.add_argument("--resume_dir", type=str, default="",
                   help="existing run directory to continue: restores the "
                        "full train state saved at the last completed epoch "
                        "and trains on bit for bit")
    p.add_argument("--state_backend", type=str, default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="full-state checkpoint format: 'msgpack' (one file) "
                        "or 'orbax' (JAX's optax tree as orbax steps under "
                        "orbax_state/, written in the background)")
    p.add_argument("--save_state", action="store_true", default=True,
                   help="write the full train state every epoch so that the "
                        "run resumes with --resume_dir (default on)")
    p.add_argument("--no_save_state", dest="save_state",
                   action="store_false")
    p.add_argument("--grad_diag_every", type=int, default=0,
                   help="run the read-only gradient-flow diagnostics "
                        "(analysis/grad_flow_diagnostics.py) on the val "
                        "split every N epochs, in the two patch modes "
                        "(0 = off)")
    p.add_argument("--grad_diag_batches", type=int, default=4)
    p.add_argument("--flash_block_b", type=int, default=2,
                   help="ignored: a TPU tuning knob of the JAX package (the "
                        "flash-attention batch block of its fused step)")
    return p




def vit_config(args) -> ViTConfig:
    """ViT-B/14 at 518² (``--vit_size base``) or the tiny smoke geometry,
    with ``--vit_quant`` (JAX ``cli/train_teacher.py:127-131``)."""
    if args.vit_size == "base":
        return ViTConfig(quant=args.vit_quant)
    return ViTConfig(image_size=56, patch_size=14, d_model=64, n_layers=2,
                     n_heads=2, d_feedforward=128, quant=args.vit_quant)


def teacher_config(args, dcfg, duett, vit) -> TeacherConfig:
    """The ``TeacherConfig`` of the parsed flags (JAX
    ``cli/train_teacher.py:123-143``): ``correction_dropout`` is
    ``--lp_correction_dropout`` in LP mode, else unset."""
    return TeacherConfig(
        duett=duett, vit=vit,
        perceiver=PerceiverConfig(
            n_pathologies=len(dcfg.pathology_labels),
            d_latent=args.d_latent, n_heads=args.n_perceiver_heads,
            dropout=args.perceiver_dropout, head_hidden=args.head_hidden,
            head_dropout=args.head_dropout,
            n_latents=args.n_latents, n_layers=args.n_perceiver_layers,
            correction_dropout=(args.lp_correction_dropout
                                if args.lp_only_correction else None)),
        perceiver_type=args.perceiver_type,
        freeze_duett=args.freeze_duett, freeze_cxr=not args.unfreeze_cxr)


def lp_kwargs(args) -> dict:
    """``train_teacher``'s LP arguments: LP mode from ``--lp_ckpt`` only
    with ``--lp_only_correction`` (JAX ``cli/train_teacher.py:178``)."""
    return {"lp_from": args.lp_ckpt if args.lp_only_correction else None,
            "lp_beta_l2": args.lp_beta_l2, "lp_corr_l2": args.lp_corr_l2}


def image_kwargs(args) -> dict:
    """``train_teacher``'s real-image and prefetch arguments (JAX
    ``cli/train_teacher.py:189-194``)."""
    return {"jpeg_store": (JpegStore(root=args.cxr_jpeg_root)
                           if args.cxr_jpeg_root else None),
            "prefetch_depth": args.prefetch_depth,
            "image_bank": args.image_bank,
            "u8_store_path": args.u8_store_path or None,
            "hbm_image_budget_gb": args.hbm_image_budget_gb}


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.vit_quant != "none" and args.unfreeze_cxr:
        p.error("--vit_quant requires a frozen CXR branch (the quantized "
                "matmuls are inference-only)")

    join_process_group(args)
    dcfg, duett, tcfg = configs_from_args(args)
    vit = vit_config(args)
    logger = Logger("teacher", wandb_project(args),
                    args.wandb_run_name or None, tcfg.to_dict())
    _, meta, anchor_ds = load_data(args, dcfg)
    teacher_cfg = teacher_config(
        args, dcfg, sync_duett_with_meta(duett, meta, logger.info), vit)

    head_ckpt = args.pretrained_cxr_head_ckpt or None
    model = None
    if args.duett_ckpt or args.vit_weights:
        model = init_teacher(teacher_cfg, tcfg.seed, **pretrained_head_spec(
            teacher_cfg, head_ckpt, dcfg.pathology_labels))
    if args.duett_ckpt:
        changed = transplant_encoder(args.duett_ckpt, model)
        logger.info(f"DuETT backbone from {args.duett_ckpt} "
                    f"({len(changed)} keys adjusted)")
    if args.vit_weights:
        model.cxr.load_state_dict(load_vit_params(args.vit_weights,
                                                  teacher_cfg.vit))
        logger.info(f"CXR branch (RAD-DINO) from {args.vit_weights}")
    run_dir = args.resume_dir or make_run_dir(args.ckpt_dir, tcfg)
    res = train_teacher(anchor_ds, teacher_cfg, tcfg, run_dir,
                        dcfg.pathology_labels, model=model,
                        device=args.device,
                        feature_cache=args.cxr_feature_cache,
                        hbm_feature_budget_gb=args.hbm_feature_budget_gb,
                        feature_store_path=args.cxr_feature_store_path
                        or None, pretrained_head_ckpt=head_ckpt,
                        auto_resume=bool(args.resume_dir),
                        save_full_state=args.save_state,
                        state_backend=args.state_backend,
                        grad_diag_every=args.grad_diag_every,
                        grad_diag_batches=args.grad_diag_batches,
                        logger=logger, **lp_kwargs(args),
                        **image_kwargs(args))
    logger.info(f"best val macro fusion AUROC: {res.best_metric:.4f}  "
                f"ckpt: {res.best_path}")
    logger.finish()
    return res


if __name__ == "__main__":
    main()
