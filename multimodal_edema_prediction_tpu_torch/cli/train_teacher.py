"""Teacher training CLI on the card (the counterpart of
``multimodal_edema_prediction_tpu/cli/train_teacher.py``).

    python -m multimodal_edema_prediction_tpu_torch.cli.train_teacher \\
        --device cuda --cxr_feature_cache hbm --epochs 30 --batch_size 128

Trains the ``dual_patch`` teacher, or with ``--perceiver_type dual
--pretrained_cxr_head_ckpt <cli.train_cxr_head's cxr_linear_head.msgpack>``
the ``dual`` one, whose image branch is that frozen CXR linear head on the
ViT's CLS token. With the RAD-DINO branch frozen (the default), on the
pixel tier (``--cxr_feature_cache none``: the ViT runs in
every step) or an encode-once tier (``hbm``: each image is encoded once,
steps gather cached tokens through K2; ``host``: the tokens stay on the
host, in RAM or in a disk store at ``--cxr_feature_store_path``; ``auto``:
the card within ``--hbm_feature_budget_gb``, else the host).
``--unfreeze_cxr`` fine-tunes the ViT too, on the pixel tier only, its
attention's gradient through K1's
backward kernels; ``--vit_weights`` starts the ViT from a converted
RAD-DINO checkpoint (``scripts/convert_rad_dino.py``); ``--duett_ckpt``
starts the DuETT backbone (weights and BatchNorm statistics) from an SSL
checkpoint of ``cli.train_ssl``, written by either package.
``--eval_train_batches N`` evaluates N train batches after each epoch and
prints their gap table, as the JAX loop does. By default (``--save_state``)
the full train state is written into the run directory at every epoch
boundary; ``--resume_dir <run dir>`` continues such a run bit for bit, and
a SIGTERM saves the state at the next epoch boundary and exits cleanly.
Every flag of the JAX CLI parses: ``--flash_block_b`` (a TPU tuning knob) is ignored, and the flags
of what is not ported yet raise ``NotImplementedError`` naming their
ROADMAP item.

    python -m multimodal_edema_prediction_tpu_torch.cli.train_teacher \\
        --device cuda --unfreeze_cxr --vit_weights rad_dino_flax.msgpack
"""
from __future__ import annotations

import argparse

from ..config import PerceiverConfig, TeacherConfig, ViTConfig
from ..models.teacher import init_teacher
from ..models.vit import load_vit_params
from ..train.ssl_loop import transplant_encoder
from ..train.teacher_loop import pretrained_head_spec, train_teacher
from .common import (COMMON_QUEUED, add_common_flags, add_queued_flags,
                     configs_from_args, load_data, make_run_dir,
                     refuse_queued_flags, sync_duett_with_meta)

# JAX flags of this CLI whose feature is not ported yet → their ROADMAP
# item (the common ones: COMMON_QUEUED)
QUEUED_FLAGS = {
    # the other teacher modes and LP mode
    "--n_latents": "P13", "--n_perceiver_layers": "P13",
    "--aux_stage2_alpha": "P13", "--aux_stage4_alpha": "P13",
    "--use_aux_cxr": "P13", "--aux_cxr_alpha": "P13", "--lp_ckpt": "P13",
    "--lp_beta_l2": "P13", "--lp_corr_l2": "P13",
    "--lp_correction_dropout": "P13",
    # the image feed tiers
    "--image_bank": "P15",
    "--hbm_image_budget_gb": "P15", "--u8_store_path": "P15",
    "--prefetch_depth": "P15",
    # the loop's gradient-flow diagnostics
    "--grad_diag_every": "P19", "--grad_diag_batches": "P19",
}


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
                   help="'orbax' is not ported yet (ROADMAP P16)")
    p.add_argument("--save_state", action="store_true", default=True,
                   help="write the full train state every epoch so that the "
                        "run resumes with --resume_dir (default on)")
    p.add_argument("--no_save_state", dest="save_state",
                   action="store_false")
    p.add_argument("--flash_block_b", type=int, default=2,
                   help="ignored: a TPU tuning knob of the JAX package (the "
                        "flash-attention batch block of its fused step)")
    add_queued_flags(p, QUEUED_FLAGS)
    return p


# flag → (value that is not ported, ROADMAP item)
_QUEUED = (
    ("vit_quant", "int8", "P20"),
    ("lp_only_correction", True, "P13"),
    ("cxr_jpeg_root", None, "P15"),
    ("state_backend", "orbax", "P16"),
)


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    refuse_queued_flags(args, COMMON_QUEUED, QUEUED_FLAGS)
    if args.vit_quant != "none" and args.unfreeze_cxr:
        p.error("--vit_quant requires a frozen CXR branch (the quantized "
                "matmuls are inference-only)")
    for flag, value, item in _QUEUED:
        got = getattr(args, flag)
        if (got if value is None else got == value):
            raise NotImplementedError(
                f"--{flag} {got} is not ported yet (ROADMAP {item})")
    if args.perceiver_type not in ("dual_patch", "dual"):
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

    head_ckpt = args.pretrained_cxr_head_ckpt or None
    model = None
    if args.duett_ckpt or args.vit_weights:
        model = init_teacher(teacher_cfg, tcfg.seed, **pretrained_head_spec(
            teacher_cfg, head_ckpt, dcfg.pathology_labels))
    if args.duett_ckpt:
        changed = transplant_encoder(args.duett_ckpt, model)
        print(f"DuETT backbone from {args.duett_ckpt} ({len(changed)} keys "
              "adjusted)", flush=True)
    if args.vit_weights:
        model.cxr.load_state_dict(load_vit_params(args.vit_weights,
                                                  teacher_cfg.vit))
        print(f"CXR branch (RAD-DINO) from {args.vit_weights}", flush=True)
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
                        state_backend=args.state_backend)
    print(f"best val macro fusion AUROC: {res.best_metric:.4f}  "
          f"ckpt: {res.best_path}", flush=True)
    return res


if __name__ == "__main__":
    main()
