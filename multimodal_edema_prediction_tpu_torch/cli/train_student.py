"""Student knowledge-distillation CLI on the card (the counterpart of
``multimodal_edema_prediction_tpu/cli/train_student.py``; reference
``main_train_student_duett.py``), with the same flags and defaults:

    python -m multimodal_edema_prediction_tpu_torch.cli.train_student \\
        --device cuda --teacher_ckpt runs/<teacher run>/best-*.msgpack \\
        --duett_ckpt runs/<ssl run>/pretrain-*.msgpack \\
        --cxr_feature_cache hbm

The last stage of the SSL → teacher → student chain: the frozen teacher is
read from ``--teacher_ckpt`` (written by either package's teacher CLI) and
``--duett_ckpt`` starts the student's DuETT from an SSL checkpoint.
``--cxr_feature_cache`` picks the teacher's image tier: ``none`` runs its
ViT in every KD step; ``hbm`` caches its tokens per image on the card;
``host`` in host RAM, or in a reusable disk store at
``--cxr_feature_store_path``; ``auto`` the card within 8 GB, else the host.
Writes ``best-step<N>-<auroc>.msgpack`` and, by default, the full train
state of every epoch into a new run directory under ``--ckpt_dir``;
``--resume_dir`` continues such a run bit for bit; a SIGTERM saves the
state at the next epoch boundary and exits cleanly. The wandb flags reach
its ``Logger``. ``--steps_per_call K`` runs K KD steps per call (one
CUDA graph replay on a card, bit-equal to K = 1). ``--state_backend
orbax`` writes the state as orbax steps (``train/orbax_io.py``).
"""
from __future__ import annotations

import argparse

from ..config import StudentConfig
from ..ops.losses import resolve_kd_loss
from ..train.kd_loop import train_student_kd
from ..utils.logging import Logger
from .common import (add_common_flags, configs_from_args, load_data,
                     join_process_group, make_run_dir,
                     sync_duett_with_meta, wandb_project)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("DuETT KD student training (PyTorch/CUDA)")
    add_common_flags(p)
    p.add_argument("--teacher_ckpt", type=str, required=True)
    p.add_argument("--student_pool", type=str, default="mean",
                   choices=["mean", "rep_token"])
    p.add_argument("--kd_name", type=str, default="vanilla_kl",
                   help="KD loss from ops.losses.KD_LOSSES (unknown names "
                        "fail fast)")
    p.add_argument("--kd_T", type=float, default=4.0)
    p.add_argument("--kd_alpha", type=float, default=0.5)
    p.add_argument("--duett_ckpt", type=str, default="",
                   help="SSL checkpoint for the student backbone")
    p.add_argument("--resume_dir", type=str, default="",
                   help="existing run directory: restore the full train "
                        "state at the last completed epoch and continue "
                        "bit-exactly")
    p.add_argument("--state_backend", type=str, default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="full-state checkpoint format: 'msgpack' (one file) "
                        "or 'orbax' (JAX's optax tree as orbax steps under "
                        "orbax_state/, written in the background)")
    p.add_argument("--save_state", action="store_true", default=True)
    p.add_argument("--no_save_state", dest="save_state",
                   action="store_false")
    p.add_argument("--cxr_feature_cache", type=str, default="none",
                   choices=["none", "auto", "hbm", "host"],
                   help="encode-once tier: the KD teacher is frozen, so "
                        "cache its ViT (CLS, patch) tokens per unique image "
                        "and drop its ViT forward from every KD step")
    p.add_argument("--cxr_feature_store_path", type=str, default="",
                   help="the host tier's token store as a reusable disk "
                        "memmap at this path")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    resolve_kd_loss(args.kd_name)
    join_process_group(args)
    dcfg, duett, tcfg = configs_from_args(args)
    tcfg = tcfg.replace(kd_name=args.kd_name, kd_T=args.kd_T,
                        kd_alpha=args.kd_alpha)
    logger = Logger("student", wandb_project(args),
                    args.wandb_run_name or None, tcfg.to_dict())
    _, meta, anchor_ds = load_data(args, dcfg)
    student_cfg = StudentConfig(duett=sync_duett_with_meta(duett, meta,
                                                           logger.info),
                                pool=args.student_pool,
                                head_hidden=args.head_hidden,
                                head_dropout=args.head_dropout)
    run_dir = args.resume_dir or make_run_dir(args.ckpt_dir, tcfg)
    res = train_student_kd(
        anchor_ds, student_cfg, args.teacher_ckpt, tcfg, run_dir,
        device=args.device, ssl_backbone_ckpt=args.duett_ckpt or None,
        auto_resume=bool(args.resume_dir), save_full_state=args.save_state,
        state_backend=args.state_backend,
        feature_cache=args.cxr_feature_cache,
        feature_store_path=args.cxr_feature_store_path or None,
        log=logger.info)
    logger.info(f"best val AUROC: {res.best_metric:.4f}  ckpt: "
                f"{res.best_path}")
    logger.finish()
    return res


if __name__ == "__main__":
    main()
