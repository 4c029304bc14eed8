"""Shared CLI plumbing for the port's training CLIs: flags → configs, run
directories, data loading (the counterpart of
``multimodal_edema_prediction_tpu/cli/common.py``, with the same flag names
and defaults for what the port trains).

Data: ``--data_dir`` reads a cohort written by ``cli.preprocess``
(``cohort.npz`` + ``meta_with_stats.pkl``); otherwise the
learnable synthetic cohort is generated (``--synthetic``, the default, as
in the JAX CLIs). ``--device`` (default ``cuda``) picks where training
runs. Under a launcher (``torchrun``'s environment) the teacher, SSL and
student CLIs join its process group (``join_process_group``) and train
data-parallel, one process per card (or over gloo, ranks sharing one).

Every flag of the JAX CLIs parses here. ``--wandb_project`` (unless
``--wandb_disabled``) and ``--wandb_run_name`` go to the CLI's
``utils/logging.Logger``; ``--log_every`` to
``TrainConfig.log_every``; ``--steps_per_call K`` to
``TrainConfig.steps_per_call`` (``train/engine.py::scan_steps``: K steps
per call, a ``[multistep] captured K=...`` line when a card's graph is
captured).
"""
from __future__ import annotations

import argparse
import os

import torch

from ..config import (DataConfig, DuettConfig, OptimConfig, TrainConfig,
                      make_run_id)
from ..data import pipeline as P
from ..data import synthetic as S


def add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--synthetic", action="store_true", default=True,
                   help="the synthetic cohort when --data_dir is empty "
                        "(which it is by default; as in the JAX CLIs)")
    p.add_argument("--synthetic_stays", type=int, default=500)
    p.add_argument("--n_variables", type=int, default=34)
    p.add_argument("--n_timesteps", type=int, default=24)
    p.add_argument("--split_seed", type=int, default=42)
    p.add_argument("--label_col", type=str, default="label_edema")
    # model dims
    p.add_argument("--d_embedding", type=int, default=24)
    p.add_argument("--n_duett_layers", type=int, default=2)
    p.add_argument("--d_latent", type=int, default=256)
    p.add_argument("--n_perceiver_heads", type=int, default=4)
    p.add_argument("--perceiver_dropout", type=float, default=0.2)
    p.add_argument("--head_hidden", type=int, default=128)
    p.add_argument("--head_dropout", type=float, default=0.2)
    p.add_argument("--aug_noise", type=float, default=0.0)
    p.add_argument("--aug_mask", type=float, default=0.0)
    p.add_argument("--transformer_dropout", type=float, default=0.0)
    # optim
    p.add_argument("--lr", type=float, default=8e-5)
    p.add_argument("--backbone_lr_mult", type=float, default=0.2)
    p.add_argument("--query_lr_mult", type=float, default=0.2)
    p.add_argument("--correction_lr_mult", type=float, default=1.0)
    p.add_argument("--weight_decay", type=float, default=5e-2)
    p.add_argument("--warmup_steps", type=int, default=300)
    p.add_argument("--min_lr_ratio", type=float, default=0.01)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--limit_batches", type=int, default=0)
    p.add_argument("--log_every", type=int, default=20,
                   help="per-step wandb scalar cadence (only with a live "
                        "wandb sink: the default path has no per-step host "
                        "sync)")
    p.add_argument("--eval_train_batches", type=int, default=0,
                   help="teacher: evaluate this many train batches after "
                        "each epoch and print their gap table")
    p.add_argument("--mixed_precision", type=str, default="bf16",
                   choices=["no", "bf16"])
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="K optimizer steps per dispatch: on a card one CUDA "
                        "graph replay per K steps (the teacher's dual modes "
                        "and LP, SSL, KD); bit-equal to K = 1")
    p.add_argument("--ckpt_dir", type=str, default="runs")
    p.add_argument("--wandb_project", type=str, default="")
    p.add_argument("--wandb_run_name", type=str, default="")
    p.add_argument("--wandb_disabled", action="store_true",
                   help="force wandb off even if --wandb_project is set")
    # loss alphas
    p.add_argument("--aux_img_alpha", type=float, default=0.5)
    p.add_argument("--aux_ts_alpha", type=float, default=0.5)
    p.add_argument("--aux_fus_alpha", type=float, default=1.0)
    p.add_argument("--aux_residual_alpha", type=float, default=0.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")


def wandb_project(args):
    """The wandb project, or None under ``--wandb_disabled`` (JAX
    ``cli/common.py:80-84``)."""
    if getattr(args, "wandb_disabled", False):
        return None
    return args.wandb_project or None


def configs_from_args(args) -> tuple:
    # every training CLI passes through here: arm the graceful-preemption
    # handler (SIGTERM → the state saved at the epoch boundary, a clean
    # exit; utils/preemption.py)
    from ..utils import preemption
    preemption.install_handler()
    dcfg = DataConfig(label_col=args.label_col,
                      n_timesteps=args.n_timesteps,
                      split_seed=args.split_seed, data_dir=args.data_dir)
    duett = DuettConfig(
        n_variables=args.n_variables, n_timesteps=args.n_timesteps,
        d_embedding=args.d_embedding, n_layers=args.n_duett_layers,
        aug_noise=args.aug_noise, aug_mask=args.aug_mask,
        transformer_dropout=args.transformer_dropout)
    tcfg = TrainConfig(
        batch_size=args.batch_size, epochs=args.epochs,
        patience=args.patience, seed=args.seed,
        limit_batches=args.limit_batches,
        eval_train_batches=args.eval_train_batches,
        dtype="bfloat16" if args.mixed_precision == "bf16" else "float32",
        log_every=args.log_every, steps_per_call=args.steps_per_call,
        alpha_img=args.aux_img_alpha, alpha_ts=args.aux_ts_alpha,
        alpha_fus=args.aux_fus_alpha,
        aux_residual_alpha=args.aux_residual_alpha,
        # the teacher CLI's mode weights (JAX cli/common.py:111-114)
        aux_stage2_alpha=getattr(args, "aux_stage2_alpha", 1.0),
        aux_stage4_alpha=getattr(args, "aux_stage4_alpha", 0.5),
        use_aux_cxr=getattr(args, "use_aux_cxr", False),
        aux_cxr_alpha=getattr(args, "aux_cxr_alpha", 0.0),
        optim=OptimConfig(
            lr=args.lr, backbone_lr_mult=args.backbone_lr_mult,
            query_lr_mult=args.query_lr_mult,
            correction_lr_mult=args.correction_lr_mult,
            weight_decay=args.weight_decay, warmup_steps=args.warmup_steps,
            min_lr_ratio=args.min_lr_ratio))
    return dcfg, duett, tcfg


def load_data(args, dcfg: DataConfig):
    """Returns (synthetic_dataset_or_ingest, meta, anchor_dataset)."""
    if args.data_dir:
        from ..data.ingest import load_artifacts
        ds, meta = load_artifacts(args.data_dir)
    else:
        ds = S.make_synthetic(seed=0, n_stays=args.synthetic_stays,
                              n_subjects=max(args.synthetic_stays // 3, 10),
                              n_variables=args.n_variables)
        meta = P.meta_from_events(ds, dcfg)
    anchor_ds = P.build_anchor_dataset(ds, meta, dcfg)
    return ds, meta, anchor_ds


def sync_duett_with_meta(duett, meta, log=None):
    """Reconcile model dims with the loaded cohort's meta: a ``--data_dir``
    cohort defines its own variable count and static width."""
    if (duett.n_variables, duett.d_static) != (meta.n_variables,
                                               meta.d_static):
        if log is not None:
            log(f"model dims from meta: n_variables "
                f"{duett.n_variables}→{meta.n_variables}, d_static "
                f"{duett.d_static}→{meta.d_static}")
        duett = duett.replace(n_variables=meta.n_variables,
                              d_static=meta.d_static)
    return duett


def join_process_group(args) -> None:
    """Under a launcher (``WORLD_SIZE`` > 1 with ``MASTER_ADDR``,
    ``MASTER_PORT`` and ``RANK``, as ``torchrun`` sets them) join its
    ``torch.distributed`` group, so that the teacher, SSL and KD loops run
    data-parallel (``parallel/multihost.initialize_distributed``); nothing
    for one process."""
    from ..parallel.multihost import initialize_distributed
    initialize_distributed(device=args.device)


def make_run_dir(base: str, cfg) -> str:
    """A new run directory under ``base`` with the config's JSON; in a
    multi-process run rank 0 makes it and every rank gets its name."""
    from ..parallel import multihost as mh
    run_dir = None
    if mh.is_main_process():
        run_dir = os.path.join(base, make_run_id(cfg))
        os.makedirs(run_dir, exist_ok=False)   # never overwrite a run
        cfg.save_json(os.path.join(run_dir, "config.json"))
    if mh.process_count() > 1:
        names = [None] * mh.process_count()
        torch.distributed.all_gather_object(names, run_dir)
        run_dir = names[0]
    return run_dir
