"""MIMIC supervised fine-tuning CLI on the card (the counterpart of
``multimodal_edema_prediction_tpu/cli/finetune_mimic.py``; reference
``duett/train_duett_finetune.py``), with the same flags:

    python -m multimodal_edema_prediction_tpu_torch.cli.finetune_mimic \\
        --device cuda --ssl_ckpt runs/ssl/<run>/pretrain-*.msgpack

An SSL-pretrained DuETT (``cli.train_ssl``'s checkpoint, from either
package) fine-tuned on the stay-level mortality label (``death_adm``):
several seeds, the top-k checkpoints of each by val AUPRC under
``<ckpt_dir>/seed<seed>/ft-*.msgpack``, the test split on their averaged
weights, and mean ± std across seeds (``train/finetune_loop.
finetune_duett``), on an ingested cohort (``--data_dir``) or the synthetic
default. A SIGTERM or SIGUSR1 is taken by the port's preemption handler, as
in the JAX CLI. ``--wandb_project`` names the wandb project of its
``Logger`` (off by default; wandb is imported only then).
"""
from __future__ import annotations

import argparse

from ..config import DataConfig, DuettConfig, OptimConfig, TrainConfig
from ..data import pipeline as P
from ..data import synthetic as S
from ..data.sliding import build_stay_label_dataset
from ..train.finetune_loop import finetune_duett
from ..utils.logging import Logger
from .common import wandb_project


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("DuETT MIMIC supervised finetune "
                                "(PyTorch/CUDA)")
    p.add_argument("--ssl_ckpt", type=str, default="",
                   help="SSL-pretrained DuETT checkpoint to start from "
                        "(empty: random init, still multi-seed+averaged)")
    p.add_argument("--data_dir", type=str, default="",
                   help="ingested cohort dir (cohort.npz + "
                        "meta_with_stats.pkl); default: synthetic")
    p.add_argument("--synthetic_stays", type=int, default=500)
    p.add_argument("--n_variables", type=int, default=34)
    p.add_argument("--n_timesteps", type=int, default=24)
    p.add_argument("--d_embedding", type=int, default=24)
    p.add_argument("--n_duett_layers", type=int, default=2)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=1e-5)
    p.add_argument("--warmup_steps", type=int, default=50)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--mixed_precision", type=str, default="none",
                   choices=["none", "bf16"])
    p.add_argument("--ckpt_dir", type=str, default="runs/finetune_mimic")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")
    p.add_argument("--wandb_project", type=str, default="")
    return p


def main(argv=None, extras: dict = None):
    """Returns the summary; ``extras`` as ``finetune_duett`` takes it."""
    args = build_parser().parse_args(argv)

    from ..utils import preemption
    preemption.install_handler()

    logger = Logger("finetune_mimic", wandb_project(args))
    dcfg = DataConfig(n_timesteps=args.n_timesteps, data_dir=args.data_dir)
    if args.data_dir:
        from ..data.ingest import load_artifacts
        ds, meta = load_artifacts(args.data_dir)
    else:
        ds = S.make_synthetic(seed=0, n_stays=args.synthetic_stays,
                              n_subjects=max(args.synthetic_stays // 3, 10),
                              n_variables=args.n_variables)
        meta = P.meta_from_events(ds, dcfg)
    ft_ds = build_stay_label_dataset(ds, meta, args.n_timesteps)
    duett = DuettConfig(n_variables=meta.n_variables,
                        d_static=meta.d_static,
                        n_timesteps=args.n_timesteps,
                        d_embedding=args.d_embedding,
                        n_layers=args.n_duett_layers)
    cfg = TrainConfig(
        batch_size=args.batch_size, epochs=args.epochs,
        patience=args.patience,
        dtype="bfloat16" if args.mixed_precision == "bf16" else "float32",
        optim=OptimConfig(lr=args.lr, weight_decay=args.weight_decay,
                          warmup_steps=args.warmup_steps))
    summary = finetune_duett(ft_ds, duett, cfg, args.ckpt_dir,
                            ssl_ckpt=args.ssl_ckpt or None,
                            seeds=tuple(args.seeds), top_k=args.top_k,
                            device=args.device, log=logger.info,
                            extras=extras)
    logger.finish()
    return summary


if __name__ == "__main__":
    main()
