"""PhysioNet-2012 paper reproduction on the card: DuETT SSL pretraining on
sliding windows (stride 12 h, stays capped at 48 h), then multi-seed
fine-tuning with top-k weight averaging from the best SSL checkpoint (the
counterpart of ``multimodal_edema_prediction_tpu/cli/train_physionet.py``;
reference ``duett/train.py:74-100``), with the same flags:

    python -m multimodal_edema_prediction_tpu_torch.cli.train_physionet \\
        --device cuda [--data_dir <set-a/.. + Outcomes-a.txt>]

Without ``--data_dir`` the cohort is the synthetic PhysioNet-shaped one
(``data/physionet.make_synthetic_physionet``); with it, the raw challenge
files (``load_physionet2012_raw``). Writes ``<ckpt_dir>/ssl`` and
``<ckpt_dir>/finetune/seed<seed>``.
"""
from __future__ import annotations

import argparse
import os

from ..config import DuettConfig, OptimConfig, TrainConfig
from ..data.physionet import N_STATIC, N_TS_VARS, make_synthetic_physionet
from ..data.sliding import build_sliding_ssl_dataset, build_stay_label_dataset
from ..train.finetune_loop import finetune_duett
from ..train.ssl_loop import train_ssl
from ..utils.logging import Logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("PhysioNet-2012 pretrain + finetune "
                                "(PyTorch/CUDA)")
    p.add_argument("--n_patients", type=int, default=400)
    p.add_argument("--data_dir", type=str, default=None,
                   help="raw PhysioNet-2012 challenge directory "
                        "(set-a/... + Outcomes-a.txt); default: synthetic "
                        "P12-shaped cohort")
    p.add_argument("--n_timesteps", type=int, default=24)
    p.add_argument("--pretrain_epochs", type=int, default=10)
    p.add_argument("--finetune_epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--top_k", type=int, default=5)
    p.add_argument("--ckpt_dir", type=str, default="runs/physionet")
    p.add_argument("--d_embedding", type=int, default=24)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")
    return p


def main(argv=None, extras: dict = None):
    """Returns the fine-tuning summary; ``extras``, when given, gets the
    SSL run's ``TrainResult`` under ``ssl`` and ``finetune_duett``'s
    extras under ``finetune``."""
    args = build_parser().parse_args(argv)
    log = Logger("physionet").info
    if args.data_dir:
        from ..data.physionet import load_physionet2012_raw
        ds, meta = load_physionet2012_raw(args.data_dir)
        log(f"raw P12 cohort: {len(ds.events.stay_ids)} records from "
            f"{args.data_dir}")
    else:
        ds, meta = make_synthetic_physionet(n_patients=args.n_patients)
    duett = DuettConfig(n_variables=N_TS_VARS, n_timesteps=args.n_timesteps,
                        d_static=N_STATIC, d_embedding=args.d_embedding)

    ssl_ds = build_sliding_ssl_dataset(ds, meta, args.n_timesteps, stride=12,
                                       max_stay_hours=48)
    ssl_cfg = TrainConfig(batch_size=args.batch_size,
                          epochs=args.pretrain_epochs,
                          patience=args.pretrain_epochs, dtype="float32")
    ssl_res = train_ssl(ssl_ds, duett, ssl_cfg,
                        os.path.join(args.ckpt_dir, "ssl"), warmup_steps=100,
                        device=args.device, log=log)

    ft_ds = build_stay_label_dataset(ds, meta, args.n_timesteps)
    ft_cfg = TrainConfig(batch_size=args.batch_size,
                         epochs=args.finetune_epochs, patience=5,
                         dtype="float32",
                         optim=OptimConfig(lr=1e-4, weight_decay=1e-5,
                                           warmup_steps=50))
    ft_extras = None
    if extras is not None:
        extras["ssl"] = ssl_res
        ft_extras = extras.setdefault("finetune", {})
    return finetune_duett(ft_ds, duett, ft_cfg,
                          os.path.join(args.ckpt_dir, "finetune"),
                          ssl_ckpt=ssl_res.best_path,
                          seeds=tuple(args.seeds), top_k=args.top_k,
                          device=args.device, log=log, extras=ft_extras)


if __name__ == "__main__":
    main()
