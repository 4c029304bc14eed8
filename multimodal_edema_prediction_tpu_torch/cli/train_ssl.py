"""DuETT SSL pretraining CLI on the card (the counterpart of
``multimodal_edema_prediction_tpu/cli/train_ssl.py``; reference
``duett/train_duett_ssl.py``), with the same flags:

    python -m multimodal_edema_prediction_tpu_torch.cli.train_ssl \\
        --device cuda --epochs 300 --batch_size 128

Writes ``pretrain-step<N>-<val>.msgpack`` (the best val loss, JAX format),
``meta_with_stats.pkl`` and, by default, the full train state of every
epoch into a new run directory under ``--ckpt_dir``; ``--resume_dir``
continues such a run bit for bit; a SIGTERM saves the state at the next
epoch boundary and exits cleanly. The teacher starts from the checkpoint
with ``cli.train_teacher --duett_ckpt``. ``--steps_per_call K`` runs K
steps per call (one CUDA graph replay on a card, bit-equal to K = 1).
``--state_backend orbax`` writes the state as orbax steps
(``train/orbax_io.py``); the wandb flags
reach its ``Logger``; ``--eval_train_batches`` and ``--log_every`` are
accepted and, as in the JAX CLI, unused by the SSL loop.
"""
from __future__ import annotations

import argparse

from ..data.sliding import build_sliding_ssl_dataset
from ..train.ssl_loop import train_ssl
from ..utils.logging import Logger
from .common import (add_common_flags, configs_from_args, load_data,
                     join_process_group, make_run_dir,
                     sync_duett_with_meta, wandb_project)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("DuETT SSL pretraining (PyTorch/CUDA)")
    add_common_flags(p)
    p.add_argument("--stride", type=int, default=12)
    p.add_argument("--max_stay_hours", type=int, default=336)
    p.add_argument("--ssl_lr", type=float, default=3e-4)
    p.add_argument("--ssl_weight_decay", type=float, default=0.1)
    p.add_argument("--ssl_warmup", type=int, default=2000)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--pretrain_masked_steps", type=int, default=1)
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
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    join_process_group(args)
    dcfg, duett, tcfg = configs_from_args(args)
    duett = duett.replace(pretrain_masked_steps=args.pretrain_masked_steps)
    logger = Logger("duett_ssl", wandb_project(args),
                    args.wandb_run_name or None, tcfg.to_dict())
    ds, meta, _ = load_data(args, dcfg)
    duett = sync_duett_with_meta(duett, meta, logger.info)
    ssl_ds = build_sliding_ssl_dataset(ds, meta, dcfg.n_timesteps,
                                       args.stride, args.max_stay_hours)
    run_dir = args.resume_dir or make_run_dir(args.ckpt_dir, tcfg)
    res = train_ssl(ssl_ds, duett, tcfg, run_dir, lr=args.ssl_lr,
                    weight_decay=args.ssl_weight_decay,
                    warmup_steps=args.ssl_warmup, grad_clip=args.grad_clip,
                    auto_resume=bool(args.resume_dir),
                    save_full_state=args.save_state,
                    state_backend=args.state_backend, device=args.device,
                    log=logger.info)
    logger.info(f"best val_loss: {res.best_metric:.4f}  ckpt: "
                f"{res.best_path}")
    logger.finish()
    return res


if __name__ == "__main__":
    main()
