"""Supervised fine-tuning of an SSL-pretrained DuETT backbone: the port's
counterpart of ``multimodal_edema_prediction_tpu/train/finetune_loop.py``
(reference ``duett/train_duett_finetune.py``).

Per seed: a fresh ``DuettClassifier`` (its initial weights from the seed),
the SSL encoder transplanted into its ``encoder`` (tolerant restore, head
surgery), training on the stay-level label (``death_adm``) with pos-frac
class weights, the top-k checkpoints by val AUPRC (JAX format, prefix
``ft``, under ``<ckpt_dir>/seed<seed>``), and the test split evaluated on
the top-k **averaged** weights and on the best checkpoint alone, both with
the best checkpoint's BatchNorm statistics (:56-62, :204-207); then mean ±
std across seeds (:160-224). The averaging sums each leaf in float64 and
divides (``checkpoint.average_params``), then casts to float32, so an
average of the same checkpoints is the JAX package's bit for bit.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..config import DuettConfig, TrainConfig
from ..convert import load_flax
from ..data.pipeline import gather_windows
from ..data.sliding import StayLabelDataset
from ..models.duett import DuettClassifier, feats_to_input, init_classifier
from ..ops import metrics as M
from ..ops.losses import bce_with_logits
from ..utils import resolve_device
from .checkpoint import BestKTracker, load_checkpoint
from .engine import to_device
from .loops import EarlyStopper, refuse_multi_process
from .optim import simple_adamw
from .ssl_loop import transplant_encoder
from .state import TrainState
from .teacher_loop import DTYPES, _sync


def make_finetune_steps(n_timesteps: int, dtype,
                        pos_frac: Optional[float]) -> tuple:
    """(``train_step(state, grid, static, batch, gen)`` → the loss,
    detached; ``eval_step(model, grid, static, batch)`` → float32 logits):
    the fine-tuning step and eval of JAX ``finetune_loop.py:33-74``. No
    augmentation; the train step runs the model in train mode (dropout from
    ``gen``, BatchNorm on batch statistics) on the BCE weighted 1/(2p) for
    positives and 1/(2(1-p)) for negatives, ``p`` the train split's
    positive share (no weights when ``pos_frac`` is None)."""
    if pos_frac is not None:
        pos_w = 1.0 / (2.0 * pos_frac)
        neg_w = 1.0 / (2.0 * (1.0 - pos_frac))
    else:
        pos_w = neg_w = None

    def inputs(grid, static, batch):
        x_ts = gather_windows(grid, batch["stay_rows"], batch["slot_idx"],
                              n_timesteps)
        x_static = static[batch["stay_rows"].long()].to(dtype)
        x_in, x_static = feats_to_input(x_ts.to(dtype), x_static)
        return x_in, x_static, batch["bin_ends"].to(dtype)

    def train_step(state: TrainState, grid, static, batch, gen
                   ) -> torch.Tensor:
        x_in, x_static, times = inputs(grid, static, batch)
        logits = state.model(x_in, x_static, times, train=True, gen=gen)
        y = batch["y"]
        w = None if pos_w is None else torch.where(y > 0, pos_w, neg_w)
        loss = bce_with_logits(logits, y, weight=w)
        state.apply_gradients(loss)
        return loss.detach()

    def eval_step(model, grid, static, batch) -> torch.Tensor:
        with torch.inference_mode():
            return model(*inputs(grid, static, batch)).float()

    return train_step, eval_step


def evaluate_split(eval_step, model, ds: StayLabelDataset, split: str,
                   batch_size: int) -> Dict[str, float]:
    """``binary_metrics`` of a split's logits. ``iter_batches`` drops the
    incomplete remainder, so a split smaller than the batch would give no
    batch and a NaN metric: the batch is clamped to the split's size, and
    an empty split raises (JAX ``finetune_loop.py:77-92``)."""
    n = ds.split_size(split)
    if n == 0:
        raise ValueError(f"{split} split is empty — cannot evaluate")
    device = ds.grid.device
    logits, ys = [], []
    for batch in ds.iter_batches(split, min(batch_size, n), shuffle=False):
        logits.append(eval_step(model, ds.grid, ds.static,
                                to_device(batch, device)).cpu().numpy())
        ys.append(batch["y"])
    return M.binary_metrics(np.concatenate(ys), np.concatenate(logits))


def finetune_duett(ds: StayLabelDataset, duett_cfg: DuettConfig,
                   cfg: TrainConfig, ckpt_dir: str,
                   ssl_ckpt: Optional[str] = None,
                   seeds: Sequence[int] = (0, 1, 2), top_k: int = 5,
                   init_variables: Optional[Callable[[int], dict]] = None,
                   device="cuda", log: Callable[[str], None] = print,
                   extras: Optional[dict] = None) -> dict:
    """Multi-seed fine-tuning with top-k weight averaging; returns the JAX
    package's summary (``per_seed``: ``seed``, ``val_auprc``,
    ``test_best``, ``test_avg``; ``test_auroc_mean/std``,
    ``test_auprc_mean/std`` over the averaged weights).

    ``init_variables``: seed → flax-layout ``{"params", "batch_stats"}``,
    each seed's initial classifier (the JAX loop draws them from
    ``jax.random.key(seed)``); default: ``init_classifier`` from the seed,
    in distribution. ``extras``, when given, is filled per seed with what a
    measurement reads: the averaged model's state as it sits on the device
    (``avg_state``), the kept checkpoints (``entries``), and the train steps
    and their wall seconds."""
    refuse_multi_process("fine-tuning", "P18b")
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    ds.to(dev)
    pos_frac = ds.pos_frac("train") or None
    train_step, eval_step = make_finetune_steps(ds.n_timesteps, dtype,
                                                pos_frac)
    per_seed = []

    def classifier(params, batch_stats) -> DuettClassifier:
        return load_flax(DuettClassifier(duett_cfg), params,
                         batch_stats).to(dev)

    for seed in seeds:
        if init_variables is not None:
            v = init_variables(seed)
            model = load_flax(DuettClassifier(duett_cfg), v["params"],
                              v["batch_stats"])
        else:
            model = init_classifier(duett_cfg, seed)
        if ssl_ckpt:
            transplant_encoder(ssl_ckpt, model, dest="encoder")
        model = model.to(dev)

        steps_per_epoch = max(ds.split_size("train") // cfg.batch_size, 1)
        state = TrainState(model, simple_adamw(
            model, cfg.optim.lr, cfg.optim.weight_decay,
            warmup_steps=cfg.optim.warmup_steps,
            total_steps=steps_per_epoch * cfg.epochs,
            min_lr_ratio=cfg.optim.min_lr_ratio))
        tracker = BestKTracker(os.path.join(ckpt_dir, f"seed{seed}"),
                               k=top_k, mode="max", prefix="ft")
        stopper = EarlyStopper(cfg.patience, mode="max")
        gen = torch.Generator(device=dev).manual_seed(seed + 100)
        train_s, n_steps = 0.0, 0
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            for batch in ds.iter_batches("train", cfg.batch_size, True,
                                         seed=seed * 1000 + epoch,
                                         limit=cfg.limit_batches):
                train_step(state, ds.grid, ds.static, to_device(batch, dev),
                           gen)
                n_steps += 1
            _sync(dev)
            train_s += time.perf_counter() - t0
            val = evaluate_split(eval_step, model, ds, "val",
                                 cfg.batch_size)
            stopper.update(val["auprc"])
            tracker.offer(val["auprc"], model, state.step)
            if stopper.should_stop:
                break

        # top-k weight averaging at test time, with the best's statistics
        avg = tracker.averaged_params(np.float32)
        best = load_checkpoint(tracker.entries[0][1])
        avg_model = classifier(avg, best["batch_stats"])
        test_avg = evaluate_split(eval_step, avg_model, ds, "test",
                                  cfg.batch_size)
        test_best = evaluate_split(
            eval_step, classifier(best["params"], best["batch_stats"]), ds,
            "test", cfg.batch_size)
        log(f"seed {seed}: val_auprc={stopper.best:.4f}  "
            f"test(best)={test_best['auprc']:.4f}  "
            f"test(avg{len(tracker.entries)})={test_avg['auprc']:.4f}")
        per_seed.append({"seed": seed, "val_auprc": stopper.best,
                         "test_best": test_best, "test_avg": test_avg})
        if extras is not None:
            extras[seed] = {"avg_state": avg_model.state_dict(),
                            "entries": list(tracker.entries),
                            "train_steps": n_steps, "train_s": train_s}

    aurocs = [r["test_avg"]["auroc"] for r in per_seed]
    auprcs = [r["test_avg"]["auprc"] for r in per_seed]
    summary = {
        "per_seed": per_seed,
        "test_auroc_mean": float(np.mean(aurocs)),
        "test_auroc_std": float(np.std(aurocs)),
        "test_auprc_mean": float(np.mean(auprcs)),
        "test_auprc_std": float(np.std(auprcs)),
    }
    log(f"summary: AUROC {summary['test_auroc_mean']:.4f}"
        f"±{summary['test_auroc_std']:.4f}  "
        f"AUPRC {summary['test_auprc_mean']:.4f}"
        f"±{summary['test_auprc_std']:.4f}")
    return summary
