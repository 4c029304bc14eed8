"""DuETT SSL pretraining loop (masked value / presence / event
reconstruction): the port's counterpart of
``multimodal_edema_prediction_tpu/train/ssl_loop.py`` (reference
``duett/train_duett_ssl.py`` + ``duett/duett.py:329-418``).

Sliding-window samples, inverse-square-root warmup, gradient clipping by the
global norm, the best checkpoint by the lowest val loss (JAX format, prefix
``pretrain``), early stopping, and ``meta_with_stats.pkl`` written beside
the checkpoints: the contract every later stage reads. With
``save_full_state`` the full train state is saved at every epoch boundary
(``FullStateResumer``: msgpack, or ``state_backend="orbax"``'s async orbax
steps, committed before the call returns), and ``auto_resume`` continues
from it bit for bit; a SIGTERM (``utils/preemption.py``) saves it at the
next boundary and ends the call cleanly.

Multi-step dispatch (``cfg.steps_per_call`` K > 1; JAX ``ssl_loop.py:
103-147``): each group of K train batches (``stack_host_batches``; the
remainder group last) goes through ``engine.scan_steps``, one CUDA graph
replay per group on a card (in one process or an NCCL group; a loop of K
steps over gloo, ``engine.capture_route``); the history, weights and
generator equal K = 1's bit for bit, in a multi-process run too.

Multi-process (JAX ``ssl_loop.py:49-232``): under an initialised
``torch.distributed`` group each rank trains on its rows of the same global
batches; the masks and the loss are the global batch's
(``parallel/multihost.py``) and the gradients are summed over the ranks.
The validation batch is snapped down to a multiple of the ranks (JAX
``ssl_loop.py:173-187``), and only rank 0 writes the meta contract, the
checkpoints and the full state.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import DuettConfig, TrainConfig
from ..data.prefetch import stack_host_batches
from ..data.sliding import SlidingSSLDataset
from ..models.duett import DuettPretrainModel, init_pretrain_model
from ..parallel import mesh as meshlib
from ..parallel import multihost as mh
from ..utils import preemption, resolve_device
from . import engine
from .checkpoint import (BestKTracker, FullStateResumer, load_checkpoint,
                         restore_tolerant)
from .loops import EarlyStopper, TrainResult
from .optim import MultiGroupAdamW, invsqrt_warmup
from .state import TrainState, param_count
from .teacher_loop import DTYPES, _sync


def train_ssl(dataset: SlidingSSLDataset, duett_cfg: DuettConfig,
              cfg: TrainConfig, ckpt_dir: str, lr: float = 3e-4,
              weight_decay: float = 0.1, warmup_steps: int = 2000,
              grad_clip: float = 1.0, auto_resume: bool = False,
              save_full_state: Optional[bool] = None,
              state_backend: str = "msgpack",
              stop_after_epochs: Optional[int] = None,
              model: Optional[DuettPretrainModel] = None,
              device="cuda",
              log: Callable[[str], None] = print) -> TrainResult:
    """Pretrain DuETT; returns the best val loss, its checkpoint and the
    per-epoch history. ``model``: the initial weights (default:
    ``init_pretrain_model`` from ``cfg.seed``), moved to ``device`` and
    trained in place. ``stop_after_epochs`` pauses after that many epochs
    of this call (the state saved, as a preempted run's would be)."""
    world = mh.check_group()
    scan_k = engine.steps_per_call(cfg.steps_per_call)
    if world > 1:
        meshlib.create_mesh(cfg.n_data, cfg.n_model)
    if save_full_state is None:
        save_full_state = auto_resume
    resumer = FullStateResumer(ckpt_dir, state_backend)
    dev = mh.rank_device(resolve_device(device))
    dtype = DTYPES[cfg.dtype]
    if model is None:
        model = init_pretrain_model(duett_cfg, cfg.seed)
    model = model.to(dev)
    dataset.to(dev)
    T = dataset.n_timesteps
    log(f"SSL params: {param_count(model):,}  device={dev}")

    state = TrainState(model, MultiGroupAdamW.one_group(
        model, invsqrt_warmup(lr, warmup_steps), weight_decay, grad_clip))
    train_step = engine.make_ssl_step(duett_cfg, T, dtype)
    if scan_k > 1:
        # SSL steps are small: host dispatch bounds them (JAX :104-108)
        train_step = engine.scan_steps(
            train_step, scan_k, log, engine.capture_route(dev, scan_k, log))
    eval_step = engine.make_ssl_eval(duett_cfg, T, dtype)
    tracker = BestKTracker(ckpt_dir, k=1, mode="min", prefix="pretrain")
    stopper = EarlyStopper(cfg.patience, mode="min")
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    history, start_epoch, n_steps = [], 0, 0
    cfg_dict = {"duett": duett_cfg.to_dict(), "train": cfg.to_dict()}
    if auto_resume:
        meta = resumer.restore(state)
        if meta is not None:
            start_epoch, history, n_steps = resumer.apply_meta(
                meta, stopper, tracker, gen)
            log(f"[resume:{state_backend}] continuing at epoch "
                f"{start_epoch}")

    # the meta contract, next to the checkpoints
    if mh.is_main_process():
        dataset.meta.save(os.path.join(ckpt_dir, "meta_with_stats.pkl"))
    n_val = dataset.split_size("val")
    if n_val < world:
        raise ValueError(
            f"the val split has {n_val} windows for {world} process(es): "
            "SSL validation needs at least one window a process")
    # a multiple of the ranks, so that the batch splits over them
    val_bs = max(min(cfg.batch_size, n_val) // world * world, world)

    def evaluate(m, split: str = "val") -> float:
        """Mean eval ``total`` over ``split``, each batch with its own
        deterministic mask stream."""
        losses = []
        for i, batch in enumerate(dataset.iter_batches(
                split, val_bs, shuffle=False, limit=cfg.limit_batches)):
            parts = eval_step(m, dataset.grid, dataset.static,
                              engine.to_device(batch, dev),
                              torch.Generator(device=dev).manual_seed(
                                  1000 + i))
            losses.append(float(parts["total"]))
        return float(np.mean(losses)) if losses else float("nan")

    t_start, resumed_steps = time.perf_counter(), n_steps
    for epoch in range(start_epoch, cfg.epochs):
        acc, nb = None, 0
        batches = dataset.iter_batches("train", cfg.batch_size,
                                       shuffle=True, seed=cfg.seed + epoch,
                                       limit=cfg.limit_batches)
        if scan_k > 1:
            batches = stack_host_batches(batches, scan_k)
        for batch in batches:
            out = train_step(state, dataset.grid, dataset.static,
                             engine.to_device(batch, dev), gen)
            # step by step, in step order, whatever K
            for (total,) in engine.step_rows(out, ("total",)):
                acc = total if acc is None else acc + total
                nb += 1
                n_steps += 1
        # one host sync per epoch
        train_loss = float(acc) / nb if nb else float("nan")
        if nb and not np.isfinite(train_loss):
            raise FloatingPointError(
                f"non-finite SSL loss at epoch {epoch}; aborting")
        val_loss = evaluate(model)
        improved = stopper.update(val_loss)
        if improved and mh.is_main_process():
            tracker.offer(val_loss, model, state.step, cfg_dict)
        history.append({"epoch": epoch, "train_loss": train_loss,
                        "val_loss": val_loss})
        log(f"epoch {epoch:3d}  train={train_loss:.4f}  val={val_loss:.4f}"
            f"{'  *' if improved else ''}")
        # agreed over the ranks: a SIGTERM may reach only some of them
        preempted = mh.any_flag(preemption.requested())
        if save_full_state or preempted:
            resumer.save(state, epoch, stopper, tracker, history, n_steps,
                         gen)
        if preempted:
            log(f"SIGTERM/preemption at epoch {epoch}: state saved; resume "
                "with auto_resume / --resume_dir")
            break
        if stopper.should_stop:
            break
        if stop_after_epochs is not None \
                and epoch + 1 - start_epoch >= stop_after_epochs:
            log(f"pausing after {stop_after_epochs} epochs")
            break
    resumer.finish()    # the orbax save in flight, committed (JAX :229)
    _sync(dev)
    elapsed = time.perf_counter() - t_start

    if mh.is_main_process():
        tracker.ensure_saved(model, state.step, cfg_dict)
        best_metric, best_path = tracker.best
    else:
        best_metric = stopper.best if stopper.best is not None \
            else float("nan")
        best_path = ""
    mh.barrier()    # rank 0's files are complete before any rank returns
    ran = n_steps - resumed_steps
    sps = ran / max(elapsed, 1e-9)
    return TrainResult(best_metric=best_metric, best_path=best_path,
                       history=history, test_metrics={}, steps_per_sec=sps,
                       samples_per_sec=sps * cfg.batch_size,
                       extras={"n_train_steps": ran,
                               "train_seconds": elapsed,
                               "evaluate": evaluate, "state": state,
                               "generator": gen})


def transplant_encoder(ssl_ckpt_path: str, model: torch.nn.Module,
                       dest: str = "duett") -> list:
    """Load an SSL checkpoint's encoder (written by either package) into
    ``model``'s DuETT backbone ``dest``, in place: parameters tolerantly
    (missing leaves keep the model's, shape-mismatched ``head`` leaves are
    skipped), and the encoder's BatchNorm statistics when the checkpoint
    has them (JAX ``ssl_loop.py:248-260``, the reference's
    ``load_duett_backbone``, strict=False). Returns the adjusted paths."""
    from ..convert import load_flax, to_flax
    ckpt = load_checkpoint(ssl_ckpt_path)
    backbone = getattr(model, dest)
    params, stats = to_flax(backbone)
    params, changed = restore_tolerant(params, ckpt["params"]["encoder"],
                                       skip_prefixes=("head",))
    enc_stats = ckpt.get("batch_stats", {}).get("encoder")
    load_flax(backbone, params, stats if enc_stats is None else enc_stats)
    return changed
