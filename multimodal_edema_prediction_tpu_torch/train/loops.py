"""Loop bookkeeping shared by the training loops, and the supervised
time-series loop: the port's counterparts of ``EarlyStopper``,
``evaluate_binary_split``, ``TrainResult`` and ``train_supervised_ts`` in
``multimodal_edema_prediction_tpu/train/loops.py``."""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.prefetch import stack_host_batches
from ..ops import metrics as M
from ..parallel.multihost import fetch_global, process_count
from . import engine
from .engine import to_device


class EarlyStopper:
    """Patience-based early stop on a monotone-improving metric
    (trainer.py:707-716)."""

    def __init__(self, patience: int, mode: str = "max"):
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def update(self, metric: float) -> bool:
        """Returns True if this metric is an improvement. NaN never improves
        (a NaN first epoch must not become the 'best' checkpoint)."""
        if metric != metric:   # NaN
            self.bad_epochs += 1
            return False
        improved = (self.best is None
                    or (metric > self.best if self.mode == "max"
                        else metric < self.best))
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        return improved

    @property
    def should_stop(self) -> bool:
        return self.patience > 0 and self.bad_epochs >= self.patience


def evaluate_binary_split(eval_step, model, dataset, split: str,
                          batch_size: int, limit: int = 0,
                          keep_logits: bool = False) -> Dict[str, float]:
    """Stream a split's logits through ``eval_step(model, grid, static,
    batch)`` to the host and keep the ``valid`` rows (the padded tail's
    are not) → ``binary_metrics`` of ``batch['y']`` (JAX
    ``loops.py:62-85``, reference evaluator.py:10-37); with
    ``keep_logits`` the host logits ride along under ``logits``. In a
    multi-process run the logits are gathered over the ranks and the labels
    and ``valid`` are the global copies under ``batch["_global"]``, so
    every rank computes the same metrics."""
    device = dataset.grid.device
    logits_all, y_all = [], []
    for batch in dataset.iter_batches(split, batch_size, shuffle=False,
                                      limit=limit):
        src = batch.get("_global", batch)
        keep = np.asarray(src["valid"]) > 0
        batch.pop("valid")
        logits = fetch_global(eval_step(model, dataset.grid, dataset.static,
                                        to_device(batch, device)))
        logits_all.append(logits[keep])
        y_all.append(np.asarray(src["y"])[keep])
    logits = np.concatenate(logits_all)
    r = M.binary_metrics(np.concatenate(y_all), logits)
    return {**r, "logits": logits} if keep_logits else r


def refuse_multi_process(loop: str, item: str) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP ``item`` when ``loop``
    would run in more than one process (a launcher's ``WORLD_SIZE``, or an
    initialised group): each would train on every batch alone and write
    the same checkpoints."""
    world = max(int(os.environ.get("WORLD_SIZE", "1")), process_count())
    if world > 1:
        raise NotImplementedError(
            f"{world} processes: multi-process {loop} is not ported yet "
            f"(ROADMAP {item})")


@dataclass
class TrainResult:
    best_metric: float
    best_path: str
    history: List[dict]
    test_metrics: Dict[str, float]
    steps_per_sec: float = 0.0
    samples_per_sec: float = 0.0
    # the port's additions, read by chip_smoke.py and the tests:
    # phase_seconds (feature_build / train / eval wall seconds, each ended
    # by a device sync), n_train_steps, n_eval_steps, feature_tier (the
    # image tier and, for a cached one, its images, bytes and build time),
    # best_val_outputs (the host arrays of the best epoch's val eval),
    # evaluate(model, split), the loop's own evaluation on its own data and
    # image tier, and the final train state and step generator (``state``,
    # ``generator``)
    extras: dict = field(default_factory=dict)


def without_valid(batches):
    """Train batches without their ``valid`` column."""
    for b in batches:
        b.pop("valid")
        yield b


def train_supervised_ts(dataset, model_cfg, cfg, ckpt_dir: str,
                        model: Optional[torch.nn.Module] = None,
                        device="cuda",
                        log: Callable[[str], None] = print) -> TrainResult:
    """TS-only supervised training of the student architecture
    (``models/student.py``) on the BCE of the main label (JAX
    ``loops.py:97-212``): per epoch, shuffled train batches (the losses
    stay on the device until the epoch's one host sync), the val AUROC,
    early stopping and the best checkpoint (JAX format, prefix ``best``,
    config ``{"model", "train"}``); at the end the best checkpoint,
    reloaded, is evaluated on the test split. ``dataset`` is an
    ``AnchorDataset``; ``model``: the initial weights (default:
    ``init_student`` from ``cfg.seed``), moved to ``device`` and trained in
    place. With ``cfg.steps_per_call`` K > 1 each group of K train batches
    (the remainder group last) goes through ``engine.scan_steps`` (JAX
    ``loops.py:132-167``; one CUDA graph replay per group on a card), the
    history and weights equal to K = 1's bit for bit. More than one process
    is ROADMAP P18b (JAX's loop has no multi-process branch either)."""
    from ..models.student import init_student
    from .checkpoint import BestKTracker, load_student_from_ckpt
    from .optim import MultiGroupAdamW
    from .state import TrainState, param_count
    from .teacher_loop import DTYPES, _sync
    from ..utils import resolve_device

    refuse_multi_process("supervised training", "P18b")
    scan_k = engine.steps_per_call(cfg.steps_per_call)
    dev = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    dataset.to(dev)
    if model is None:
        model = init_student(model_cfg, cfg.seed)
    model = model.to(dev)
    log(f"params: {param_count(model):,}  device={dev}")
    T = dataset.n_timesteps
    steps_per_epoch = dataset.split_size("train") // cfg.batch_size
    if cfg.limit_batches > 0:
        steps_per_epoch = min(steps_per_epoch, cfg.limit_batches)
    state = TrainState(model, MultiGroupAdamW(
        model, cfg.optim, steps_per_epoch * cfg.epochs))
    train_step = engine.make_supervised_ts_step(model_cfg.duett, T, dtype)
    if scan_k > 1:
        train_step = engine.scan_steps(train_step, scan_k, log)
    eval_step = engine.make_supervised_ts_eval(T, dtype)
    stopper = EarlyStopper(cfg.patience, mode="max")
    tracker = BestKTracker(ckpt_dir, k=1, mode="max", prefix="best")
    cfg_dict = {"model": model_cfg.to_dict(), "train": cfg.to_dict()}
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    history, n_steps = [], 0
    t_start = time.perf_counter()
    for epoch in range(cfg.epochs):
        losses = []
        batches = without_valid(dataset.iter_batches(
            "train", cfg.batch_size, shuffle=True, seed=cfg.seed + epoch,
            limit=cfg.limit_batches))
        if scan_k > 1:
            batches = stack_host_batches(batches, scan_k)
        for b in batches:
            out = train_step(state, dataset.grid, dataset.static,
                             to_device(b, dev), gen)
            for (loss,) in engine.step_rows(out, ("loss",)):
                losses.append(loss)
                n_steps += 1
        # one host sync per epoch
        train_loss = float(torch.stack(losses).mean()) if losses \
            else float("nan")
        val = evaluate_binary_split(eval_step, model, dataset, "val",
                                    cfg.batch_size)
        improved = stopper.update(val["auroc"])
        if improved:
            tracker.offer(val["auroc"], model, state.step, cfg_dict)
        history.append({"epoch": epoch, "train_loss": train_loss, **val})
        log(f"epoch {epoch:3d}  loss={train_loss:.4f}  "
            f"val_auroc={val['auroc']:.4f}  val_auprc={val['auprc']:.4f}"
            f"{'  *' if improved else ''}")
        if stopper.should_stop:
            log(f"early stop at epoch {epoch}")
            break
    _sync(dev)
    elapsed = time.perf_counter() - t_start

    # reload the best and test (trainer.py:718-764)
    tracker.ensure_saved(model, state.step, cfg_dict)
    best_metric, best_path = tracker.best
    best_model, _, _ = load_student_from_ckpt(best_path, dev)
    test = evaluate_binary_split(eval_step, best_model, dataset, "test",
                                 cfg.batch_size)
    log(f"test: auroc={test['auroc']:.4f} auprc={test['auprc']:.4f}")
    sps = n_steps / max(elapsed, 1e-9)
    return TrainResult(best_metric=best_metric, best_path=best_path,
                       history=history, test_metrics=test,
                       steps_per_sec=sps,
                       samples_per_sec=sps * cfg.batch_size,
                       extras={"n_train_steps": n_steps,
                               "train_seconds": elapsed, "state": state,
                               "generator": gen})
