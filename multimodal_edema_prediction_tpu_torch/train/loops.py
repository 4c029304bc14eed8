"""Loop bookkeeping shared by the training loops: the port's counterparts of
``EarlyStopper``, ``evaluate_binary_split`` and ``TrainResult`` in
``multimodal_edema_prediction_tpu/train/loops.py``."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..ops import metrics as M
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
    ``keep_logits`` the host logits ride along under ``logits``."""
    device = dataset.grid.device
    logits_all, y_all = [], []
    for batch in dataset.iter_batches(split, batch_size, shuffle=False,
                                      limit=limit):
        keep = np.asarray(batch.pop("valid")) > 0
        logits = eval_step(model, dataset.grid, dataset.static,
                           to_device(batch, device))
        logits_all.append(logits.cpu().numpy()[keep])
        y_all.append(np.asarray(batch["y"])[keep])
    logits = np.concatenate(logits_all)
    r = M.binary_metrics(np.concatenate(y_all), logits)
    return {**r, "logits": logits} if keep_logits else r


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
    # best_val_outputs (the host arrays of the best epoch's val eval) and
    # evaluate(model, split), the loop's own evaluation on its own data and
    # image tier
    extras: dict = field(default_factory=dict)
