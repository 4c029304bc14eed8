"""Loop bookkeeping shared by the training loops: the port's counterparts of
``EarlyStopper`` and ``TrainResult`` in
``multimodal_edema_prediction_tpu/train/loops.py``."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


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
    # by a device sync), n_train_steps, n_eval_steps, best_val_outputs (the
    # host arrays of the best epoch's val eval) and evaluate(model, split),
    # the loop's own evaluation on its own data and image tier
    extras: dict = field(default_factory=dict)
