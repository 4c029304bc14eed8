"""The dataset meta contract — array-first version of ``meta_with_stats.pkl``
(the port's copy of ``multimodal_edema_prediction_tpu/data/meta.py``).

The reference passes a pickled dict with variable names, normalization stats
and split ids between every pipeline stage (produced at
``duett/train_duett_ssl.py:130-135``, validated at
``training_duett/data_processing.py:49-110``). We keep the same contract but
materialize the per-variable stats as aligned arrays so normalization is one
fused multiply-add instead of dict lookups.
"""
from __future__ import annotations

import json
import math
import os
import pickle
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

REQUIRED_KEYS = (
    "ALL_VARS", "ALL_COUNTS", "ONEHOT_STATIC", "D_STATIC", "LABEL_COL",
    "means", "stds", "age_mean", "age_std", "N_TIMESTEPS",
)


@dataclass
class Meta:
    """Schema + train-split normalization statistics."""
    all_vars: Tuple[str, ...]
    all_counts: Tuple[str, ...]
    onehot_static: Tuple[str, ...]
    d_static: int
    label_col: str
    n_timesteps: int
    means: np.ndarray            # [V] aligned with all_vars
    stds: np.ndarray             # [V]
    age_mean: float
    age_std: float
    train_ids: Optional[np.ndarray] = None   # stay ids per split
    val_ids: Optional[np.ndarray] = None
    test_ids: Optional[np.ndarray] = None

    def __post_init__(self):
        self.means = np.asarray(self.means, np.float32)
        self.stds = np.asarray(self.stds, np.float32)
        self.validate()

    @property
    def n_variables(self) -> int:
        return len(self.all_vars)

    def validate(self):
        """Fail-fast sanity checks (data_processing.py:58-110)."""
        if len(self.all_vars) != len(self.all_counts):
            raise ValueError("ALL_VARS / ALL_COUNTS length mismatch")
        if self.means.shape != (self.n_variables,) or \
                self.stds.shape != (self.n_variables,):
            raise ValueError(
                f"stats shape mismatch: means {self.means.shape}, "
                f"stds {self.stds.shape}, V={self.n_variables}")
        bad = [v for v, m, s in zip(self.all_vars, self.means, self.stds)
               if not (math.isfinite(float(m)) and math.isfinite(float(s)))]
        if bad:
            raise ValueError(f"NaN/Inf normalization stats for: {bad}")
        zero = [v for v, s in zip(self.all_vars, self.stds) if float(s) == 0.0]
        if zero:
            print(f"[meta][WARN] std==0 for {zero} (1e-7 fallback applies)")
        if not (math.isfinite(self.age_mean) and math.isfinite(self.age_std)):
            raise ValueError(
                f"bad age stats: {self.age_mean}, {self.age_std}")

    # ---- reference-format round trip ----
    @classmethod
    def from_reference_dict(cls, d: dict) -> "Meta":
        missing = [k for k in REQUIRED_KEYS if k not in d]
        if missing:
            raise KeyError(f"meta missing required keys: {missing}")
        all_vars = tuple(d["ALL_VARS"])
        means = np.array([float(d["means"][v]) for v in all_vars], np.float32)
        stds = np.array([float(d["stds"][v]) for v in all_vars], np.float32)
        return cls(
            all_vars=all_vars, all_counts=tuple(d["ALL_COUNTS"]),
            onehot_static=tuple(d["ONEHOT_STATIC"]),
            d_static=int(d["D_STATIC"]), label_col=str(d["LABEL_COL"]),
            n_timesteps=int(d["N_TIMESTEPS"]), means=means, stds=stds,
            age_mean=float(d["age_mean"]), age_std=float(d["age_std"]),
            train_ids=np.asarray(d["train_ids"]) if "train_ids" in d else None,
            val_ids=np.asarray(d["val_ids"]) if "val_ids" in d else None,
            test_ids=np.asarray(d["test_ids"]) if "test_ids" in d else None,
        )

    def to_reference_dict(self) -> dict:
        d = {
            "ALL_VARS": list(self.all_vars),
            "ALL_COUNTS": list(self.all_counts),
            "ONEHOT_STATIC": list(self.onehot_static),
            "D_STATIC": self.d_static, "LABEL_COL": self.label_col,
            "N_TIMESTEPS": self.n_timesteps,
            "means": {v: float(m) for v, m in zip(self.all_vars, self.means)},
            "stds": {v: float(s) for v, s in zip(self.all_vars, self.stds)},
            "age_mean": self.age_mean, "age_std": self.age_std,
        }
        for k, ids in (("train_ids", self.train_ids),
                       ("val_ids", self.val_ids), ("test_ids", self.test_ids)):
            if ids is not None:
                d[k] = np.asarray(ids)
        return d

    @classmethod
    def load(cls, path: str) -> "Meta":
        if path.endswith(".json"):
            with open(path) as f:
                d = json.load(f)
        else:
            with open(path, "rb") as f:
                d = pickle.load(f)
        return cls.from_reference_dict(d)

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self.to_reference_dict(), f)
