"""L0 preprocessing: raw irregular clinical events → hourly slot grids.

TPU-native replacement for the reference's pandas notebooks
(``preprocess/*.ipynb``, ``duett/[full]input_preprocess.ipynb`` — SURVEY §2.3):
everything is vectorized columnar numpy executed ONCE per cohort, producing
the :class:`..data.synthetic.EventTable` the training path consumes.

Capabilities covered:
- per-variable unit standardization + physiologic outlier clipping
  (notebook cells 185-296),
- hourly ``slot_idx`` binning with per-variable aggregation policy
  (mean / last / sum — the notebook's merge_asof + resample logic,
  cells 305-382),
- CXR → slot assignment ``cxrtime ∈ [slot_start, slot_end)`` + ``cxr_flag``
  (cells 391-398),
- phenotype-dependent soft-label exponential decay (CPE fast 12 h vs NCPE
  slow 72 h half-life; ``[subject_data]time_series_text_preprocess.ipynb``
  cell 51 — legacy ``Edema_soft`` capability).

The port's copy of ``multimodal_edema_prediction_tpu/data/preprocess.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .synthetic import AnchorTable, EventTable

AGG_MEAN, AGG_LAST, AGG_SUM = 0, 1, 2


@dataclass
class VariableSpec:
    """Unit/outlier/aggregation policy for one clinical variable."""
    name: str
    unit_scale: float = 1.0          # raw → standard unit multiplier
    lo: float = -np.inf              # physiologic plausibility clip
    hi: float = np.inf
    agg: int = AGG_MEAN              # within-slot aggregation


@dataclass
class RawEvents:
    """Irregular raw event stream (one row per measurement)."""
    stay_ids: np.ndarray             # [N] int64
    times_h: np.ndarray              # [N] float64 hours since stay intime
    var_ids: np.ndarray              # [N] int32 into the variable table
    values: np.ndarray               # [N] float32 raw units


def standardize(raw: RawEvents, specs: Sequence[VariableSpec]) -> RawEvents:
    """Apply unit conversion + plausibility clipping; drop non-finite."""
    scale = np.asarray([s.unit_scale for s in specs], np.float32)
    lo = np.asarray([s.lo for s in specs], np.float32)
    hi = np.asarray([s.hi for s in specs], np.float32)
    v = raw.values * scale[raw.var_ids]
    keep = np.isfinite(v) & (raw.times_h >= 0)
    v = np.clip(v, lo[raw.var_ids], hi[raw.var_ids])
    return RawEvents(raw.stay_ids[keep], raw.times_h[keep],
                     raw.var_ids[keep], v[keep].astype(np.float32))


def hourly_bin(raw: RawEvents, specs: Sequence[VariableSpec],
               stay_ids: np.ndarray, subject_ids: np.ndarray,
               max_hours: int = 336) -> EventTable:
    """Aggregate the event stream into a per-(stay, hour-slot) grid.

    One vectorized pass: events sort by (stay, slot, var, time); per-variable
    policy picks mean / last / sum within each (stay, slot, var) group.
    """
    V = len(specs)
    stay_row = {int(s): i for i, s in enumerate(stay_ids)}
    rows = np.asarray([stay_row.get(int(s), -1) for s in raw.stay_ids])
    slot = np.floor(raw.times_h).astype(np.int64)
    keep = (rows >= 0) & (slot >= 0) & (slot < max_hours)
    rows, slot = rows[keep], slot[keep]
    var, val = raw.var_ids[keep].astype(np.int64), raw.values[keep]
    t = raw.times_h[keep]

    # group key = (stay_row, slot, var); sort by key then time
    key = (rows * max_hours + slot) * V + var
    order = np.lexsort((t, key))
    key, val, t = key[order], val[order], t[order]
    uniq, start, counts = np.unique(key, return_index=True,
                                    return_counts=True)

    sums = np.add.reduceat(val.astype(np.float64), start)
    means = sums / counts
    lasts = val[start + counts - 1]
    agg_policy = np.asarray([s.agg for s in specs])
    u_var = (uniq % V).astype(np.int64)
    pol = agg_policy[u_var]
    agg_val = np.where(pol == AGG_LAST, lasts,
                       np.where(pol == AGG_SUM, sums, means)).astype(
        np.float32)

    u_rows = (uniq // (max_hours * V)).astype(np.int64)
    u_slot = ((uniq // V) % max_hours).astype(np.int64)

    # densify per (stay_row, slot): one EventTable row per observed slot
    slot_key = u_rows * max_hours + u_slot
    s_uniq, s_start, s_counts = np.unique(slot_key, return_index=True,
                                          return_counts=True)
    n_rows = len(s_uniq)
    values = np.zeros((n_rows, V), np.float32)
    cnt = np.zeros((n_rows, V), np.int32)
    row_of_group = np.repeat(np.arange(n_rows), s_counts)
    values[row_of_group, u_var] = agg_val
    cnt[row_of_group, u_var] = counts.astype(np.int32)

    out_stay_row = (s_uniq // max_hours).astype(np.int64)
    out_slot = (s_uniq % max_hours).astype(np.int32)
    order2 = np.lexsort((out_slot, out_stay_row))
    out_stay_row, out_slot = out_stay_row[order2], out_slot[order2]
    values, cnt = values[order2], cnt[order2]

    offsets = np.zeros(len(stay_ids) + 1, np.int64)
    np.add.at(offsets, out_stay_row + 1, 1)
    offsets = np.cumsum(offsets)
    stay_len = np.zeros(len(stay_ids), np.int32)
    for r in range(len(stay_ids)):
        sl = out_slot[offsets[r]:offsets[r + 1]]
        stay_len[r] = int(sl.max()) + 1 if len(sl) else 0

    return EventTable(stay_ids=np.asarray(stay_ids, np.int64),
                      subject_ids=np.asarray(subject_ids, np.int64),
                      stay_len=stay_len, offsets=offsets,
                      slot_idx=out_slot, values=values, counts=cnt)


def assign_cxr_slots(cxr_times_h: np.ndarray, cxr_stay_ids: np.ndarray,
                     stay_ids: np.ndarray, stay_len: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """CXR time → slot assignment: cxrtime ∈ [slot, slot+1) within the stay.
    Returns (slot_idx, cxr_flag)."""
    stay_row = {int(s): i for i, s in enumerate(stay_ids)}
    slot = np.floor(cxr_times_h).astype(np.int32)
    flag = np.zeros(len(cxr_times_h), np.int32)
    for i, (s, t) in enumerate(zip(cxr_stay_ids, slot)):
        r = stay_row.get(int(s), -1)
        if r >= 0 and 0 <= t < stay_len[r]:
            flag[i] = 1
    return slot, flag


def soft_label_decay(event_times_h: np.ndarray, eval_times_h: np.ndarray,
                     is_cpe: np.ndarray, fast_half_life: float = 12.0,
                     slow_half_life: float = 72.0) -> np.ndarray:
    """Phenotype-dependent soft-label decay: a positive finding at
    ``event_time`` decays exponentially; cardiogenic edema (CPE) resolves
    fast (12 h half-life), non-cardiogenic slowly (72 h)."""
    dt = np.maximum(eval_times_h - event_times_h, 0.0)
    hl = np.where(is_cpe, fast_half_life, slow_half_life)
    return (0.5 ** (dt / hl)).astype(np.float32)
