"""Demographic / past-history feature builder (L0).

Re-implements ``preprocess/demographic_preprocess.ipynb`` as
testable array functions (the reference is a pandas notebook):

- ICD past-history flags (cells 62, 65): per admission, flags computed from
  codes of STRICTLY EARLIER admissions of the same subject —
  circulatory = ICD-9 390-459 or ICD-10 ``I``-prefix,
  respiratory  = ICD-9 460-519 or ICD-10 ``J``-prefix.
- BMI WHO binning one-hots (cells 35-38) + ``observed_bmi`` missingness flag
  with NaN→0 backfill (cell 80).
- insurance / marital / race one-hots via pandas ``get_dummies`` semantics
  (cells 44-51): category order = sorted unique values, NaN rows all-zero.
- age (anchor or at-intime) + binary gender (cell 11: ``M``→1).

Output is the ``(names, matrix)`` pair that becomes the ONEHOT_STATIC block
of the meta contract (``duett/mimic_dataset.py:49-53`` consumes it).

The port's copy of ``multimodal_edema_prediction_tpu/data/demographics.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BMI_BINS = ("under", "normal", "overweight", "obese1", "obese2", "obese3")


# =============================================================================
# ICD flags (cells 6 / 65 — identical logic in both)
# =============================================================================
def is_circulatory(code: str) -> bool:
    """ICD-10 ``I``-prefix or ICD-9 390-459."""
    c = str(code).upper()
    if c.startswith("I"):
        return True
    if c[:3].isdigit():
        return 390 <= int(c[:3]) <= 459
    return False


def is_respiratory(code: str) -> bool:
    """ICD-10 ``J``-prefix or ICD-9 460-519."""
    c = str(code).upper()
    if c.startswith("J"):
        return True
    if c[:3].isdigit():
        return 460 <= int(c[:3]) <= 519
    return False


def has_circulatory(icd_list: Sequence[str]) -> int:
    return int(any(is_circulatory(c) for c in icd_list))


def has_respiratory(icd_list: Sequence[str]) -> int:
    return int(any(is_respiratory(c) for c in icd_list))


def past_history_flags(subject_ids: np.ndarray, hadm_ids: np.ndarray,
                       admittimes: np.ndarray, icd_codes: Sequence[str]
                       ) -> Dict[Tuple[int, int], Tuple[int, int]]:
    """(subject, hadm) → (circulatory, respiratory) from PRIOR admissions.

    Reference cell 62: iterating admissions in admittime order, each
    admission sees only the codes accumulated from earlier admissions (its
    own codes do NOT count — the history is strictly past).
    """
    order = np.lexsort((hadm_ids, admittimes, subject_ids))
    out: Dict[Tuple[int, int], Tuple[int, int]] = {}
    past: List[str] = []
    cur_subj = None
    cur_hadm = None
    pending: List[str] = []
    for i in order:
        s, h = int(subject_ids[i]), int(hadm_ids[i])
        if s != cur_subj:
            past, pending = [], []
            cur_subj, cur_hadm = s, None
        if h != cur_hadm:
            past = past + pending
            pending = []
            cur_hadm = h
            out[(s, h)] = (has_circulatory(past), has_respiratory(past))
        pending.append(icd_codes[i])
    return out


# =============================================================================
# BMI (cells 32-38, 80)
# =============================================================================
def compute_bmi(weight_kg: np.ndarray, height_cm: np.ndarray) -> np.ndarray:
    """round(weight / (height/100)^2, 1) — cell 32."""
    with np.errstate(divide="ignore", invalid="ignore"):
        bmi = weight_kg / (height_cm / 100.0) ** 2
    return np.round(bmi, 1)


def bmi_bin(bmi: float) -> str:
    """WHO binning (cell 37); NaN → 'unknown'."""
    if not np.isfinite(bmi):
        return "unknown"
    if bmi < 18.5:
        return "under"
    if bmi < 25:
        return "normal"
    if bmi < 30:
        return "overweight"
    if bmi < 35:
        return "obese1"
    if bmi < 40:
        return "obese2"
    return "obese3"


def bmi_onehot(bmi: np.ndarray) -> Tuple[List[str], np.ndarray]:
    """[N] BMI → (names, [N, 7]): six WHO one-hots + observed_bmi flag.

    'unknown' maps to all-zero one-hots with observed_bmi=0 (cell 80's
    dedicated missingness column + fillna(0))."""
    names = [f"bmi_{b}" for b in BMI_BINS] + ["observed_bmi"]
    out = np.zeros((len(bmi), len(names)), np.float32)
    for i, b in enumerate(np.asarray(bmi, np.float64)):
        label = bmi_bin(b)
        if label != "unknown":
            out[i, BMI_BINS.index(label)] = 1.0
            out[i, -1] = 1.0
    return names, out


# =============================================================================
# Categorical one-hots (cells 44-51: pandas get_dummies semantics)
# =============================================================================
def onehot_categorical(values: Sequence, prefix: str
                       ) -> Tuple[List[str], np.ndarray]:
    """get_dummies-equivalent: columns = sorted unique non-null values;
    null/empty rows are all-zero."""
    vals = [None if v is None or (isinstance(v, float) and np.isnan(v))
            or (isinstance(v, str) and not v.strip()) else str(v)
            for v in values]
    cats = sorted({v for v in vals if v is not None})
    names = [f"{prefix}_{c}" for c in cats]
    out = np.zeros((len(vals), len(cats)), np.float32)
    index = {c: j for j, c in enumerate(cats)}
    for i, v in enumerate(vals):
        if v is not None:
            out[i, index[v]] = 1.0
    return names, out


def gender_binary(gender: Sequence[str]) -> np.ndarray:
    """M→1, else 0 (cell 11)."""
    return np.asarray([1.0 if str(g).upper() == "M" else 0.0
                       for g in gender], np.float32)


# =============================================================================
# Assembly (cell 70: bmi + ins/mari/race + age/sex + past ICD flags)
# =============================================================================
def build_demographics(
        hadm_ids: np.ndarray,
        age: np.ndarray,
        gender: Sequence[str],
        bmi: np.ndarray,
        insurance: Sequence,
        marital_status: Sequence,
        race: Sequence,
        icd_history: Optional[Dict[int, Tuple[int, int]]] = None,
) -> Tuple[List[str], np.ndarray]:
    """One row per admission → (onehot_names, [N, D-1] matrix).

    Age rides separately as the z-scored numeric feature (meta NUM_STATIC);
    everything returned here is the ONEHOT_STATIC block: gender, BMI WHO
    one-hots + observed_bmi, insurance/marital/race one-hots, circulatory /
    respiratory past-history flags.
    """
    N = len(hadm_ids)
    del age  # numeric block, z-scored downstream (encode_static)
    names: List[str] = ["gender_m"]
    cols = [gender_binary(gender)[:, None]]

    bn, bx = bmi_onehot(np.asarray(bmi, np.float64))
    names += bn
    cols.append(bx)
    for prefix, vals in (("ins", insurance), ("mari", marital_status),
                         ("ethn", race)):
        n, x = onehot_categorical(vals, prefix)
        names += n
        cols.append(x)

    flags = np.zeros((N, 2), np.float32)
    if icd_history is not None:
        for i, h in enumerate(hadm_ids):
            circ, resp = icd_history.get(int(h), (0, 0))
            flags[i] = (circ, resp)
    names += ["hx_circulatory", "hx_respiratory"]
    cols.append(flags)
    return names, np.concatenate(cols, axis=1).astype(np.float32)
