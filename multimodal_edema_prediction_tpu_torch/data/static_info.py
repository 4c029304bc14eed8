"""L0 static-info assembly: admission/stay time-error taxonomy & repair,
death-information reconciliation, race mapping, age derivation.

Re-implements the groundwork notebook's cohort-hygiene pipeline
(``preprocess/[Subject data]multimodal_preprocessing_
groundwork.ipynb`` cells 14-62) as testable array functions — the part of L0
that VERDICT r1 flagged absent. The reference operates on a pandas
``static_info`` frame (one row per ICU stay, joined from patients ×
admissions × icustays); here the same columns arrive as parallel numpy
arrays (``datetime64[ns]`` for times) and every rule is a pure function.

Error taxonomy (cells 29-41):
- **type 0** — reversed intervals: ``admittime >= dischtime`` or
  ``intime >= outtime`` → drop (or swap) the subject (cell 29);
- **type 1.1** — overlapping admissions within a subject → drop the subject
  (cell 33); **1.2** — overlapping stays within an admission → flag
  (cell 35; the reference found zero and only flags);
- **type 3** — order errors among (AT, IT, OT, DT): classify into
  ADIO/AIDO/IADO/IAOD/IOAD by the admission-level ``i=min(IT)``,
  ``o=max(OT)`` and repair per ruleset ``del`` / ``mm``
  (AT←min(AT,i), DT←max(DT,o)) / ``aa`` (AT←i−α, DT←o+α) (cell 41).

Death reconciliation (cells 43-54): deathtime de-duplication keyed on dod
date agreement (cells 44-47), ``died = discharge_location=='DIED'``
(cell 48), repeated/inconsistent death-flag audit (cell 49), and the full
``death_error_handling`` state machine (cell 52) emitting per-admission
``deathtype ∈ {survived,in,out,out_in_24hr,out_after_365d,error}``,
``death_adm`` (the supervised label downstream, meta LABEL_COL), the
reconciled ``deathtime``, ``is_dht_date`` and a ``certainty`` grade.

Race (cell 58): MIMIC's 33 race strings → 6 groups; subjects with ≥2
distinct mapped groups are coerced to OTHER (the notebook's "rule 5").

Age (cell 62): anchor_age + (t − Jan 1 of anchor_year)/365d.

The port's copy of ``multimodal_edema_prediction_tpu/data/static_info.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

HOUR = np.timedelta64(1, "h")
DAY = np.timedelta64(24, "h")

# =============================================================================
# Error type 0 — reversed intervals (cell 29)
# =============================================================================
def reversed_interval_subjects(subject_ids: np.ndarray, start: np.ndarray,
                               end: np.ndarray) -> np.ndarray:
    """Subjects owning any interval with ``start >= end`` (NaT rows skipped)."""
    ok = ~(np.isnat(start) | np.isnat(end))
    bad = ok & (start >= end)
    return np.unique(subject_ids[bad])


def handle_reversed_intervals(subject_ids: np.ndarray, start: np.ndarray,
                              end: np.ndarray, how: str = "del"):
    """``how='del'``: boolean keep-mask dropping offending subjects entirely
    (the notebook's choice). ``how='adj'``: swapped (start, end) arrays for
    the offending subjects' rows (the alternative it codes but doesn't use).
    """
    bad_subs = reversed_interval_subjects(subject_ids, start, end)
    in_bad = np.isin(subject_ids, bad_subs)
    if how == "del":
        return ~in_bad
    if how == "adj":
        s, e = start.copy(), end.copy()
        s[in_bad], e[in_bad] = end[in_bad], start[in_bad]
        return s, e
    raise ValueError(how)


# =============================================================================
# Error type 1 — overlapping intervals (cells 33, 35)
# =============================================================================
def flag_overlapping_intervals(group_ids: np.ndarray, item_ids: np.ndarray,
                               start: np.ndarray, end: np.ndarray
                               ) -> np.ndarray:
    """Per group, sort unique items by ``start``; when item_i starts before
    item_{i-1} ends, flag BOTH (cells 33/35's pairwise rule). Returns the
    flagged item ids."""
    flagged: List = []
    order = np.lexsort((start.astype("int64"), group_ids))
    gs, it = group_ids[order], item_ids[order]
    st, en = start[order], end[order]
    prev_group = None
    prev_item = prev_end = None
    for g, i, s, e in zip(gs, it, st, en):
        if g != prev_group:
            prev_group, prev_item, prev_end = g, i, e
            continue
        if i == prev_item:
            continue                      # duplicate row of the same item
        if s < prev_end:
            flagged += [prev_item, i]
        prev_item, prev_end = i, e
    return np.unique(np.asarray(flagged, dtype=item_ids.dtype))


# =============================================================================
# Error type 3 — AT/IT/OT/DT order taxonomy + repair (cells 38-41)
# =============================================================================
ORDER_RULESET: Dict[str, str] = {
    "ADIO": "del", "AIDO": "mm", "IADO": "mm", "IAOD": "mm", "IOAD": "del",
}


def classify_stay_order(admittime, dischtime, intime_min, outtime_max
                        ) -> Optional[str]:
    """Admission-level classification (cell 41's ``srb_error_3_handler``):
    ``i``/``o`` are the min intime / max outtime over the admission's stays.
    Returns None when the normal ``a <= i < o <= d`` interleaving (or any
    unlisted pattern) holds."""
    a, d, i, o = admittime, dischtime, intime_min, outtime_max
    if a <= d <= i <= o:
        return "ADIO"
    if a <= i <= d <= o:
        return "AIDO"
    if i <= a <= d <= o:
        return "IADO"
    if i <= a <= o <= d:
        return "IAOD"
    if i <= o <= a <= d:
        return "IOAD"
    return None


def repair_stay_order(admittime, dischtime, intime_min, outtime_max,
                      ruleset: Dict[str, str] = ORDER_RULESET,
                      alpha=np.timedelta64(12, "h")):
    """→ (error_type, keep, admittime', dischtime'). ``keep=False`` means the
    subject is excluded (``del`` rule); ``mm``/``aa`` adjust AT/DT from the
    trusted IT/OT (cell 41: "IT, OT의 정보는 정확하다고 가정" — stay times are
    assumed correct)."""
    et = classify_stay_order(admittime, dischtime, intime_min, outtime_max)
    if et is None or et not in ruleset:
        return et, True, admittime, dischtime
    rule = ruleset[et]
    if rule == "del":
        return et, False, admittime, dischtime
    if rule == "aa":
        return et, True, intime_min - alpha, outtime_max + alpha
    if rule == "mm":
        return et, True, min(intime_min, admittime), \
            max(outtime_max, dischtime)
    raise ValueError(rule)


# =============================================================================
# Death-info reconciliation (cells 44-54)
# =============================================================================
def dedupe_deathtime(subject_ids: np.ndarray, deathtime: np.ndarray,
                     dod: np.ndarray) -> np.ndarray:
    """Cells 44-47: subjects with >1 distinct recorded deathtime keep only
    the value whose DATE matches dod (mismatching rows → NaT), then the
    surviving value is backfilled to all the subject's rows."""
    dt = deathtime.copy()
    for s in np.unique(subject_ids):
        rows = subject_ids == s
        vals = dt[rows]
        distinct = np.unique(vals[~np.isnat(vals)])
        if len(distinct) > 1:
            # drop rows whose deathtime date differs from dod date (cell 45)
            dates = vals.astype("datetime64[D]")
            dod_dates = dod[rows].astype("datetime64[D]")
            vals = np.where(
                ~np.isnat(vals) & (dates != dod_dates),
                np.datetime64("NaT"), vals)
        nn = vals[~np.isnat(vals)]
        if len(nn):                       # backfill (cell 47)
            vals = np.where(np.isnat(vals), nn[0], vals)
        dt[rows] = vals
    return dt


def audit_death_flags(hef: np.ndarray, died: np.ndarray) -> Optional[str]:
    """Cell 49 per-subject audit over admissions in admittime order:
    None (consistent) / 'error_incons' / 'adm_after_death' / 'death_rep'."""
    hef = np.asarray(hef)
    died = np.asarray(died)
    if hef.sum() == 0 and died.sum() == 0:
        return None
    if hef.sum() <= 1 and died.sum() <= 1:
        if hef[-1] == died[-1] == 1:
            return None
        if hef[-1] != died[-1]:
            return "error_incons"
        return "adm_after_death"
    return "death_rep"


def death_error_handling(admittime: np.ndarray, dischtime: np.ndarray,
                         dod, deathtime, died: np.ndarray, hef: np.ndarray
                         ) -> dict:
    """Cell 52's per-subject state machine. Inputs are the subject's
    admissions sorted by admittime; ``dod``/``deathtime`` are the subject
    scalars (post-:func:`dedupe_deathtime`). Returns per-admission
    ``death_adm`` plus subject-level deathtype/deathtime/is_dht_date/
    certainty exactly as the notebook computes them."""
    n = len(admittime)
    out = {"deathtype": None, "death_adm": np.zeros(n, np.int64),
           "deathtime": np.datetime64("NaT"), "is_dht_date": None,
           "certainty": None}
    dod = np.datetime64(dod) if dod is not None else np.datetime64("NaT")
    dht = np.datetime64(deathtime) if deathtime is not None \
        else np.datetime64("NaT")
    if np.isnat(dod):
        out["deathtype"] = "survived"
        out["certainty"] = "likely" if died.sum() >= 1 else "certain"
        return out
    errors = int(died.sum() + hef.sum())
    if not np.isnat(dht):                         # timestamp-precision branch
        out["is_dht_date"] = 0
        out["deathtime"] = dht
        if (dht <= admittime).any():
            out["deathtype"] = out["certainty"] = "error"
            return out
        in_death = (admittime < dht) & (dht <= dischtime)
        last_dt = dischtime[-1]
        if in_death.sum() >= 1:
            out["deathtype"] = "in"
            out["death_adm"][in_death] = 1
            if in_death.sum() > 1:
                out["certainty"] = "error"
            else:
                k = int(died[in_death][0] + hef[in_death][0])
                out["certainty"] = {2: "certain", 1: "likely",
                                    0: "even"}[k]
        elif (last_dt + 24 * HOUR) < dht <= (last_dt + 365 * DAY):
            out["deathtype"] = "out"
            out["certainty"] = "unlikely" if errors >= 2 else \
                ("even" if errors == 1 else "likely")
        elif last_dt < dht <= (last_dt + 24 * HOUR):
            out["deathtype"] = "out_in_24hr"
            out["certainty"] = errors / (n * 2)
        elif dht > (last_dt + 365 * DAY):
            out["deathtype"] = "out_after_365d"
            out["certainty"] = errors / (n * 2)
        else:
            raise LookupError("unreachable deathtime placement")
        return out
    # date-precision branch: compare at day granularity (cell 52 tail)
    out["is_dht_date"] = 1
    dod_d = dod.astype("datetime64[D]")
    out["deathtime"] = dod_d
    at_d = admittime.astype("datetime64[D]")
    dt_d = dischtime.astype("datetime64[D]")
    if (dod_d < at_d).any():
        out["deathtype"] = out["certainty"] = "error"
        return out
    in_death = (at_d <= dod_d) & (dod_d <= dt_d)
    last_dt = dt_d[-1]
    one_day = np.timedelta64(1, "D")
    if in_death.sum() >= 1:
        out["deathtype"] = "in"
        out["death_adm"][in_death] = 1
        if in_death.sum() > 1:
            out["certainty"] = "error"
        else:
            k = int(died[in_death][0] + hef[in_death][0])
            out["certainty"] = {2: "likely", 1: "even", 0: "unlikely"}[k]
    elif (last_dt + one_day) < dod_d <= (last_dt + 365 * one_day):
        out["deathtype"] = "out"
        out["certainty"] = "even" if errors >= 2 else \
            ("likely" if errors == 1 else "certain")
    elif dod_d == last_dt + one_day:
        out["deathtype"] = "out_in_24hr"
        out["certainty"] = errors / (n * 2)
    elif dod_d > (last_dt + 365 * one_day):
        out["deathtype"] = "out_after_365d"
        out["certainty"] = errors / (n * 2)
    else:
        raise LookupError("unreachable dod placement")
    return out


# =============================================================================
# Race mapping (cell 58) — verbatim table + multi-race rule
# =============================================================================
RACE_MAPPING: Dict[str, str] = {
    "ASIAN": "ASIAN",
    "ASIAN - ASIAN INDIAN": "ASIAN",
    "ASIAN - CHINESE": "ASIAN",
    "ASIAN - KOREAN": "ASIAN",
    "ASIAN - SOUTH EAST ASIAN": "ASIAN",
    "BLACK/AFRICAN": "BLACK",
    "BLACK/AFRICAN AMERICAN": "BLACK",
    "BLACK/CAPE VERDEAN": "BLACK",
    "BLACK/CARIBBEAN ISLAND": "BLACK",
    "HISPANIC OR LATINO": "HISPANIC/LATINO",
    "HISPANIC/LATINO - CENTRAL AMERICAN": "HISPANIC/LATINO",
    "HISPANIC/LATINO - COLUMBIAN": "HISPANIC/LATINO",
    "HISPANIC/LATINO - CUBAN": "HISPANIC/LATINO",
    "HISPANIC/LATINO - DOMINICAN": "HISPANIC/LATINO",
    "HISPANIC/LATINO - GUATEMALAN": "HISPANIC/LATINO",
    "HISPANIC/LATINO - HONDURAN": "HISPANIC/LATINO",
    "HISPANIC/LATINO - MEXICAN": "HISPANIC/LATINO",
    "HISPANIC/LATINO - PUERTO RICAN": "HISPANIC/LATINO",
    "HISPANIC/LATINO - SALVADORAN": "HISPANIC/LATINO",
    "PORTUGUESE": "HISPANIC/LATINO",
    "SOUTH AMERICAN": "HISPANIC/LATINO",
    "WHITE": "WHITE",
    "WHITE - BRAZILIAN": "WHITE",
    "WHITE - EASTERN EUROPEAN": "WHITE",
    "WHITE - OTHER EUROPEAN": "WHITE",
    "WHITE - RUSSIAN": "WHITE",
    "OTHER": "OTHER",
    "AMERICAN INDIAN/ALASKA NATIVE": "OTHER",
    "MULTIPLE RACE/ETHNICITY": "OTHER",
    "NATIVE HAWAIIAN OR OTHER PACIFIC ISLANDER": "OTHER",
    "UNKNOWN": "UNKNOWN",
    "UNABLE TO OBTAIN": "UNKNOWN",
    "PATIENT DECLINED TO ANSWER": "UNKNOWN",
}


def map_race(subject_ids: np.ndarray, race: Sequence[Optional[str]]
             ) -> np.ndarray:
    """Map raw race strings to the 6 groups, then coerce subjects carrying
    ≥2 distinct mapped groups to OTHER (the notebook's rule 5: multi-race
    records cannot be resolved)."""
    mapped = np.asarray([RACE_MAPPING.get(r, "UNKNOWN") if r else "UNKNOWN"
                         for r in race], dtype=object)
    for s in np.unique(subject_ids):
        rows = subject_ids == s
        if len(set(mapped[rows])) >= 2:
            mapped[rows] = "OTHER"
    return mapped.astype(str)


# =============================================================================
# Age (cell 62)
# =============================================================================
def age_at(times: np.ndarray, anchor_year: np.ndarray,
           anchor_age: np.ndarray) -> np.ndarray:
    """anchor_age + (t − Jan 1 of anchor_year) / 365 days — "assume all
    patients were born Jan 1st"."""
    jan1 = np.array([np.datetime64(f"{int(y)}-01-01") for y in anchor_year])
    delta_days = (times - jan1) / np.timedelta64(1, "D")
    return delta_days / 365.0 + np.asarray(anchor_age, np.float64)
