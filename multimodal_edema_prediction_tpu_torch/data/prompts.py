"""Clinical text-prompt builder (L0, demographic_preprocess.ipynb cells 6-22).

The reference's demographic notebook, besides the one-hot block
(``demographics.py``), assembles a natural-language *clinical prompt* per
(admission, hour-slot) — the text side of the time-series-text pipeline
(consumed by the report/prompt-embedding path, text_embeddings.py):

- ``build_diagnosis_prompts`` (cell 6): per admission, ICD-category flags +
  up to 10 unique diagnosis titles → one "Diagnoses: …" sentence.
- ``build_procedure_by_date`` / ``build_cumulative_procedure`` (cell 9):
  same-day procedures joined, then accumulated over the stay so each date
  carries everything done "so far".
- ``format_demo_prompt`` (cell 11 ``build_demographics``): age/gender/race/
  marital/insurance → "Demographics: …".
- ``build_timeline`` + ``build_time_aware_prompts`` (cell 11): the union of
  procedure dates and weight charttimes becomes the per-admission event
  timeline; static prompts join on, dynamic ones forward-fill.
- ``assemble_prompt`` (cell 12 ``build_prompt``): demo + body size (height/
  weight variants) + diagnoses + "Procedures so far" joined by newlines.
- ``match_prompt_to_slots`` (cell 22): latest prompt whose chartdate falls
  in [slot_start, slot_end) per hour slot, forward- then back-filled per
  admission, "No clinical information available." default, and a per-
  admission ``prompt_id`` (pandas ``factorize`` semantics: first-occurrence
  order) so duplicate texts embed once.

All functions are columnar (numpy arrays / python lists), matching the rest
of the L0 layer — no pandas dependency; the parity test replays the
reference's pandas pipeline against these.

The port's copy of ``multimodal_edema_prediction_tpu/data/prompts.py``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .demographics import has_circulatory, has_respiratory

NO_INFO = "No clinical information available."


def _is_missing(v) -> bool:
    if v is None:
        return True
    if isinstance(v, float) and math.isnan(v):
        return True
    return False


def _clean_titles(titles: Sequence) -> List[str]:
    """dropna → strip → unique keeping first-occurrence order (pd.unique)."""
    seen, out = set(), []
    for t in titles:
        if _is_missing(t):
            continue
        s = str(t).strip()
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


# =============================================================================
# Diagnoses (cell 6)
# =============================================================================
def diagnosis_prompt(icd_codes: Sequence[str],
                     long_titles: Sequence) -> str:
    """One admission's rows (already in seq_num order) → 'Diagnoses: …'."""
    titles = _clean_titles(long_titles)[:10]
    parts = []
    if has_respiratory(list(icd_codes)):
        parts.append("respiratory disease present")
    if has_circulatory(list(icd_codes)):
        parts.append("cardiovascular disease present")
    if titles:
        parts.append("Clinical history: " + "; ".join(titles))
    return "Diagnoses: " + ". ".join(parts) + "."


def build_diagnosis_prompts(subject_ids: np.ndarray, hadm_ids: np.ndarray,
                            seq_nums: np.ndarray, icd_codes: Sequence[str],
                            long_titles: Sequence
                            ) -> Dict[Tuple[int, int], str]:
    """(subject, hadm) → diag_prompt, rows sorted by (subject, hadm, seq)."""
    order = np.lexsort((np.asarray(seq_nums), np.asarray(hadm_ids),
                        np.asarray(subject_ids)))
    out: Dict[Tuple[int, int], str] = {}
    groups: Dict[Tuple[int, int], Tuple[list, list]] = {}
    for i in order:
        key = (int(subject_ids[i]), int(hadm_ids[i]))
        codes, titles = groups.setdefault(key, ([], []))
        codes.append(icd_codes[i])
        titles.append(long_titles[i])
    for key, (codes, titles) in groups.items():
        out[key] = diagnosis_prompt(codes, titles)
    return out


# =============================================================================
# Procedures (cell 9)
# =============================================================================
def build_procedure_by_date(subject_ids: np.ndarray, hadm_ids: np.ndarray,
                            chartdates: np.ndarray, seq_nums: np.ndarray,
                            long_titles: Sequence
                            ) -> Dict[Tuple[int, int, int], str]:
    """(subject, hadm, chartdate) → same-day titles joined '; ' in seq order.

    ``chartdates`` is any sortable integer encoding (e.g. days since epoch
    or YYYYMMDD) — the reference's pd.to_datetime only establishes order."""
    order = np.lexsort((np.asarray(seq_nums), np.asarray(chartdates),
                        np.asarray(hadm_ids), np.asarray(subject_ids)))
    grouped: Dict[Tuple[int, int, int], List[str]] = {}
    for i in order:
        key = (int(subject_ids[i]), int(hadm_ids[i]), int(chartdates[i]))
        if _is_missing(long_titles[i]):
            continue
        grouped.setdefault(key, []).append(str(long_titles[i]).strip())
    return {k: "; ".join(v) for k, v in grouped.items()}


def build_cumulative_procedure(proc_by_date: Dict[Tuple[int, int, int], str]
                               ) -> Dict[Tuple[int, int, int], str]:
    """Per (subject, hadm), accumulate date-prompts over chartdate order —
    each date's value becomes everything done up to AND including it
    (reference ``accumulate``: non-empty entries appended, rows keep the
    running '; '.join)."""
    keys = sorted(proc_by_date.keys())
    out: Dict[Tuple[int, int, int], str] = {}
    seen: List[str] = []
    cur: Optional[Tuple[int, int]] = None
    for key in keys:
        adm = key[:2]
        if adm != cur:
            seen, cur = [], adm
        v = proc_by_date[key]
        if v and v.strip():
            seen.append(v)
        out[key] = "; ".join(seen)
    return out


# =============================================================================
# Demographics sentence (cell 11)
# =============================================================================
def format_demo_prompt(age=None, gender=None, race=None,
                       marital_status=None, insurance=None) -> str:
    parts = []
    if not _is_missing(age) and not _is_missing(gender):
        gender_str = "male" if str(gender).upper() == "M" else "female"
        parts.append(f"{int(age)}-year-old {gender_str}")
    for v in (race, marital_status, insurance):
        if not _is_missing(v) and str(v).strip():
            parts.append(str(v).strip().lower())
    return "Demographics: " + ", ".join(parts) + "." if parts else ""


# =============================================================================
# Timeline + assembly (cells 11-12)
# =============================================================================
def build_timeline(proc_keys: Sequence[Tuple[int, int, int]],
                   weight_keys: Sequence[Tuple[int, int, int]]
                   ) -> List[Tuple[int, int, int]]:
    """Union of (subject, hadm, chartdate) from procedures and weights,
    deduplicated, sorted (cell 11 ``build_timeline``)."""
    return sorted(set(proc_keys) | set(weight_keys))


def build_time_aware_prompts(
        timeline: Sequence[Tuple[int, int, int]],
        demo: Dict[Tuple[int, int], dict],
        diag: Dict[Tuple[int, int], str],
        proc_cum: Dict[Tuple[int, int, int], str],
        weights: Dict[Tuple[int, int, int], float],
        ) -> List[dict]:
    """Per timeline event: static demo/diag joined, procedure and weight
    forward-filled within the admission (cell 11). ``demo`` rows carry
    ``demo_prompt`` and ``height``. Returns rows with the final assembled
    ``clinical_prompt`` (cell 12 ``build_prompt``)."""
    rows: List[dict] = []
    cur: Optional[Tuple[int, int]] = None
    last_proc: Optional[str] = None
    last_w: Optional[float] = None
    for key in timeline:
        adm = key[:2]
        if adm != cur:
            cur, last_proc, last_w = adm, None, None
        if key in proc_cum:
            last_proc = proc_cum[key]
        if key in weights:
            last_w = weights[key]
        d = demo.get(adm, {})
        row = {
            "subject_id": key[0], "hadm_id": key[1], "chartdate": key[2],
            "demo_prompt": d.get("demo_prompt"),
            "height": d.get("height"),
            "diag_prompt": diag.get(adm),
            "proc_prompt": last_proc,
            "weight": last_w,
        }
        row["clinical_prompt"] = assemble_prompt(row)
        rows.append(row)
    return rows


def assemble_prompt(row: dict) -> str:
    """cell 12 ``build_prompt``: demo + body size + diagnoses + procedures,
    newline-joined; each block only when present."""
    parts = []
    if not _is_missing(row.get("demo_prompt")):
        parts.append(row["demo_prompt"])
    h, w = row.get("height"), row.get("weight")
    if not _is_missing(h) and not _is_missing(w):
        parts.append(f"Body size: {h:.1f} cm, {w:.1f} kg.")
    elif not _is_missing(w):
        parts.append(f"Weight: {w:.1f} kg.")
    elif not _is_missing(h):
        parts.append(f"Height: {h:.1f} cm.")
    if not _is_missing(row.get("diag_prompt")):
        parts.append(row["diag_prompt"])
    if not _is_missing(row.get("proc_prompt")):
        parts.append(f"Procedures so far: {row['proc_prompt']}.")
    return "\n".join(parts)


def unique_texts_with_inverse(texts: Sequence[str]
                              ) -> Tuple[List[str], np.ndarray]:
    """First-occurrence-ordered unique texts + inverse row map.

    The reference embeds ``clinical_prompt.drop_duplicates()`` only (cell
    26) — duplicate prompts (ffill/bfill makes many) share one encoder
    pass. Feed the uniques to ``text_embeddings.embed_reports`` and gather
    rows back with the inverse: ``emb_rows = emb_uniq[inverse]``."""
    table: Dict[str, int] = {}
    uniq: List[str] = []
    inv = np.empty(len(texts), np.int64)
    for i, t in enumerate(texts):
        j = table.get(t)
        if j is None:
            j = table[t] = len(uniq)
            uniq.append(t)
        inv[i] = j
    return uniq, inv


# =============================================================================
# Slot matching (cell 22)
# =============================================================================
def match_prompt_to_slots(
        slot_hadm: np.ndarray, slot_stay: np.ndarray,
        slot_hour: np.ndarray, slot_start: np.ndarray, slot_end: np.ndarray,
        prompt_hadm: np.ndarray, prompt_time: np.ndarray,
        prompt_text: Sequence[str],
        ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Per hour slot, the LATEST prompt with chartdate ∈ [slot_start,
    slot_end); then per-admission forward fill (ordered hadm, stay,
    slot_start), back fill, default sentinel, and first-occurrence
    ``prompt_id`` per admission.

    Returns ``(clinical_prompt, prompt_id, order)`` aligned to the slot rows
    REORDERED by (hadm, stay, hour_slot) — ``order`` is the permutation into
    the input rows (the reference sorts and keeps the sorted frame)."""
    slot_hadm = np.asarray(slot_hadm)
    n = len(slot_hadm)
    # latest in-range prompt per (hadm, hour_slot): iterate prompts in time
    # order so later ones overwrite (reference: sort_values("chartdate") +
    # groupby.tail(1))
    p_order = np.argsort(np.asarray(prompt_time), kind="stable")
    best: Dict[Tuple[int, int], str] = {}
    by_hadm: Dict[int, List[int]] = {}
    for j in range(n):
        by_hadm.setdefault(int(slot_hadm[j]), []).append(j)
    for i in p_order:
        h = int(prompt_hadm[i])
        t = prompt_time[i]
        for j in by_hadm.get(h, ()):
            if slot_start[j] <= t < slot_end[j]:
                best[(h, int(slot_hour[j]))] = prompt_text[i]
    order = np.lexsort((np.asarray(slot_hour), np.asarray(slot_stay),
                        slot_hadm))
    texts: List[Optional[str]] = [
        best.get((int(slot_hadm[j]), int(slot_hour[j]))) for j in order]
    hadms = [int(slot_hadm[j]) for j in order]
    # ffill within admission
    last: Dict[int, str] = {}
    for k in range(len(texts)):
        if texts[k] is not None:
            last[hadms[k]] = texts[k]
        elif hadms[k] in last:
            texts[k] = last[hadms[k]]
    # bfill within admission
    nxt: Dict[int, str] = {}
    for k in range(len(texts) - 1, -1, -1):
        if texts[k] is not None:
            nxt[hadms[k]] = texts[k]
        elif hadms[k] in nxt:
            texts[k] = nxt[hadms[k]]
    texts = [t if t is not None else NO_INFO for t in texts]
    # per-admission factorize (first-occurrence order)
    pid = np.empty(len(texts), np.int64)
    tables: Dict[int, Dict[str, int]] = {}
    for k, (h, t) in enumerate(zip(hadms, texts)):
        tab = tables.setdefault(h, {})
        if t not in tab:
            tab[t] = len(tab)
        pid[k] = tab[t]
    return texts, pid, order
