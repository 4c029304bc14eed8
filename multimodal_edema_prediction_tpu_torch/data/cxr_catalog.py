"""CXR catalog derivation (L0): AP/PA filter, cxrtime, U→1, slot assignment.

Re-implements the label/catalog semantics of
``preprocess/cxr_db.ipynb`` (cells 19-28) and the CXR→slot
assignment of ``[Subject data]multimodal_preprocessing_groundwork.ipynb``
(cell 391) as array functions:

- **AP/PA view filter** (cxr_db cell 24): only ``ViewPosition`` in
  {AP, PA} enters the catalog.
- **U→1 uncertain-to-positive** (cxr_db cell 24, per the CheXpert paper):
  at the CXR-HEAD level every label ``-1`` becomes ``1``. (The ICU anchor
  path maps the main label U→0 instead — ``data_processing.py:170`` — both
  policies exist in the reference and are exposed here.)
- **cxrtime** (cxr_db cell 26): ``StudyDate`` (%Y%m%d int) + ``StudyTime``
  (float, ``'%#010.3f'`` → zero-padded HHMMSS.fff) → one timestamp.
- **slot assignment** (groundwork cell 391): a CXR lands in hourly slot k of
  its stay iff ``slot_start <= cxrtime < slot_end``; one CXR per
  (stay, slot) — the EARLIEST wins; ``cxr_flag`` marks occupied slots.

The port's copy of ``multimodal_edema_prediction_tpu/data/cxr_catalog.py``.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

VALID_VIEWS = ("AP", "PA")


def filter_ap_pa(view_positions: Sequence[str]) -> np.ndarray:
    """Boolean keep-mask (cxr_db cell 24)."""
    return np.asarray([str(v) in VALID_VIEWS for v in view_positions])


def uncertain_to_positive(labels: np.ndarray) -> np.ndarray:
    """-1 → 1 on every label column, NaN untouched (cxr_db cell 24)."""
    lab = np.asarray(labels, np.float32).copy()
    lab[lab == -1.0] = 1.0
    return lab


def apply_uncertain_policy(labels: np.ndarray, policy: str) -> np.ndarray:
    """'to_positive' (CXR-head level, cxr_db cell 24), 'to_zero' (ICU
    anchor main label, data_processing.py:170), or 'keep'."""
    if policy == "to_positive":
        return uncertain_to_positive(labels)
    if policy == "to_zero":
        lab = np.asarray(labels, np.float32).copy()
        lab[lab == -1.0] = 0.0
        return lab
    if policy == "keep":
        return np.asarray(labels, np.float32)
    raise ValueError(f"unknown uncertain policy {policy!r}")


def parse_cxrtime(study_date: np.ndarray, study_time: np.ndarray
                  ) -> np.ndarray:
    """(StudyDate int %Y%m%d, StudyTime float HHMMSS.fff) → datetime64[ms].

    The reference formats StudyTime with ``'%#010.3f'`` — zero-padded to 10
    chars with 3 decimals — then parses ``%H%M%S.%f`` (cxr_db cell 26).
    E.g. 953.0 → '000953.000' → 00:09:53.
    """
    out = np.empty(len(study_date), "datetime64[ms]")
    for i, (d, t) in enumerate(zip(study_date, study_time)):
        s = f"{float(t):010.3f}"              # '%#010.3f'
        hh, mm, ss = int(s[0:2]), int(s[2:4]), float(s[4:])
        day = np.datetime64(f"{int(d) // 10000:04d}-"
                            f"{(int(d) // 100) % 100:02d}-"
                            f"{int(d) % 100:02d}")
        ms = int(round(((hh * 60 + mm) * 60 + ss) * 1000))
        out[i] = day + np.timedelta64(ms, "ms")
    return out


def assign_cxr_to_slots(cxr_stay_ids: np.ndarray,
                        cxrtime: np.ndarray,
                        stay_intime: Dict[int, np.datetime64],
                        stay_n_slots: Dict[int, int],
                        slot_hours: float = 1.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """→ (slot_idx [-1 = outside grid], keep-mask after per-(stay,slot)
    earliest-wins dedup) — groundwork cell 391 semantics."""
    n = len(cxr_stay_ids)
    slot_idx = np.full(n, -1, np.int64)
    slot_ms = int(slot_hours * 3600 * 1000)
    for i in range(n):
        sid = int(cxr_stay_ids[i])
        if sid not in stay_intime:
            continue
        dt_ms = (cxrtime[i].astype("datetime64[ms]")
                 - np.datetime64(stay_intime[sid], "ms")).astype(np.int64)
        if dt_ms < 0:
            continue
        k = int(dt_ms // slot_ms)
        if k < stay_n_slots.get(sid, 0):
            slot_idx[i] = k

    # dedupe: earliest cxrtime per (stay, slot)
    keep = np.zeros(n, bool)
    best: Dict[Tuple[int, int], int] = {}
    for i in range(n):
        if slot_idx[i] < 0:
            continue
        key = (int(cxr_stay_ids[i]), int(slot_idx[i]))
        j = best.get(key)
        if j is None or cxrtime[i] < cxrtime[j]:
            best[key] = i
    for i in best.values():
        keep[i] = True
    return slot_idx, keep


def join_lung_masks(catalog: dict, seg_mask: dict,
                    lung_data_path: str = "") -> dict:
    """CXLSeg lung-mask LEFT join (cxr_db cells 2-8 + 30).

    The reference loads ``CXLSeg-mask.csv`` (chest-x-ray-segmentation 1.0.0),
    renames ``DicomPath`` → ``lung_mask_path``, prefixes it with
    ``<root>/lung_mask/``, and left-merges onto the jpg catalog on
    ``(subject_id, study_id, dicom_id)``; ``lung_mask_path`` then rides into
    the final multimodal df (cell 73). Unmatched rows keep ``None`` and
    ``has_lung_mask=False``.

    ``seg_mask``: columnar dict with ``subject_id``/``study_id``/
    ``dicom_id``/``DicomPath`` (or pre-renamed ``lung_mask_path``) arrays.
    Returns ``catalog`` with ``lung_mask_path`` (object) and
    ``has_lung_mask`` (bool) columns added.
    """
    import os
    paths = seg_mask.get("lung_mask_path", seg_mask.get("DicomPath"))
    if paths is None:
        raise KeyError("seg_mask needs a DicomPath/lung_mask_path column")
    by_key = {}
    for i, p in enumerate(paths):
        # skip missing paths: None AND pandas-style float NaN (a columnar
        # dict built from a frame delivers empty cells as nan, not None —
        # the pandas join in raw_mimic guards with pd.notna; mirror it)
        if p is None or p != p:
            continue
        key = (int(seg_mask["subject_id"][i]), int(seg_mask["study_id"][i]),
               str(seg_mask["dicom_id"][i]))
        full = os.path.join(lung_data_path, "lung_mask", str(p)) \
            if lung_data_path else str(p)
        by_key.setdefault(key, full)            # first match wins, like merge
    n = len(catalog["dicom_id"])
    out_paths = np.empty(n, object)
    has = np.zeros(n, bool)
    for i in range(n):
        key = (int(catalog["subject_id"][i]), int(catalog["study_id"][i]),
               str(catalog["dicom_id"][i]))
        p = by_key.get(key)
        out_paths[i] = p
        has[i] = p is not None
    out = dict(catalog)
    out["lung_mask_path"] = out_paths
    out["has_lung_mask"] = has
    return out


def derive_catalog(metadata: dict, chexpert_labels: np.ndarray,
                   label_policy: str = "to_positive",
                   seg_mask: dict | None = None,
                   lung_data_path: str = "") -> dict:
    """Full cxr_db pipeline on columnar inputs.

    metadata: dict with ``subject_id``/``study_id``/``dicom_id``/
    ``ViewPosition``/``StudyDate``/``StudyTime`` arrays aligned with
    ``chexpert_labels`` [N, K].
    ``seg_mask``: optional CXLSeg mask table → ``lung_mask_path``/
    ``has_lung_mask`` columns (cxr_db cell 30's left merge).
    Returns the filtered catalog dict + derived ``cxrtime`` + transformed
    labels.
    """
    keep = filter_ap_pa(metadata["ViewPosition"])
    out = {k: np.asarray(v)[keep] for k, v in metadata.items()}
    out["cxrtime"] = parse_cxrtime(out["StudyDate"], out["StudyTime"])
    out["labels"] = apply_uncertain_policy(
        np.asarray(chexpert_labels)[keep], label_policy)
    if seg_mask is not None:
        out = join_lung_masks(out, seg_mask, lung_data_path)
    return out
