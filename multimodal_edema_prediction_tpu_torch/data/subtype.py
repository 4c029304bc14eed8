"""Edema-subtype (CPE / NCPE) silver-standard scoring + phenotype decay.

Re-implements the legacy text/soft-label notebook's clinical heuristics
(``preprocess/[subject_data]time_series_text_preprocess
.ipynb``) as vectorized array functions:

- :func:`phenotype_half_life` (cell 51 ``decay_by_phenotype``): pick the
  soft-label decay half-life per row — fast 12 h when cardiogenic markers
  dominate (Cardiomegaly or BNP ≥ 500), slow 72 h when non-cardiogenic
  (Pneumonia, Consolidation, or S/F ratio ≤ 235), default 48 h otherwise
  or when both fire. Feeds ``preprocess.soft_label_decay``.
- :func:`silver_standard_subtype` (cell 85
  ``process_silver_standard_pipeline``): threshold-scored CPE vs NCPE
  evidence over 9 clinical variables, hard label
  {2=CPE, 1=NCPE, 0=Mixed, NaN=insufficient} with MIN_SCORE=1.0 /
  MARGIN=0.5, and softmax soft labels over logits
  ``[1.5·min(cpe,ncpe), ncpe, cpe]`` with a ``subtype_mask`` marking rows
  where labeling was possible.
- ``MEDIANS``: the ffill-median guard (cell 81) — values equal to a
  variable's global median are imputation artifacts, not signals
  (``is_meaningful_signal``, cell 85).

Variable naming: the notebook uses MIMIC itemids; here the columns carry
clinical names (the ``ITEMID_MAP`` documents the correspondence).

The port's copy of ``multimodal_edema_prediction_tpu/data/subtype.py``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# clinical name → MIMIC-IV itemid used by the reference notebook
ITEMID_MAP = {
    "bnp": "227446", "troponin": "227429", "bun": "225624",
    "creatinine": "220615", "spo2_fio2": "spo2_fio2", "fio2": "223835",
    "albumin": "227456", "temperature": "223761", "lactate": "225668",
}

# global medians: ffill'd values equal to these are imputation artifacts
# (cell 81)
MEDIANS = {
    "bnp": 3972.0, "troponin": 0.05, "bun": 22.0, "creatinine": 1.0,
    "spo2_fio2": 240.0, "fio2": 0.4, "albumin": 3.0,
    "temperature": 36.888888888888886, "lactate": 1.4,
}

MISSING = -2.0          # the notebook's missing-value sentinel
MIN_SCORE = 1.0
MARGIN = 0.5


def _signal(x: np.ndarray, name: str) -> np.ndarray:
    """True where the value is a real measurement: present, not the missing
    sentinel, and not the ffill'd global median (cell 85
    ``is_meaningful_signal``)."""
    x = np.asarray(x, np.float64)
    ok = ~np.isnan(x) & (x != MISSING)
    med = MEDIANS.get(name)
    if med is not None:
        ok &= ~np.isclose(x, med)
    return ok


def phenotype_half_life(cardiomegaly: np.ndarray, bnp: np.ndarray,
                        pneumonia: np.ndarray, consolidation: np.ndarray,
                        spo2_fio2: np.ndarray,
                        fast_hl: float = 12.0, slow_hl: float = 72.0,
                        default_hl: float = 48.0) -> np.ndarray:
    """Per-row decay half-life (cell 51): CPE-dominant → fast, NCPE-dominant
    → slow, ambiguous/neither → default."""
    bnp = np.asarray(bnp, np.float64)
    sf = np.asarray(spo2_fio2, np.float64)
    is_fast = (np.asarray(cardiomegaly) == 1) | (~np.isnan(bnp) &
                                                 (bnp >= 500))
    is_slow = (np.asarray(pneumonia) == 1) | \
        (np.asarray(consolidation) == 1) | (~np.isnan(sf) & (sf <= 235))
    out = np.full(is_fast.shape, default_hl, np.float32)
    out[is_fast & ~is_slow] = fast_hl
    out[is_slow & ~is_fast] = slow_hl
    return out


def silver_standard_subtype(cols: Dict[str, np.ndarray],
                            edema: Optional[np.ndarray] = None
                            ) -> Dict[str, np.ndarray]:
    """Vectorized cell-85 pipeline over named columns (see ``ITEMID_MAP``).

    ``edema``: optional 0/1 mask — scores/labels are computed only on
    Edema==1 rows (the notebook applies to the ~13k positive rows), the
    rest stay 0/NaN with ``subtype_mask=0``.
    Returns subtype_label, cpe_score, ncpe_score, score_diff, subtype_mask,
    p_mixed, p_ncpe, p_cpe.
    """
    def get(name):
        return np.asarray(cols.get(name, np.full(n, np.nan)), np.float64)

    n = len(next(iter(cols.values())))
    cpe = np.zeros(n)
    ncpe = np.zeros(n)

    # ----- CPE evidence -----
    bnp = get("bnp")
    m = _signal(bnp, "bnp")
    cpe += np.select([m & (bnp >= 5000), m & (bnp >= MEDIANS["bnp"]),
                      m & (bnp > 500)], [3.0, 2.0, 1.0], 0.0)
    trop = get("troponin")
    m = _signal(trop, "troponin")
    cpe += np.select([m & (trop >= 1.0), m & (trop >= 0.5),
                      m & (trop >= 0.0135)], [1.5, 1.0, 0.25], 0.0)
    bun, cr = get("bun"), get("creatinine")
    m_bun = _signal(bun, "bun")
    m_cr = _signal(cr, "creatinine") & (cr > 0)
    ratio = np.divide(bun, np.where(m_cr, cr, 1.0))
    cpe += np.where(m_bun & m_cr & (ratio > 20), 1.0,
                    np.where(m_bun & (bun >= 26), 0.5, 0.0))

    # ----- NCPE evidence -----
    sf, fio2 = get("spo2_fio2"), get("fio2")
    has_sf = ~np.isnan(sf) & (sf != MISSING)
    has_fio2 = ~np.isnan(fio2) & (fio2 != MISSING)
    ncpe += np.select([has_sf & (sf < 150), has_sf & (sf < 235),
                       has_sf & (sf < 315)], [2.0, 1.0, 0.5], 0.0)
    ncpe += np.where(has_fio2 & (fio2 >= 0.6), 0.5, 0.0)
    both = has_sf & has_fio2
    ncpe += np.where(both & (sf < 235) & (fio2 >= 0.50), 0.5, 0.0)
    ncpe += np.where(both & (sf < 150) & (fio2 >= 0.60), 1.0, 0.0)
    alb = get("albumin")
    m = _signal(alb, "albumin")
    ncpe += np.select([m & (alb < 2.9), m & (alb < 3.5)], [0.5, 0.25], 0.0)
    temp = get("temperature")
    m_t = _signal(temp, "temperature")
    ncpe += np.where(m_t & (temp > 38.3), 0.25, 0.0)
    lac = get("lactate")
    m_l = _signal(lac, "lactate")
    ncpe += np.where(m_l & (lac >= 2.0) & m_t & (temp > 38.3), 1.0, 0.0)

    # ----- hard label -----
    diff = cpe - ncpe
    has_cpe, has_ncpe = cpe >= MIN_SCORE, ncpe >= MIN_SCORE
    label = np.full(n, np.nan)
    label[has_cpe & has_ncpe & (np.abs(diff) <= MARGIN)] = 0.0   # Mixed
    label[(has_cpe | has_ncpe) & (diff > MARGIN)] = 2.0          # CPE
    label[(has_cpe | has_ncpe) & (diff < -MARGIN)] = 1.0         # NCPE

    # ----- soft labels: softmax([1.5·min, ncpe, cpe]) where labeled -----
    mask = ~np.isnan(label)
    z = np.stack([np.minimum(cpe, ncpe) * 1.5, ncpe, cpe], -1)
    z = z - z.max(-1, keepdims=True)
    e = np.exp(z)
    p = e / e.sum(-1, keepdims=True)
    p = np.where(mask[:, None], p, 0.0)

    if edema is not None:
        keep = np.asarray(edema) == 1.0
        label = np.where(keep, label, np.nan)
        mask &= keep
        cpe = np.where(keep, cpe, 0.0)
        ncpe = np.where(keep, ncpe, 0.0)
        diff = np.where(keep, diff, 0.0)
        p = np.where(keep[:, None], p, 0.0)

    return {"subtype_label": label.astype(np.float32),
            "cpe_score": cpe.astype(np.float32),
            "ncpe_score": ncpe.astype(np.float32),
            "score_diff": diff.astype(np.float32),
            "subtype_mask": mask.astype(np.float32),
            "p_mixed": p[:, 0].astype(np.float32),
            "p_ncpe": p[:, 1].astype(np.float32),
            "p_cpe": p[:, 2].astype(np.float32)}
