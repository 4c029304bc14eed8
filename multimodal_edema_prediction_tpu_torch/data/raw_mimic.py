"""Executable L0 without pandas: raw MIMIC-IV-layout tables → the reference
artifact frames → ``cohort.npz`` + ``meta_with_stats.pkl``.

The port's counterpart of ``multimodal_edema_prediction_tpu/data/
raw_mimic.py``, rewritten from pandas to numpy function by function: each
function here takes and returns the frames of :mod:`.frames` (dicts of
numpy columns) where JAX's takes and returns DataFrames, and reproduces
the pandas calls it replaces (type inference of ``read_csv``, Kahan sums
and means, "last" and "count" over non-null values, the row order of
merges and stable sorts). The tables transcribed from the reference
notebooks are data and are copied as they are. Cell citations point into
the reference notebooks (groundwork cells 36-252, input_preprocess cells
71-94, cxr_db cells 19-53).

Raw tables are read from ``.ftr``, ``.feather``, ``.csv`` or ``.csv.gz``,
in JAX's order (Feather through :func:`.frames.read_feather`, Arrow
without pyarrow), and the audit frames (``static_full``, ``final_df``,
``final_cxr_df``) are written as ``<name>.ftr``
(:func:`.frames.write_feather`), as JAX's ``to_feather`` writes them.

Run it as ``python -m multimodal_edema_prediction_tpu_torch.cli.preprocess
--raw_root … --out_dir …``.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import frames as F
from . import static_info as si
from .cxr_catalog import (apply_uncertain_policy, assign_cxr_to_slots,
                          filter_ap_pa, parse_cxrtime)
from .frames import Frame

HOUR = np.timedelta64(1, "h")

# =============================================================================
# Tables transcribed from the reference (groundwork cells 36 / 98;
# input_preprocess cells 71 / 85-94). Data, not code.
# =============================================================================
QUERY_DICT: Dict[str, List[int]] = {
    "heart_rate": [220045],
    "sbp": [220050, 225309, 220179],
    "dbp": [220051, 225310, 220180],
    "map": [220052, 220181, 225312],
    "temperature": [50825, 223761, 223762],
    "gcs": [220739, 223900, 223901],
    "resp_rate": [224690, 220210],
    "o2sat": [50817, 220277, 220227],
    "pao2": [50821, 220224],
    "fio2": [50816, 223835],
    "paco2": [50818, 52040, 220235],
    "wbc": [51300, 51301, 51755, 51756, 220546],
    "platelets": [51265, 51704, 227457],
    "hematocrit": [51221, 51638, 51639, 52028, 50810, 226540, 220545],
    "hemoglobin": [50811, 51222, 51640, 220228],
    "pt_inr": [51237, 51675, 227467],
    "ptt": [51275, 52923, 227466],
    "d-dimer": [52551, 51196, 50915, 225636],
    "sodium": [50983, 52623, 50824, 52455, 220645, 228389, 226534, 228390],
    "potassium": [50971, 52610, 50822, 52452, 227442, 227464],
    "chloride": [220367, 220602, 225166, 226536, 228385, 228386, 229618],
    "ca_ion": [50808, 51624, 225667],
    "glucose": [50809, 50931, 52569, 52027, 220621, 225664, 226537, 228338],
    "art_ph": [50820, 223830],
    "base_excess": [50802, 224828],
    "anion_gap": [50868, 52500, 227073],
    "lactate": [50813, 52442, 225668],
    "bilirubin": [50885, 53089, 225690],
    "creatinine": [50912, 52546, 52024, 220615],
    "bun": [51006, 52647, 225624],
    "albumin": [50862, 52022, 53085, 53138, 227456],
    "ast": [53088, 50878, 220587],
    "alt": [50861, 53084, 220644],
    "troponin-T": [51003, 227429],
    "Brain Natiuretic Peptide": [227446],
    "NTproBNP": [50963],
    "ck_mb": [50911, 227445],
    "ck_mb_frac": [50908, 225628],
    "urine": [226557, 226558, 226559, 226560, 226561, 226563, 226564,
              226565, 226567, 226584, 227488, 227489],
    "fluid_alb": [220862, 220864],
    "fluid_cyst": [220949, 220950, 220952, 225158, 225159, 225161, 225828,
                   225797, 225799, 225823, 225825, 225827, 225830, 226089,
                   225941, 225943, 225944, 226361, 226363, 226364, 226375,
                   226377, 226452, 226453, 227533, 228140, 228141, 228142,
                   228341, 220955, 220967, 220968, 220953],
    "weight": [224639],
    "height": [226707, 226730],
}

# variables fed to resampling_chart — everything except the ones with
# dedicated pipelines / non-TS roles (groundwork cell 219 exclude set).
CHART_LAB_EXCLUDE = {"specimen", "height", "weight", "sbp", "dbp", "map",
                     "NTproBNP", "ck_mb_frac", "gcs", "fluid_alb",
                     "fluid_cyst", "urine"}

# name → (lb, ub, lb_inclusive_drop, ub_inclusive_drop); inclusion=1 means
# the boundary value itself is ALSO an outlier (cell 98 stored output).
OUTLIER_CRITERIA: Dict[str, Tuple[float, float, int, int]] = {
    "heart_rate": (0.0, 300.0, 1, 1),
    "resp_rate": (0.0, 60.0, 1, 0),
    "temperature": (32.0, 43.0, 0, 1),
    "sbp": (0.0, 300.0, 1, 0),
    "dbp": (10.0, 175.0, 0, 0),
    "pao2": (10.0, 500.0, 0, 0),
    "fio2": (20.98, 100.0, 0, 0),
    "bilirubin": (0.0, 100.0, 1, 0),
    "platelets": (0.0, 1500.0, 0, 0),
    "creatinine": (0.0, 40.0, 0, 0),
    "lactate": (0.0, 30.0, 0, 0),
    "bun": (0.0, 300.0, 1, 0),
    "art_ph": (6.5, 7.8, 0, 0),
    "wbc": (0.0, 200.0, 0, 0),
    "paco2": (0.0, 200.0, 1, 0),
    "hemoglobin": (0.0, 30.0, 1, 0),
    "hematocrit": (0.0, 100.0, 1, 1),
    "potassium": (0.0, 10.0, 1, 0),
    "sodium": (80.0, 200.0, 0, 0),
    "height": (140.0, 240.0, 0, 0),
    "weight": (30.0, 250.0, 0, 0),
    "glucose": (20.0, 2000.0, 0, 0),
    "albumin": (0.6, 6.0, 0, 0),
    "alt": (2.0, 10000.0, 0, 0),
    "ast": (6.0, 20000.0, 0, 0),
    "anion_gap": (5.0, 50.0, 0, 0),
    "chloride": (50.0, 175.0, 0, 0),
    "o2sat": (0.0, 100.0, 0, 0),
    "ca_ion": (1.0, 10.0, 0, 0),
    "gcs_eye": (1.0, 4.0, 0, 0),
    "gcs_verbal": (1.0, 5.0, 0, 0),
    "gcs_motor": (1.0, 6.0, 0, 0),
}
GCS_SUB = {220739: "gcs_eye", 223900: "gcs_verbal", 223901: "gcs_motor"}

# input_preprocess cell 71 grouping maps.
ADMISSION_TYPE_MAP = {
    "EW EMER.": "EMERGENCY", "DIRECT EMER.": "EMERGENCY",
    "URGENT": "EMERGENCY",
    "OBSERVATION ADMIT": "OBSERVATION", "EU OBSERVATION": "OBSERVATION",
    "DIRECT OBSERVATION": "OBSERVATION",
    "AMBULATORY OBSERVATION": "OBSERVATION",
    "ELECTIVE": "ELECTIVE", "SURGICAL SAME DAY ADMISSION": "ELECTIVE",
}
ADMISSION_LOCATION_MAP = {
    "EMERGENCY ROOM": "EMERGENCY", "WALK-IN/SELF REFERRAL": "EMERGENCY",
    "PHYSICIAN REFERRAL": "REFERRAL", "CLINIC REFERRAL": "REFERRAL",
    "TRANSFER FROM HOSPITAL": "TRANSFER",
    "TRANSFER FROM SKILLED NURSING FACILITY": "TRANSFER",
    "AMBULATORY SURGERY TRANSFER": "TRANSFER",
    "PROCEDURE SITE": "PROCEDURE_PACU", "PACU": "PROCEDURE_PACU",
    "INFORMATION NOT AVAILABLE": "OTHER_UNKNOWN",
    "INTERNAL TRANSFER TO OR FROM PSYCH": "OTHER_UNKNOWN",
}
CAREUNIT_GROUPS = {
    "MICU": ["Medical Intensive Care Unit (MICU)", "Medicine", "Med/Surg"],
    "SICU": ["Surgical Intensive Care Unit (SICU)",
             "Surgery/Vascular/Intermediate", "Surgery/Trauma"],
    "MICU_SICU": ["Medical/Surgical Intensive Care Unit (MICU/SICU)",
                  "Intensive Care Unit (ICU)"],
    "CARDIAC": ["Cardiac Vascular Intensive Care Unit (CVICU)",
                "Coronary Care Unit (CCU)",
                "Medicine/Cardiology Intermediate"],
    "TSICU": ["Trauma SICU (TSICU)"],
    "NEURO": ["Neuro Intermediate", "Neuro Stepdown",
              "Neuro Surgical Intensive Care Unit (Neuro SICU)",
              "Neurology"],
}

# input_preprocess cells 85/88/94: 33 STD vars − {BNP, d-dimer, hematocrit}
# + spo2_fio2 ⇒ 31 value-pivot vars; EXTRA {fluid_cumul, map, urine} ⇒ 34.
STD_VARS_PIVOT = [
    "albumin", "alt", "anion_gap", "art_ph", "ast", "base_excess",
    "bilirubin", "bun", "ca_ion", "chloride", "ck_mb", "creatinine",
    "fio2", "gcs", "glucose", "heart_rate", "hemoglobin", "lactate",
    "o2sat", "paco2", "pao2", "platelets", "potassium", "pt_inr", "ptt",
    "resp_rate", "sodium", "temperature", "troponin-T", "wbc",
]
STD_VARS = STD_VARS_PIVOT + ["spo2_fio2"]
EXTRA_VARS = {"fluid_cumul": "count_fluid_cumul", "map": "count_map",
              "urine": "count_urine"}
ALL_VARS = STD_VARS + list(EXTRA_VARS.keys())
ALL_COUNTS = [f"count_{v}" for v in STD_VARS] + list(EXTRA_VARS.values())

# mimic-cxr-2.0.0-chexpert column → reference final_df label column.
CHEXPERT_TO_LABEL = {
    "Edema": "label_edema",
    "Cardiomegaly": "label_cardiomegaly",
    "Pleural Effusion": "label_effusion",
    "Pneumonia": "label_pneumonia",
    "Atelectasis": "label_atelectasis",
    "Lung Opacity": "label_opacity",
    "Consolidation": "label_consolidation",
}


# =============================================================================
# IO
# =============================================================================
RAW_TABLES = {
    "admissions": ("hosp/admissions",),
    "patients": ("hosp/patients",),
    "labevents": ("hosp/labevents",),
    "omr": ("hosp/omr",),
    "diagnoses_icd": ("hosp/diagnoses_icd",),
    "icustays": ("icu/icustays",),
    "chartevents": ("icu/chartevents",),
    "inputevents": ("icu/inputevents",),
    "outputevents": ("icu/outputevents",),
    "cxr_metadata": ("cxr/mimic-cxr-2.0.0-metadata", "cxr/metadata"),
    "cxr_chexpert": ("cxr/mimic-cxr-2.0.0-chexpert", "cxr/chexpert"),
    # CXLSeg lung segmentation masks (chest-x-ray-segmentation 1.0.0;
    # cxr_db cells 2-8) — optional: the join degrades to no mask columns
    "cxr_seg_mask": ("cxr/CXLSeg-mask", "cxr/seg_mask"),
}
OPTIONAL_TABLES = {"omr", "diagnoses_icd", "cxr_seg_mask"}
_TIME_COLS = ("admittime", "dischtime", "deathtime", "intime", "outtime",
              "charttime", "starttime", "endtime", "dod")



# =============================================================================
# IO
# =============================================================================
def read_table(root: str, stems: Sequence[str]) -> Optional[Frame]:
    """Read ``<root>/<stem>.{ftr,feather,csv,csv.gz}``, the first hit
    winning (the reference converts csv.gz to feather up front, groundwork
    cell 3), with ``_TIME_COLS`` through ``pd.to_datetime`` as
    ``datetime64[ns]``."""
    for stem in stems:
        base = os.path.join(root, stem)
        for ext in (".ftr", ".feather"):
            if os.path.exists(base + ext):
                df = F.read_feather(base + ext)
                return {c: to_datetime(v) if c in _TIME_COLS else v
                        for c, v in df.items()}
        for ext in (".csv", ".csv.gz"):
            p = base + ext
            if os.path.exists(p):
                return F.read_csv(p, dates=_TIME_COLS)
    return None


def to_datetime(col: np.ndarray) -> np.ndarray:
    """``pd.to_datetime`` of a column as a feather table stores it:
    strings parsed as the CSV route parses them (None -> NaT), timestamps
    cast to ``datetime64[ns]``; a column with no time at all, which
    ``pd.read_csv`` reads as float64 NaN, becomes NaT."""
    kind = col.dtype.kind
    if kind == "M":
        return col.astype("datetime64[ns]")
    if kind == "O":
        if any(not isinstance(v, str) for v in col if v is not None):
            raise ValueError("a time column holds values that are neither "
                             "strings nor null")
        return F._datetimes(["" if v is None else v for v in col])
    if kind == "f" and np.isnan(col).all():
        return np.full(len(col), np.datetime64("NaT"), "datetime64[ns]")
    raise ValueError(f"a time column of dtype {col.dtype} cannot be "
                     "converted to datetimes")


def load_raw_tables(root: str) -> Dict[str, Frame]:
    out = {}
    for name, stems in RAW_TABLES.items():
        df = read_table(root, stems)
        if df is None and name not in OPTIONAL_TABLES:
            raise FileNotFoundError(
                f"required raw table {name!r} not found under {root} "
                f"(tried {stems} with .ftr/.csv/.csv.gz)")
        if df is not None:
            out[name] = df
    return out


# =============================================================================
# Slot grid (groundwork cell 180)
# =============================================================================
def _n_slots(icustays: Frame) -> np.ndarray:
    n = np.ceil((icustays["outtime"] - icustays["intime"]) / HOUR)
    if np.isnan(n).any():
        raise ValueError("an ICU stay without intime or outtime")
    return np.clip(n.astype(np.int64), 0, None)


def build_slot_grid(icustays: Frame) -> Frame:
    """Hourly ``slot_idx`` grid per stay from intime to outtime."""
    n_slots = _n_slots(icustays)
    rep = np.repeat(np.arange(len(n_slots)), n_slots)
    slot = F._ranges(np.zeros(len(n_slots), np.int64), n_slots)
    intime = icustays["intime"][rep]
    return {"subject_id": icustays["subject_id"][rep],
            "hadm_id": icustays["hadm_id"][rep],
            "stay_id": icustays["stay_id"][rep],
            "slot_idx": slot,
            "slot_start": intime + slot * HOUR,
            "slot_end": intime + (slot + 1) * HOUR}


def _stay_values(icustays: Frame, col: str,
                 stay_ids: np.ndarray) -> np.ndarray:
    """``icustays[col]`` of each row's stay (NaT where the stay is not
    there); for a repeated stay id its last row wins, as in JAX's dict."""
    ids = icustays["stay_id"].astype(np.int64)
    uniq, back = np.unique(ids[::-1], return_index=True)
    vals = icustays[col][len(ids) - 1 - back]
    sid = np.asarray(stay_ids).astype(np.int64)
    pos = np.clip(np.searchsorted(uniq, sid), 0, max(len(uniq) - 1, 0))
    found = (uniq[pos] == sid) if len(uniq) else np.zeros(len(sid), bool)
    out = vals[pos] if len(uniq) else np.zeros(len(sid), vals.dtype)
    return np.where(found, out, np.datetime64("NaT"))


def _slot_of(df: Frame, icustays: Frame,
             time_col: str = "charttime") -> np.ndarray:
    """Vectorized containment: slot k iff charttime ∈ [intime+k, intime+k+1)
    and the slot exists (< ceil(outtime-intime)); −1 otherwise (cell 231)."""
    t_in = _stay_values(icustays, "intime", df["stay_id"])
    t_out = _stay_values(icustays, "outtime", df["stay_id"])
    dt = (df[time_col] - t_in) / HOUR
    n_slots = np.ceil((t_out - t_in) / HOUR)
    slot = np.floor(dt)
    ok = np.isfinite(dt) & (slot >= 0) & (slot < n_slots)
    return np.where(ok, slot, -1).astype(np.int64)


# =============================================================================
# Unit standardization + outlier policy (cells 52-110)
# =============================================================================
def _eq(df: Frame, col: str, value: str) -> np.ndarray:
    """``df.get(col, "") == value``: a missing column compares as ``""``."""
    v = df.get(col)
    if v is None:
        return np.full(F.nrows(df), value == "")
    return (v == value) if v.dtype == object else np.zeros(len(v), bool)


def fix_units(chart: Frame, lab: Frame, inputev: Frame
              ) -> Tuple[Frame, Frame, Frame]:
    chart = F.take(chart, ~F.isnull(chart["valuenum"]))
    lab = F.take(lab, ~F.isnull(lab["valuenum"]))
    inputev = dict(inputev)
    # ck_mb rows recorded as '%' are a different assay — drop (cell 60).
    chart = F.take(chart, ~(np.isin(chart["itemid"], QUERY_DICT["ck_mb"])
                            & _eq(chart, "valueuom", "%")))
    v = chart["valuenum"].astype(np.float64)
    # °F → °C (cell 62)
    cond = np.isin(chart["itemid"], QUERY_DICT["temperature"]) \
        & _eq(chart, "valueuom", "°F")
    v[cond] = (v[cond] - 32) * 5 / 9
    # height inch → cm (cell 74)
    cond = np.isin(chart["itemid"], QUERY_DICT["height"]) \
        & _eq(chart, "valueuom", "Inch")
    v[cond] = v[cond] * 2.54
    chart["valuenum"] = v
    lab["valuenum"] = lab["valuenum"].astype(np.float64)
    # FiO2 recorded as a fraction → percent, both sources (cells 95-96)
    for df in (chart, lab):
        x = df["valuenum"]
        cond = np.isin(df["itemid"], QUERY_DICT["fio2"]) \
            & (x >= 0.21) & (x <= 1)
        x[cond] = x[cond] * 100

    if F.nrows(inputev):
        a = inputev["amount"].astype(np.float64)
        # fluid volumes to mL (cell 85)
        cond = np.isin(inputev["itemid"], QUERY_DICT["fluid_cyst"]) \
            & _eq(inputev, "amountuom", "L")
        a[cond] = a[cond] * 1000
        # Albumin 5% (220864) → equivalent 25% amount (cell 107)
        cond = inputev["itemid"] == 220864
        a[cond] = a[cond] / 5
        inputev["amount"] = a
    return chart, lab, inputev


def _criteria_mask(values: np.ndarray, crit) -> np.ndarray:
    """True = outlier (cell 101: strict bound violation, plus the bound
    itself when the inclusion flag is set)."""
    lb, ub, lb_incl, ub_incl = crit
    bad = (values > ub) | (values < lb)
    if ub_incl:
        bad |= values == ub
    if lb_incl:
        bad |= values == lb
    return bad


def remove_outliers(chart: Frame, lab: Frame) -> Tuple[Frame, Frame]:
    """Per-variable lb/ub criteria; GCS bounded per subcomponent; variables
    without criteria get the 2%/98% percentile trim (cell 101)."""
    drop_c = np.zeros(F.nrows(chart), bool)
    drop_l = np.zeros(F.nrows(lab), bool)
    vc, vl = chart["valuenum"], lab["valuenum"]
    for item, itemids in QUERY_DICT.items():
        if item == "gcs":
            for iid, sub in GCS_SUB.items():
                cond = chart["itemid"] == iid
                drop_c |= cond & _criteria_mask(vc, OUTLIER_CRITERIA[sub])
            continue
        in_c = np.isin(chart["itemid"], itemids)
        in_l = np.isin(lab["itemid"], itemids)
        if item in OUTLIER_CRITERIA:
            drop_c |= in_c & _criteria_mask(vc, OUTLIER_CRITERIA[item])
            drop_l |= in_l & _criteria_mask(vl, OUTLIER_CRITERIA[item])
        else:
            for in_x, vx, drop_x in ((in_c, vc, drop_c), (in_l, vl, drop_l)):
                if in_x.sum() > 0:
                    hi = np.quantile(vx[in_x], 0.98)
                    lo = np.quantile(vx[in_x], 0.02)
                    drop_x |= in_x & ((vx > hi) | (vx < lo))
    return F.take(chart, ~drop_c), F.take(lab, ~drop_l)


# =============================================================================
# Per-modality streams
# =============================================================================
def build_gcs(chart: Frame) -> Frame:
    """Complete (eye, verbal, motor) triples summed per (stay, charttime)
    (cell 217)."""
    g = F.take(chart, np.isin(chart["itemid"], list(GCS_SUB)))
    codes, first = F.group_rows([g["stay_id"], g["charttime"]])
    total = F.group_sum(codes, len(first), g["valuenum"])
    full = F.group_count(codes, len(first), g["itemid"]) == 3
    return {"stay_id": g["stay_id"][first][full],
            "feature_name": np.full(int(full.sum()), "gcs", object),
            "charttime": g["charttime"][first][full],
            "valuenum": total[full]}


def _pivot(df: Frame, index: Sequence[str], column: str, value: str,
           agg) -> Tuple[Frame, Dict[object, np.ndarray]]:
    """``df.pivot_table(index=index, columns=column, values=value,
    aggfunc=agg)`` → (the index rows, sorted; ``{column value: its
    column}``, sorted, NaN where a cell has no row)."""
    codes, first = F.group_rows([df[c] for c in index] + [df[column]])
    cell = agg(codes, len(first), df[value])
    rcodes, rfirst = F.group_rows([df[c][first] for c in index])
    rows = {c: df[c][first][rfirst] for c in index}
    cols = {}
    for name in sorted(set(df[column][first].tolist())):
        at = df[column][first] == name
        col = np.full(len(rfirst), np.nan)
        col[rcodes[at]] = cell[at]
        cols[name] = col
    return rows, cols


def _row_nanmean(mat: np.ndarray) -> np.ndarray:
    cnt = (~np.isnan(mat)).sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(cnt > 0, F.row_nansum(mat) / cnt, np.nan)


def build_bp(chart: Frame, icustays: Frame) -> Frame:
    """ABP-priority sbp/dbp/map at charttime granularity (cell 148), then
    within-slot LAST + count + sbp>dbp filter (cells 211-212). Returns the
    full slot grid left-joined (missing slots → NaN, bp_count 0)."""
    ids = [220050, 225309, 220179, 220051, 225310, 220180,
           220052, 225312, 220181]
    bp = F.take(chart, np.isin(chart["itemid"], ids))
    grid = F.select(build_slot_grid(icustays), ["stay_id", "slot_idx"])
    if not F.nrows(bp):
        n = F.nrows(grid)
        return {**grid, "sbp": np.full(n, np.nan), "dbp": np.full(n, np.nan),
                "map": np.full(n, np.nan), "bp_count": np.zeros(n, np.int64)}
    wide, cols = _pivot(bp, ["stay_id", "charttime"], "itemid", "valuenum",
                        F.group_mean)
    n = F.nrows(wide)

    def col_mean(ids_):
        exist = [cols[c] for c in ids_ if c in cols]
        return _row_nanmean(np.stack(exist, 1)) if exist \
            else np.full(n, np.nan)

    def first_valid(ids_):
        out = np.full(n, np.nan)
        for c in ids_:
            if c in cols:
                out = np.where(np.isnan(out), cols[c], out)
        return out

    def fill(a, b):
        return np.where(np.isnan(a), b, a)

    wide["sbp"] = fill(col_mean([220050, 225309]), first_valid([220179]))
    wide["dbp"] = fill(col_mean([220051, 225310]), first_valid([220180]))
    m = fill(col_mean([220052, 225312]), first_valid([220181]))
    calc = np.isnan(m) & ~np.isnan(wide["sbp"]) & ~np.isnan(wide["dbp"])
    m[calc] = (wide["sbp"][calc] + 2 * wide["dbp"][calc]) / 3
    wide["map"] = m

    wide["slot_idx"] = _slot_of(wide, icustays)
    wide = F.sort_values(F.take(wide, wide["slot_idx"] >= 0),
                         ["stay_id", "slot_idx", "charttime"])
    codes, first = F.group_rows([wide["stay_id"], wide["slot_idx"]])
    k = len(first)
    grouped = {"stay_id": wide["stay_id"][first],
               "slot_idx": wide["slot_idx"][first],
               **{c: F.group_last(codes, k, wide[c])
                  for c in ("sbp", "dbp", "map")},
               "bp_count": F.group_count(codes, k, wide["sbp"])}
    grouped = F.take(grouped, grouped["sbp"] > grouped["dbp"])
    out = F.merge(grid, grouped, ["stay_id", "slot_idx"], "left")
    out["bp_count"] = F.fillna(out["bp_count"], 0).astype(np.int64)
    return out


def build_urine(outputev: Frame, icustays: Frame) -> Frame:
    """Cells 113-125 + 252: per-charttime urine totals → intervals between
    consecutive measurements → overlap-proportional hourly distribution."""
    grid = build_slot_grid(icustays)
    n = F.nrows(grid)
    empty = {"stay_id": grid["stay_id"], "slot_idx": grid["slot_idx"],
             "urine": np.zeros(n), "urine_count": np.zeros(n, np.int64)}
    ur = F.take(outputev, np.isin(outputev["itemid"], QUERY_DICT["urine"]))
    if not F.nrows(ur):
        return empty
    # pivot per itemid; 227488 (irrigant in) flips sign; other negatives→NaN
    wide, cols = _pivot(ur, ["stay_id", "charttime"], "itemid", "value",
                        F.group_sum)
    if 227488 in cols:
        cols[227488] = -cols[227488]
    for iid in QUERY_DICT["urine"]:
        if iid in cols and iid != 227488:
            cols[iid][cols[iid] < 0] = np.nan
    mat = np.stack([cols[c] for c in QUERY_DICT["urine"] if c in cols], 1)
    total = F.row_nansum(mat)
    total[np.isnan(mat).all(axis=1)] = np.nan          # min_count=1
    wide["urine"] = total
    wide = F.take(wide, ~np.isnan(wide["urine"]))
    wide = F.take(wide, ~(wide["urine"] > 3000))       # bag-size hard cap

    wide["intime"] = _stay_values(icustays, "intime", wide["stay_id"])
    wide = F.take(wide, ~np.isnat(wide["intime"]))
    off = (wide["charttime"] - wide["intime"]) / HOUR
    wide = F.sort_values(F.take(wide, off >= -24), ["stay_id", "charttime"])
    if not F.nrows(wide):
        return empty

    # starttime = previous charttime + 1 min (first: intime − 60 min)
    sid, ct = wide["stay_id"], wide["charttime"]
    same = np.r_[False, sid[1:] == sid[:-1]]
    prev = np.where(same, np.r_[np.datetime64("NaT"), ct[:-1]],
                    np.datetime64("NaT")).astype(ct.dtype)
    start = prev + np.timedelta64(1, "m")
    first = np.isnat(prev)
    start[first] = wide["intime"][first] - np.timedelta64(60, "m")
    wide["starttime"] = start
    wide["endtime"] = ct
    dur = (wide["endtime"] - wide["starttime"]) / HOUR
    rate = wide["urine"] / dur
    ok = rate[~np.isnan(rate)]
    cutoff = np.percentile(ok, np.asarray([0.98]) * 100.0)[0] if len(ok) \
        else np.nan
    wide = F.take(wide, ~(rate > cutoff))

    dist = _distribute_intervals(wide, grid, "urine")
    if not F.nrows(dist):
        return empty
    out = F.merge(F.select(grid, ["stay_id", "slot_idx"]),
                  {"stay_id": dist["stay_id"], "slot_idx": dist["slot_idx"],
                   "urine": dist["amount"], "urine_count": dist["count"]},
                  ["stay_id", "slot_idx"], "left")
    u = F.fillna(out["urine"], 0.0)
    out["urine"] = np.where(u < 0, 0.0, u)
    out["urine_count"] = F.fillna(out["urine_count"], 0).astype(np.int64)
    return out


def build_fluid(inputev: Frame, icustays: Frame) -> Frame:
    """Crystalloid infusions distributed over overlapped slots; boluses go
    to the containing slot; counts = decision points (cell 202)."""
    grid = build_slot_grid(icustays)
    fl = F.take(inputev, np.isin(inputev["itemid"], QUERY_DICT["fluid_cyst"]))
    fl = F.take(fl, fl["amount"] > 0)
    fl = {("fluid_cumul" if c == "amount" else c): v for c, v in fl.items()}
    dist = _distribute_intervals(fl, grid, "fluid_cumul")
    keys = F.select(grid, ["stay_id", "slot_idx"])
    if F.nrows(dist):
        out = F.merge(keys, {"stay_id": dist["stay_id"],
                             "slot_idx": dist["slot_idx"],
                             "fluid_cumul": dist["amount"],
                             "count_fluid_cumul": dist["count"]},
                      ["stay_id", "slot_idx"], "left")
    else:
        n = F.nrows(keys)
        out = {**keys, "fluid_cumul": np.full(n, np.nan),
               "count_fluid_cumul": np.full(n, np.nan)}
    out["fluid_cumul"] = F.fillna(out["fluid_cumul"], 0.0)
    out["count_fluid_cumul"] = F.fillna(out["count_fluid_cumul"],
                                        0).astype(np.int64)
    return out


def _distribute_intervals(df: Frame, grid: Frame, value_col: str) -> Frame:
    """Shared overlap-proportional slot distribution (cells 202 / 252):
    momentary records (start == end) land fully in their containing slot;
    interval records contribute ``amount · overlap/total`` per slot; the
    per-slot count sums records whose decision point falls in the slot."""
    empty = {"stay_id": np.zeros(0, np.int64),
             "slot_idx": np.zeros(0, np.int64), "amount": np.zeros(0),
             "count": np.zeros(0, np.int64)}
    if not F.nrows(df):
        return empty
    m = F.merge({c: df[c] for c in ("stay_id", "starttime", "endtime",
                                    value_col)},
                F.select(grid, ["stay_id", "slot_idx", "slot_start",
                                "slot_end"]), ["stay_id"], "inner")
    ov_start = np.maximum(m["starttime"], m["slot_start"])
    ov_end = np.minimum(m["endtime"], m["slot_end"])
    ov_h = np.clip((ov_end - ov_start) / HOUR, 0, None)
    tot_h = (m["endtime"] - m["starttime"]) / HOUR
    keep = tot_h >= 0
    m, ov_h, tot_h = F.take(m, keep), ov_h[keep], tot_h[keep]
    momentary = tot_h == 0
    st, en = m["starttime"], m["endtime"]
    s0, s1 = m["slot_start"], m["slot_end"]
    in_slot = (st >= s0) & (st < s1)
    val = m[value_col].astype(np.float64)
    amount = np.where(momentary, np.where(in_slot, val, 0.0),
                      val * np.where(tot_h > 0, ov_h
                                     / np.where(tot_h > 0, tot_h, 1), 0.0))
    measured = np.where(momentary, in_slot, (en > s0) & (en <= s1))
    nz = amount != 0
    m, amount, measured = F.take(m, nz), amount[nz], measured[nz]
    codes, first = F.group_rows([m["stay_id"], m["slot_idx"]])
    k = len(first)
    return {"stay_id": m["stay_id"][first], "slot_idx": m["slot_idx"][first],
            "amount": F.group_sum(codes, k, amount),
            "count": np.bincount(codes, weights=measured.astype(np.int64),
                                 minlength=k).astype(np.int64)}


def bin_chart_lab(chart: Frame, lab: Frame, icustays: Frame) -> Frame:
    """Cells 219-246: itemid→feature mapping, lab assignment to stays by
    hadm + containment, GCS concat, dedupe keep-last per (stay, feature,
    charttime), within-slot LAST + count, ward T0 backfill, fillna 0.
    Returns long frame [stay_id, feature_name, slot_idx, value, count]."""
    itemid_to_var = {iid: v for v, ids in QUERY_DICT.items() for iid in ids
                     if v not in CHART_LAB_EXCLUDE}
    valid = list(itemid_to_var)

    def features(itemids):
        return np.array([itemid_to_var[int(i)] for i in itemids], object)

    c = F.take(chart, np.isin(chart["itemid"], valid))
    c = {"stay_id": c["stay_id"], "feature_name": features(c["itemid"]),
         "charttime": c["charttime"], "valuenum": c["valuenum"]}
    c = F.concat([c, build_gcs(chart)])

    # labevents carry hadm_id but no stay_id: containment assignment
    lb = F.take(lab, np.isin(lab["itemid"], valid))
    lb["feature_name"] = features(lb["itemid"])
    stays = F.select(icustays, ["hadm_id", "stay_id", "intime", "outtime"])
    li = F.merge(lb, stays, ["hadm_id"], "inner")
    in_icu = (li["charttime"] >= li["intime"]) \
        & (li["charttime"] < li["outtime"])
    l_icu = F.select(F.take(li, in_icu), ["stay_id", "feature_name",
                                          "charttime", "valuenum"])

    combined = F.concat([c, l_icu])
    combined = F.drop_duplicates(combined, ["stay_id", "feature_name",
                                            "charttime"], keep="last")
    combined["slot_idx"] = _slot_of(combined, icustays)
    combined = F.sort_values(F.take(combined, combined["slot_idx"] >= 0),
                             ["stay_id", "feature_name", "slot_idx",
                              "charttime"])
    codes, first = F.group_rows([combined["stay_id"],
                                 combined["feature_name"],
                                 combined["slot_idx"]])
    k = len(first)
    grouped = {"stay_id": combined["stay_id"][first],
               "feature_name": combined["feature_name"][first],
               "slot_idx": combined["slot_idx"][first],
               "value": F.group_last(codes, k, combined["valuenum"]),
               "count": F.group_count(codes, k, combined["valuenum"])}

    # ward labs in the 24 h before ICU admission → closest value per
    # feature backfills slot 0 where the ICU value is missing (cell 222/237)
    day_before = li["intime"] - np.timedelta64(24, "h")
    pre = F.take(li, (li["charttime"] >= day_before)
                 & (li["charttime"] < li["intime"]))
    if F.nrows(pre):
        tdiff = np.abs(pre["intime"] - pre["charttime"]).astype(np.int64)
        codes, first = F.group_rows([pre["stay_id"], pre["feature_name"]])
        k = len(first)
        best = np.full(k, np.iinfo(np.int64).max)
        np.minimum.at(best, codes, tdiff)
        pick = np.full(k, len(tdiff), np.int64)
        at = np.flatnonzero(tdiff == best[codes])
        np.minimum.at(pick, codes[at], at)             # idxmin: the first
        ward = {"stay_id": pre["stay_id"][pick],
                "feature_name": pre["feature_name"][pick],
                "value_ward": pre["valuenum"][pick],
                "slot_idx": np.zeros(k, np.int64)}
        grouped = F.merge(grouped, ward, ["stay_id", "feature_name",
                                          "slot_idx"], "outer")
        fill = np.isnan(grouped["value"]) & ~np.isnan(grouped["value_ward"])
        grouped["value"] = np.where(fill, grouped["value_ward"],
                                    grouped["value"])
        grouped["count"] = np.where(fill, 1, grouped["count"])
        del grouped["value_ward"]
    grouped["count"] = F.fillna(grouped["count"], 0).astype(np.int64)
    grouped["value"] = F.fillna(grouped["value"], 0.0)
    return grouped


# =============================================================================
# Wide assembly (input_preprocess cells 73-94)
# =============================================================================
def assemble_icu_events(binned: Frame, bp: Frame, fluid: Frame,
                        urine: Frame, icustays: Frame) -> Frame:
    grid = F.select(build_slot_grid(icustays), ["subject_id", "hadm_id",
                                                "stay_id", "slot_idx"])
    keys = ["stay_id", "slot_idx"]
    rows, values = _pivot(binned, keys, "feature_name", "value", _first)
    _, counts = _pivot(binned, keys, "feature_name", "count", _first)
    wide = {**rows, **values, **{f"count_{v}": c for v, c in counts.items()}}

    df = F.merge(grid, wide, keys, "left")
    df = F.merge(df, fluid, keys, "left")
    df = F.merge(df, {"stay_id": bp["stay_id"], "slot_idx": bp["slot_idx"],
                      "map": bp["map"], "count_map": bp["bp_count"]},
                 keys, "left")
    df = F.merge(df, {"stay_id": urine["stay_id"],
                      "slot_idx": urine["slot_idx"], "urine": urine["urine"],
                      "count_urine": urine["urine_count"]}, keys, "left")

    n = F.nrows(df)
    for v in STD_VARS_PIVOT:
        if v not in df:
            df[v] = np.zeros(n)
            df[f"count_{v}"] = np.zeros(n, np.int64)
    for v in STD_VARS_PIVOT:
        df[v] = F.fillna(df[v].astype(np.float64), 0.0)
        df[f"count_{v}"] = F.fillna(df[f"count_{v}"], 0).astype(np.int64)
    for v in ("fluid_cumul", "map", "urine"):
        df[v] = F.fillna(df[v], 0.0)
        df[EXTRA_VARS[v]] = F.fillna(df[EXTRA_VARS[v]], 0).astype(np.int64)

    # derived spo2_fio2 (input_preprocess cell 90); count = validity flag
    fio2 = np.where(df["fio2"] <= 1, df["fio2"], df["fio2"] / 100)
    o2 = df["o2sat"]
    ok = (o2 > 0) & (o2 <= 100) & (fio2 >= 0.21) & (fio2 <= 1.0)
    df["spo2_fio2"] = np.where(ok, o2 / np.where(ok, fio2, 1.0), 0.0)
    df["count_spo2_fio2"] = ok.astype(np.int64)

    return F.select(df, ["subject_id", "hadm_id", "stay_id", "slot_idx"]
                    + ALL_VARS + ALL_COUNTS)


def _first(codes, n_groups, values) -> np.ndarray:
    """``agg("first")``: each group's first non-null value, as float."""
    ok = np.flatnonzero((codes >= 0) & ~F.isnull(values))
    first = np.full(n_groups, len(values), np.int64)
    np.minimum.at(first, codes[ok], ok)
    out = np.full(n_groups, np.nan)
    has = first < len(values)
    out[has] = values[first[has]]
    return out


# =============================================================================
# Static frame (groundwork cells 14-57 via static_info +
# input_preprocess cell 71)
# =============================================================================
def _col(df: Frame, name: str, default) -> np.ndarray:
    """``df.get(name, pd.Series(default, index=df.index))``."""
    v = df.get(name)
    return v if v is not None else np.full(F.nrows(df), default)


def _mapped(values: np.ndarray, table: Dict[str, str],
            default: str) -> np.ndarray:
    """``Series.map(table).fillna(default)``."""
    return np.array([table.get(v, default) if isinstance(v, str) else default
                     for v in values], object)


def build_static(admissions: Frame, patients: Frame,
                 icustays: Frame) -> Frame:
    adm = F.merge(admissions, patients, ["subject_id"], "inner")
    # per-admission stay ranges for the order taxonomy
    codes, first = F.group_rows([icustays["hadm_id"]])
    k = len(first)
    rng = {"hadm_id": icustays["hadm_id"][first],
           "intime_min": F.group_min(codes, k, icustays["intime"]),
           "outtime_max": F.group_max(codes, k, icustays["outtime"])}
    adm = F.merge(adm, rng, ["hadm_id"], "left")

    # time-order repair on admissions having ICU stays
    keep_subject = set(adm["subject_id"].tolist())
    at, dt = adm["admittime"].copy(), adm["dischtime"].copy()
    for i in np.flatnonzero(~np.isnat(adm["intime_min"])):
        _, keep, a, d = si.repair_stay_order(at[i], dt[i],
                                             adm["intime_min"][i],
                                             adm["outtime_max"][i])
        if not keep:
            keep_subject.discard(adm["subject_id"][i])
        else:
            at[i], dt[i] = a, d
    adm["admittime"], adm["dischtime"] = at, dt
    adm = F.take(adm, np.isin(adm["subject_id"], list(keep_subject)))

    # death reconciliation per subject (cells 44-52); `died` is the
    # notebook's discharge-location flag
    if "died" not in adm:
        adm["died"] = _eq(adm, "discharge_location", "DIED").astype(np.int64)
    adm = F.sort_values(adm, ["subject_id", "admittime"])
    nat = np.datetime64("NaT", "ns")
    dod = _col(adm, "dod", nat)
    died = _col(adm, "died", 0)
    hef = _col(adm, "hospital_expire_flag", 0)
    death_adm = np.zeros(F.nrows(adm), np.int64)
    drop_subjects = set()
    _, first = F.group_rows([adm["subject_id"]])
    # sorted by subject: each subject's admissions are one run of rows
    for a, b in zip(first, np.r_[first[1:], F.nrows(adm)]):
        idx = np.arange(a, b)
        dts = si.dedupe_deathtime(adm["subject_id"][idx],
                                  adm["deathtime"][idx], dod[idx])
        d0 = dod[idx][0]
        nn = dts[~np.isnat(dts)]
        res = si.death_error_handling(
            adm["admittime"][idx], adm["dischtime"][idx],
            None if np.isnat(d0) else d0, None if len(nn) == 0 else nn[0],
            died[idx], hef[idx])
        if res["certainty"] == "error":
            drop_subjects.add(adm["subject_id"][idx][0])
        death_adm[idx] = res["death_adm"]
    adm["death_adm"] = death_adm
    adm = F.take(adm, ~np.isin(adm["subject_id"], list(drop_subjects)))

    # race mapping (cells 51-54)
    adm["race"] = si.map_race(adm["subject_id"],
                              adm["race"].tolist()).astype(object)

    st = F.merge(icustays, F.select(adm, ["subject_id", "hadm_id",
                                          "admission_type",
                                          "admission_location", "race",
                                          "death_adm"]),
                 ["subject_id", "hadm_id"], "inner")
    st = F.merge(st, F.select(patients, ["subject_id", "gender", "anchor_age",
                                         "anchor_year"]),
                 ["subject_id"], "inner")
    st["age_at_intime"] = si.age_at(st["intime"], st["anchor_year"],
                                    st["anchor_age"])
    st = F.take(st, (st["age_at_intime"] >= 18.0)
                & (st["age_at_intime"] <= 90.0))

    # grouped one-hots (input_preprocess cell 71)
    unit_map = {u: g for g, units in CAREUNIT_GROUPS.items() for u in units}
    st["admission_type_grouped"] = _mapped(st["admission_type"],
                                           ADMISSION_TYPE_MAP, "OTHER")
    st["admission_location_grouped"] = _mapped(
        st["admission_location"], ADMISSION_LOCATION_MAP, "OTHER_UNKNOWN")
    st["first_careunit_grouped"] = _mapped(st["first_careunit"], unit_map,
                                           "OTHER")
    onehot = ["admission_type_grouped", "admission_location_grouped",
              "first_careunit_grouped", "race", "gender"]
    return F.get_dummies(F.select(st, ["subject_id", "hadm_id", "stay_id",
                                       "age_at_intime", "death_adm"]
                                  + onehot), onehot)


# =============================================================================
# CXR frames (cxr_db cells 19-28 / 53 / 73)
# =============================================================================
def build_cxr_frames(metadata: Frame, chexpert: Frame, icustays: Frame,
                     label_policy: str = "to_positive",
                     seg_mask: Optional[Frame] = None,
                     lung_mask_root: str = "") -> Tuple[Frame, Frame]:
    """→ (final_cxr_df catalog, anchor rows with stay/slot/cxr_flag).

    The catalog keeps the CXR-head label policy (U→1 by default, cell 24);
    anchor rows carry the RAW CheXpert values — the anchor-level U→0
    happens downstream in the pipeline's anchor frame
    (data_processing.py:162-174).

    ``seg_mask``: CXLSeg-mask table (chest-x-ray-segmentation 1.0.0), its
    ``DicomPath`` renamed ``lung_mask_path``, prefixed with
    ``<root>/lung_mask/`` and LEFT-merged on (subject_id, study_id,
    dicom_id) — cxr_db cells 5-6 + 30."""
    m = F.merge(metadata, chexpert, ["subject_id", "study_id"], "inner")
    m = F.take(m, filter_ap_pa(m["ViewPosition"].tolist()))
    m["cxrtime"] = parse_cxrtime(m["StudyDate"], m["StudyTime"])

    label_cols = [c for c in CHEXPERT_TO_LABEL if c in m]
    n = F.nrows(m)
    raw = np.stack([m[c] for c in label_cols], 1).astype(np.float32) \
        if label_cols else np.zeros((n, 0), np.float32)
    head = apply_uncertain_policy(raw, label_policy)

    catalog = F.select(m, ["subject_id", "study_id", "dicom_id",
                           "ViewPosition", "cxrtime"])
    for j, c in enumerate(label_cols):
        catalog[CHEXPERT_TO_LABEL[c]] = head[:, j]

    if seg_mask is not None:                     # CXLSeg join (cell 30)
        sm = {"subject_id": seg_mask["subject_id"],
              "study_id": seg_mask["study_id"],
              "dicom_id": seg_mask["dicom_id"],
              "lung_mask_path": seg_mask["DicomPath"]}
        sm = F.drop_duplicates(sm, ["subject_id", "study_id", "dicom_id"])
        if lung_mask_root:                       # cell 6 path prefix
            p = sm["lung_mask_path"]
            miss = F.isnull(p)
            sm["lung_mask_path"] = np.array(
                [None if z else os.path.join(lung_mask_root, "lung_mask",
                                             str(x))
                 for x, z in zip(p, miss)], object)
        catalog = F.merge(catalog, sm, ["subject_id", "study_id",
                                        "dicom_id"], "left")
        catalog["has_lung_mask"] = ~F.isnull(catalog["lung_mask_path"])

    # assign each image to a stay of the same subject whose window holds it
    stays = F.select(icustays, ["subject_id", "hadm_id", "stay_id",
                                "intime", "outtime"])
    a = F.merge(m, stays, ["subject_id"], "inner")
    a = F.take(a, (a["cxrtime"] >= a["intime"]) & (a["cxrtime"]
                                                   < a["outtime"]))
    slot_idx, keep2 = assign_cxr_to_slots(
        a["stay_id"], a["cxrtime"].astype("datetime64[ns]"),
        *_stay_n_slots(icustays))
    a["slot_idx"] = slot_idx
    a = F.take(a, keep2)
    anchors = F.select(a, ["subject_id", "hadm_id", "stay_id", "study_id",
                           "dicom_id", "slot_idx", "cxrtime"])
    for c in label_cols:
        anchors[CHEXPERT_TO_LABEL[c]] = a[c].astype(np.float32)
    anchors["cxr_flag"] = np.ones(F.nrows(a), np.int64)
    return catalog, anchors


def _stay_n_slots(icustays: Frame):
    ids = [int(s) for s in icustays["stay_id"]]
    return (dict(zip(ids, icustays["intime"])),
            dict(zip(ids, (int(k) for k in _n_slots(icustays)))))


def build_final_df(icu_events: Frame, anchors: Frame) -> Frame:
    """[subject]input_preprocess cells 41-46: CXR anchor rows joined onto
    the slot-grid events. Row set = all event-grid rows; anchor slots carry
    cxr_flag=1 + dicom_id + raw labels."""
    label_cols = [c for c in anchors if c.startswith("label_")]
    join = F.select(anchors, ["stay_id", "slot_idx", "study_id", "dicom_id",
                              "cxr_flag"] + label_cols)
    df = F.merge(icu_events, join, ["stay_id", "slot_idx"], "left")
    df["cxr_flag"] = F.fillna(df["cxr_flag"], 0).astype(np.int64)
    df["study_id"] = F.fillna(df["study_id"], 0).astype(np.int64)
    df["dicom_id"] = F.fillna(df["dicom_id"].astype(object), "")
    return df


# =============================================================================
# Orchestrator
# =============================================================================
def build_audit_frames(raw_root: str, label_policy: str = "to_positive"
                       ) -> Tuple[Frame, Frame, Frame]:
    """The reference artifact frames of a raw layout: ``(static_full,
    final_df, final_cxr_df)``, as :func:`run_l0` writes them."""
    t = load_raw_tables(raw_root)
    icustays = t["icustays"]

    chart, lab, inputev = fix_units(t["chartevents"], t["labevents"],
                                    t["inputevents"])
    chart, lab = remove_outliers(chart, lab)

    binned = bin_chart_lab(chart, lab, icustays)
    bp = build_bp(chart, icustays)
    fluid = build_fluid(inputev, icustays)
    urine = build_urine(t["outputevents"], icustays)
    icu_events = assemble_icu_events(binned, bp, fluid, urine, icustays)

    static_df = build_static(t["admissions"], t["patients"], icustays)
    # cohort filter: stays surviving the static hygiene chain
    icu_events = F.take(icu_events, np.isin(icu_events["stay_id"],
                                            static_df["stay_id"]))

    catalog, anchors = build_cxr_frames(
        t["cxr_metadata"], t["cxr_chexpert"], icustays, label_policy,
        seg_mask=t.get("cxr_seg_mask"),
        lung_mask_root=os.path.join(raw_root, "cxr"))
    final_df = build_final_df(icu_events, anchors)

    return static_df, final_df, catalog


def run_l0(raw_root: str, out_dir: str, n_timesteps: int = 24,
           label_policy: str = "to_positive", split_seed: int = 42,
           count_clip: int = 15) -> Dict[str, str]:
    """Full L0 chain → reference artifact frames + columnar cohort.

    Writes ``static_full.ftr``, ``final_df.ftr``, ``final_cxr_df.ftr``
    (:func:`.frames.write_feather`), ``cohort.npz`` and
    ``meta_with_stats.pkl`` into ``out_dir``; returns the path map, with
    the keys of the JAX package's."""
    from ..config import DEFAULT_PATHOLOGY_LABELS, DataConfig
    from .ingest import from_reference_frames, save_npz
    from .pipeline import meta_from_events

    static_df, final_df, catalog = build_audit_frames(raw_root, label_policy)

    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, df in (("static_full", static_df), ("final_df", final_df),
                     ("final_cxr_df", catalog)):
        paths[name] = os.path.join(out_dir, f"{name}.ftr")
        F.write_feather(paths[name], df)

    labels = [c for c in DEFAULT_PATHOLOGY_LABELS if c in final_df]
    ds = from_reference_frames(final_df, static_df, catalog,
                               _schema_meta(static_df, n_timesteps), labels)
    cfg = DataConfig(n_timesteps=n_timesteps, split_seed=split_seed,
                     count_clip=count_clip)
    meta = meta_from_events(ds, cfg, label_col="death_adm")
    # same pickle contract the reference's SSL script writes
    # (duett/train_duett_ssl.py:130-135) and Meta.load consumes
    with open(os.path.join(out_dir, "meta_with_stats.pkl"), "wb") as f:
        pickle.dump(meta.to_reference_dict(), f)
    save_npz(os.path.join(out_dir, "cohort.npz"), ds)
    paths["cohort"] = os.path.join(out_dir, "cohort.npz")
    paths["meta"] = os.path.join(out_dir, "meta_with_stats.pkl")
    return paths


def _schema_meta(static_df: Frame, n_timesteps: int):
    """Schema-only Meta for the frame→columnar conversion; the real
    train-split stats are recomputed by meta_from_events afterwards."""
    from .meta import Meta
    onehot = tuple(c for c in static_df
                   if c not in {"subject_id", "hadm_id", "stay_id",
                                "age_at_intime", "death_adm"})
    V = len(ALL_VARS)
    return Meta(all_vars=tuple(ALL_VARS), all_counts=tuple(ALL_COUNTS),
                onehot_static=onehot, d_static=1 + len(onehot),
                label_col="death_adm", n_timesteps=n_timesteps,
                means=np.zeros(V, np.float32), stds=np.ones(V, np.float32),
                age_mean=0.0, age_std=1.0)
