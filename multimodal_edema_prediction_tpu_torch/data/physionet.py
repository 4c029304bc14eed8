"""PhysioNet-2012 mortality cohort (the DuETT paper's own dataset): the
port's numpy copy of ``multimodal_edema_prediction_tpu/data/physionet.py``
(reference ``duett/physionet.py``: a torchtime-backed DataModule with 36
time-series variables, 8 static features, value + count channels, a fixed
split seed).

``load_physionet2012_raw`` reads the published challenge layout directly
(set-a/b/c records + Outcomes files), with no torchtime;
``make_synthetic_physionet`` makes a cohort of the same structure (36
variables, 48 h, the static block, an in-hospital-death label with a
learnable signal) for tests and smoke runs. Either feeds the stay-label
dataset (``data/sliding.build_stay_label_dataset``) and the sliding SSL
dataset, through the port's ``data/pipeline.meta_from_events``.
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from ..config import DataConfig
from .meta import Meta
from .pipeline import meta_from_events
from .synthetic import AnchorTable, EventTable, StaticTable, SyntheticDataset

N_TS_VARS = 36       # physionet.py: 36 time-series variables
N_STATIC = 8         # 8 static features (age, gender, height, ICU type…)


def make_synthetic_physionet(seed: int = 0, n_patients: int = 400,
                             n_hours: int = 48, obs_rate: float = 0.25
                             ) -> Tuple[SyntheticDataset, Meta]:
    """P12-shaped synthetic cohort: one stay per patient, 48 h of sparse
    vitals/labs, mortality label driven by a latent severity state."""
    rng = np.random.default_rng(seed)
    V = N_TS_VARS
    sev = rng.normal(size=(n_patients, 3)).astype(np.float32)
    load = rng.normal(size=(3, V)).astype(np.float32) * \
        (rng.random((3, V)) < 0.4)
    base = rng.normal(1.0, 0.5, V).astype(np.float32)
    scale = rng.uniform(0.3, 2.0, V).astype(np.float32)

    stay_ids = np.arange(5000, 5000 + n_patients, dtype=np.int64)
    subj = np.arange(n_patients, dtype=np.int64)
    stay_len = np.full(n_patients, n_hours, np.int32)

    rows_slot, rows_val, rows_cnt, offsets = [], [], [], [0]
    for i in range(n_patients):
        t = np.arange(n_hours, dtype=np.float32)
        mean_tv = base + scale * (sev[i] @ load)[None, :] * \
            (0.5 + t[:, None] / n_hours)
        observed = rng.random((n_hours, V)) < obs_rate
        observed[0, rng.integers(0, V)] = True
        counts = np.where(observed, 1 + rng.poisson(0.5, (n_hours, V)),
                          0).astype(np.int32)
        vals = np.where(observed,
                        mean_tv + rng.normal(scale=0.4, size=(n_hours, V))
                        * scale, 0.0).astype(np.float32)
        keep = observed.any(axis=1)
        rows_slot.append(np.nonzero(keep)[0].astype(np.int32))
        rows_val.append(vals[keep])
        rows_cnt.append(counts[keep])
        offsets.append(offsets[-1] + int(keep.sum()))

    events = EventTable(stay_ids=stay_ids, subject_ids=subj,
                        stay_len=stay_len,
                        offsets=np.asarray(offsets, np.int64),
                        slot_idx=np.concatenate(rows_slot),
                        values=np.concatenate(rows_val),
                        counts=np.concatenate(rows_cnt))
    onehot = (rng.random((n_patients, N_STATIC - 1)) < 0.4).astype(np.float32)
    age = rng.uniform(20, 90, n_patients).astype(np.float32)
    death = (1 / (1 + np.exp(-(sev[:, 0] * 1.5 - 1.0)))
             > rng.random(n_patients)).astype(np.float32)

    static = StaticTable(stay_ids=stay_ids, subject_ids=subj, age=age,
                         onehot=onehot, death_adm=death)
    empty = AnchorTable(np.zeros(0, np.int64), np.zeros(0, np.int64),
                        np.zeros(0, np.int32), np.zeros(0, np.int64),
                        np.zeros((0, 1), np.float32))
    ds = SyntheticDataset(
        events=events, static=static, anchors=empty, cxr_catalog=empty,
        var_names=tuple(f"p12_var_{i:02d}" for i in range(V)),
        onehot_names=tuple(f"p12_static_{i}" for i in range(N_STATIC - 1)),
        latent_by_stay=sev, label_weights_true=load)
    meta = meta_from_events(ds, DataConfig(n_timesteps=24),
                            label_col="death_adm")
    return ds, meta


# the 36 time-series parameters, in torchtime column order (reference
# duett/physionet.py:8-46; TroponinI/T are spelled TropI/TropT in the raw
# challenge files)
P12_TS_PARAMS = (
    "Albumin", "ALP", "ALT", "AST", "Bilirubin", "BUN", "Cholesterol",
    "Creatinine", "DiasABP", "FiO2", "GCS", "Glucose", "HCO3", "HCT", "HR",
    "K", "Lactate", "Mg", "MAP", "MechVent", "Na", "NIDiasABP", "NIMAP",
    "NISysABP", "PaCO2", "PaO2", "pH", "Platelets", "RespRate", "SaO2",
    "SysABP", "Temp", "TropI", "TropT", "Urine", "WBC")
_P12_TS_INDEX = {p: i for i, p in enumerate(P12_TS_PARAMS)}
# general descriptors recorded at time 00:00 (reference cols 37-44:
# Weight + Age + Gender + Height + ICUType one-hot(4) → d_static = 8)
P12_STATIC_PARAMS = ("Age", "Gender", "Height", "ICUType", "Weight")


def _parse_record(path: str):
    """One raw set-X/<RecordID>.txt → (record_id, statics, observations)
    where observations is a list of ``(minutes, var_index, value)``."""
    import csv
    statics = {}
    obs = []
    with open(path) as f:
        reader = csv.reader(f)
        header = next(reader, None)
        assert header and header[0] == "Time", f"bad P12 record {path}"
        rid = None
        for row in reader:
            if len(row) != 3:
                continue
            t, param, val = row
            try:
                v = float(val)
            except ValueError:
                continue
            if param == "RecordID":
                rid = int(v)
                continue
            if param in P12_STATIC_PARAMS:
                # first non-missing wins (-1 encodes missing in the raw
                # files); later in-stay Weight rows are treated as TS-like
                # re-measurements by some pipelines, torchtime keeps the
                # descriptor — mirror torchtime
                if v >= 0 and param not in statics:
                    statics[param] = v
                continue
            j = _P12_TS_INDEX.get(param)
            if j is None or v < 0:
                continue
            hh, mm = t.split(":")
            obs.append((int(hh) * 60 + int(mm), j, v))
    return rid, statics, obs


def _bin_record(obs, binning: str, max_hours: int, n_bins: int):
    """Observations → (slot → value row, count row) dicts.

    ``absolute``: slot = observation hour clamped to ``max_hours``; value =
    within-slot MEAN (the framework's MIMIC contract, preprocess.hourly_bin).

    ``relative``: the reference's torchtime-era semantics
    (duett/physionet.py:92-96) — each record's time axis is divided into
    ``n_bins`` bins relative to its OWN span (``bin = t/t_last·n_bins``, the
    final observation landing in the last bin) and within a bin the LAST
    observation wins (plain overwrite), while counts accumulate per
    observation.
    """
    V = len(P12_TS_PARAMS)
    sums: dict = {}
    counts: dict = {}

    def row(slot):
        if slot not in sums:
            sums[slot] = np.zeros(V, np.float64)
            counts[slot] = np.zeros(V, np.int32)
        return sums[slot], counts[slot]

    if binning == "absolute":
        for minutes, j, v in obs:
            s, c = row(min(minutes // 60, max_hours - 1))
            s[j] += v
            c[j] += 1
        vals = {s_: np.where(counts[s_] > 0,
                             sums[s_] / np.maximum(counts[s_], 1), 0.0)
                for s_ in sums}
    elif binning == "relative":
        t_last = max((m for m, _, _ in obs), default=0)
        for minutes, j, v in obs:
            b = n_bins - 1 if minutes == t_last or t_last == 0 else \
                int(minutes / t_last * n_bins)
            s, c = row(min(b, n_bins - 1))
            s[j] = v            # last observation wins (overwrite)
            c[j] += 1
        vals = sums
    else:
        raise ValueError(f"unknown binning {binning!r}")
    return vals, counts


def load_physionet2012_raw(data_dir: str, max_hours: int = 48,
                           sets: Sequence[str] = ("set-a", "set-b", "set-c"),
                           binning: str = "absolute", n_bins: int = 24
                           ) -> Tuple[SyntheticDataset, Meta]:
    """Raw PhysioNet-2012 challenge files → framework cohort + meta.

    Replaces the reference's torchtime dependency (duett/physionet.py:1,
    ``PhysioNet2012(...)`` downloads + assembles X/y) with a direct reader
    of the published layout::

        {data_dir}/set-a/132539.txt     # Time,Parameter,Value records
        {data_dir}/Outcomes-a.txt       # RecordID,...,In-hospital_death

    ``binning`` selects the slot semantics (see :func:`_bin_record`):

    - ``"absolute"`` (default): hour-of-stay slots clamped to ``max_hours``,
      within-slot MEAN values — the framework's MIMIC contract. This is a
      deliberate deviation from the reference pipeline (cohort slot values
      differ); use it when P12 flows through the shared MIMIC machinery.
    - ``"relative"``: the reference's exact semantics
      (duett/physionet.py:92-96) — ``n_bins`` bins over each record's own
      span, last-observation-wins — for paper-repro parity runs.

    Statics become [age_z | gender, ICUType one-hot(4), height_z, weight_z]
    (d_static = 8, matching reference d_static_num()). Split/meta/stats
    then flow through the standard ``meta_from_events`` machinery
    (subject-level seed-42 split, train-split z-scoring).
    """
    import glob

    outcomes = {}
    for suffix in ("a", "b", "c"):
        p = os.path.join(data_dir, f"Outcomes-{suffix}.txt")
        if not os.path.exists(p):
            continue
        with open(p) as f:
            header = f.readline().strip().split(",")
            death_col = header.index("In-hospital_death")
            for line in f:
                parts = line.strip().split(",")
                if len(parts) > death_col:
                    outcomes[int(parts[0])] = float(parts[death_col])

    record_paths = []
    for s in sets:
        record_paths += sorted(glob.glob(os.path.join(data_dir, s, "*.txt")))
    if not record_paths:
        raise FileNotFoundError(f"no P12 records under {data_dir}/set-*/")

    V = len(P12_TS_PARAMS)
    rids, ages, onehots, deaths = [], [], [], []
    offsets = [0]
    all_slots, all_vals, all_cnts = [], [], []
    heights, weights = [], []
    for path in record_paths:
        rid, st, obs = _parse_record(path)
        vals_by_slot, counts = _bin_record(obs, binning, max_hours, n_bins)
        if rid is None:
            rid = int(os.path.splitext(os.path.basename(path))[0])
        rids.append(rid)
        ages.append(st.get("Age", np.nan))
        icu = np.zeros(4, np.float32)
        if "ICUType" in st and 1 <= int(st["ICUType"]) <= 4:
            icu[int(st["ICUType"]) - 1] = 1.0
        gender = st.get("Gender", np.nan)
        heights.append(st.get("Height", np.nan))
        weights.append(st.get("Weight", np.nan))
        onehots.append(np.concatenate([[0.0 if np.isnan(gender) else gender],
                                       icu, [0.0, 0.0]]))  # h/w filled below
        deaths.append(outcomes.get(rid, 0.0))
        slots = sorted(vals_by_slot)
        all_slots.append(np.asarray(slots, np.int32))
        vals = np.zeros((len(slots), V), np.float32)
        cnts = np.zeros((len(slots), V), np.int32)
        for r, s_ in enumerate(slots):
            vals[r] = vals_by_slot[s_]
            cnts[r] = counts[s_]
        all_vals.append(vals)
        all_cnts.append(cnts)
        offsets.append(offsets[-1] + len(slots))

    n = len(rids)
    onehot = np.stack(onehots).astype(np.float32)
    for col, arr in ((5, np.asarray(heights, np.float64)),
                     (6, np.asarray(weights, np.float64))):
        obs = arr[~np.isnan(arr)]
        mu = obs.mean() if obs.size else 0.0
        sd = obs.std() if obs.size else 1.0
        onehot[:, col] = np.nan_to_num((arr - mu) / (sd + 1e-7))

    stay_ids = np.asarray(rids, np.int64)
    events = EventTable(
        stay_ids=stay_ids, subject_ids=stay_ids.copy(),
        stay_len=np.full(n, max_hours if binning == "absolute" else n_bins,
                         np.int32),
        offsets=np.asarray(offsets, np.int64),
        slot_idx=np.concatenate(all_slots) if n else np.zeros(0, np.int32),
        values=np.concatenate(all_vals) if n else np.zeros((0, V),
                                                           np.float32),
        counts=np.concatenate(all_cnts) if n else np.zeros((0, V), np.int32))
    static = StaticTable(stay_ids=stay_ids, subject_ids=stay_ids.copy(),
                         age=np.nan_to_num(np.asarray(ages, np.float32)),
                         onehot=onehot,
                         death_adm=np.asarray(deaths, np.float32))
    empty = AnchorTable(np.zeros(0, np.int64), np.zeros(0, np.int64),
                        np.zeros(0, np.int32), np.zeros(0, np.int64),
                        np.zeros((0, 1), np.float32))
    ds = SyntheticDataset(
        events=events, static=static, anchors=empty, cxr_catalog=empty,
        var_names=P12_TS_PARAMS,
        onehot_names=("gender", "icu1", "icu2", "icu3", "icu4",
                      "height_z", "weight_z"),
        latent_by_stay=None, label_weights_true=None)
    meta = meta_from_events(ds, DataConfig(n_timesteps=24),
                            label_col="death_adm")
    return ds, meta


def load_physionet2012(data_dir: str):
    """Real P12 loader: direct raw-file reader (torchtime-free)."""
    return load_physionet2012_raw(data_dir)
