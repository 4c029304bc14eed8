"""Synthetic raw-MIMIC directory generator: the standing rehearsal cohort.

The port's counterpart of ``multimodal_edema_prediction_tpu/data/
synthetic_raw.py``, without pandas or PIL. It writes a tiny directory laid
out exactly like a raw MIMIC-IV + MIMIC-CXR download (``hosp/``, ``icu/``,
``cxr/`` CSVs), so that the whole offline chain (``cli.preprocess``, then
every training CLI) runs with no PHI. For the same ``n_subjects``,
``stay_hours`` and ``seed`` its CSVs are byte-equal to the JAX package's:
the same ``default_rng`` draws in the same order, written as
``DataFrame.to_csv`` writes them (:func:`.frames.write_csv`).

The cohort is deliberately adversarial where the notebook rules have
teeth: Fahrenheit temperatures, FiO2 charted as a fraction, an impossible
heart rate the outlier criteria must drop, a pre-ICU ward lab draw that
must backfill slot 0, an instantaneous bolus next to an infusion, and a
LATERAL view the CXR filter must reject.

Usage:
    python -m multimodal_edema_prediction_tpu_torch.data.synthetic_raw \\
        --out /tmp/raw [--n_subjects 24] [--jpegs_for /path/to/artifacts]
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List

import numpy as np

from . import frames as F
from .jpeg_writer import encode_gray
from .raw_mimic import CHEXPERT_TO_LABEL

H = np.timedelta64(1, "h")
M = np.timedelta64(1, "m")
NAT = np.datetime64("NaT", "ns")

__all__ = ["make_raw_layout", "write_jpegs_for_artifacts"]

TABLES = ("hosp/admissions", "hosp/patients", "hosp/labevents",
          "icu/icustays", "icu/chartevents", "icu/inputevents",
          "icu/outputevents", "cxr/mimic-cxr-2.0.0-metadata",
          "cxr/mimic-cxr-2.0.0-chexpert", "cxr/CXLSeg-mask")


def _write(root: str, rel: str, rows: List[dict]) -> None:
    """``pd.DataFrame(rows).to_csv(index=False)``: the columns in the order
    the row dicts give them, each of the dtype its values make (ints,
    floats, datetimes with NaT, strings)."""
    frame = {}
    for c in dict.fromkeys(k for r in rows for k in r):
        col = np.array([r[c] for r in rows])
        frame[c] = col.astype(object) if col.dtype.kind == "U" else col
    p = os.path.join(root, rel + ".csv")
    os.makedirs(os.path.dirname(p), exist_ok=True)
    F.write_csv(p, frame)


def _study_date_time(ct: np.datetime64):
    """``int(strftime("%Y%m%d"))`` and ``float(strftime("%H%M%S"))``."""
    day = ct.astype("datetime64[D]")
    sec = int((ct - day) // np.timedelta64(1, "s"))
    hh, mm, ss = sec // 3600, (sec // 60) % 60, sec % 60
    return (int(str(day).replace("-", "")),
            float(f"{hh:02d}{mm:02d}{ss:02d}"))


def make_raw_layout(root, n_subjects=24, stay_hours=40, seed=0):
    """Tiny raw cohort: one stay per subject, hourly vitals, labs with a
    pre-ICU ward draw, an infusion + bolus, urine records, and 2 CXRs per
    stay (one anchor-eligible at slot >= 24, plus a lateral that must be
    dropped)."""
    rng = np.random.default_rng(seed)
    base = np.datetime64("2150-03-01T08:00", "ns")
    tables: Dict[str, List[dict]] = {rel: [] for rel in TABLES}
    adm_rows, pat_rows = tables["hosp/admissions"], tables["hosp/patients"]
    icu_rows, lab = tables["icu/icustays"], tables["hosp/labevents"]
    chart, inputs = tables["icu/chartevents"], tables["icu/inputevents"]
    outputs = tables["icu/outputevents"]
    meta_rows = tables["cxr/mimic-cxr-2.0.0-metadata"]
    chex_rows = tables["cxr/mimic-cxr-2.0.0-chexpert"]

    for i in range(n_subjects):
        sid, hid, stid = 10 + i, 100 + i, 1000 + i
        admit = base + i * np.timedelta64(3, "D")
        intime = admit + 2 * H
        outtime = intime + stay_hours * H
        disch = outtime + 5 * H
        died = i == 1
        adm_rows.append({
            "subject_id": sid, "hadm_id": hid, "admittime": admit,
            "dischtime": disch,
            "deathtime": disch if died else NAT,
            "admission_type": "EW EMER." if i % 2 else "ELECTIVE",
            "admission_location": "EMERGENCY ROOM",
            "discharge_location": "DIED" if died else "HOME",
            "insurance": "Medicare", "marital_status": "SINGLE",
            "race": "WHITE" if i % 3 else "BLACK/AFRICAN AMERICAN",
            "hospital_expire_flag": int(died)})
        pat_rows.append({
            "subject_id": sid, "gender": "M" if i % 2 else "F",
            "anchor_age": 50 + i, "anchor_year": 2150,
            "dod": disch if died else NAT})
        icu_rows.append({
            "subject_id": sid, "hadm_id": hid, "stay_id": stid,
            "first_careunit": "Medical Intensive Care Unit (MICU)",
            "last_careunit": "Medical Intensive Care Unit (MICU)",
            "intime": intime, "outtime": outtime,
            "los": stay_hours / 24.0})

        for t in range(stay_hours):
            ct = intime + t * H + 10 * M
            chart.append({"subject_id": sid, "hadm_id": hid,
                          "stay_id": stid, "charttime": ct,
                          "itemid": 220045,
                          "valuenum": 70 + 10 * np.sin(t / 5) + i,
                          "valueuom": "bpm"})
            if t % 4 == 0:   # temperature charted in Fahrenheit
                chart.append({"subject_id": sid, "hadm_id": hid,
                              "stay_id": stid, "charttime": ct,
                              "itemid": 223761, "valuenum": 98.6 + 0.1 * i,
                              "valueuom": "°F"})
            if t % 2 == 0:   # arterial + noninvasive BP
                sbp = 115 + rng.normal(0, 3)
                dbp = 70 + rng.normal(0, 2)
                for iid, v in ((220050, sbp), (220051, dbp)):
                    chart.append({"subject_id": sid, "hadm_id": hid,
                                  "stay_id": stid, "charttime": ct,
                                  "itemid": iid, "valuenum": v,
                                  "valueuom": "mmHg"})
            if t % 6 == 0:   # complete GCS triple
                for iid, v in ((220739, 4), (223900, 5), (223901, 6)):
                    chart.append({"subject_id": sid, "hadm_id": hid,
                                  "stay_id": stid, "charttime": ct,
                                  "itemid": iid, "valuenum": v,
                                  "valueuom": "points"})
            if t % 3 == 0:   # SpO2 + FiO2 charted as a FRACTION
                chart.append({"subject_id": sid, "hadm_id": hid,
                              "stay_id": stid, "charttime": ct,
                              "itemid": 220277, "valuenum": 96.0,
                              "valueuom": "%"})
                chart.append({"subject_id": sid, "hadm_id": hid,
                              "stay_id": stid, "charttime": ct,
                              "itemid": 223835, "valuenum": 0.40,
                              "valueuom": "fraction"})

        # an impossible heart rate that the criteria table must drop
        chart.append({"subject_id": sid, "hadm_id": hid, "stay_id": stid,
                      "charttime": intime + 5 * H + 20 * M,
                      "itemid": 220045, "valuenum": 400.0,
                      "valueuom": "bpm"})

        # labs: sodium every 12 h in-ICU, one ward draw 6 h BEFORE intime
        for t in range(0, stay_hours, 12):
            lab.append({"subject_id": sid, "hadm_id": hid,
                        "charttime": intime + t * H + 30 * M,
                        "itemid": 50983, "valuenum": 140 + i,
                        "valueuom": "mEq/L"})
        lab.append({"subject_id": sid, "hadm_id": hid,
                    "charttime": intime - 6 * H, "itemid": 50912,
                    "valuenum": 1.0 + 0.1 * i, "valueuom": "mg/dL"})

        # crystalloid: 4-hour infusion + an instantaneous bolus, in L once
        inputs.append({"subject_id": sid, "hadm_id": hid, "stay_id": stid,
                       "starttime": intime + 2 * H, "endtime": intime + 6 * H,
                       "itemid": 225158, "amount": 1.0 if i == 0 else 1000.0,
                       "amountuom": "L" if i == 0 else "ml"})
        inputs.append({"subject_id": sid, "hadm_id": hid, "stay_id": stid,
                       "starttime": intime + 10 * H + 15 * M,
                       "endtime": intime + 10 * H + 15 * M,
                       "itemid": 225158, "amount": 250.0,
                       "amountuom": "ml"})

        # urine foley records every 4 h
        for t in range(4, stay_hours, 4):
            outputs.append({"subject_id": sid, "hadm_id": hid,
                            "stay_id": stid, "charttime": intime + t * H,
                            "itemid": 226559, "value": 200.0 + 10 * i,
                            "valueuom": "ml"})

        # CXRs: anchor at slot 30 (AP), early one at slot 2 (PA),
        # plus a LATERAL that the view filter must drop
        for k, (view, slot) in enumerate(
                (("AP", 30), ("PA", 2), ("LATERAL", 31))):
            ct = intime + slot * H + 5 * M
            date, time_ = _study_date_time(ct)
            meta_rows.append({
                "subject_id": sid, "study_id": 5000 + 10 * i + k,
                "dicom_id": f"im{i}_{k}", "ViewPosition": view,
                "StudyDate": date, "StudyTime": time_})
            row = {"subject_id": sid, "study_id": 5000 + 10 * i + k}
            for c in CHEXPERT_TO_LABEL:
                row[c] = float(rng.choice([0.0, 1.0, -1.0, np.nan],
                                          p=[0.4, 0.4, 0.1, 0.1]))
            row["Edema"] = float(i % 2)      # main target always labeled
            chex_rows.append(row)

    # CXLSeg lung masks for the AP images only — the PA/LATERAL rows stay
    # unmatched so the left-join semantics (null path, has_lung_mask=False)
    # are exercised end-to-end (cxr_db cells 2-8 + 30)
    tables["cxr/CXLSeg-mask"] = [
        {"subject_id": r["subject_id"], "study_id": r["study_id"],
         "dicom_id": r["dicom_id"], "DicomPath": f"{r['dicom_id']}.png"}
        for r in meta_rows if r["ViewPosition"] == "AP"]
    for rel, rows in tables.items():
        _write(root, rel, rows)
    return root


def write_jpegs_for_artifacts(artifacts_dir: str, out_root: str,
                              side: int = 96, seed: int = 7) -> int:
    """One tiny distinct JPEG per catalog image id of a produced cohort,
    in the ``JpegStore`` ``{root}/{id}.jpg`` layout — lets the rehearsal
    drive the real-JPEG training tier (``--cxr_jpeg_root``) without
    MIMIC-CXR files. The pixels are JAX's (the same draws); the files are
    grayscale baseline JPEGs from :func:`.jpeg_writer.encode_gray`, where
    JAX's are PIL's RGB ones. Returns the number written."""
    z = np.load(os.path.join(artifacts_dir, "cohort.npz"),
                allow_pickle=False)
    ids = np.unique(np.concatenate(
        [np.asarray(z["cat_image_ids"], np.int64),
         np.asarray(z["an_image_ids"], np.int64)]))
    ids = ids[ids >= 0]
    os.makedirs(out_root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in ids:
        arr = (rng.random((side, side)) * 255).astype(np.uint8)
        with open(os.path.join(out_root, f"{int(i)}.jpg"), "wb") as f:
            f.write(encode_gray(arr, quality=90))
    return len(ids)


def main(argv=None):
    ap = argparse.ArgumentParser("synthetic raw-MIMIC layout generator")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n_subjects", type=int, default=24)
    ap.add_argument("--stay_hours", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jpegs_for", default="",
                    help="artifacts dir of a finished preprocess run: "
                         "write {id}.jpg files into --out instead of CSVs")
    args = ap.parse_args(argv)
    if args.jpegs_for:
        n = write_jpegs_for_artifacts(args.jpegs_for, args.out)
        print(f"[synthetic_raw] wrote {n} JPEGs to {args.out}")
    else:
        make_raw_layout(args.out, args.n_subjects, args.stay_hours,
                        args.seed)
        print(f"[synthetic_raw] raw MIMIC-style layout at {args.out}")


if __name__ == "__main__":
    main()
