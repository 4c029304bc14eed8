"""Reference artifact frames → columnar cohort, and back from disk: the
port's counterpart of ``multimodal_edema_prediction_tpu/data/ingest.py``.

``from_reference_frames`` converts the L0 chain's frames (``final_df`` /
``static_full`` / ``final_cxr_df``, as the dicts of numpy columns of
:mod:`.frames`) into the columnar tables once; ``save_npz`` writes them.
``cohort.npz`` holds plain arrays (read without pickle);
``meta_with_stats.pkl`` is the reference's meta dict of names, floats and
numpy arrays, with no class of either package in it (a ``.json`` meta reads
too). The port's own ``cli.preprocess`` writes both from a raw MIMIC-IV +
MIMIC-CXR layout.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from . import frames as F
from .meta import Meta
from .synthetic import AnchorTable, EventTable, StaticTable


@dataclass
class IngestedDataset:
    """Duck-typed like SyntheticDataset for build_anchor_dataset()."""
    events: EventTable
    static: StaticTable
    anchors: AnchorTable
    cxr_catalog: AnchorTable
    var_names: Tuple[str, ...]
    onehot_names: Tuple[str, ...]


def save_npz(path: str, ds: IngestedDataset):
    np.savez_compressed(
        path,
        ev_stay_ids=ds.events.stay_ids, ev_subject_ids=ds.events.subject_ids,
        ev_stay_len=ds.events.stay_len, ev_offsets=ds.events.offsets,
        ev_slot_idx=ds.events.slot_idx, ev_values=ds.events.values,
        ev_counts=ds.events.counts,
        st_stay_ids=ds.static.stay_ids, st_subject_ids=ds.static.subject_ids,
        st_age=ds.static.age, st_onehot=ds.static.onehot,
        st_death=ds.static.death_adm,
        an_subject_ids=ds.anchors.subject_ids, an_stay_ids=ds.anchors.stay_ids,
        an_slot_idx=ds.anchors.slot_idx, an_image_ids=ds.anchors.image_ids,
        an_labels=ds.anchors.labels,
        cat_subject_ids=ds.cxr_catalog.subject_ids,
        cat_image_ids=ds.cxr_catalog.image_ids,
        cat_labels=ds.cxr_catalog.labels,
        var_names=np.asarray(ds.var_names),
        onehot_names=np.asarray(ds.onehot_names))


def load_npz(path: str) -> IngestedDataset:
    z = np.load(path, allow_pickle=False)
    n_cat = len(z["cat_subject_ids"])
    return IngestedDataset(
        events=EventTable(z["ev_stay_ids"], z["ev_subject_ids"],
                          z["ev_stay_len"], z["ev_offsets"],
                          z["ev_slot_idx"], z["ev_values"], z["ev_counts"]),
        static=StaticTable(z["st_stay_ids"], z["st_subject_ids"],
                           z["st_age"], z["st_onehot"], z["st_death"]),
        anchors=AnchorTable(z["an_subject_ids"], z["an_stay_ids"],
                            z["an_slot_idx"], z["an_image_ids"],
                            z["an_labels"]),
        cxr_catalog=AnchorTable(z["cat_subject_ids"],
                                np.full(n_cat, -1, np.int64),
                                np.zeros(n_cat, np.int32),
                                z["cat_image_ids"], z["cat_labels"]),
        var_names=tuple(str(v) for v in z["var_names"]),
        onehot_names=tuple(str(v) for v in z["onehot_names"]))


def _matrix(df: F.Frame, cols, n: int) -> np.ndarray:
    """``df[cols].to_numpy(np.float32)``."""
    return np.stack([df[c] for c in cols], 1).astype(np.float32) if cols \
        else np.zeros((n, 0), np.float32)


def from_reference_frames(final_df: F.Frame, static_df: F.Frame,
                          cxr_df: F.Frame, meta: Meta,
                          pathology_labels) -> IngestedDataset:
    """Convert the reference frames (final_df / static_full / final_cxr_df)
    into columnar tables, as JAX's ``from_reference_frames`` does with
    DataFrames. Mirrors the column contracts of
    ``training_duett/data_processing.py:137-214`` and
    ``duett/mimic_dataset.py:33-53``."""
    var_names = list(meta.all_vars)
    count_cols = list(meta.all_counts)

    final_df = F.sort_values(final_df, ["stay_id", "slot_idx"])
    n = F.nrows(final_df)
    codes, first = F.group_rows([final_df["stay_id"]])
    stay_ids = final_df["stay_id"][first].astype(np.int64)
    sdf = F.drop_duplicates(static_df, ["stay_id"])
    row_of = {int(s): i for i, s in enumerate(sdf["stay_id"])}

    slots = final_df["slot_idx"].astype(np.int32)
    vals = _matrix(final_df, var_names, n)
    cnts = _matrix(final_df, count_cols, n)
    keep = np.nan_to_num(cnts, nan=0.0).sum(axis=1) > 0
    # the frame is sorted by stay: each stay's rows are one run
    ends = np.r_[first[1:], n] if len(first) else first
    stay_len = np.array([int(slots[a:b].max()) + 1
                         for a, b in zip(first, ends)], np.int32)
    offsets = np.r_[0, np.cumsum(np.bincount(codes[keep],
                                             minlength=len(first)))]
    subj_ids = np.array([int(sdf["subject_id"][row_of[int(s)]])
                         if int(s) in row_of else -1 for s in stay_ids],
                        np.int64)
    events = EventTable(
        stay_ids=stay_ids, subject_ids=subj_ids, stay_len=stay_len,
        offsets=offsets.astype(np.int64), slot_idx=slots[keep],
        values=np.nan_to_num(vals[keep], nan=0.0),
        counts=np.nan_to_num(cnts[keep], nan=0.0).astype(np.int32))

    onehot_names = list(meta.onehot_static)
    srows = F.take(sdf, np.array([row_of[int(s)] for s in stay_ids
                                  if int(s) in row_of], np.int64))
    k = F.nrows(srows)
    static = StaticTable(
        stay_ids=srows["stay_id"].astype(np.int64),
        subject_ids=srows["subject_id"].astype(np.int64),
        age=srows["age_at_intime"].astype(np.float32),
        onehot=_matrix(srows, onehot_names, k),
        death_adm=(srows[meta.label_col].astype(np.float32)
                   if meta.label_col in srows else np.zeros(k, np.float32)))

    cxr_rows = F.take(final_df, final_df["cxr_flag"] == 1)
    a = F.nrows(cxr_rows)
    anchors = AnchorTable(
        subject_ids=cxr_rows["subject_id"].astype(np.int64),
        stay_ids=cxr_rows["stay_id"].astype(np.int64),
        slot_idx=cxr_rows["slot_idx"].astype(np.int32),
        image_ids=np.arange(a, dtype=np.int64),
        labels=_matrix(cxr_rows, list(pathology_labels), a))

    cat = F.drop_duplicates(cxr_df, ["dicom_id"])
    c = F.nrows(cat)
    catalog = AnchorTable(
        subject_ids=cat["subject_id"].astype(np.int64),
        stay_ids=np.full(c, -1, np.int64),
        slot_idx=np.zeros(c, np.int32),
        image_ids=np.arange(c, dtype=np.int64),
        labels=_matrix(cat, list(pathology_labels), c))

    return IngestedDataset(events=events, static=static, anchors=anchors,
                           cxr_catalog=catalog, var_names=tuple(var_names),
                           onehot_names=tuple(onehot_names))


def load_artifacts(data_dir: str) -> Tuple[IngestedDataset, Meta]:
    """``cohort.npz`` + ``meta_with_stats.pkl`` from ``data_dir``."""
    npz = os.path.join(data_dir, "cohort.npz")
    if not os.path.exists(npz):
        raise FileNotFoundError(
            f"{npz} not found: make it from a raw MIMIC-IV + MIMIC-CXR "
            "layout with python -m multimodal_edema_prediction_tpu_torch"
            ".cli.preprocess --raw_root <dir> --out_dir <data_dir>")
    return load_npz(npz), Meta.load(os.path.join(data_dir,
                                                 "meta_with_stats.pkl"))
