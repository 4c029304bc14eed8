"""Read a converted cohort: the port's counterpart of ``load_npz`` and
``load_artifacts`` in ``multimodal_edema_prediction_tpu/data/ingest.py``.

``cohort.npz`` holds plain arrays (read without pickle);
``meta_with_stats.pkl`` is the reference's meta dict of names, floats and
numpy arrays, with no class of either package in it (a ``.json`` meta reads
too). Converting reference frames into these files is ROADMAP P21; until
then the port reads what the JAX package's preprocessing writes.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np

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


def load_artifacts(data_dir: str) -> Tuple[IngestedDataset, Meta]:
    """``cohort.npz`` + ``meta_with_stats.pkl`` from ``data_dir``."""
    npz = os.path.join(data_dir, "cohort.npz")
    if not os.path.exists(npz):
        raise FileNotFoundError(
            f"{npz} not found: convert the reference artifacts with the JAX "
            "package's preprocessing first (ROADMAP P21)")
    return load_npz(npz), Meta.load(os.path.join(data_dir,
                                                 "meta_with_stats.pkl"))
