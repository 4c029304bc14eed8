"""Synthetic MIMIC-like multimodal dataset with learnable structure.

Real MIMIC-IV / MIMIC-CXR artifacts are private; this module generates tables
with the exact schema the reference pipelines consume (events grid, static
frame, CXR anchors with 7 partially-missing CheXpert labels), plus procedural
chest-"X-ray" images, all driven by a shared latent patient state so that
every branch (TS, image, fusion) has real signal to learn:

    z ~ N(0, I_4) per stay
    labels[k] = Bernoulli(sigmoid(w_k · z + b_k)), NaN-masked at random
    TS variables load on z through a sparse factor matrix + observation noise
    images contain label-dependent intensity blobs

Used by tests and benchmarks; the real-data loaders in :mod:`.ingest` accept
the same columnar format. The port's numpy copy of
``multimodal_edema_prediction_tpu/data/synthetic.py``: the same seed gives
the same tables and pixels in both packages (``tests/test_torch_data.py``).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..config import DEFAULT_PATHOLOGY_LABELS

N_LATENT = 4


@dataclass
class EventTable:
    """Sparse per-(stay, slot) observations, row-major by stay."""
    stay_ids: np.ndarray        # [S] int64
    subject_ids: np.ndarray     # [S] int64 (aligned with stay_ids)
    stay_len: np.ndarray        # [S] int32 — dense grid length per stay
    offsets: np.ndarray         # [S+1] int64 into the row arrays
    slot_idx: np.ndarray        # [N] int32
    values: np.ndarray          # [N, V] float32 (raw units)
    counts: np.ndarray          # [N, V] int32


@dataclass
class StaticTable:
    stay_ids: np.ndarray        # [S]
    subject_ids: np.ndarray     # [S]
    age: np.ndarray             # [S] float32 (raw years)
    onehot: np.ndarray          # [S, D-1] float32
    death_adm: np.ndarray       # [S] float32 {0,1}


@dataclass
class AnchorTable:
    """One row per CXR event (cxr_flag==1 rows of final_df)."""
    subject_ids: np.ndarray     # [A]
    stay_ids: np.ndarray        # [A]
    slot_idx: np.ndarray        # [A] int32 — anchor slot e (window = [e-T, e))
    image_ids: np.ndarray       # [A] int64 — procedural image seed / dicom key
    labels: np.ndarray          # [A, K] float32 with NaN for missing


@dataclass
class SyntheticDataset:
    events: EventTable
    static: StaticTable
    anchors: AnchorTable
    cxr_catalog: AnchorTable    # the "240k-image" table the split aligns to
    var_names: Tuple[str, ...]
    onehot_names: Tuple[str, ...]
    latent_by_stay: np.ndarray  # [S, N_LATENT] (ground truth, for diagnostics)
    label_weights_true: np.ndarray


def make_synthetic(seed: int = 0, n_subjects: int = 120, n_stays: int = 150,
                   n_variables: int = 34, min_len: int = 26, max_len: int = 72,
                   n_extra_cxr: int = 300,
                   pathology_labels=DEFAULT_PATHOLOGY_LABELS,
                   obs_rate: float = 0.35, label_missing: float = 0.15,
                   ) -> SyntheticDataset:
    rng = np.random.default_rng(seed)
    K = len(pathology_labels)
    V = n_variables

    subj_of_stay = rng.integers(0, n_subjects, size=n_stays)
    stay_ids = np.arange(1000, 1000 + n_stays, dtype=np.int64)
    stay_len = rng.integers(min_len, max_len + 1, size=n_stays).astype(np.int32)

    z = rng.normal(size=(n_stays, N_LATENT)).astype(np.float32)

    # --- time series: sparse observations loading on z ---
    load = rng.normal(size=(N_LATENT, V)).astype(np.float32)
    load *= (rng.random((N_LATENT, V)) < 0.5)           # sparse factor loadings
    base = rng.normal(loc=2.0, scale=1.0, size=V).astype(np.float32)
    scale = rng.uniform(0.5, 3.0, size=V).astype(np.float32)

    rows_slot, rows_val, rows_cnt, offsets = [], [], [], [0]
    for s in range(n_stays):
        L = int(stay_len[s])
        t = np.arange(L, dtype=np.float32)
        drift = np.sin(t[:, None] / 10.0 + rng.random(V)[None, :] * 6.28)
        signal = z[s] @ load                              # [V]
        mean_tv = base + scale * (signal[None, :] * (t[:, None] / L) + 0.3 * drift)
        observed = rng.random((L, V)) < obs_rate
        # at least one observation per slot to mirror the dense-grid cohort
        observed[rng.integers(0, L), rng.integers(0, V)] = True
        counts = np.where(observed,
                          1 + rng.poisson(1.0, size=(L, V)), 0).astype(np.int32)
        vals = np.where(observed,
                        mean_tv + rng.normal(scale=0.5, size=(L, V)) * scale,
                        0.0).astype(np.float32)
        keep = observed.any(axis=1)
        rows_slot.append(np.nonzero(keep)[0].astype(np.int32))
        rows_val.append(vals[keep])
        rows_cnt.append(counts[keep])
        offsets.append(offsets[-1] + int(keep.sum()))

    events = EventTable(
        stay_ids=stay_ids, subject_ids=subj_of_stay.astype(np.int64),
        stay_len=stay_len, offsets=np.asarray(offsets, np.int64),
        slot_idx=np.concatenate(rows_slot), values=np.concatenate(rows_val),
        counts=np.concatenate(rows_cnt))

    # --- static ---
    n_onehot = 17
    onehot = (rng.random((n_stays, n_onehot)) < 0.3).astype(np.float32)
    age = rng.uniform(25, 90, size=n_stays).astype(np.float32)
    death = (1 / (1 + np.exp(-(z[:, 0] - 0.8)))
             > rng.random(n_stays)).astype(np.float32)
    static = StaticTable(stay_ids=stay_ids, subject_ids=subj_of_stay,
                         age=age, onehot=onehot, death_adm=death)

    # --- label model ---
    w = rng.normal(size=(K, N_LATENT)).astype(np.float32) * 1.5
    b = rng.normal(size=K).astype(np.float32) * 0.3 - 0.5

    def sample_labels(zrow, n):
        p = 1 / (1 + np.exp(-(zrow @ w.T + b)))
        lab = (rng.random((n, K)) < p).astype(np.float32)
        lab[rng.random((n, K)) < label_missing] = np.nan
        return lab

    # --- anchors: 1-3 CXR events per stay at slots >= 24 where possible ---
    a_subj, a_stay, a_slot, a_img, a_lab = [], [], [], [], []
    img_id = 50_000
    for s in range(n_stays):
        L = int(stay_len[s])
        if L < 25:
            continue
        n_cxr = rng.integers(1, 4)
        slots = rng.integers(24, L, size=n_cxr)
        lab = sample_labels(z[s][None, :], n_cxr)
        for j in range(n_cxr):
            a_subj.append(int(subj_of_stay[s]))
            a_stay.append(int(stay_ids[s]))
            a_slot.append(int(slots[j]))
            a_img.append(img_id)
            img_id += 1
        a_lab.append(lab)
    anchors = AnchorTable(
        subject_ids=np.asarray(a_subj, np.int64),
        stay_ids=np.asarray(a_stay, np.int64),
        slot_idx=np.asarray(a_slot, np.int32),
        image_ids=np.asarray(a_img, np.int64),
        labels=np.concatenate(a_lab, axis=0) if a_lab else
        np.zeros((0, K), np.float32))

    # --- the big CXR catalog the aligned split is derived from ---
    # includes every anchor subject plus extra non-ICU subjects
    extra_subj = rng.integers(0, n_subjects, size=n_extra_cxr)
    cat_subj = np.concatenate([anchors.subject_ids, extra_subj])
    z_subj = np.zeros((n_subjects, N_LATENT), np.float32)
    for s in range(n_stays):
        z_subj[subj_of_stay[s]] = z[s]
    cat_lab = sample_labels(z_subj[cat_subj], len(cat_subj))
    cxr_catalog = AnchorTable(
        subject_ids=cat_subj.astype(np.int64),
        stay_ids=np.full(len(cat_subj), -1, np.int64),
        slot_idx=np.zeros(len(cat_subj), np.int32),
        image_ids=np.arange(90_000, 90_000 + len(cat_subj), dtype=np.int64),
        labels=cat_lab)

    var_names = tuple(f"var_{i:02d}" for i in range(V))
    onehot_names = tuple(f"onehot_{i:02d}" for i in range(n_onehot))
    return SyntheticDataset(events=events, static=static, anchors=anchors,
                            cxr_catalog=cxr_catalog, var_names=var_names,
                            onehot_names=onehot_names, latent_by_stay=z,
                            label_weights_true=w)


def synthetic_image_batch(rng: np.ndarray, image_ids: np.ndarray,
                          labels: np.ndarray, size: int = 518,
                          mean=None, std=None) -> np.ndarray:
    """Procedural 'CXR' images [B, H, W, 3] with label-dependent structure.

    The port's synthetic pixel source for both image tiers. (The JAX
    package's training loop draws its synthetic pixels on the device from
    ``jax.random`` instead; parity tests feed both packages these.) With
    ``mean`` and ``std`` each image is normalized in place, ``(px - mean)
    / std`` over the channel axis. The images are drawn on a pool of host
    threads, one image a task: each has its own generator (seeded by its
    id) and its own rows of the output, so the result does not depend on
    the number of threads.
    """
    B = len(image_ids)
    out = np.empty((B, size, size, 3), np.float32)
    if B == 0:
        return out
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    lab = np.nan_to_num(np.asarray(labels), nan=0.0) > 0.5
    blobs = {}      # label k's blob, the same for every image: made once
    for k in np.nonzero(lab.any(axis=0))[0].tolist():
        cx = 0.2 + 0.6 * (k % 3) / 2.0
        cy = 0.2 + 0.6 * (k // 3) / 2.0
        blobs[k] = 0.5 * np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 0.02))

    def draw(i: int) -> None:
        r = np.random.default_rng(int(image_ids[i]))
        img = 0.3 + 0.1 * r.normal(size=(size, size)).astype(np.float32)
        for k in np.nonzero(lab[i])[0].tolist():
            img += blobs[k]
        out[i] = np.clip(img, 0, 1)[..., None]
        if mean is not None:
            out[i] -= mean
            out[i] /= std

    workers = min(B, len(os.sched_getaffinity(0)))
    if workers == 1:
        draw(0)
    else:
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(draw, range(B)))
    return out
