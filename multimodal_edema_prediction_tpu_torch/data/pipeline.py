"""Input pipeline for the training path: the port's counterpart of
``multimodal_edema_prediction_tpu/data/pipeline.py``.

1. **One-time columnar densification** (numpy, runs once): sparse events
   scatter into a dense per-stay grid ``[S, L_max, 2V]`` with z-scored
   values and clipped counts.
2. **Device-resident window gather**: the grid lives on the card; a batch
   of anchor windows is one indexing op inside the train step
   (``gather_windows``). Per-step host work: handing over index arrays.
3. **Anchor construction + aligned subject split** with the semantics of
   ``build_anchors``/``split_anchors`` (reference
   ``training_duett/data_processing.py:137-276``), including the seed-42
   ``train_test_split`` over the CXR catalog, written here in numpy
   (``train_test_split`` below) because the port does not use sklearn.

Multi-process feeding (JAX ``pipeline.py:262-360``): every process builds
the same global batches and keeps its own rows
(``parallel/multihost.split_batch_for_process``), and with
``host_partition_count`` P the global batch is composed of P per-partition
picks (``image_id % P``), so that a rank's rows only name its own images and
its image bank or feature store holds only those.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import DataConfig
from ..parallel.multihost import split_batch_for_process
from .meta import Meta
from .synthetic import AnchorTable, EventTable, StaticTable


def train_test_split(x: np.ndarray, test_size: float, random_state: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """sklearn's unstratified ``train_test_split(x, test_size=...,
    random_state=...)`` for one array: ``ceil(test_size·n)`` test items
    taken first from ``RandomState(random_state).permutation(n)``, the rest
    of the permutation for train. Returns (train, test)."""
    n = len(x)
    n_test = int(math.ceil(test_size * n))
    perm = np.random.RandomState(random_state).permutation(n)
    return x[perm[n_test:]], x[perm[:n_test]]


# =============================================================================
# Dense grid build (prepare_from_raw dense-grid step, mimic_dataset.py:286-294)
# =============================================================================
def densify_events(events: EventTable, meta: Meta, max_len: int,
                   count_clip: int = 15) -> np.ndarray:
    """Scatter sparse events into normalized dense grids [S, max_len, 2V].

    values are z-scored with train-split stats where count>0 (else 0);
    counts are clipped to [0, count_clip].
    """
    S = len(events.stay_ids)
    V = events.values.shape[1]
    grid = np.zeros((S, max_len, 2 * V), np.float32)
    stay_row = np.repeat(np.arange(S), np.diff(events.offsets))
    slot = events.slot_idx.astype(np.int64)
    keep = slot < max_len
    stay_row, slot = stay_row[keep], slot[keep]
    vals, cnts = events.values[keep], events.counts[keep]
    cnts = np.clip(cnts, 0, count_clip).astype(np.float32)
    observed = cnts > 0
    norm = (vals - meta.means[None, :]) / (meta.stds[None, :] + 1e-7)
    grid[stay_row, slot, :V] = np.where(observed, norm, 0.0)
    grid[stay_row, slot, V:] = cnts
    return grid


def encode_static_table(static: StaticTable, meta: Meta) -> np.ndarray:
    """[S, D_STATIC]: z-scored age + one-hots (mimic_dataset.py:49-53)."""
    age = (static.age - meta.age_mean) / (meta.age_std + 1e-7)
    age = np.nan_to_num(age, nan=0.0).astype(np.float32)
    return np.concatenate([age[:, None], static.onehot.astype(np.float32)],
                          axis=1)


def compute_train_stats(events: EventTable, train_stay_mask: np.ndarray,
                        max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Train-split per-variable mean/std over observed cells
    (mimic_dataset.py:308-315; std is the pandas/unbiased estimator)."""
    V = events.values.shape[1]
    stay_row = np.repeat(np.arange(len(events.stay_ids)),
                         np.diff(events.offsets))
    keep = train_stay_mask[stay_row] & (events.slot_idx < max_len)
    vals, cnts = events.values[keep], events.counts[keep]
    means = np.zeros(V, np.float32)
    stds = np.ones(V, np.float32)
    for v in range(V):
        obs = vals[cnts[:, v] > 0, v]
        if len(obs) > 1:
            means[v] = obs.mean()
            stds[v] = obs.std(ddof=1)
    return means, stds


# =============================================================================
# Anchor construction + aligned split (data_processing.py:137-276)
# =============================================================================
def build_anchor_frame(anchors: AnchorTable, cfg: DataConfig,
                       stay_id_to_row: Dict[int, int],
                       stay_len: np.ndarray) -> dict:
    """Filter anchors: labeled main target, slot_idx >= T, stay known.

    U(-1) labels on the main target map to 0 (data_processing.py:162-174);
    aux labels keep NaN → mask.
    Returns dict of aligned arrays incl. per-anchor stay grid row.
    """
    lab = anchors.labels.copy()
    main = lab[:, 0]
    y_e = np.where(np.isnan(main), np.nan,
                   np.where(main == -1.0, 0.0, main)).astype(np.float32)
    keep = ~np.isnan(y_e)
    keep &= anchors.slot_idx >= cfg.n_timesteps
    stay_rows = np.array([stay_id_to_row.get(int(s), -1)
                          for s in anchors.stay_ids])
    keep &= stay_rows >= 0
    keep &= anchors.slot_idx <= stay_len[np.maximum(stay_rows, 0)]

    lab = lab[keep]
    mask = (~np.isnan(lab)).astype(np.float32)
    y_multi = np.where(mask > 0, np.nan_to_num(lab, nan=0.0), 0.0)
    y_multi[:, 0] = y_e[keep]
    return {
        "subject_ids": anchors.subject_ids[keep],
        "stay_rows": stay_rows[keep].astype(np.int32),
        "slot_idx": anchors.slot_idx[keep].astype(np.int32),
        "image_ids": anchors.image_ids[keep],
        "y": y_e[keep],
        "y_multi": y_multi.astype(np.float32),
        "y_multi_mask": mask,
    }


def split_anchors_aligned(anchor_subjects: np.ndarray,
                          catalog_subjects: np.ndarray,
                          catalog_has_label: np.ndarray,
                          seed: int = 42) -> Dict[str, np.ndarray]:
    """Subject-level 70/15/15 split aligned with the CXR-head split.

    Reproduces ``split_anchors`` (data_processing.py:217-276): the pretrained
    head's subject split over the full CXR catalog (seed-42
    ``train_test_split``) is re-derived, then every ICU anchor maps into it.
    Guarantees subject-disjointness between catalog-TRAIN and ICU-TEST.
    """
    cat = catalog_subjects[catalog_has_label]
    # pandas .unique() preserves first-occurrence order; np.unique sorts —
    # keep pandas semantics so the seed-42 split is bit-identical.
    _, first_idx = np.unique(cat, return_index=True)
    subj_all = cat[np.sort(first_idx)]
    train_ids, temp_ids = train_test_split(subj_all, 0.30, seed)
    val_ids, test_ids = train_test_split(temp_ids, 0.50, seed)
    pre = {"train": set(int(x) for x in train_ids),
           "val": set(int(x) for x in val_ids),
           "test": set(int(x) for x in test_ids)}
    idx = np.arange(len(anchor_subjects))
    out = {}
    assigned = 0
    for name, ids in pre.items():
        sel = np.isin(anchor_subjects, list(ids))
        out[name] = idx[sel]
        assigned += int(sel.sum())
    if assigned != len(anchor_subjects):
        raise RuntimeError(
            f"{len(anchor_subjects) - assigned} anchor rows not assigned to "
            "any catalog split — subjects missing from the CXR catalog")
    # subject-disjointness (data_processing.py:263-264)
    for a in ("train", "val", "test"):
        for b in ("train", "val", "test"):
            if a < b:
                sa = set(anchor_subjects[out[a]].tolist())
                sb = set(anchor_subjects[out[b]].tolist())
                if not sa.isdisjoint(sb):
                    raise RuntimeError(f"subject leakage {a}/{b}")
    return out


# =============================================================================
# Procedural images on the device, drawn as jax.random draws them
# =============================================================================
_U32 = 0xFFFFFFFF
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's float32 erf_inv (Giles' polynomials in w = -log1p(-x²), split at
# w = 5), which jax.random.normal lowers to
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds), the block function of JAX's default PRNG,
    on int64 tensors that hold uint32 values (broadcast together)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _U32, (x1 + ks[1]) & _U32
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _U32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _U32
    return x0, x1


def _erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_W_LT5[i], device=x.device),
                           torch.tensor(_ERFINV_W_GE5[i], device=x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_W_LT5)):
        p = coef(i) + p * w
    return p * x


def _normal_from_key(k0: torch.Tensor, k1: torch.Tensor, n: int
                     ) -> torch.Tensor:
    """n float32 normals [..., n] from threefry keys (k0, k1) [...]: the
    partitionable bit stream (a counter over the flat index), the uniform
    in (-1, 1) and √2·erf_inv of JAX 0.9's ``jax.random.normal``."""
    counter = torch.arange(n, dtype=torch.int64, device=k0.device)
    b0, b1 = threefry2x32(k0[..., None], k1[..., None],
                          torch.zeros_like(counter), counter)
    mantissa = ((b0 ^ b1) >> 9) | 0x3F800000
    floats = mantissa.to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    # float32(1 - lo) is 2.0
    u = torch.clamp_min(floats * 2.0 + lo, lo)
    return float(np.float32(np.sqrt(2.0))) * _erf_inv_f32(u)


def jax_normal_f32(image_ids: torch.Tensor, shape: Tuple[int, ...]
                   ) -> torch.Tensor:
    """``jax.random.normal(fold_in(key(0), id), shape)`` (float32) for each
    id, [B, *shape], on the ids' device: the threefry key schedule and
    ``_normal_from_key``. The bits are JAX's exactly; the normals within
    ~1e-6 (``log1p`` and fused multiply-adds round apart)."""
    ids = image_ids.to(torch.int64) & _U32
    zero = torch.zeros_like(ids)
    k0, k1 = threefry2x32(zero, zero, zero, ids)          # fold_in
    return _normal_from_key(k0, k1, math.prod(shape)).reshape(
        len(ids), *shape)


def jax_key(seed: int) -> Tuple[int, int]:
    """``jax.random.key(seed)`` (threefry, seed >= 0) as its two uint32
    words."""
    return (seed >> 32) & _U32, seed & _U32


def jax_split(key: Tuple[int, int], num: int = 2) -> list:
    """``jax.random.split(key, num)`` (the partitionable form of JAX 0.9):
    subkey i is threefry(key, (0, i))."""
    k0, k1 = (torch.tensor(k, dtype=torch.int64) for k in key)
    c = torch.arange(num, dtype=torch.int64)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(c), c)
    return [(int(a), int(b)) for a, b in zip(b0.tolist(), b1.tolist())]


def jax_normal(key: Tuple[int, int], shape: Tuple[int, ...],
               device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32) on ``device``."""
    k0, k1 = (torch.tensor(k, dtype=torch.int64, device=device)
              for k in key)
    return _normal_from_key(k0, k1, math.prod(shape)).reshape(shape)


def synthetic_image_device(image_ids: torch.Tensor, labels: torch.Tensor,
                           size: int = 518) -> torch.Tensor:
    """Procedural 'CXR' [B, size, size, 3] float32 in [0, 1] on the ids'
    device: the JAX package's ``data/pipeline.synthetic_image_device``
    (per-id noise from ``jax.random``, a blob per positive label), which its
    serving ``synthetic`` mode and analysis CLIs draw. Not the host
    generator ``synthetic.synthetic_image_batch`` that the training loops
    use: the two draw their noise differently."""
    dev = image_ids.device
    img = 0.3 + 0.1 * jax_normal_f32(image_ids, (size, size))
    grid = torch.arange(size, dtype=torch.float32, device=dev) / (size - 1)
    yy, xx = grid[:, None], grid[None, :]
    lab = torch.nan_to_num(labels.to(device=dev, dtype=torch.float32))
    for k in range(lab.shape[1]):
        cx = 0.2 + 0.6 * (k % 3) / 2.0
        cy = 0.2 + 0.6 * (k // 3) / 2.0
        blob = torch.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 0.02))
        img = img + torch.where(lab[:, k] > 0.5, 0.5, 0.0)[:, None, None] \
            * blob
    return img.clamp(0.0, 1.0)[..., None].expand(-1, -1, -1, 3)


# =============================================================================
# Device-side window gather + batch iterator
# =============================================================================
def gather_windows(grid: torch.Tensor, stay_rows: torch.Tensor,
                   slot_end: torch.Tensor, n_timesteps: int) -> torch.Tensor:
    """[B] anchors → [B, T, 2V] windows ending at ``slot_end`` (exclusive),
    one indexing op on the grid's device. An out-of-range window start is
    treated as ``jax.lax.dynamic_slice`` treats it, wrapped once if negative
    and then clamped into the grid (anchors built by ``build_anchor_frame``
    never need either)."""
    L = grid.shape[1]
    start = slot_end.long() - n_timesteps
    start = torch.where(start < 0, start + L, start).clamp(0, L - n_timesteps)
    t = start[:, None] + torch.arange(n_timesteps, device=grid.device)
    return grid[stay_rows.long()[:, None], t]


@dataclass
class AnchorDataset:
    """Supervised dataset: grid + static on a device, anchor arrays on the
    host."""
    grid: torch.Tensor           # [S, L, 2V] normalized dense grids
    static: torch.Tensor         # [S, D_STATIC]
    anchor: dict                 # host numpy arrays from build_anchor_frame
    splits: Dict[str, np.ndarray]
    meta: Meta
    n_timesteps: int
    # optional host-side batch transform (e.g. the feature bank's id → row
    # rewrite); applied by iter_batches, to this process's rows only, so
    # trainers and evaluators see the same enriched batches.
    batch_hook: Optional[Callable[[dict], dict]] = None
    # >0: partition samples over this many processes by image_id % P, and
    # build each global batch as the concat of the partitions' picks, so
    # that process p's rows only name ITS OWN images (per-process image
    # banks and feature stores; the anchor arrays stay on every process)
    host_partition_count: int = 0

    def to(self, device) -> "AnchorDataset":
        """Move the grid and the static table to ``device`` (in place)."""
        self.grid = self.grid.to(device)
        self.static = self.static.to(device)
        return self

    @property
    def bin_ends(self) -> np.ndarray:
        return (np.arange(1, self.n_timesteps + 1) / 24.0).astype(np.float32)

    def split_size(self, name: str) -> int:
        return len(self.splits[name])

    def anchor_batch(self, idx: np.ndarray) -> dict:
        """Host-side index slice → small arrays shipped to device."""
        a = self.anchor
        B = len(idx)
        return {
            "stay_rows": a["stay_rows"][idx],
            "slot_idx": a["slot_idx"][idx],
            "image_ids": a["image_ids"][idx].astype(np.int32),
            "y": a["y"][idx],
            "y_multi": a["y_multi"][idx],
            "y_multi_mask": a["y_multi_mask"][idx],
            "bin_ends": np.broadcast_to(self.bin_ends, (B, self.n_timesteps)),
        }

    def iter_batches(self, name: str, batch_size: int, shuffle: bool,
                     seed: int = 0, drop_last: Optional[bool] = None,
                     limit: int = 0) -> Iterator[dict]:
        """Fixed-shape host batches in the JAX package's order (a seeded
        permutation when shuffling; shuffled training drops the ragged tail,
        evaluation pads it with the batch's first row, masked out through
        ``y_multi_mask`` and ``valid``). ``batch_size`` is the GLOBAL batch:
        in a multi-process run each process gets its contiguous rows, the
        labels' global copies under ``_global``, and runs the hook on its
        rows alone."""
        if self.host_partition_count > 0:
            yield from self._iter_batches_partitioned(
                name, batch_size, shuffle, seed, drop_last, limit)
            return
        idx = self.splits[name]
        if shuffle:
            idx = np.random.default_rng(seed).permutation(idx)
        drop = shuffle if drop_last is None else drop_last
        n = len(idx)
        stop = n - (n % batch_size) if drop else n
        count = 0
        for i in range(0, stop, batch_size):
            b = idx[i:i + batch_size]
            if len(b) < batch_size:
                pad = batch_size - len(b)
                batch = self.anchor_batch(
                    np.concatenate([b, b[:1].repeat(pad)]))
                batch["y_multi_mask"][-pad:] = 0.0
                batch["valid"] = np.r_[np.ones(len(b)), np.zeros(pad)
                                       ].astype(np.float32)
            else:
                batch = self.anchor_batch(b)
                batch["valid"] = np.ones(batch_size, np.float32)
            batch = split_batch_for_process(batch)
            if self.batch_hook is not None:
                batch = self.batch_hook(batch)
            yield batch
            count += 1
            if limit and count >= limit:
                return

    def _iter_batches_partitioned(self, name: str, batch_size: int,
                                  shuffle: bool, seed: int,
                                  drop_last: Optional[bool], limit: int
                                  ) -> Iterator[dict]:
        """Partitioned batch composition (JAX ``pipeline.py:306-360``):
        every process computes the same global batches, each the concat of
        the P partitions' next ``batch_size/P`` picks, so that after the
        process split process p's rows name only partition p's images. An
        uneven pool pads with its own first element, masked through
        ``valid`` and ``y_multi_mask``; shuffled training drops each pool's
        ragged tail instead."""
        P = self.host_partition_count
        if batch_size % P:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{P} host partitions")
        local = batch_size // P
        idx = self.splits[name]
        assign = self.anchor["image_ids"][idx] % P
        pools = [idx[assign == p] for p in range(P)]
        for p_i, pool in enumerate(pools):
            if len(pool) == 0:
                raise ValueError(
                    f"host partition {p_i} owns no samples in split "
                    f"{name!r}: too many partitions for this cohort")
        rng = np.random.default_rng(seed)
        if shuffle:
            pools = [rng.permutation(p) for p in pools]
        drop = shuffle if drop_last is None else drop_last
        if drop:
            nb = min(len(p) // local for p in pools)
        else:
            nb = max((len(p) + local - 1) // local for p in pools)
        count = 0
        for i in range(nb):
            picks, valid = [], []
            for p in pools:
                b = p[i * local:(i + 1) * local]
                pad = local - len(b)
                if pad:
                    fill = p[:1] if len(b) == 0 else b[:1]
                    b = np.concatenate([b, np.repeat(fill, pad)])
                picks.append(b)
                valid.append(np.r_[np.ones(local - pad), np.zeros(pad)])
            batch = self.anchor_batch(np.concatenate(picks))
            v = np.concatenate(valid).astype(np.float32)
            batch["valid"] = v
            batch["y_multi_mask"] = batch["y_multi_mask"] * v[:, None]
            batch = split_batch_for_process(batch)
            if self.batch_hook is not None:
                batch = self.batch_hook(batch)
            yield batch
            count += 1
            if limit and count >= limit:
                return


def build_anchor_dataset(dataset, meta: Meta, cfg: DataConfig,
                         max_len: Optional[int] = None) -> AnchorDataset:
    """SyntheticDataset (or same-shaped real ingest) → AnchorDataset on the
    CPU (``AnchorDataset.to`` moves it)."""
    events, static, anchors = dataset.events, dataset.static, dataset.anchors
    L = int(max_len or events.stay_len.max())
    grid = densify_events(events, meta, L, cfg.count_clip)
    static_enc = encode_static_table(static, meta)
    stay_id_to_row = {int(s): i for i, s in enumerate(events.stay_ids)}
    anchor = build_anchor_frame(anchors, cfg, stay_id_to_row, events.stay_len)
    catalog = dataset.cxr_catalog
    has_label = ~np.isnan(catalog.labels).all(axis=1)
    splits = split_anchors_aligned(anchor["subject_ids"],
                                   catalog.subject_ids, has_label,
                                   seed=cfg.split_seed)
    return AnchorDataset(grid=torch.from_numpy(grid),
                         static=torch.from_numpy(static_enc),
                         anchor=anchor, splits=splits, meta=meta,
                         n_timesteps=cfg.n_timesteps)


def meta_from_events(dataset, cfg: DataConfig, label_col: str = "death_adm",
                     train_frac_seed: int = 42) -> Meta:
    """Derive a Meta (train-split stats) from raw events, mirroring
    prepare_from_raw (mimic_dataset.py:254-330) with the subject-level split.
    """
    del train_frac_seed     # unused in the JAX package too; kept for parity
    events, static = dataset.events, dataset.static
    subj = np.unique(static.subject_ids)
    tr_s, tmp_s = train_test_split(subj, 0.30, cfg.split_seed)
    va_s, te_s = train_test_split(tmp_s, 0.50, cfg.split_seed)
    train_mask = np.isin(events.subject_ids, tr_s)
    means, stds = compute_train_stats(events, train_mask,
                                      max_len=int(events.stay_len.max()))
    age_sel = np.isin(static.subject_ids, tr_s)
    age = static.age[age_sel].astype(np.float64)
    split_ids = {
        "train": events.stay_ids[np.isin(events.subject_ids, tr_s)],
        "val": events.stay_ids[np.isin(events.subject_ids, va_s)],
        "test": events.stay_ids[np.isin(events.subject_ids, te_s)],
    }
    return Meta(
        all_vars=dataset.var_names,
        all_counts=tuple(f"count_{v}" for v in dataset.var_names),
        onehot_static=dataset.onehot_names,
        d_static=1 + len(dataset.onehot_names),
        label_col=label_col, n_timesteps=cfg.n_timesteps,
        means=means, stds=stds,
        age_mean=float(age.mean()), age_std=float(age.std(ddof=1)),
        train_ids=split_ids["train"], val_ids=split_ids["val"],
        test_ids=split_ids["test"])
