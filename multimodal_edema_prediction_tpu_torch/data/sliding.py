"""Sliding-window SSL samples: the port's counterpart of
``multimodal_edema_prediction_tpu/data/sliding.py`` (``sliding_samples``,
``SlidingSSLDataset``, ``build_sliding_ssl_dataset``, ``StayLabelDataset``,
``build_stay_label_dataset``; reference ``MIMICSlidingDataset`` and
``MIMICDataset``, duett/mimic_dataset.py:59-155).

One sample per (stay, start) pair, the windows stepping by ``stride`` and
lying wholly inside the stay (capped at ``max_stay_hours``). The dense grid
and the static table live on a device; a batch is host index arrays that
``data/pipeline.gather_windows`` turns into windows there (slot_end =
start + T). ``StayLabelDataset`` is the supervised fine-tuning set: the
first window of each stay and its stay-level label.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..parallel.multihost import split_batch_for_process
from .meta import Meta
from .pipeline import densify_events, encode_static_table


def sliding_samples(stay_len: np.ndarray, stay_rows: np.ndarray,
                    n_timesteps: int, stride: int = 12,
                    max_stay_hours: int = 336) -> np.ndarray:
    """[(stay_row, start)] int32 pairs of the windows inside
    [0, min(stay length, max_stay_hours))."""
    out = []
    for row in stay_rows:
        last = min(int(stay_len[row]), max_stay_hours) - n_timesteps
        out.extend((row, start) for start in range(0, last + 1, stride))
    return np.asarray(out, np.int32).reshape(-1, 2)


@dataclass
class SlidingSSLDataset:
    """SSL dataset over sliding windows: grid and static on a device."""
    grid: torch.Tensor                 # [S, L, 2V]
    static: torch.Tensor               # [S, D_STATIC]
    samples: Dict[str, np.ndarray]     # split → [(stay_row, start)]
    meta: Meta
    n_timesteps: int

    def to(self, device) -> "SlidingSSLDataset":
        """Move the grid and the static table to ``device`` (in place)."""
        self.grid = self.grid.to(device)
        self.static = self.static.to(device)
        return self

    @property
    def bin_ends(self) -> np.ndarray:
        return (np.arange(1, self.n_timesteps + 1) / 24.0).astype(np.float32)

    def split_size(self, name: str) -> int:
        return len(self.samples[name])

    def iter_batches(self, name: str, batch_size: int, shuffle: bool,
                     seed: int = 0, limit: int = 0) -> Iterator[dict]:
        """Fixed-shape host batches in the JAX package's order (a seeded
        permutation when shuffling); the incomplete last batch is dropped.
        ``batch_size`` is the GLOBAL batch: in a multi-process run each
        process gets its contiguous rows (JAX ``sliding.py:52-81``,
        ``parallel/multihost.split_batch_for_process``)."""
        pairs = self.samples[name]
        if shuffle:
            pairs = np.random.default_rng(seed).permutation(pairs)
        n = len(pairs) - (len(pairs) % batch_size)
        for count, i in enumerate(range(0, n, batch_size), start=1):
            b = pairs[i:i + batch_size]
            yield split_batch_for_process({
                "stay_rows": b[:, 0],
                "slot_idx": b[:, 1] + self.n_timesteps,   # slot_end
                "bin_ends": np.broadcast_to(
                    self.bin_ends, (batch_size, self.n_timesteps))})
            if limit and count >= limit:
                return


@dataclass
class StayLabelDataset(SlidingSSLDataset):
    """First window of each stay with a per-stay label (reference
    ``MIMICDataset``, duett/mimic_dataset.py:59-91: the label is
    ``death_adm`` of the static frame)."""
    labels: Optional[np.ndarray] = None    # [S] float32, by grid row

    def iter_batches(self, name: str, batch_size: int, shuffle: bool,
                     seed: int = 0, limit: int = 0) -> Iterator[dict]:
        for b in super().iter_batches(name, batch_size, shuffle, seed, limit):
            b["y"] = self.labels[b["stay_rows"]]
            if "_global" in b:   # multi-process: the global labels, for eval
                b["_global"]["y"] = self.labels[b["_global"]["stay_rows"]]
            yield b

    def pos_frac(self, name: str = "train") -> float:
        """The positive share over the split's unique stays."""
        rows = np.unique(self.samples[name][:, 0])
        return float(self.labels[rows].mean()) if len(rows) else 0.0


def build_stay_label_dataset(dataset, meta: Meta, n_timesteps: int = 24,
                             max_len: Optional[int] = None
                             ) -> StayLabelDataset:
    """One first ``n_timesteps``-hour window per stay and its ``death_adm``
    label (the reference's prepare_from_raw path, mimic_dataset.py:254-330),
    on the CPU."""
    base = build_sliding_ssl_dataset(dataset, meta, n_timesteps,
                                     stride=10 ** 9,   # start 0 only
                                     max_stay_hours=n_timesteps,
                                     max_len=max_len or n_timesteps)
    return StayLabelDataset(
        grid=base.grid, static=base.static, samples=base.samples,
        meta=base.meta, n_timesteps=base.n_timesteps,
        labels=dataset.static.death_adm.astype(np.float32))


def build_sliding_ssl_dataset(dataset, meta: Meta, n_timesteps: int = 24,
                              stride: int = 12, max_stay_hours: int = 336,
                              max_len: Optional[int] = None
                              ) -> SlidingSSLDataset:
    """A synthetic cohort (or a same-shaped ingest) → the sliding SSL
    dataset over meta's stay splits, on the CPU (``to`` moves it). Cohort
    filter: stays of at least ``n_timesteps`` hours
    (mimic_dataset.py:188-195)."""
    events, static = dataset.events, dataset.static
    L = int(min(max_len or events.stay_len.max(), max_stay_hours))
    grid = densify_events(events, meta, L)
    id_to_row = {int(s): i for i, s in enumerate(events.stay_ids)}
    samples = {}
    for name, ids in (("train", meta.train_ids), ("val", meta.val_ids),
                      ("test", meta.test_ids)):
        rows = np.asarray([id_to_row[int(s)] for s in ids
                           if int(s) in id_to_row], np.int32)
        keep = events.stay_len[rows] >= n_timesteps
        samples[name] = sliding_samples(events.stay_len, rows[keep],
                                        n_timesteps, stride, max_stay_hours)
    return SlidingSSLDataset(
        grid=torch.from_numpy(grid),
        static=torch.from_numpy(encode_static_table(static, meta)),
        samples=samples, meta=meta, n_timesteps=n_timesteps)
