"""CXR image store and the image feed tiers: the port's counterpart of
``multimodal_edema_prediction_tpu/data/images.py`` (and of
``train/teacher_loop.py::make_bank_image_source``).

- ``JpegStore`` maps image_id → JPEG bytes (``{root}/{image_id}.jpg``, or an
  in-memory dict).
- ``decode_batch`` / ``decode_batch_u8`` decode, resize and (float32)
  normalize a batch through the port's decoder (``data/native_loader.py``:
  libjpeg on the host, giving numpy, or nvJPEG on the card where the host
  has no libjpeg, giving a tensor that stays on the card); a file that
  does not decode raises ``ValueError`` naming the batch items. There is
  no PIL fallback: a decoder that is missing raises.
- Decode-once tiers of uint8 pixels: ``DecodedU8Cache`` (a host dict),
  ``HostU8Bank`` (host RAM), ``U8MemmapStore`` (a disk memmap, the JAX
  package's three files, so a store either package built opens in the
  other) and ``HBMImageBank`` (the card). Their batch hooks attach
  ``pixel_u8`` (host tiers) or rewrite ``image_ids`` to bank rows (the
  card's bank); the [0, 1] + mean/std normalization runs on the device, in
  the step (``engine.default_image_source``) or in the bank's
  ``image_source``.
"""
from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..models.vit import IMAGE_MEAN, IMAGE_STD, normalize_image
from .native_loader import (Pixels, decode_jpeg_batch_native,
                            decode_jpeg_batch_u8_native)


class JpegStore:
    """image_id → JPEG bytes. Directory layout: ``{root}/{image_id}.jpg``;
    or an explicit dict ``blobs`` (tests)."""

    def __init__(self, root: Optional[str] = None,
                 blobs: Optional[Dict[int, bytes]] = None):
        if not root and blobs is None:
            raise ValueError("a JpegStore needs a root directory or blobs")
        self.root = root
        self.blobs = blobs

    def get(self, image_id: int) -> bytes:
        if self.blobs is not None:
            return self.blobs[int(image_id)]
        with open(os.path.join(self.root, f"{int(image_id)}.jpg"), "rb") as f:
            return f.read()


def _raise_on_failures(status: np.ndarray) -> None:
    if (status != 0).any():
        bad = np.nonzero(status)[0]
        raise ValueError(f"JPEG decode failed for batch items {bad}")


def host_pixels(pixels: Pixels) -> np.ndarray:
    """A decoded batch as numpy, copied off the card if the decoder left it
    there."""
    if isinstance(pixels, torch.Tensor):
        return pixels.cpu().numpy()
    return pixels


def decode_batch(blobs: Sequence[bytes], side: int, mean=IMAGE_MEAN,
                 std=IMAGE_STD, n_threads: int = 4) -> Pixels:
    """[N] JPEG bytes → [N, side, side, 3] normalized float32 (numpy, or a
    tensor on the card from the nvjpeg route)."""
    pixels, status = decode_jpeg_batch_native(list(blobs), side, mean, std,
                                              n_threads)
    _raise_on_failures(status)
    return pixels


def make_jpeg_host_fn(store: JpegStore, side: int = 518, mean=IMAGE_MEAN,
                      std=IMAGE_STD, n_threads: int = 4
                      ) -> Callable[[dict], dict]:
    """Batch hook: batch{image_ids} → batch + ``pixel_values`` (on the card
    already from the nvjpeg route: the feed copies nothing)."""
    def host_fn(batch: dict) -> dict:
        blobs = [store.get(i) for i in np.asarray(batch["image_ids"])]
        return {**batch, "pixel_values": decode_batch(blobs, side, mean, std,
                                                      n_threads)}
    return host_fn


def decode_batch_u8(blobs: Sequence[bytes], side: int,
                    n_threads: int = 4) -> Pixels:
    """[N] JPEG bytes → [N, side, side, 3] uint8 (resized, rounded, not
    normalized): the decode-once fill; numpy or on the card, by route."""
    pixels, status = decode_jpeg_batch_u8_native(list(blobs), side,
                                                 n_threads)
    _raise_on_failures(status)
    return pixels


def _decode_all_u8(store: JpegStore, ids: np.ndarray, side: int,
                   n_threads: int, chunk: int, out) -> None:
    """Decode ``ids`` in chunks into ``out[0..len(ids))`` (a numpy array, a
    memmap or a tensor; pixels the decoder left on the card go to a tensor
    there without a round trip through the host)."""
    for i in range(0, len(ids), chunk):
        blobs = [store.get(j) for j in ids[i:i + chunk]]
        px = decode_batch_u8(blobs, side, n_threads)
        if isinstance(out, torch.Tensor):
            if isinstance(px, np.ndarray):
                px = torch.from_numpy(px)
            out[i:i + len(blobs)].copy_(px)
        else:
            out[i:i + len(blobs)] = host_pixels(px)


def _rows_for(sorted_ids: np.ndarray, image_ids: np.ndarray,
              what: str) -> np.ndarray:
    """Rows of ``image_ids`` in ``sorted_ids``; ``KeyError`` naming the
    first missing ids."""
    ids = np.asarray(image_ids, np.int64)
    rows = np.clip(np.searchsorted(sorted_ids, ids), 0,
                   max(len(sorted_ids) - 1, 0))
    if len(sorted_ids) == 0 or not (sorted_ids[rows] == ids).all():
        missing = ids if len(sorted_ids) == 0 else ids[sorted_ids[rows] != ids]
        raise KeyError(f"image ids not in {what}: {missing[:5]}")
    return rows


class DecodedU8Cache:
    """Decode-once uint8 cache in a host dict: image_id → [side, side, 3];
    a batch decodes only the ids it has not seen, and per-step host work
    drops to slicing bytes. ``max_images`` bounds the dict (entries not in
    the current batch are dropped, oldest first)."""

    def __init__(self, store: JpegStore, side: int = 518,
                 n_threads: int = 4, max_images: Optional[int] = None):
        self.store = store
        self.side = side
        self.n_threads = n_threads
        self.max_images = max_images
        self._cache: Dict[int, np.ndarray] = {}

    def get_batch(self, image_ids: np.ndarray) -> np.ndarray:
        ids = [int(i) for i in np.asarray(image_ids)]
        missing = sorted({i for i in ids if i not in self._cache})
        if missing:
            blobs = [self.store.get(i) for i in missing]
            for i, px in zip(missing, host_pixels(decode_batch_u8(
                    blobs, self.side, self.n_threads))):
                self._cache[i] = px
        out = np.stack([self._cache[i] for i in ids])
        if self.max_images and len(self._cache) > self.max_images:
            needed = set(ids)
            drop = [k for k in self._cache if k not in needed]
            for k in drop[:len(self._cache) - self.max_images]:
                del self._cache[k]
        return out


def make_u8_cache_host_fn(cache: DecodedU8Cache) -> Callable[[dict], dict]:
    """Batch hook: batch{image_ids} → batch + ``pixel_u8`` (uint8)."""
    def host_fn(batch: dict) -> dict:
        return {**batch, "pixel_u8": cache.get_batch(batch["image_ids"])}
    return host_fn


class HostU8Bank:
    """Every image of ``image_ids`` decoded once into a uint8 array in host
    RAM; per step a numpy row gather attaches ``pixel_u8``."""

    def __init__(self, store: JpegStore, image_ids: np.ndarray,
                 side: int = 518, n_threads: int = 4, chunk: int = 256):
        self.side = side
        self.ids = np.unique(np.asarray(image_ids)).astype(np.int64)
        self.bank = np.empty((len(self.ids), side, side, 3), np.uint8)
        _decode_all_u8(store, self.ids, side, n_threads, chunk, self.bank)

    @property
    def nbytes(self) -> int:
        return self.bank.nbytes

    def rows_for(self, image_ids: np.ndarray) -> np.ndarray:
        return _rows_for(self.ids, image_ids, "host bank")

    def host_fn(self) -> Callable[[dict], dict]:
        def fn(batch: dict) -> dict:
            return {**batch,
                    "pixel_u8": self.bank[self.rows_for(batch["image_ids"])]}
        return fn


class U8MemmapStore:
    """Catalog-scale decode-once store: every image resized to uint8 in a
    disk memmap keyed by image_id, for image sets that fit neither the
    card nor RAM; epochs read page-cached rows instead of decoding.

    Files (the JAX package's): ``{path}.ids.npy`` (sorted ids), ``{path}.u8``
    (a ``.npy``-format [n, side, side, 3] uint8 array) and
    ``{path}.meta.json`` (side, count, a fingerprint of the id set and side,
    ``complete``). ``build`` reuses a complete store with the same
    fingerprint and refuses one with another."""

    def __init__(self, path: str, ids: np.ndarray, side: int,
                 mmap: np.ndarray, n_threads: int = 4):
        self.path = path
        self.ids = ids
        self.side = side
        self._mm = mmap
        self.n_threads = n_threads

    @staticmethod
    def _files(path: str) -> tuple:
        return f"{path}.meta.json", f"{path}.ids.npy", f"{path}.u8"

    @staticmethod
    def fingerprint(ids: np.ndarray, side: int) -> str:
        return hashlib.sha256(np.asarray(ids, np.int64).tobytes()
                              + str(side).encode()).hexdigest()

    @classmethod
    def build(cls, store: JpegStore, image_ids: np.ndarray, side: int,
              path: str, n_threads: int = 4, chunk: int = 256,
              progress: Optional[Callable[[int, int], None]] = None
              ) -> "U8MemmapStore":
        """Decode every image once into the memmap; reopen a complete store
        of the same images and side."""
        ids = np.unique(np.asarray(image_ids)).astype(np.int64)
        fp = cls.fingerprint(ids, side)
        meta_p, ids_p, data_p = cls._files(path)
        if os.path.exists(meta_p):
            with open(meta_p) as f:
                meta = json.load(f)
            if meta.get("fingerprint") != fp:
                raise ValueError(
                    f"existing u8 store at {path} was built for a different "
                    f"image set/side — delete it or use another path")
            if meta.get("complete"):
                return cls.open(path, n_threads=n_threads)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.save(ids_p, ids)
        n = len(ids)
        mm = np.lib.format.open_memmap(data_p, mode="w+", dtype=np.uint8,
                                       shape=(n, side, side, 3))
        with open(meta_p, "w") as f:
            json.dump({"fingerprint": fp, "side": side, "n": n,
                       "complete": False}, f)
        for i in range(0, n, chunk):
            _decode_all_u8(store, ids[i:i + chunk], side, n_threads, chunk,
                           mm[i:i + chunk])
            if progress is not None:
                progress(min(i + chunk, n), n)
        mm.flush()
        with open(meta_p, "w") as f:
            json.dump({"fingerprint": fp, "side": side, "n": n,
                       "complete": True}, f)
        return cls(path, ids, side, mm, n_threads)

    @classmethod
    def open(cls, path: str, n_threads: int = 4) -> "U8MemmapStore":
        meta_p, ids_p, data_p = cls._files(path)
        with open(meta_p) as f:
            meta = json.load(f)
        if not meta.get("complete"):
            raise ValueError(f"u8 store at {path} is incomplete — rebuild")
        return cls(path, np.load(ids_p), int(meta["side"]),
                   np.load(data_p, mmap_mode="r"), n_threads)

    def rows_for(self, image_ids: np.ndarray) -> np.ndarray:
        return _rows_for(self.ids, image_ids, "u8 store").astype(np.int64)

    def get_batch(self, image_ids: np.ndarray) -> np.ndarray:
        """[B] ids → [B, side, side, 3] uint8, read by up to ``n_threads``
        threads (numpy releases the GIL while it copies)."""
        rows = self.rows_for(image_ids)
        out = np.empty((len(rows), self.side, self.side, 3), np.uint8)
        if self.n_threads <= 1 or len(rows) < 8:
            out[:] = self._mm[rows]
            return out
        spans = np.array_split(np.arange(len(rows)),
                               min(self.n_threads, len(rows)))

        def fill(span):
            out[span] = self._mm[rows[span]]

        with ThreadPoolExecutor(len(spans)) as ex:
            list(ex.map(fill, spans))
        return out

    def host_fn(self) -> Callable[[dict], dict]:
        """Batch hook: attach ``pixel_u8``; the step normalizes it on the
        device (``engine.default_image_source``)."""
        def fn(batch: dict) -> dict:
            return {**batch, "pixel_u8": self.get_batch(batch["image_ids"])}
        return fn


class HBMImageBank:
    """Every image decoded once into a uint8 ``[n, side, side, 3]`` tensor
    on ``device``; the step gathers its rows and normalizes them there, so
    a step does no host image work and copies no pixels. The batch hook
    rewrites ``image_ids`` to bank rows, validated on the host
    (``KeyError``)."""

    def __init__(self, store: JpegStore, image_ids: np.ndarray,
                 side: int = 518, n_threads: int = 4, chunk: int = 256,
                 device="cuda"):
        self.side = side
        self.ids = np.unique(np.asarray(image_ids)).astype(np.int64)
        self.bank = torch.empty((len(self.ids), side, side, 3),
                                dtype=torch.uint8, device=device)
        _decode_all_u8(store, self.ids, side, n_threads, chunk, self.bank)

    @staticmethod
    def nbytes(n_images: int, side: int = 518) -> int:
        return int(n_images) * 3 * side * side

    def rows_for(self, image_ids: np.ndarray) -> np.ndarray:
        return _rows_for(self.ids, image_ids, "HBM bank").astype(np.int32)

    def host_fn(self) -> Callable[[dict], dict]:
        """Batch hook: rewrite ``image_ids`` to bank rows."""
        def fn(batch: dict) -> dict:
            return {**batch, "image_ids": self.rows_for(batch["image_ids"])}
        return fn

    def image_source(self) -> Callable[[dict], torch.Tensor]:
        """The step's pixels: the batch's bank rows, as float32 in [0, 1]
        normalized on the device. A row outside the bank gives NaN pixels
        (``make_bank_image_source``) rather than an out-of-range read."""
        rows_of = make_bank_image_source(self.bank)

        def source(batch: dict) -> torch.Tensor:
            return normalize_image(rows_of(batch) / 255.0)
        return source


def make_bank_image_source(bank: torch.Tensor
                           ) -> Callable[[dict], torch.Tensor]:
    """Pixel rows gathered from a bank on the device by ``image_ids``, as
    float32. An id outside ``[0, n)`` gives NaN rows (not a clamped or
    aliased row), so a broken id → row mapping trips the loop's finite-loss
    guard in the first epoch (JAX ``teacher_loop.py:50-68``)."""
    n = bank.shape[0]

    def source(batch: dict) -> torch.Tensor:
        ids = batch["image_ids"].long()
        rows = bank[ids.clamp(0, n - 1)].float()
        bad = (ids < 0) | (ids >= n)
        return rows.masked_fill(bad[:, None, None, None], float("nan"))
    return source
