"""Encode-once frozen-ViT feature bank: the port's counterpart of the device
tier of ``multimodal_edema_prediction_tpu/data/features.py``.

The teacher's CXR branch is frozen by default, which makes the ViT forward a
pure function of the pixels. So each unique image is encoded ONCE (through
K1) into a bank on the card, and every train and eval step gathers its
(CLS, patch) token rows through K2 (``ops/gather.py``) instead of running
the ViT: (1+1369)·768·2 B ≈ 2.1 MB per image in bf16.

Invalid ids NaN-poison the gathered rows, so a broken id → row mapping trips
the loop's finite-loss guard: the bank carries one extra all-NaN sentinel
row and invalid ids are remapped to it BEFORE the gather (a [B] integer op),
so no pass re-touches the gathered tokens.

The host tier, ``HostFeatureStore``, holds the same tokens on the host: in
RAM, or in a disk memmap store that a later run reopens when its fingerprint
matches. Its batch hook attaches each batch's token rows (``cxr_cls``,
``cxr_patches``), which ``features_from_batch`` hands to the step: no kernel
runs for them in the step.

A ``dual`` teacher reads only the CLS token. Both tiers then hand the step
CLS alone (``cls_only``): one K2 gather of B rows of 1.5 KB (bf16) a step
instead of two, and no 2.1 MB patch row per sample on the host tier. The store's files are the JAX package's: bf16
tokens are written as 2-byte void items (``'<V2'``, the header ml_dtypes'
bfloat16 gives) and read back as such, so either package reopens a store
the other built.
"""
from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..ops.gather import gather_rows


def _float_tensor(pixels) -> torch.Tensor:
    """Pixels from a hook (numpy, or a tensor a card decoder left on the
    card) as a float32 tensor where they are."""
    if isinstance(pixels, torch.Tensor):
        return pixels.float()
    return torch.from_numpy(np.ascontiguousarray(pixels, np.float32))


def encode_fn_for_teacher(model, dtype=torch.bfloat16) -> Callable:
    """``pixels [B, S, S, 3] → (cls [B, D], patches [B, N, D])`` through the
    teacher's frozen ViT (``model.cxr``) in eval mode and without gradients,
    on the model's device; pixels may be numpy or a tensor."""
    vit = model.cxr
    device = next(vit.parameters()).device

    def encode(pixels):
        with torch.no_grad():
            return vit(_float_tensor(pixels).to(device, dtype))

    return encode


def _encoded_chunks(encode_fn: Callable,
                    pixels_for_ids: Callable[[np.ndarray], np.ndarray],
                    ids: np.ndarray, chunk: int
                    ) -> Iterator[Tuple[int, int, torch.Tensor,
                                        torch.Tensor]]:
    """``(first row, rows, cls, patches)`` for each chunk of ``chunk`` ids,
    the last chunk padded by repeating its last image, as in the JAX
    package, so that every encoder call has one shape."""
    for i in range(0, len(ids), chunk):
        span = ids[i:i + chunk]
        pixels = _float_tensor(pixels_for_ids(span))
        pad = chunk - len(span)
        if pad:
            pixels = torch.cat([pixels, pixels[-1:].expand(
                pad, *pixels.shape[1:])])
        cls, patches = encode_fn(pixels)
        yield i, len(span), cls[:len(span)], patches[:len(span)]


def build_feature_arrays(encode_fn: Callable,
                         pixels_for_ids: Callable[[np.ndarray], np.ndarray],
                         image_ids: np.ndarray, chunk: int = 16,
                         out_dtype=torch.bfloat16
                         ) -> Tuple[np.ndarray, torch.Tensor, torch.Tensor]:
    """Encode every unique image once, in chunks of ``chunk``. Returns
    ``(sorted_ids, cls [N+1, D], patches [N+1, P, D])``: row ``i`` holds
    image ``sorted_ids[i]`` and row ``N`` is the all-NaN sentinel, written
    in place so the bank is allocated once. The tokens stay on the encoder's
    device in ``out_dtype``: bf16 storage is lossless when the loop computes
    in bf16 (the encoder already emits bf16); loops that compute in float32
    keep float32."""
    ids = np.unique(np.asarray(image_ids)).astype(np.int64)
    n = len(ids)
    cls_out = patch_out = None
    for i, m, cls, patches in _encoded_chunks(encode_fn, pixels_for_ids,
                                              ids, chunk):
        if cls_out is None:
            cls_out = cls.new_empty((n + 1,) + tuple(cls.shape[1:]),
                                    dtype=out_dtype)
            patch_out = patches.new_empty((n + 1,) + tuple(patches.shape[1:]),
                                          dtype=out_dtype)
        cls_out[i:i + m] = cls
        patch_out[i:i + m] = patches
    cls_out[n] = float("nan")
    patch_out[n] = float("nan")
    return ids, cls_out, patch_out


def _rows_for(sorted_ids: np.ndarray, image_ids: np.ndarray,
              what: str) -> np.ndarray:
    ids = np.asarray(image_ids, np.int64)
    rows = np.searchsorted(sorted_ids, ids)
    rows = np.clip(rows, 0, len(sorted_ids) - 1)
    if not (sorted_ids[rows] == ids).all():
        missing = ids[sorted_ids[rows] != ids]
        raise KeyError(f"image ids not in {what}: {missing[:5]}")
    return rows.astype(np.int32)


class CXRFeatureBank:
    """Device-resident (CLS, patch) token bank for the frozen ViT. ``cls``
    [N+1, D] and ``patches`` [N+1, P, D] hold the tokens of ``ids`` (N
    sorted unique image ids) in rows ``0..N-1`` and the all-NaN sentinel in
    row ``N``, as ``build_feature_arrays`` returns them.

    Per-step cost replaced: the ViT forward (~0.3 TFLOP per sample at
    ViT-B/14 518²) → two K2 gathers of 2·B·2.1 MB."""

    def __init__(self, ids: np.ndarray, cls: torch.Tensor,
                 patches: torch.Tensor):
        self.ids = np.asarray(ids, np.int64)
        n = len(self.ids) + 1
        if cls.shape[0] != n or patches.shape[0] != n:
            raise ValueError(f"banks of {n} rows ({n - 1} images and the "
                             f"sentinel) expected, got {cls.shape[0]} and "
                             f"{patches.shape[0]}")
        self.cls, self.patches = cls.contiguous(), patches.contiguous()

    @classmethod
    def build(cls, encode_fn, pixels_for_ids, image_ids, chunk: int = 16,
              out_dtype=torch.bfloat16) -> "CXRFeatureBank":
        ids, c, p = build_feature_arrays(encode_fn, pixels_for_ids,
                                         image_ids, chunk, out_dtype)
        return cls(ids, c, p)

    @staticmethod
    def nbytes(n_images: int, n_patches: int = 1369, d: int = 768,
               itemsize: int = 2) -> int:
        # +1: the NaN sentinel row
        return (int(n_images) + 1) * (n_patches + 1) * d * itemsize

    def rows_for(self, image_ids: np.ndarray) -> np.ndarray:
        return _rows_for(self.ids, image_ids, "feature bank")

    def host_fn(self) -> Callable[[dict], dict]:
        """Batch hook: rewrite ``image_ids`` to bank rows, validated on the
        host with a real exception."""
        def fn(batch: dict) -> dict:
            return {**batch, "image_ids": self.rows_for(batch["image_ids"])}
        return fn

    def feature_source(self, keyed_by_row: bool = True,
                       cls_only: bool = False) -> Callable[[dict], tuple]:
        """Device-side gather for the step; a key that names no image gathers
        the sentinel. ``keyed_by_row=True`` (the training loops):
        ``batch['image_ids']`` holds bank rows (``host_fn``), and a row
        outside ``[0, N)`` is remapped to ``N``. ``False`` (batches built
        without the hook, e.g. counterfactual evaluation): raw image ids are
        resolved to rows by ``torch.searchsorted`` over the sorted ids on
        the card, an id not in the bank to ``N``. Then K2 gathers the CLS
        and the patch rows; with ``cls_only`` the CLS rows alone, and the
        source returns ``(cls, None)``."""
        n = self.cls.shape[0] - 1
        ids_dev = None if keyed_by_row else \
            torch.from_numpy(self.ids).to(self.cls.device)

        def source(batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
            ids = batch["image_ids"]
            if keyed_by_row:
                rows = ids.masked_fill((ids < 0) | (ids >= n), n)
            else:
                ids = ids.long()
                rows = torch.searchsorted(ids_dev, ids).clamp_(0, n - 1)
                rows = rows.masked_fill(ids_dev[rows] != ids, n)
            rows = rows.to(torch.int32)
            cls = gather_rows(self.cls, rows)
            return cls, None if cls_only else gather_rows(self.patches, rows)

        return source


# bf16 tokens on disk: 2-byte void items under the header ml_dtypes'
# bfloat16 writes, held in memory as their int16 bit patterns
_BF16_DESCR = "<V2"


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A token tensor as a host numpy array: float32 as is, bf16 as its
    int16 bit patterns."""
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _from_host(a: np.ndarray) -> torch.Tensor:
    """The inverse of ``_to_host``, without a copy: int16 (or a store's
    2-byte void items) → bf16, float32 as is."""
    if a.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _create_npy(path: str, dtype: np.dtype, shape: tuple) -> np.memmap:
    """A ``.npy`` file of ``shape`` opened for writing as a memmap of
    ``dtype``; 2-byte items go under the bf16 header (``'<V2'``), so the
    file is the one the JAX package writes for the same tokens."""
    descr = _BF16_DESCR if dtype.itemsize == 2 else \
        np.lib.format.dtype_to_descr(dtype)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": descr, "fortran_order": False,
                "shape": tuple(shape)})
        offset = f.tell()
        f.truncate(offset + int(np.prod(shape)) * dtype.itemsize)
    return np.memmap(path, dtype=dtype, mode="r+", offset=offset,
                     shape=tuple(shape))


class HostFeatureStore:
    """Host tier (JAX ``data/features.py:201-299``): the tokens of ``ids``
    (sorted unique image ids) in host arrays, ``cls`` [N, D] and ``patches``
    [N, P, D], float32 or bf16 held as int16 bit patterns; in RAM, or a
    read-only memmap pair. The batch hook (``host_fn``) attaches each
    batch's rows as CPU tensors of the token dtype, which the loop copies to
    the card with the rest of the batch.

    Disk layout, as the JAX package's: ``{path}.ids.npy``,
    ``{path}.cls.npy``, ``{path}.patches.npy`` and ``{path}.meta.json``
    with the fingerprint, the sha256 of the sorted int64 ids."""

    def __init__(self, ids: np.ndarray, cls: np.ndarray, patches: np.ndarray,
                 n_threads: int = 4):
        self.ids = np.asarray(ids, np.int64)
        self.cls = cls
        self.patches = patches
        self.n_threads = n_threads

    @classmethod
    def build(cls, encode_fn, pixels_for_ids, image_ids, chunk: int = 16,
              path: Optional[str] = None, n_threads: int = 4,
              out_dtype=torch.bfloat16) -> "HostFeatureStore":
        """Encode every unique image once, each chunk copied to the host as
        it comes: into RAM when ``path`` is None, else into a disk store at
        ``path``, which is reopened instead when a complete one with the
        same fingerprint is there (another image set raises)."""
        ids = np.unique(np.asarray(image_ids)).astype(np.int64)
        fp = hashlib.sha256(ids.tobytes()).hexdigest()
        meta_p = None if path is None else f"{path}.meta.json"
        if meta_p is not None and os.path.exists(meta_p):
            with open(meta_p) as f:
                meta = json.load(f)
            if meta.get("fingerprint") != fp:
                raise ValueError(
                    f"existing feature store at {path} was built for a "
                    f"different image set — delete it or use another path")
            if meta.get("complete"):
                return cls.open(path, n_threads=n_threads)
        dtype = np.dtype(np.int16 if out_dtype == torch.bfloat16
                         else np.float32)
        c = p = None
        for i, m, cls_t, patch_t in _encoded_chunks(encode_fn, pixels_for_ids,
                                                    ids, chunk):
            if c is None:
                shapes = ((len(ids),) + tuple(cls_t.shape[1:]),
                          (len(ids),) + tuple(patch_t.shape[1:]))
                if path is None:
                    c, p = (np.empty(s_, dtype) for s_ in shapes)
                else:
                    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                    np.save(f"{path}.ids.npy", ids)
                    c, p = (_create_npy(f"{path}.{k}.npy", dtype, s_)
                            for k, s_ in zip(("cls", "patches"), shapes))
            c[i:i + m] = _to_host(cls_t.to(out_dtype))
            p[i:i + m] = _to_host(patch_t.to(out_dtype))
        if path is None:
            return cls(ids, c, p, n_threads)
        c.flush()
        p.flush()
        with open(meta_p, "w") as f:
            json.dump({"fingerprint": fp, "n": len(ids), "complete": True,
                       "cls_shape": list(c.shape),
                       "patch_shape": list(p.shape)}, f)
        del c, p
        return cls.open(path, n_threads=n_threads)

    @classmethod
    def open(cls, path: str, n_threads: int = 4) -> "HostFeatureStore":
        """A complete store at ``path``, written by either package, as
        read-only memmaps (bf16 items viewed as int16)."""
        with open(f"{path}.meta.json") as f:
            meta = json.load(f)
        if not meta.get("complete"):
            raise ValueError(f"feature store at {path} incomplete — rebuild")
        ids = np.load(f"{path}.ids.npy")
        arrays = []
        for k in ("cls", "patches"):
            a = np.load(f"{path}.{k}.npy", mmap_mode="r")
            arrays.append(a.view(np.int16) if a.dtype.itemsize == 2 else a)
        return cls(ids, *arrays, n_threads=n_threads)

    def rows_for(self, image_ids: np.ndarray) -> np.ndarray:
        return _rows_for(self.ids, image_ids, "feature store")

    def get_batch(self, image_ids: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """The rows of ``image_ids`` as host arrays (unknown ids raise
        ``KeyError``); from a memmap, gathered by ``n_threads`` threads
        (numpy's reads release the GIL)."""
        rows = self.rows_for(image_ids)
        if self.n_threads <= 1 or len(rows) < 8 or \
                not isinstance(self.patches, np.memmap):
            return np.asarray(self.cls[rows]), np.asarray(self.patches[rows])
        out_c = np.empty((len(rows),) + self.cls.shape[1:], self.cls.dtype)
        out_p = np.empty((len(rows),) + self.patches.shape[1:],
                         self.patches.dtype)

        def fill(span):
            out_c[span] = self.cls[rows[span]]
            out_p[span] = self.patches[rows[span]]

        nt = min(self.n_threads, len(rows))
        with ThreadPoolExecutor(nt) as ex:
            list(ex.map(fill, np.array_split(np.arange(len(rows)), nt)))
        return out_c, out_p

    def host_fn(self, cls_only: bool = False) -> Callable[[dict], dict]:
        """Batch hook: attach the batch's tokens, ``cxr_cls`` [B, D] and
        ``cxr_patches`` [B, P, D] (not with ``cls_only``), as CPU tensors
        of the token dtype."""
        def fn(batch: dict) -> dict:
            if cls_only:
                rows = self.rows_for(batch["image_ids"])
                return {**batch,
                        "cxr_cls": _from_host(np.asarray(self.cls[rows]))}
            c, p = self.get_batch(batch["image_ids"])
            return {**batch, "cxr_cls": _from_host(c),
                    "cxr_patches": _from_host(p)}
        return fn


def features_from_batch(batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Feature source of the host tier: the tokens ``HostFeatureStore``'s
    hook attached to the batch (patches None from a CLS-only hook)."""
    return batch["cxr_cls"], batch.get("cxr_patches")
