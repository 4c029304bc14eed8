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

The host tier (``HostFeatureStore``, RAM or disk memmap) waits for
ROADMAP P8.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..ops.gather import gather_rows


def encode_fn_for_teacher(model, dtype=torch.bfloat16) -> Callable:
    """``pixels [B, S, S, 3] → (cls [B, D], patches [B, N, D])`` through the
    teacher's frozen ViT (``model.cxr``) in eval mode and without gradients,
    on the model's device; pixels may be numpy or a tensor."""
    vit = model.cxr
    device = next(vit.parameters()).device

    def encode(pixels):
        with torch.no_grad():
            px = torch.as_tensor(np.asarray(pixels, np.float32)).to(
                device, dtype)
            return vit(px)

    return encode


def build_feature_arrays(encode_fn: Callable,
                         pixels_for_ids: Callable[[np.ndarray], np.ndarray],
                         image_ids: np.ndarray, chunk: int = 16,
                         out_dtype=torch.bfloat16
                         ) -> Tuple[np.ndarray, torch.Tensor, torch.Tensor]:
    """Encode every unique image once, in fixed chunks of ``chunk`` (the
    last chunk padded by repeating its last image, as in the JAX package).
    Returns ``(sorted_ids, cls [N+1, D], patches [N+1, P, D])``: row ``i``
    holds image ``sorted_ids[i]`` and row ``N`` is the all-NaN sentinel,
    written in place so the bank is allocated once. The tokens stay on the
    encoder's device in ``out_dtype``: bf16 storage is lossless when the
    loop computes in bf16 (the encoder already emits bf16); loops that
    compute in float32 keep float32."""
    ids = np.unique(np.asarray(image_ids)).astype(np.int64)
    n = len(ids)
    cls_out = patch_out = None
    for i in range(0, n, chunk):
        span = ids[i:i + chunk]
        pixels = np.asarray(pixels_for_ids(span), np.float32)
        pad = chunk - len(span)
        if pad:
            pixels = np.concatenate([pixels, pixels[-1:].repeat(pad, 0)])
        cls, patches = encode_fn(pixels)
        if cls_out is None:
            cls_out = cls.new_empty((n + 1,) + tuple(cls.shape[1:]),
                                    dtype=out_dtype)
            patch_out = patches.new_empty((n + 1,) + tuple(patches.shape[1:]),
                                          dtype=out_dtype)
        cls_out[i:i + len(span)] = cls[:len(span)]
        patch_out[i:i + len(span)] = patches[:len(span)]
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

    def feature_source(self) -> Callable[[dict], tuple]:
        """Device-side gather for the step. ``batch['image_ids']`` holds
        bank rows (``host_fn``): a row outside ``[0, N)`` is remapped to the
        sentinel ``N``, then K2 gathers the CLS and the patch rows."""
        n = self.cls.shape[0] - 1

        def source(batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
            ids = batch["image_ids"]
            rows = ids.masked_fill((ids < 0) | (ids >= n), n).to(torch.int32)
            return gather_rows(self.cls, rows), gather_rows(self.patches,
                                                            rows)

        return source

