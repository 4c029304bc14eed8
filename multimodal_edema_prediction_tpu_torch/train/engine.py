"""Teacher eval on explicit windows, pixel path: the PyTorch counterpart of
``default_image_source`` and ``make_teacher_eval_from_windows`` in
``multimodal_edema_prediction_tpu/train/engine.py``.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..models.duett import feats_to_input
from ..models.vit import normalize_image

EVAL_KEYS = ("main_logit", "img_logits", "ts_logits", "fusion_logits",
             "scaled_correction")


def default_image_source(batch: dict) -> torch.Tensor:
    """``pixel_u8`` [B, S, S, 3] uint8 → float32 in [0, 1] → normalized.
    The caller casts to the compute dtype."""
    return normalize_image(batch["pixel_u8"].float() / 255.0)


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else torch.as_tensor(x)
    return t.to(device, non_blocking=True)


def make_teacher_eval_from_windows(
        model, dtype=torch.bfloat16,
        image_source: Callable = default_image_source) -> Callable:
    """``step(x_ts [B,T,2V], x_static [B,D], batch)`` → the five eval
    outputs as float32 tensors on the model's device. ``batch`` carries
    ``bin_ends`` [B, T] and ``pixel_u8`` [B, S, S, 3]; numpy or torch
    inputs are moved to the model's device. The ViT always runs on pixels
    here (the JAX ``feature_source`` tier is not ported yet)."""
    device = next(model.parameters()).device

    def step(x_ts, x_static, batch: dict) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            b = {k: _as_tensor(v, device) for k, v in batch.items()}
            x_in, xs = feats_to_input(
                _as_tensor(x_ts, device).to(dtype),
                _as_tensor(x_static, device).to(dtype))
            pixels = image_source(b).to(dtype)
            out = model(x_in, xs, b["bin_ends"].to(dtype), pixels)
            return {k: out[k].float() for k in EVAL_KEYS}

    return step
