"""Per-batch teacher steps: the PyTorch counterpart of
``multimodal_edema_prediction_tpu/train/engine.py`` (``_prep_inputs``,
``_cxr_inputs``, ``make_teacher_step``, ``make_teacher_eval``,
``default_image_source``, ``make_teacher_eval_from_windows``).

A step runs eagerly on the device that holds the batch: window gather →
augmentation → model forward/backward → optimizer update. The encode-once
tier's ``feature_source`` (``data/features.py``) and the pixel tier's
``image_source`` share one code path, as in JAX: the first replaces the ViT
forward with two K2 gathers. On the pixel tier with ``freeze_cxr=False`` the
ViT trains in the step: nothing here detaches its tokens, and its
attention's backward runs K1's dkv and dq kernels.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import DuettConfig, TrainConfig
from ..data.pipeline import gather_windows
from ..models.duett import feats_to_input
from ..models.vit import normalize_image
from ..ops import losses as L
from .state import TrainState

EVAL_KEYS = ("main_logit", "img_logits", "ts_logits", "fusion_logits",
             "scaled_correction")


def default_image_source(batch: dict) -> torch.Tensor:
    """Pixel batch, in one of two layouts: ``pixel_u8`` [B, S, S, 3] uint8
    → float32 in [0, 1] → normalized on the device; or ``pixel_values``,
    already normalized float32. The caller casts to the compute dtype."""
    if "pixel_u8" in batch:
        return normalize_image(batch["pixel_u8"].float() / 255.0)
    return batch["pixel_values"]


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else torch.as_tensor(x)
    return t.to(device, non_blocking=True)


def to_device(batch: dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Host batch (numpy) → tensors on ``device``, copied ``non_blocking``."""
    return {k: _as_tensor(v, device) for k, v in batch.items()}


def _prep_inputs(grid, static, batch, n_timesteps, dtype, gen=None,
                 aug_noise=0.0, aug_mask=0.0, train=False):
    x_ts = gather_windows(grid, batch["stay_rows"], batch["slot_idx"],
                          n_timesteps)
    x_static = static[batch["stay_rows"].long()]
    x_in, x_static = feats_to_input(x_ts, x_static, aug_noise, aug_mask,
                                    train, gen)
    return x_in.to(dtype), x_static.to(dtype), batch["bin_ends"].to(dtype)


def _cxr_inputs(batch, image_source, feature_source, dtype):
    """(pixels, cxr_feats) for the teacher forward: the encode-once tier
    (``feature_source``) replaces the frozen-ViT forward with a cached-token
    gather; otherwise pixels flow to the in-step ViT."""
    if feature_source is None:
        return image_source(batch).to(dtype), None
    cls, patches = feature_source(batch)
    return None, (cls.to(dtype), patches.to(dtype))


def make_teacher_step(cfg: TrainConfig, duett_cfg: DuettConfig,
                      n_timesteps: int, label_weights,
                      pos_weight=None, dtype=torch.bfloat16,
                      image_source: Callable = default_image_source,
                      feature_source: Optional[Callable] = None) -> Callable:
    """``step(state, grid, static, batch, gen)`` → metrics: one teacher
    update on a device batch (the JAX step without LP mode). Dropout and
    augmentation draw from the ``torch.Generator`` ``gen``. The loss is the
    3-branch masked BCE plus ``aux_residual_alpha``·KL. Returns the loss
    parts and ``main_logit``, detached, on the device; ``state`` is updated
    in place."""
    def step(state: TrainState, grid, static, batch, gen
             ) -> Dict[str, torch.Tensor]:
        x_in, x_static, times = _prep_inputs(
            grid, static, batch, n_timesteps, dtype, gen,
            duett_cfg.aug_noise, duett_cfg.aug_mask, train=True)
        pixels, feats = _cxr_inputs(batch, image_source, feature_source,
                                    dtype)
        out = state.model(x_in, x_static, times, pixels, train=True, gen=gen,
                          cxr_feats=feats)
        lw = torch.as_tensor(label_weights, dtype=torch.float32,
                             device=x_in.device)
        losses = L.dual_pathology_loss(
            out["img_logits"], out["ts_logits"], out["fusion_logits"],
            batch["y_multi"], batch["y_multi_mask"], lw, pos_weight,
            cfg.alpha_img, cfg.alpha_ts, cfg.alpha_fus)
        total = losses["total"]
        if cfg.aux_residual_alpha > 0.0:
            aux = L.aux_residual_kl(out["img_logits"],
                                    out["scaled_correction"],
                                    batch["y_multi"], batch["y_multi_mask"])
            losses["aux_residual"] = aux
            total = total + cfg.aux_residual_alpha * aux
        losses["total"] = total
        state.apply_gradients(total)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["main_logit"] = out["main_logit"].detach().float()
        return metrics

    return step


def make_teacher_eval(n_timesteps: int, dtype=torch.bfloat16,
                      image_source: Callable = default_image_source,
                      feature_source: Optional[Callable] = None) -> Callable:
    """``step(model, grid, static, batch)`` → the five eval outputs as
    float32 tensors: eval mode, no gradients, no augmentation."""
    def step(model, grid, static, batch) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            x_in, x_static, times = _prep_inputs(grid, static, batch,
                                                 n_timesteps, dtype)
            pixels, feats = _cxr_inputs(batch, image_source, feature_source,
                                        dtype)
            out = model(x_in, x_static, times, pixels, cxr_feats=feats)
            return {k: out[k].float() for k in EVAL_KEYS}

    return step


def make_teacher_eval_from_windows(
        model, dtype=torch.bfloat16,
        image_source: Callable = default_image_source) -> Callable:
    """``step(x_ts [B,T,2V], x_static [B,D], batch)`` → the five eval
    outputs as float32 tensors on the model's device. ``batch`` carries
    ``bin_ends`` [B, T] and ``pixel_u8`` [B, S, S, 3]; numpy or torch
    inputs are moved to the model's device. The ViT runs on pixels here
    (serving has no feature bank yet: ROADMAP P8/P15)."""
    device = next(model.parameters()).device

    def step(x_ts, x_static, batch: dict) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            b = to_device(batch, device)
            x_in, xs = feats_to_input(
                _as_tensor(x_ts, device).to(dtype),
                _as_tensor(x_static, device).to(dtype))
            pixels = image_source(b).to(dtype)
            out = model(x_in, xs, b["bin_ends"].to(dtype), pixels)
            return {k: out[k].float() for k in EVAL_KEYS}

    return step
