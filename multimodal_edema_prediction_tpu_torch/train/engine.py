"""Per-batch teacher, student and SSL steps: the PyTorch counterpart of
``multimodal_edema_prediction_tpu/train/engine.py`` (``_prep_inputs``,
``_cxr_inputs``, ``make_teacher_step`` with LP mode, ``make_teacher_eval``,
``make_teacher_pathology_step`` and ``_eval`` (``single``),
``make_teacher_legacy_step`` and the legacy eval (JAX
``teacher_loop.py:464-479``), ``default_image_source``,
``make_teacher_eval_from_windows``, ``make_supervised_ts_eval``,
``make_kd_step``, ``make_ssl_step``, ``make_ssl_eval``).

A step runs eagerly on the device that holds the batch: window gather →
augmentation → model forward/backward → optimizer update. The encode-once
tier's ``feature_source`` (``data/features.py``) and the pixel tier's
``image_source`` share one code path, as in JAX: the first replaces the ViT
forward with two K2 gathers (the device bank) or with the tokens the host
store's hook attached to the batch. On the pixel tier with
``freeze_cxr=False`` the ViT trains in the step: nothing here detaches its
tokens, and its attention's backward runs K1's dkv and dq kernels.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import DuettConfig, TrainConfig
from ..data.pipeline import gather_windows
from ..models.duett import feats_to_input, pretrain_prep_batch
from ..models.vit import normalize_image
from ..ops import losses as L
from .state import TrainState

EVAL_KEYS = ("main_logit", "img_logits", "ts_logits", "fusion_logits",
             "scaled_correction")
PATHOLOGY_EVAL_KEYS = ("main_logit", "stage2_logits", "stage4_logits")


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
    gather (patches None from a CLS-only source, which a ``dual`` teacher
    takes); otherwise pixels flow to the in-step ViT."""
    if feature_source is None:
        return image_source(batch).to(dtype), None
    cls, patches = feature_source(batch)
    return None, (cls.to(dtype),
                  None if patches is None else patches.to(dtype))


def make_teacher_step(cfg: TrainConfig, duett_cfg: DuettConfig,
                      n_timesteps: int, label_weights,
                      pos_weight=None, dtype=torch.bfloat16,
                      image_source: Callable = default_image_source,
                      feature_source: Optional[Callable] = None,
                      lp_mode: bool = False, lp_beta_l2: float = 0.0,
                      lp_corr_l2: float = 0.0) -> Callable:
    """``step(state, grid, static, batch, gen)`` → metrics: one teacher
    update of a residual-fusion mode on a device batch. Dropout and
    augmentation draw from the ``torch.Generator`` ``gen``. The loss is the
    3-branch masked BCE plus ``aux_residual_alpha``·KL. Returns the loss
    parts and ``main_logit``, detached, on the device; ``state`` is updated
    in place.

    ``lp_mode``: the correction-only linear probe (JAX ``engine.py:196-
    264``): the optimizer must already leave out everything but the
    correction head and β (``teacher_loop.lp_frozen_label_fn``); the
    forward runs with ``train=False`` (no augmentation, no dropout, even
    the correction head's, and no BatchNorm update), and the loss gains
    ``reg_beta_l2 = lp_beta_l2·mean(β²)`` and ``reg_corr_l2 =
    lp_corr_l2·mean(scaled_correction²)``."""
    train = not lp_mode

    def step(state: TrainState, grid, static, batch, gen
             ) -> Dict[str, torch.Tensor]:
        x_in, x_static, times = _prep_inputs(
            grid, static, batch, n_timesteps, dtype, gen,
            duett_cfg.aug_noise, duett_cfg.aug_mask, train=train)
        pixels, feats = _cxr_inputs(batch, image_source, feature_source,
                                    dtype)
        out = state.model(x_in, x_static, times, pixels, train=train,
                          gen=gen, cxr_feats=feats)
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
        if lp_mode:
            beta = state.model.perceiver.beta
            losses["reg_beta_l2"] = lp_beta_l2 * (beta ** 2).mean()
            losses["reg_corr_l2"] = lp_corr_l2 * (
                out["scaled_correction"] ** 2).mean()
            total = total + losses["reg_beta_l2"] + losses["reg_corr_l2"]
        losses["total"] = total
        state.apply_gradients(total)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["main_logit"] = out["main_logit"].detach().float()
        return metrics

    return step


def make_teacher_pathology_step(cfg: TrainConfig, duett_cfg: DuettConfig,
                                n_timesteps: int, label_weights,
                                pos_weight=None, dtype=torch.bfloat16,
                                alpha_stage2: float = 1.0,
                                alpha_stage4: float = 0.5,
                                image_source: Callable = default_image_source,
                                feature_source: Optional[Callable] = None
                                ) -> Callable:
    """``single`` mode's step (JAX ``engine.py:287-330``, reference
    training_duett/engine.py:94-129): stage 2 + stage 4 masked multi-label
    BCE, weighted ``alpha_stage2`` and ``alpha_stage4`` (the loop passes
    ``TrainConfig.aux_stage2_alpha`` and ``aux_stage4_alpha``). Returns
    the loss parts and ``main_logit``, detached."""
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
        losses = L.pathology_multilabel_loss(
            out["stage2_logits"], out["stage4_logits"], batch["y_multi"],
            batch["y_multi_mask"], lw, pos_weight, alpha_stage2,
            alpha_stage4)
        state.apply_gradients(losses["total"])
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["main_logit"] = out["main_logit"].detach().float()
        return metrics

    return step


def make_teacher_legacy_step(cfg: TrainConfig, duett_cfg: DuettConfig,
                             n_timesteps: int, dtype=torch.bfloat16,
                             aux_alpha: float = 0.0,
                             image_source: Callable = default_image_source
                             ) -> Callable:
    """``legacy`` mode's step (JAX ``engine.py:350-381``, reference
    training_duett/engine.py:42-73), on pixels only: the binary BCE of
    ``main_logit`` on ``batch["y"]``, plus ``aux_alpha`` × the auxiliary
    CXR head's BCE, which is 0.0 when ``aux_alpha`` is 0. Returns
    ``loss``, ``main_loss``, ``aux_loss`` and ``logits``, detached."""
    def step(state: TrainState, grid, static, batch, gen
             ) -> Dict[str, torch.Tensor]:
        x_in, x_static, times = _prep_inputs(
            grid, static, batch, n_timesteps, dtype, gen,
            duett_cfg.aug_noise, duett_cfg.aug_mask, train=True)
        out = state.model(x_in, x_static, times,
                          image_source(batch).to(dtype), train=True, gen=gen)
        main_loss = L.bce_with_logits(out["main_logit"], batch["y"])
        aux_loss = L.bce_with_logits(out["aux_logit"], batch["y"]) \
            if aux_alpha > 0 else torch.zeros((), device=x_in.device)
        total = main_loss + aux_alpha * aux_loss
        state.apply_gradients(total)
        return {"loss": total.detach(), "main_loss": main_loss.detach(),
                "aux_loss": aux_loss.detach(),
                "logits": out["main_logit"].detach()}

    return step


def make_teacher_eval(n_timesteps: int, dtype=torch.bfloat16,
                      image_source: Callable = default_image_source,
                      feature_source: Optional[Callable] = None,
                      keys=EVAL_KEYS) -> Callable:
    """``step(model, grid, static, batch)`` → the eval outputs ``keys`` as
    float32 tensors: eval mode, no gradients, no augmentation. ``keys``:
    ``EVAL_KEYS`` (the residual-fusion modes) or ``PATHOLOGY_EVAL_KEYS``
    (``single``: JAX ``make_teacher_pathology_eval``); ``None`` returns
    ``main_logit`` alone as a tensor (``legacy``, the binary eval of JAX
    ``teacher_loop.py:464-479``)."""
    def step(model, grid, static, batch):
        with torch.inference_mode():
            x_in, x_static, times = _prep_inputs(grid, static, batch,
                                                 n_timesteps, dtype)
            pixels, feats = _cxr_inputs(batch, image_source, feature_source,
                                        dtype)
            out = model(x_in, x_static, times, pixels, cxr_feats=feats)
            if keys is None:
                return out["main_logit"].float()
            return {k: out[k].float() for k in keys}

    return step


def make_teacher_eval_from_windows(
        model, dtype=torch.bfloat16,
        image_source: Callable = default_image_source,
        feature_source: Optional[Callable] = None) -> Callable:
    """``step(x_ts [B,T,2V], x_static [B,D], batch)`` → the five eval
    outputs as float32 tensors on the model's device (those the model's
    mode has: ``main_logit`` alone for ``single`` and ``legacy``).
    ``batch`` carries ``bin_ends`` [B, T] and either ``pixel_u8``
    [B, S, S, 3] for the ViT or, with ``feature_source`` (e.g.
    ``CXRFeatureBank.feature_source(keyed_by_row=False)`` over raw
    ``image_ids``), what that source reads:
    windows perturbed on the host then reuse the cached tokens (JAX
    ``engine.py:403-432``). numpy or torch inputs are moved to the model's
    device."""
    device = next(model.parameters()).device

    def step(x_ts, x_static, batch: dict) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            b = to_device(batch, device)
            x_in, xs = feats_to_input(
                _as_tensor(x_ts, device).to(dtype),
                _as_tensor(x_static, device).to(dtype))
            pixels, feats = _cxr_inputs(b, image_source, feature_source,
                                        dtype)
            out = model(x_in, xs, b["bin_ends"].to(dtype), pixels,
                        cxr_feats=feats)
            return {k: out[k].float() for k in EVAL_KEYS if k in out}

    return step


def make_supervised_ts_eval(n_timesteps: int, dtype=torch.bfloat16
                            ) -> Callable:
    """``step(model, grid, static, batch)`` → a time-series model's logits
    [B] as float32 (the student's eval, JAX ``engine.py:82-92``): eval
    mode, no gradients, no augmentation."""
    def step(model, grid, static, batch) -> torch.Tensor:
        with torch.inference_mode():
            x_in, x_static, times = _prep_inputs(grid, static, batch,
                                                 n_timesteps, dtype)
            return model(x_in, x_static, times).float()

    return step


def make_kd_step(cfg: TrainConfig, duett_cfg: DuettConfig, n_timesteps: int,
                 dtype=torch.bfloat16,
                 image_source: Callable = default_image_source,
                 feature_source: Optional[Callable] = None) -> Callable:
    """``step(state, teacher, grid, static, batch, gen)`` → metrics: one
    student update by knowledge distillation (JAX ``engine.py:435-477``,
    reference training_duett/engine.py:270-301). The frozen teacher sees
    the un-augmented inputs in eval mode under ``torch.no_grad()`` (not
    ``inference_mode``: the KD loss keeps its probabilities for the
    student's backward), on pixels through its ViT or on the tier's cached
    tokens; the student sees the inputs augmented from ``gen``, trains with
    dropout from ``gen`` and updates its BatchNorm statistics. The loss is
    α·BCE + (1 − α)·KD (``ops/losses.student_kd_loss``). Returns ``total``,
    ``bce``, ``kd`` and the student's ``logits``, detached, on the device;
    ``state`` (the student's) is updated in place."""
    def step(state: TrainState, teacher, grid, static, batch, gen
             ) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            x_in_t, x_static_t, times = _prep_inputs(
                grid, static, batch, n_timesteps, dtype)
            pixels, feats = _cxr_inputs(batch, image_source, feature_source,
                                        dtype)
            z_t = teacher(x_in_t, x_static_t, times, pixels,
                          cxr_feats=feats)["main_logit"].detach()
        x_in, x_static, _ = _prep_inputs(
            grid, static, batch, n_timesteps, dtype, gen,
            duett_cfg.aug_noise, duett_cfg.aug_mask, train=True)
        z_s = state.model(x_in, x_static, times, train=True, gen=gen)
        losses = L.student_kd_loss(z_s, z_t, batch["y"], cfg.kd_T,
                                   cfg.kd_alpha, kd_name=cfg.kd_name)
        state.apply_gradients(losses["total"])
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["logits"] = z_s.detach().float()
        return metrics

    return step


def _ssl_forward(model, duett_cfg: DuettConfig, n_timesteps: int, grid,
                 static, batch, dtype, gen, train: bool) -> dict:
    """Window gather → SSL masking (or the batch's ``ssl_mask_idx`` /
    ``ssl_event_var``) → the pretrain model → ``ssl_pretrain_loss``."""
    x_ts = gather_windows(grid, batch["stay_rows"], batch["slot_idx"],
                          n_timesteps)
    x_static = static[batch["stay_rows"].long()].to(dtype)
    times = batch["bin_ends"].to(dtype)
    pb = pretrain_prep_batch(
        x_ts, duett_cfg.pretrain_masked_steps, duett_cfg.pretrain_dropout,
        duett_cfg.predict_events, mask_idx=batch.get("ssl_mask_idx"),
        event_var=batch.get("ssl_event_var"), gen=gen)
    pb = pb._replace(x_in=pb.x_in.to(dtype))
    out = model(pb, x_static, times, train=train, gen=gen)
    return L.ssl_pretrain_loss(
        out["y_hat_value"], out["y_hat_presence"], out["y_hat_events"],
        out["y_hat_events_presence"], pb.y_value, pb.y_presence_mask,
        pb.y_events, pb.y_events_mask,
        pretrain_value=duett_cfg.pretrain_value,
        pretrain_presence=duett_cfg.pretrain_presence,
        presence_weight=duett_cfg.pretrain_presence_weight,
        predict_events=duett_cfg.predict_events)


def make_ssl_step(duett_cfg: DuettConfig, n_timesteps: int,
                  dtype=torch.bfloat16) -> Callable:
    """``step(state, grid, static, batch, gen)`` → loss parts: one DuETT SSL
    update (JAX ``engine.py:97-134``, reference duett.py:329-358). The masks
    and dropout draw from ``gen``; the parts come back detached, on the
    device; ``state`` is updated in place."""
    def step(state: TrainState, grid, static, batch, gen
             ) -> Dict[str, torch.Tensor]:
        parts = _ssl_forward(state.model, duett_cfg, n_timesteps, grid,
                             static, batch, dtype, gen, train=True)
        state.apply_gradients(parts["total"])
        return {k: v.detach() for k, v in parts.items()}

    return step


def make_ssl_eval(duett_cfg: DuettConfig, n_timesteps: int,
                  dtype=torch.bfloat16) -> Callable:
    """``step(model, grid, static, batch, gen)`` → loss parts in eval mode,
    no gradients (JAX ``engine.py:480-516``). The reference's quirk is
    kept: ``total`` leaves out the event-presence term that the training
    step includes (duett.py:394-399 against :355-358), so the best
    checkpoint is chosen on value + presence + event value;
    ``total_all_terms`` is the full sum."""
    def step(model, grid, static, batch, gen) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            parts = _ssl_forward(model, duett_cfg, n_timesteps, grid, static,
                                 batch, dtype, gen, train=False)
        parts["total_all_terms"] = parts["total"]
        if duett_cfg.predict_events and duett_cfg.pretrain_presence:
            parts["total"] = parts["total"] - parts["event_presence"]
        return parts

    return step
