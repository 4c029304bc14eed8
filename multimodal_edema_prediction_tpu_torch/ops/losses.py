"""Losses of the teacher, student and SSL steps: the counterparts of
``bce_with_logits``, ``masked_per_label_bce``, ``dual_pathology_loss``,
``pathology_multilabel_loss``, ``aux_residual_kl``, ``binary_kl_kd``,
``student_kd_loss`` and ``ssl_pretrain_loss`` in
``multimodal_edema_prediction_tpu/ops/losses.py:18-199``.

Every function computes in float32 whatever the dtype of its inputs, and
returns float32 scalars or [K] vectors. Their means divide by counts of the
batch they are given: in a multi-process run the steps
(``train/engine.py``) hand them the global batch's rows, gathered over the
ranks, so a count of valid entries is the global count, as under JAX's
GSPMD, and never a mean of the ranks' means.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, y: torch.Tensor,
                    pos_weight: Optional[torch.Tensor] = None,
                    weight: Optional[torch.Tensor] = None,
                    reduce: bool = True) -> torch.Tensor:
    """Stable sigmoid BCE, torch ``BCEWithLogitsLoss``:
    pos_weight·y·softplus(−x) + (1−y)·softplus(x), optionally weighted."""
    x = logits.float()
    y = y.float()
    pos = y * F.softplus(-x)
    if pos_weight is not None:
        pos = pos_weight * pos
    loss = pos + (1.0 - y) * F.softplus(x)
    if weight is not None:
        loss = loss * weight
    return loss.mean() if reduce else loss


def masked_per_label_bce(logits: torch.Tensor, y: torch.Tensor,
                         mask: torch.Tensor,
                         pos_weight: Optional[torch.Tensor] = None,
                         eps: float = 1e-6) -> torch.Tensor:
    """[B, K] → [K]: Σ_b BCE·mask / (Σ_b mask + eps)."""
    loss = bce_with_logits(logits, y, pos_weight=pos_weight, reduce=False)
    m = mask.float()
    return (loss * m).sum(dim=0) / (m.sum(dim=0) + eps)


def dual_pathology_loss(img_logits, ts_logits, fusion_logits, y_multi,
                        y_multi_mask, label_weights,
                        pos_weight: Optional[torch.Tensor] = None,
                        alpha_img: float = 0.5, alpha_ts: float = 0.5,
                        alpha_fus: float = 1.0) -> dict:
    """3-branch masked multi-label BCE (reference
    loss/losses_duett.py:131-194)."""
    lw = label_weights.float()
    per = {name: masked_per_label_bce(lg, y_multi, y_multi_mask, pos_weight)
           for name, lg in (("img", img_logits), ("ts", ts_logits),
                            ("fus", fusion_logits))}
    totals = {name: (lw * v).sum() for name, v in per.items()}
    total = alpha_img * totals["img"] + alpha_ts * totals["ts"] \
        + alpha_fus * totals["fus"]
    return {"total": total,
            "img_total": totals["img"], "ts_total": totals["ts"],
            "fus_total": totals["fus"],
            "img_per": per["img"], "ts_per": per["ts"], "fus_per": per["fus"]}


def pathology_multilabel_loss(stage2_logits, stage4_logits, y_multi,
                              y_multi_mask, label_weights,
                              pos_weight: Optional[torch.Tensor] = None,
                              alpha_stage2: float = 0.5,
                              alpha_stage4: float = 1.0) -> dict:
    """``single`` mode: stage 2 (image only) + stage 4 (multimodal) masked
    multi-label BCE (JAX ``losses.py:73-89``, reference
    loss/losses_duett.py:63-125). The defaults are the function's own, as
    in JAX; the training step passes ``TrainConfig``'s 1.0 and 0.5."""
    lw = label_weights.float()
    s2 = masked_per_label_bce(stage2_logits, y_multi, y_multi_mask,
                              pos_weight)
    s4 = masked_per_label_bce(stage4_logits, y_multi, y_multi_mask,
                              pos_weight)
    s2_total, s4_total = (lw * s2).sum(), (lw * s4).sum()
    return {"total": alpha_stage2 * s2_total + alpha_stage4 * s4_total,
            "stage2_total": s2_total, "stage4_total": s4_total,
            "stage2_per": s2, "stage4_per": s4}


def aux_residual_kl(img_logits, scaled_correction, y_multi, y_multi_mask,
                    label_smoothing: float = 0.05) -> torch.Tensor:
    """KL(Bernoulli(y_smooth) ‖ Bernoulli(σ(stop_grad(img) + correction)))
    over the masked labels: the gradient reaches only ``scaled_correction``
    (reference training_duett/engine.py:149-165)."""
    y = y_multi.float()
    eps = label_smoothing
    y_s = y * (1.0 - eps) + (1.0 - y) * eps
    p = torch.sigmoid(img_logits.detach().float() + scaled_correction.float())
    p = p.clamp(1e-6, 1.0 - 1e-6)
    kl = y_s * (torch.log(y_s) - torch.log(p)) + \
        (1.0 - y_s) * (torch.log(1.0 - y_s) - torch.log(1.0 - p))
    m = y_multi_mask.float()
    return (kl * m).sum() / m.sum().clamp_min(1.0)


def binary_kl_kd(z_s: torch.Tensor, z_t: torch.Tensor, T: float = 4.0,
                 eps: float = 1e-7) -> torch.Tensor:
    """T² · mean KL(σ(z_t/T) ‖ σ(z_s/T)) over binary logits, each
    probability clipped to [eps, 1 − eps]; the teacher's logits are
    constants (reference loss/losses_duett.py:8-26)."""
    z_t = z_t.detach().float()
    z_s = z_s.float()
    p_t = torch.sigmoid(z_t / T).clamp(eps, 1 - eps)
    p_s = torch.sigmoid(z_s / T).clamp(eps, 1 - eps)
    kl = p_t * (torch.log(p_t) - torch.log(p_s)) + \
        (1 - p_t) * (torch.log(1 - p_t) - torch.log(1 - p_s))
    return (T ** 2) * kl.mean()


# KD losses by the --kd_name flag (the reference's build_kd_loss,
# loss/losses_duett.py:28-36, holds 'vanilla_kl' only)
KD_LOSSES = {"vanilla_kl": binary_kl_kd}


def resolve_kd_loss(name: str):
    if name not in KD_LOSSES:
        raise ValueError(f"unknown KD loss: {name!r}. "
                         f"available: {list(KD_LOSSES)}")
    return KD_LOSSES[name]


def student_kd_loss(z_s, z_t, y, kd_T: float = 4.0, kd_alpha: float = 0.5,
                    pos_weight: Optional[torch.Tensor] = None,
                    kd_name: str = "vanilla_kl") -> dict:
    """total = α·BCE(z_s, y) + (1 − α)·KD(z_s, z_t)."""
    loss_bce = bce_with_logits(z_s, y, pos_weight=pos_weight)
    loss_kd = resolve_kd_loss(kd_name)(z_s, z_t, T=kd_T)
    return {"total": kd_alpha * loss_bce + (1.0 - kd_alpha) * loss_kd,
            "bce": loss_bce, "kd": loss_kd}


def ssl_pretrain_loss(y_hat_value, y_hat_presence, y_hat_events,
                      y_hat_events_presence, y_value, y_presence_mask,
                      y_events, y_events_mask,
                      pretrain_value: bool = True,
                      pretrain_presence: bool = True,
                      presence_weight: float = 0.2,
                      predict_events: bool = True) -> dict:
    """Masked value MSE + presence BCE + event value MSE + event presence
    BCE (reference duett.py:337-358), with the reference's quirk kept: the
    masked MSE is averaged over ALL elements
    (``F.mse_loss(y_hat·mask, y·mask)``), not only the observed ones.

    Shapes: y_hat_value/presence, y_value, y_presence_mask [B, S, V];
    y_hat_events(_presence), y_events, y_events_mask [B, T]."""
    out = {}
    total = torch.zeros((), dtype=torch.float32,
                        device=y_presence_mask.device)
    mask = y_presence_mask.float()
    if pretrain_value:
        diff = y_hat_value.float() * mask - y_value.float() * mask
        # mean over [B, V] per masked step, then over the steps
        out["value"] = (diff ** 2).mean(dim=(0, 2)).mean()
        total = total + out["value"]
    if pretrain_presence:
        pres = bce_with_logits(y_hat_presence, mask, reduce=False)
        out["presence"] = presence_weight * pres.mean(dim=(0, 2)).mean()
        total = total + out["presence"]
    if predict_events:
        em = y_events_mask.float()
        ediff = y_hat_events.float() * em - y_events.float() * em
        if pretrain_value:
            out["event_value"] = (ediff ** 2).mean()
            total = total + out["event_value"]
        if pretrain_presence:
            out["event_presence"] = presence_weight * bce_with_logits(
                y_hat_events_presence, em)
            total = total + out["event_presence"]
    out["total"] = total
    return out
