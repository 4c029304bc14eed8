"""Losses of the teacher step: the counterparts of ``bce_with_logits``,
``masked_per_label_bce``, ``dual_pathology_loss`` and ``aux_residual_kl`` in
``multimodal_edema_prediction_tpu/ops/losses.py:18-108``.

Every function computes in float32 whatever the dtype of its inputs, and
returns float32 scalars or [K] vectors.
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
