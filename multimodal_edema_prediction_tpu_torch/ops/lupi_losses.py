"""Legacy LUPI (learning under privileged information) distillation
losses: the counterpart of
``multimodal_edema_prediction_tpu/ops/lupi_losses.py``.

The reference's ``loss/losses.py`` defines them as dead code, and neither
package calls them; they are here for the privileged → deployable
distillation they describe, held against the JAX package by the tests:

    masked soft cross-entropy (the subtype head)
    NaN-masked soft-label BCE
    feature and readout distillation (cosine + smooth-L1)
    temperature-T binary logit distillation
    covariance regularization (off-diagonal penalty on pooled features)

``dual_stream_distillation_loss`` composes them with the reference's
weights. Everything is computed in float32; ``jax.lax.stop_gradient``
is ``detach``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def masked_soft_cross_entropy(logits, target_probs, mask):
    """-Σ p·log_softmax(logits) over masked rows; (loss, valid_count)."""
    logits = logits.float()
    p = target_probs.float()
    m = mask.float()
    ce = -(p * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    count = m.sum()
    loss = (ce * m).sum() / count.clamp_min(1.0)
    return torch.where(count > 0, loss, 0.0 * logits.sum()), count


def _bce_with_logits(x, y):
    """max(x, 0) − x·y + log1p(exp(−|x|)), elementwise (``maximum``, whose
    gradient at x = 0 is ½ as ``jnp.maximum``'s)."""
    return torch.maximum(x, torch.zeros_like(x)) - x * y \
        + torch.log1p(torch.exp(-x.abs()))


def nan_masked_bce(logits, soft_labels):
    """BCE over entries whose (soft) label is not NaN; (loss, count)."""
    y = soft_labels.float()
    valid = ~torch.isnan(y)
    x = logits.float()
    per = _bce_with_logits(x, torch.where(valid, y, torch.zeros_like(y)))
    count = valid.sum()
    loss = (per * valid).sum() / count.clamp_min(1)
    return torch.where(count > 0, loss, 0.0 * x.sum()), count


def _cos_l1_match(student_feat, teacher_feat):
    """Direction (1 − cosine) + magnitude (smooth-L1) feature matching."""
    t = teacher_feat.detach().float()
    s = student_feat.float()
    cos = (s * t).sum(-1) / (torch.linalg.vector_norm(s, dim=-1)
                             * torch.linalg.vector_norm(t, dim=-1) + 1e-8)
    cos_loss = (1.0 - cos).mean()
    diff = (s - t).abs()
    l1 = torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5).mean()
    return cos_loss + l1, cos_loss, l1


def covariance_regularization(features):
    """Off-diagonal covariance penalty on pooled features [B, D]."""
    f = features.float()
    f = f - f.mean(dim=0, keepdim=True)
    n = f.shape[0]
    cov = (f.T @ f) / max(n - 1, 1)
    off = cov - torch.diag(torch.diag(cov))
    return (off ** 2).sum() / f.shape[1]


def binary_logit_kd(logit_priv, logit_deploy, valid, T: float = 2.0):
    """T²·BCE(σ(priv/T) targets, deploy/T logits) over valid rows."""
    lp = logit_priv.detach().float()
    x = logit_deploy.float() / T
    per = _bce_with_logits(x, torch.sigmoid(lp / T))
    count = valid.sum()
    return torch.where(count > 0,
                       (T ** 2) * (per * valid).sum() / count.clamp_min(1),
                       torch.zeros((), device=x.device))


def dual_stream_distillation_loss(
        logit_priv, logit_deploy, soft_labels,
        fused_priv=None, fused_deploy=None,
        readout_priv=None, readout_deploy=None,
        subtype_logits_priv=None, subtype_logits_deploy=None,
        subtype_target_probs=None, subtype_mask=None,
        fd_weight: float = 1.0, rd_weight: float = 1.0,
        kd_weight: float = 1.0, cov_weight: float = 0.0,
        subtype_weight: float = 0.0, kd_T: float = 2.0) -> dict:
    """Privileged (priv) → deployable (deploy) dual-stream loss (reference
    ``loss/losses.py:44-191``)."""
    bce_priv, n_valid = nan_masked_bce(logit_priv, soft_labels)
    bce_deploy, _ = nan_masked_bce(logit_deploy, soft_labels)
    valid = (~torch.isnan(soft_labels.float())).float()

    out = {"bce_priv": bce_priv, "bce_deploy": bce_deploy,
           "n_valid": n_valid}
    total = bce_priv + bce_deploy

    if fused_priv is not None and fused_deploy is not None:
        fd, fd_cos, fd_l1 = _cos_l1_match(fused_deploy, fused_priv)
        out.update({"fd": fd, "fd_cos": fd_cos, "fd_l1": fd_l1})
        total = total + fd_weight * fd
    if readout_priv is not None and readout_deploy is not None:
        rd, rd_cos, rd_l1 = _cos_l1_match(readout_deploy, readout_priv)
        out.update({"rd": rd, "rd_cos": rd_cos, "rd_l1": rd_l1})
        total = total + rd_weight * rd
    kd = binary_logit_kd(logit_priv, logit_deploy, valid, kd_T)
    out["kd"] = kd
    total = total + kd_weight * kd
    if cov_weight > 0 and fused_deploy is not None:
        pooled = fused_deploy.mean(dim=1) if fused_deploy.dim() == 3 \
            else fused_deploy
        cov = covariance_regularization(pooled)
        out["cov"] = cov
        total = total + cov_weight * cov
    if subtype_weight > 0 and subtype_target_probs is not None:
        st = 0.0
        for logits in (subtype_logits_priv, subtype_logits_deploy):
            if logits is not None:
                loss, _ = masked_soft_cross_entropy(
                    logits, subtype_target_probs, subtype_mask)
                st = st + loss
        out["subtype"] = st
        total = total + subtype_weight * st
    out["total"] = total
    return out
