"""Pathology-query Perceiver fusion, eval-mode: the PyTorch counterpart of
``PatchDualPathologyPerceiver`` and its blocks in
``multimodal_edema_prediction_tpu/models/perceiver.py``.

Residual fusion rule:
    fusion_logit = img_logit + beta[k] · correction_head(T_k)
(the JAX package stops the gradient through img_logit; the port serves only,
so there is no gradient to stop).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import PerceiverConfig
from .layers import Dense, LayerNorm, MultiHeadAttention, gelu_exact


class PerceiverBlock(nn.Module):
    """Pre-LN cross-attention + FFN with residuals. The LayerNorms keep
    flax's default eps of 1e-6, not torch's 1e-5."""

    def __init__(self, d: int, n_heads: int, use_flash: bool = False):
        super().__init__()
        self.norm_q = LayerNorm(d)
        self.norm_kv = LayerNorm(d)
        self.attn = MultiHeadAttention(d, n_heads, d // n_heads, qkv_bias=True,
                                       use_flash=use_flash)
        self.norm_ff = LayerNorm(d)
        self.ff_in = Dense(d, 4 * d)
        self.ff_out = Dense(4 * d, d)

    def forward(self, latents: torch.Tensor, kv: torch.Tensor
                ) -> torch.Tensor:
        q = self.norm_q(latents)
        k = self.norm_kv(kv).to(latents.dtype)
        latents = latents + self.attn(q, k)
        h = self.ff_out(gelu_exact(self.ff_in(self.norm_ff(latents))))
        return latents + h


class _Head(nn.Module):
    """Linear → GELU → Linear(1) (reference ``_mk_head`` :572-576)."""

    def __init__(self, d_in: int, d_hidden: int, use_bias_out: bool = True):
        super().__init__()
        self.add_module("in", Dense(d_in, d_hidden))
        self.out = Dense(d_hidden, 1, use_bias_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(gelu_exact(getattr(self, "in")(x)))


class CorrectionHead(nn.Module):
    """LN → Linear → GELU → Linear(no bias) (reference :582-589)."""

    def __init__(self, d_in: int, d_hidden: int):
        super().__init__()
        self.norm = LayerNorm(d_in)
        self.head = _Head(d_in, d_hidden, use_bias_out=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.norm(x))


def _correction_dropout(cfg: PerceiverConfig) -> float:
    """Correction-head dropout: ``correction_dropout`` when set, otherwise
    the shared head dropout. Eval-mode serving applies no dropout; kept so
    that training slices read the same rule."""
    return cfg.head_dropout if cfg.correction_dropout is None \
        else cfg.correction_dropout


class PatchDualPathologyPerceiver(nn.Module):
    """K shared pathology queries cross-attend image patches and DuETT
    hourly tokens; residual fusion on top (reference :538-654)."""

    def __init__(self, cfg: PerceiverConfig, d_ts: int):
        super().__init__()
        self.cfg = cfg
        K, d = cfg.n_pathologies, cfg.d_latent
        self.shared_queries = nn.Parameter(torch.zeros(K, d))
        self.ts_proj = Dense(d_ts, d)
        self.img_cross = PerceiverBlock(d, cfg.n_heads,
                                        use_flash=cfg.use_flash)
        self.img_self = PerceiverBlock(d, cfg.n_heads)
        self.ts_cross = PerceiverBlock(d, cfg.n_heads)
        self.ts_self = PerceiverBlock(d, cfg.n_heads)
        self.image_label_bias = nn.Parameter(torch.zeros(K))
        self.temporal_label_bias = nn.Parameter(torch.zeros(K))
        self.beta = nn.Parameter(torch.ones(K))
        self.image_head = _Head(d, cfg.head_hidden)
        self.temporal_head = _Head(d, cfg.head_hidden)
        self.correction_head = CorrectionHead(d, cfg.head_hidden)

    def forward(self, ts_tokens: torch.Tensor, img_patches_proj: torch.Tensor,
                ts_ablation: Optional[str] = None) -> dict:
        cfg = self.cfg
        abl = ts_ablation or cfg.ts_ablation
        if ts_tokens.dim() != 3:
            raise ValueError(f"ts_tokens must be [B,T+1,d_ts], "
                             f"got {tuple(ts_tokens.shape)}")
        B = ts_tokens.shape[0]
        q = self.shared_queries.to(ts_tokens.dtype).expand(
            B, cfg.n_pathologies, cfg.d_latent)
        if abl == "full":
            ts_sel = ts_tokens
        elif abl == "hourly_only":
            ts_sel = ts_tokens[:, :-1, :]
        elif abl == "rep_only":
            ts_sel = ts_tokens[:, -1:, :]
        else:
            raise ValueError(f"unknown ts_ablation {abl!r}")
        ts_kv = self.ts_proj(ts_sel)

        I = self.img_cross(q, img_patches_proj)   # noqa: E741
        Tk = self.ts_cross(q, ts_kv)
        I = self.img_self(I, I)                   # noqa: E741
        Tk = self.ts_self(Tk, Tk)

        img_logits = self.image_head(I).squeeze(-1).float() \
            + self.image_label_bias[None, :]
        ts_logits = self.temporal_head(Tk).squeeze(-1).float() \
            + self.temporal_label_bias[None, :]
        corr = self.correction_head(Tk).squeeze(-1).float()
        scaled_corr = self.beta[None, :] * corr
        fusion_logits = img_logits + scaled_corr
        return {
            "img_logits": img_logits,
            "ts_logits": ts_logits,
            "fusion_logits": fusion_logits,
            "img_tokens": I,
            "ts_tokens": Tk,
            "fusion_tokens": Tk,
            "ts_correction": corr,
            "scaled_correction": scaled_corr,
        }
