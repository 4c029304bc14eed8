"""Pathology-query Perceiver fusion: the PyTorch counterparts of
``PatchDualPathologyPerceiver`` (``dual_patch``), ``DualPathologyPerceiver``
(``dual``) and their blocks in
``multimodal_edema_prediction_tpu/models/perceiver.py``.

Residual fusion rule:
    fusion_logit = stop_grad(img_logit) + beta[k] · correction_head(T_k)
(JAX ``perceiver.py:189``): the fusion loss trains only the correction path.
While training, ``dropout`` applies to the attention probabilities and after
each block's FF layers, ``head_dropout`` inside the image and temporal heads,
and ``_correction_dropout`` inside the correction head.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import PerceiverConfig
from .layers import Dense, LayerNorm, MultiHeadAttention, dropout, gelu_exact


class PerceiverBlock(nn.Module):
    """Pre-LN cross-attention + FFN with residuals. The LayerNorms keep
    flax's default eps of 1e-6, not torch's 1e-5."""

    def __init__(self, d: int, n_heads: int, use_flash: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.norm_q = LayerNorm(d)
        self.norm_kv = LayerNorm(d)
        self.attn = MultiHeadAttention(d, n_heads, d // n_heads, qkv_bias=True,
                                       use_flash=use_flash, dropout=dropout)
        self.norm_ff = LayerNorm(d)
        self.ff_in = Dense(d, 4 * d)
        self.ff_out = Dense(4 * d, d)

    def forward(self, latents: torch.Tensor, kv: torch.Tensor,
                train: bool = False, gen: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        p = self.dropout
        q = self.norm_q(latents)
        k = self.norm_kv(kv).to(latents.dtype)
        latents = latents + self.attn(q, k, train=train, gen=gen)
        h = dropout(gelu_exact(self.ff_in(self.norm_ff(latents))), p, train,
                    gen)
        return latents + dropout(self.ff_out(h), p, train, gen)


class _Head(nn.Module):
    """Linear → GELU → Dropout → Linear(1) (reference ``_mk_head``
    :572-576)."""

    def __init__(self, d_in: int, d_hidden: int, use_bias_out: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.add_module("in", Dense(d_in, d_hidden))
        self.out = Dense(d_hidden, 1, use_bias_out)

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        h = gelu_exact(getattr(self, "in")(x))
        return self.out(dropout(h, self.dropout, train, gen))


class CorrectionHead(nn.Module):
    """LN → Linear → GELU → Dropout → Linear(no bias) (reference
    :582-589)."""

    def __init__(self, d_in: int, d_hidden: int, dropout: float = 0.0):
        super().__init__()
        self.norm = LayerNorm(d_in)
        self.head = _Head(d_in, d_hidden, use_bias_out=False,
                          dropout=dropout)

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.head(self.norm(x), train, gen)


def _correction_dropout(cfg: PerceiverConfig) -> float:
    """Correction-head dropout: ``correction_dropout`` when set, otherwise
    the shared head dropout."""
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
        p = cfg.dropout
        self.img_cross = PerceiverBlock(d, cfg.n_heads,
                                        use_flash=cfg.use_flash, dropout=p)
        self.img_self = PerceiverBlock(d, cfg.n_heads, dropout=p)
        self.ts_cross = PerceiverBlock(d, cfg.n_heads, dropout=p)
        self.ts_self = PerceiverBlock(d, cfg.n_heads, dropout=p)
        self.image_label_bias = nn.Parameter(torch.zeros(K))
        self.temporal_label_bias = nn.Parameter(torch.zeros(K))
        self.beta = nn.Parameter(torch.ones(K))
        self.image_head = _Head(d, cfg.head_hidden,
                                dropout=cfg.head_dropout)
        self.temporal_head = _Head(d, cfg.head_hidden,
                                   dropout=cfg.head_dropout)
        self.correction_head = CorrectionHead(d, cfg.head_hidden,
                                              _correction_dropout(cfg))

    def forward(self, ts_tokens: torch.Tensor, img_patches_proj: torch.Tensor,
                ts_ablation: Optional[str] = None, train: bool = False,
                gen: Optional[torch.Generator] = None) -> dict:
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

        I = self.img_cross(q, img_patches_proj, train, gen)   # noqa: E741
        Tk = self.ts_cross(q, ts_kv, train, gen)
        I = self.img_self(I, I, train, gen)                   # noqa: E741
        Tk = self.ts_self(Tk, Tk, train, gen)

        img_logits = self.image_head(I, train, gen).squeeze(-1).float() \
            + self.image_label_bias[None, :]
        ts_logits = self.temporal_head(Tk, train, gen).squeeze(-1).float() \
            + self.temporal_label_bias[None, :]
        corr = self.correction_head(Tk, train, gen).squeeze(-1).float()
        scaled_corr = self.beta[None, :] * corr
        fusion_logits = img_logits.detach() + scaled_corr
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


class StackedLabelHeads(nn.Module):
    """K independent per-label MLP heads (the reference ``dual`` perceiver's
    ``nn.ModuleList([_mk_head() for _ in range(K)])``, :688-694) as
    stacked parameters, flax's leaves: ``w1 [K, d, H]``, ``b1 [K, H]``,
    ``w2 [K, H, 1]``, ``b2 [K, 1]``; x [B, K, d] → [B, K] (JAX
    ``perceiver.py:509-534``)."""

    def __init__(self, n_labels: int, d_in: int, d_hidden: int,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.w1 = nn.Parameter(torch.zeros(n_labels, d_in, d_hidden))
        self.b1 = nn.Parameter(torch.zeros(n_labels, d_hidden))
        self.w2 = nn.Parameter(torch.zeros(n_labels, d_hidden, 1))
        self.b2 = nn.Parameter(torch.zeros(n_labels, 1))

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = x.dtype
        h = torch.einsum("bkd,kdh->bkh", x, self.w1.to(dt)) + self.b1.to(dt)
        h = dropout(gelu_exact(h), self.dropout, train, gen)
        o = torch.einsum("bkh,kho->bko", h, self.w2.to(dt)) + self.b2.to(dt)
        return o[..., 0]


class DualPathologyPerceiver(nn.Module):
    """``dual`` mode (JAX ``perceiver.py:537-603``, reference :659-741): the
    image branch is the frozen pretrained CXR head's logits, passed in and
    detached; K shared queries cross-attend the DuETT tokens; per-label
    temporal and residual heads; plain additive fusion with no β:
    ``fusion_logit[k] = img_logit[k] + residual_head_k(T_k)``."""

    def __init__(self, cfg: PerceiverConfig, d_ts: int):
        super().__init__()
        self.cfg = cfg
        K, d = cfg.n_pathologies, cfg.d_latent
        self.shared_queries = nn.Parameter(torch.zeros(K, d))
        self.ts_proj = Dense(d_ts, d)
        self.ts_cross = PerceiverBlock(d, cfg.n_heads, dropout=cfg.dropout)
        self.ts_self = PerceiverBlock(d, cfg.n_heads, dropout=cfg.dropout)
        self.temporal_heads = StackedLabelHeads(K, d, cfg.head_hidden,
                                                cfg.head_dropout)
        self.residual_heads = StackedLabelHeads(K, d, cfg.head_hidden,
                                                cfg.head_dropout)

    def forward(self, ts_tokens: torch.Tensor, img_logits: torch.Tensor,
                ts_ablation: Optional[str] = None, train: bool = False,
                gen: Optional[torch.Generator] = None) -> dict:
        cfg = self.cfg
        abl = ts_ablation or cfg.ts_ablation
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
            raise ValueError(f"unknown ts_ablation {abl!r}; expected one of "
                             "{'full', 'hourly_only', 'rep_only'}")
        Tk = self.ts_cross(q, self.ts_proj(ts_sel), train, gen)
        Tk = self.ts_self(Tk, Tk, train, gen)
        ts_logits = self.temporal_heads(Tk, train, gen).float()
        residuals = self.residual_heads(Tk, train, gen).float()
        img_logits = img_logits.float().detach()
        return {
            "img_logits": img_logits,
            "ts_logits": ts_logits,
            "fusion_logits": img_logits + residuals,
            "ts_tokens": Tk,
            "fusion_tokens": Tk,
            "residuals": residuals,
            # the evaluator reads the additive residual as an unscaled
            # correction
            "ts_correction": residuals,
            "scaled_correction": residuals,
        }
