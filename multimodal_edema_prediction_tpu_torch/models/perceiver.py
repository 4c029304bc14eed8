"""Pathology-query Perceiver fusion: the PyTorch counterparts of
``PatchDualPathologyPerceiver`` (``dual_patch``), ``EventPatchPerceiver``
(``dual_patch_event``), ``PathologyPerceiver`` (``single``),
``TemporalPerceiver`` (``legacy``), ``DualPathologyPerceiver`` (``dual``),
their blocks and ``adaptive_avg_pool_tokens`` in
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
import torch.nn.functional as F
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


def _select_ts(ts_tokens: torch.Tensor, abl: str) -> torch.Tensor:
    """The DuETT tokens a temporal branch reads under ``ts_ablation``:
    all of them, the hourly ones, or the [REP] token alone."""
    if abl == "full":
        return ts_tokens
    if abl == "hourly_only":
        return ts_tokens[:, :-1, :]
    if abl == "rep_only":
        return ts_tokens[:, -1:, :]
    raise ValueError(f"unknown ts_ablation {abl!r}; expected one of "
                     "{'full', 'hourly_only', 'rep_only'}")


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
        _add_residual_heads(self, cfg)

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
        ts_kv = self.ts_proj(_select_ts(ts_tokens, abl))

        I = self.img_cross(q, img_patches_proj, train, gen)   # noqa: E741
        Tk = self.ts_cross(q, ts_kv, train, gen)
        I = self.img_self(I, I, train, gen)                   # noqa: E741
        Tk = self.ts_self(Tk, Tk, train, gen)
        return _residual_fusion(self, I, Tk, train, gen)


def _add_residual_heads(m: nn.Module, cfg: PerceiverConfig) -> None:
    """The residual-fusion parameters the ``dual_patch`` and
    ``dual_patch_event`` perceivers share: per-label image and temporal
    biases, β, the shared image and temporal heads and the correction
    head."""
    K, d = cfg.n_pathologies, cfg.d_latent
    m.image_label_bias = nn.Parameter(torch.zeros(K))
    m.temporal_label_bias = nn.Parameter(torch.zeros(K))
    m.beta = nn.Parameter(torch.ones(K))
    m.image_head = _Head(d, cfg.head_hidden, dropout=cfg.head_dropout)
    m.temporal_head = _Head(d, cfg.head_hidden, dropout=cfg.head_dropout)
    m.correction_head = CorrectionHead(d, cfg.head_hidden,
                                       _correction_dropout(cfg))


def _residual_fusion(m: nn.Module, I: torch.Tensor,   # noqa: E741
                     Tk: torch.Tensor, train: bool,
                     gen: Optional[torch.Generator]) -> dict:
    """The heads of ``_add_residual_heads`` on the image tokens ``I`` and
    the temporal tokens ``Tk`` [B, K, d]:
    fusion = stop_grad(img) + β · correction(Tk)."""
    img_logits = m.image_head(I, train, gen).squeeze(-1).float() \
        + m.image_label_bias[None, :]
    ts_logits = m.temporal_head(Tk, train, gen).squeeze(-1).float() \
        + m.temporal_label_bias[None, :]
    corr = m.correction_head(Tk, train, gen).squeeze(-1).float()
    scaled_corr = m.beta[None, :] * corr
    return {
        "img_logits": img_logits,
        "ts_logits": ts_logits,
        "fusion_logits": img_logits.detach() + scaled_corr,
        "img_tokens": I,
        "ts_tokens": Tk,
        "fusion_tokens": Tk,
        "ts_correction": corr,
        "scaled_correction": scaled_corr,
    }


class EventPerceiverBlock(nn.Module):
    """Event-grid cross-attention (JAX ``perceiver.py:207-253``): the
    ``PerceiverBlock`` skeleton with the query path ``event_query_proj`` →
    ``event_query_norm``, and a ``key_padding_mask`` on the keys."""

    def __init__(self, d: int, n_heads: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.event_query_proj = Dense(d, d)
        self.event_query_norm = LayerNorm(d)
        self.norm_kv = LayerNorm(d)
        self.attn = MultiHeadAttention(d, n_heads, d // n_heads, qkv_bias=True,
                                       dropout=dropout)
        self.norm_ff = LayerNorm(d)
        self.ff_in = Dense(d, 4 * d)
        self.ff_out = Dense(4 * d, d)

    def forward(self, queries: torch.Tensor, event_kv: torch.Tensor,
                train: bool = False, gen: Optional[torch.Generator] = None,
                key_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        p = self.dropout
        q = self.event_query_norm(self.event_query_proj(queries))
        k = self.norm_kv(event_kv)
        latents = queries + self.attn(q, k, train=train, gen=gen,
                                      key_padding_mask=key_padding_mask)
        h = dropout(gelu_exact(self.ff_in(self.norm_ff(latents))), p, train,
                    gen)
        return latents + dropout(self.ff_out(h), p, train, gen)


class EventPatchPerceiver(nn.Module):
    """``dual_patch_event`` mode (JAX ``perceiver.py:256-377``): separate
    ``image_queries`` and ``temporal_queries`` banks; the image branch of
    ``dual_patch`` (its ``img_cross`` without ``use_flash``, as in JAX);
    the temporal branch cross-attends the dynamic event grid, one key per
    clinical variable ([B, T, V, De] → [B, V, T·De] → ``event_kv_proj``),
    with the variables of ``ts_padding_mask`` [B, V] (True = never
    observed) masked, except in a sample where every variable is; the
    residual fusion of ``dual_patch``."""

    def __init__(self, cfg: PerceiverConfig, d_event: int):
        super().__init__()
        self.cfg = cfg
        K, d, p = cfg.n_pathologies, cfg.d_latent, cfg.dropout
        self.image_queries = nn.Parameter(torch.zeros(K, d))
        self.temporal_queries = nn.Parameter(torch.zeros(K, d))
        self.img_cross = PerceiverBlock(d, cfg.n_heads, dropout=p)
        self.img_self = PerceiverBlock(d, cfg.n_heads, dropout=p)
        self.event_kv_proj = Dense(d_event, d)
        self.event_cross = EventPerceiverBlock(d, cfg.n_heads, dropout=p)
        self.ts_self = PerceiverBlock(d, cfg.n_heads, dropout=p)
        _add_residual_heads(self, cfg)

    def forward(self, event_grid: torch.Tensor, img_patches_proj: torch.Tensor,
                train: bool = False, gen: Optional[torch.Generator] = None,
                ts_padding_mask: Optional[torch.Tensor] = None) -> dict:
        cfg = self.cfg
        if event_grid.dim() != 4:
            raise ValueError(f"event_grid must be [B,T,V,d_emb], "
                             f"got {tuple(event_grid.shape)}")
        B, T, V, De = event_grid.shape
        dt = event_grid.dtype
        shape = (B, cfg.n_pathologies, cfg.d_latent)
        img_q = self.image_queries.to(dt).expand(shape)
        ts_q = self.temporal_queries.to(dt).expand(shape)
        I = self.img_cross(img_q, img_patches_proj, train, gen)  # noqa: E741
        I = self.img_self(I, I, train, gen)                      # noqa: E741
        ev_kv = self.event_kv_proj(
            event_grid.permute(0, 2, 1, 3).reshape(B, V, T * De))
        mask = None
        if ts_padding_mask is not None:
            # a sample with no observed variable attends to all of them
            mask = ts_padding_mask & ~ts_padding_mask.all(-1, keepdim=True)
        Tk = self.event_cross(ts_q, ev_kv, train, gen, key_padding_mask=mask)
        Tk = self.ts_self(Tk, Tk, train, gen)
        return _residual_fusion(self, I, Tk, train, gen)


def adaptive_avg_pool_tokens(patches: torch.Tensor, out_hw: int = 7
                             ) -> torch.Tensor:
    """[B, g², D] patch tokens → [B, out_hw², D] by adaptive average
    pooling of the g × g grid, torch's bounds (cell i spans
    [⌊i·g/o⌋, ⌈(i+1)·g/o⌉)), as JAX's ``adaptive_avg_pool_tokens``
    (37 × 37 → 7 × 7)."""
    B, N, D = patches.shape
    g = int(N ** 0.5)
    grid = patches.reshape(B, g, g, D).permute(0, 3, 1, 2)
    pooled = F.adaptive_avg_pool2d(grid, out_hw)          # [B, D, o, o]
    return pooled.flatten(2).transpose(1, 2)


class PathologyPerceiver(nn.Module):
    """``single`` mode (JAX ``perceiver.py:438-506``): K
    ``pathology_queries`` read the image (``img_cross``, ``img_self``:
    stage 2), then the DuETT tokens (``ts_cross``, ``ts_self``: stage 4);
    per-label stacked heads on each stage's tokens. Its ablation default
    is ``"full"``, not ``cfg.ts_ablation`` (the ``dual_patch`` knob)."""

    def __init__(self, cfg: PerceiverConfig, d_ts: int):
        super().__init__()
        self.cfg = cfg
        K, d, p = cfg.n_pathologies, cfg.d_latent, cfg.dropout
        self.pathology_queries = nn.Parameter(torch.zeros(K, d))
        self.ts_proj = Dense(d_ts, d)
        self.img_cross = PerceiverBlock(d, cfg.n_heads, dropout=p)
        self.img_self = PerceiverBlock(d, cfg.n_heads, dropout=p)
        self.ts_cross = PerceiverBlock(d, cfg.n_heads, dropout=p)
        self.ts_self = PerceiverBlock(d, cfg.n_heads, dropout=p)
        self.stage2_heads = StackedLabelHeads(K, d, cfg.head_hidden,
                                              cfg.head_dropout)
        self.stage4_heads = StackedLabelHeads(K, d, cfg.head_hidden,
                                              cfg.head_dropout)

    def forward(self, ts_tokens: torch.Tensor, img_patches_proj: torch.Tensor,
                ts_ablation: Optional[str] = None, train: bool = False,
                gen: Optional[torch.Generator] = None) -> dict:
        cfg = self.cfg
        B = ts_tokens.shape[0]
        q = self.pathology_queries.to(ts_tokens.dtype).expand(
            B, cfg.n_pathologies, cfg.d_latent)
        ts_kv = self.ts_proj(_select_ts(ts_tokens, ts_ablation or "full"))
        h = self.img_cross(q, img_patches_proj, train, gen)
        s2 = self.img_self(h, h, train, gen)
        h = self.ts_cross(s2, ts_kv, train, gen)
        s4 = self.ts_self(h, h, train, gen)
        return {"stage2_logits": self.stage2_heads(s2, train, gen).float(),
                "stage4_logits": self.stage4_heads(s4, train, gen).float(),
                "stage2_tokens": s2, "stage4_tokens": s4}


class TemporalPerceiver(nn.Module):
    """``legacy`` mode (JAX ``perceiver.py:380-417``): ``cfg.n_latents``
    learned latents pass through ``cfg.n_layers`` pairs of blocks, the
    image kv (``img_block_{i}``) then the projected DuETT tokens
    (``ts_block_{i}``); ``norm_out``, then the mean over the latents →
    [B, d_latent]."""

    def __init__(self, cfg: PerceiverConfig, d_ts: int):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.d_latent, cfg.dropout
        self.latents = nn.Parameter(torch.zeros(cfg.n_latents, d))
        self.ts_proj = Dense(d_ts, d)
        for i in range(cfg.n_layers):
            self.add_module(f"img_block_{i}",
                            PerceiverBlock(d, cfg.n_heads, dropout=p))
            self.add_module(f"ts_block_{i}",
                            PerceiverBlock(d, cfg.n_heads, dropout=p))
        self.norm_out = LayerNorm(d)

    def forward(self, ts_tokens: torch.Tensor, img_kv_proj: torch.Tensor,
                train: bool = False, gen: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        cfg = self.cfg
        B = ts_tokens.shape[0]
        h = self.latents.to(ts_tokens.dtype).expand(B, cfg.n_latents,
                                                    cfg.d_latent)
        ts_kv = self.ts_proj(ts_tokens)
        for i in range(cfg.n_layers):
            h = getattr(self, f"img_block_{i}")(h, img_kv_proj, train, gen)
            h = getattr(self, f"ts_block_{i}")(h, ts_kv, train, gen)
        return self.norm_out(h).mean(dim=1)


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
        Tk = self.ts_cross(q, self.ts_proj(_select_ts(ts_tokens, abl)),
                           train, gen)
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
