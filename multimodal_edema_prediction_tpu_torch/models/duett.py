"""DuETT dual-axis transformer over the (time × event) grid: the PyTorch
counterpart of ``multimodal_edema_prediction_tpu/models/duett.py``
(``feats_to_input``, ``DuettEncoder``, the SSL masking
``pretrain_prep_batch``, ``DuettPretrainModel`` and the supervised
``DuettClassifier``).

Train-time augmentation and the SSL masks draw from a ``torch.Generator``;
the JAX package draws from ``jax.random``, so the two give different noise
from the same seed and are compared in distribution
(``tests/test_torch_train_layers.py``, ``tests/test_torch_ssl.py``), or
with the masks handed to both (``mask_idx``/``event_var``).

Shape conventions
    x_ts    [B, T, 2V]   dense window: values(V) | counts(V)
    x_in    [B, T, 2V+1] after feats_to_input: values | counts | mask-col
    times   [B, T]       bin end times (hours / 24)
    tokens  [B, T+1, R]  R = d_embedding·(V+1); row T is the [REP] token
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..config import DuettConfig
from ..parallel.multihost import draw_rows
from .layers import (CVE, PerVariableMLP, SimpleMLP, TransformerEncoder,
                     init_like_flax)

MASKED_KEY = 0           # duett.py:79
REP_KEY = 1              # duett.py:80


def feats_to_input(x_ts: torch.Tensor, x_static: torch.Tensor,
                   aug_noise: float = 0.0, aug_mask: float = 0.0,
                   train: bool = False,
                   gen: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append the mask column and, while training, augment (JAX
    ``duett.py:43-69``): values get N(0, aug_noise²) noise scaled by their
    count channel and the static features unscaled N(0, aug_noise²) noise;
    each timestep is masked with probability ``aug_mask`` (values and counts
    zeroed, mask column set to 1). Returns (x_in [B,T,2V+1], x_static)."""
    B, T, C = x_ts.shape
    V = C // 2
    values, counts = x_ts[..., :V], x_ts[..., V:]
    mask_col = torch.zeros(B, T, 1, dtype=x_ts.dtype, device=x_ts.device)
    if train and (aug_noise > 0 or aug_mask > 0):
        if gen is None:
            raise ValueError("augmentation needs a torch.Generator")

        def normal(shape, dtype):
            return draw_rows(lambda sh: torch.randn(
                sh, generator=gen, device=x_ts.device,
                dtype=torch.float32), shape).to(dtype)

        if aug_noise > 0:
            values = values + aug_noise * normal(values.shape,
                                                 values.dtype) * counts
            x_static = x_static + aug_noise * normal(x_static.shape,
                                                     x_static.dtype)
        if aug_mask > 0:
            m = draw_rows(lambda sh: torch.rand(
                sh, generator=gen, device=x_ts.device), (B, T)) < aug_mask
            values = values.masked_fill(m[..., None], 0.0)
            counts = counts.masked_fill(m[..., None], 0.0)
            mask_col = m[..., None].to(x_ts.dtype)
    return torch.cat([values, counts, mask_col], dim=-1), x_static


class PretrainBatch(NamedTuple):
    """Masked SSL inputs and reconstruction targets (reference
    duett.py:189-237)."""
    x_in: torch.Tensor             # [B, T, 2V+1] masked input
    mask_idx: torch.Tensor         # [B, S] masked timestep indices (int64)
    y_value: torch.Tensor          # [B, S, V] target values
    y_presence_mask: torch.Tensor  # [B, S, V] target presence (counts 0..1)
    event_var: torch.Tensor        # [B] masked variable index (int64)
    y_events: torch.Tensor         # [B, T] the masked variable's values
    y_events_mask: torch.Tensor    # [B, T]


def pretrain_prep_batch(x_ts: torch.Tensor, masked_steps: int = 1,
                        pretrain_dropout: float = 0.5,
                        predict_events: bool = True,
                        mask_idx: Optional[torch.Tensor] = None,
                        event_var: Optional[torch.Tensor] = None,
                        gen: Optional[torch.Generator] = None
                        ) -> PretrainBatch:
    """SSL masking of dense windows [B, T, 2V] (JAX ``duett.py:83-147``):
    ``masked_steps`` timesteps per sample drawn with replacement and
    zeroed (mask column 1), one variable per sample event-masked (values 0,
    counts −1) when ``predict_events``, and, with ``pretrain_dropout`` > 0,
    each variable dropped with that probability unless it was observed at
    a masked step. ``mask_idx`` [B, S] / ``event_var`` [B] replace the draws
    with the caller's masks. The draws come from ``gen``, in that order."""
    B, T, C = x_ts.shape
    V = C // 2
    S = masked_steps
    dev = x_ts.device

    def need_gen():
        if gen is None:
            raise ValueError("SSL masking draws need a torch.Generator")
        return gen

    values, counts = x_ts[..., :V], x_ts[..., V:]
    if mask_idx is None:
        mask_idx = draw_rows(lambda sh: torch.randint(
            0, T, sh, generator=need_gen(), device=dev), (B, S))
    mask_idx = mask_idx.to(device=dev, dtype=torch.int64).reshape(B, S)
    idx = mask_idx[..., None].expand(B, S, V)
    y_value = torch.gather(values, 1, idx)                     # [B,S,V]
    y_presence_mask = torch.gather(counts, 1, idx).clamp(0.0, 1.0)

    # [B, T]: step t is masked when any of the S draws is t (no host
    # value written in: a CUDA graph's capture takes no such copy)
    row_masked = (torch.arange(T, device=dev)[None, None]
                  == mask_idx[..., None]).any(1)
    x_masked = x_ts.masked_fill(row_masked[..., None], 0.0)
    mask_col = row_masked[..., None].to(x_ts.dtype)

    if event_var is None:
        event_var = draw_rows(lambda sh: torch.randint(
            0, V, sh, generator=need_gen(), device=dev), (B,))
    event_var = event_var.to(device=dev, dtype=torch.int64).reshape(B)
    rows = torch.arange(B, device=dev)
    y_events = values[rows, :, event_var]                      # [B,T]
    y_events_mask = counts[rows, :, event_var].clamp(0.0, 1.0)
    x_val, x_cnt = x_masked[..., :V], x_masked[..., V:]
    if predict_events:
        vmask = (torch.arange(V, device=dev) == event_var[:, None])[:, None]
        x_val = x_val.masked_fill(vmask, 0.0)
        x_cnt = x_cnt.masked_fill(vmask, -1.0)

    if pretrain_dropout > 0:
        keep = draw_rows(lambda sh: torch.rand(
            sh, generator=need_gen(), device=dev), (B, V)) \
            > pretrain_dropout
        observed_at_masked = y_presence_mask.sum(dim=1).clamp(0.0, 1.0)
        keep = (observed_at_masked < 0.5) | keep                # [B,V]
        kb = keep[:, None, :]
        x_val = torch.where(kb, x_val, torch.zeros_like(x_val))
        x_cnt = torch.where(kb | (x_cnt == -1.0), x_cnt,
                            torch.zeros_like(x_cnt))

    x_in = torch.cat([x_val, x_cnt, mask_col], dim=-1)
    return PretrainBatch(x_in, mask_idx, y_value, y_presence_mask,
                         event_var, y_events, y_events_mask)


class DuettEncoder(nn.Module):
    """Dual-axis encoder: returns all T+1 contextual tokens and the psi
    grid [B, T+1, V+1, d]. ``train`` switches BatchNorm to batch statistics
    and turns on ``transformer_dropout``."""

    def __init__(self, cfg: DuettConfig):
        super().__init__()
        self.cfg = cfg
        V, d = cfg.n_variables, cfg.d_embedding
        self.n_obs_embedding = nn.Embedding(cfg.n_obs_bins, 1)
        self.embedding_layers = PerVariableMLP(V, d,
                                               cfg.d_hidden_mlp_embedding)
        self.tab_encoder = SimpleMLP(cfg.d_static, d, cfg.n_hidden_tab_encoder,
                                     cfg.d_hidden_tab_encoder,
                                     hidden_batch_norm=True)
        self.special_embeddings = nn.Parameter(torch.zeros(8, d))
        self.full_time_embedding = CVE(cfg.tt_dim, batch_norm=True)
        self.full_rep_embedding = nn.Parameter(torch.zeros(cfg.tt_dim))
        self.full_event_embedding = nn.Parameter(
            torch.zeros(V + 1, cfg.et_dim))
        d_head = d // cfg.n_heads
        for i in range(cfg.n_layers):
            for axis, dim in (("event", cfg.et_dim), ("time", cfg.tt_dim)):
                self.add_module(f"{axis}_transformer_{i}", TransformerEncoder(
                    dim, 1, cfg.n_heads, d_head, cfg.d_feedforward,
                    cfg.scalenorm, cfg.transformer_dropout))

    def forward(self, x_in: torch.Tensor, x_static: torch.Tensor,
                times: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        B, T, _ = x_in.shape
        V, d = cfg.n_variables, cfg.d_embedding
        dt = x_in.dtype
        values, counts = x_in[..., :V], x_in[..., V:2 * V]
        row_mask_col = x_in[..., -1]

        # event-mask cells flagged by count == -1 (duett.py:248-250)
        event_mask = counts == -1.0                             # [B,T,V]
        event_mask = torch.cat(
            [event_mask, event_mask.new_zeros(B, T, 1)], dim=2)   # +static
        event_mask = torch.cat([event_mask, event_mask[:, :1]], dim=1)

        # count-bin embedding → scalar per cell (duett.py:88,251-252)
        bins = counts.to(torch.int32).clamp(0, cfg.n_obs_bins - 1).long()
        n_obs = self.n_obs_embedding.weight[bins, 0].to(dt)
        cell_in = torch.stack([values, n_obs], dim=-1)         # [B,T,V,2]
        emb = self.embedding_layers(cell_in, train)             # [B,T,V,d]
        static_emb = self.tab_encoder(x_static.to(dt), train)  # [B,d]
        special = self.special_embeddings.to(dt)

        psi_t = torch.cat([emb, static_emb[:, None, None, :].expand(
            B, T, 1, d)], dim=2)                                 # [B,T,V+1,d]
        rep_row = special[REP_KEY].expand(B, 1, V + 1, d)
        psi = torch.cat([psi_t, rep_row], dim=1)               # [B,T+1,V+1,d]
        row_mask = torch.cat([row_mask_col == 1.0,
                              row_mask_col.new_zeros(B, 1, dtype=torch.bool)],
                             dim=1)
        psi = torch.where(row_mask[:, :, None, None], special[MASKED_KEY], psi)
        psi = torch.where(event_mask[..., None], special[MASKED_KEY], psi)

        tt_dim, et_dim = cfg.tt_dim, cfg.et_dim
        time_emb = self.full_time_embedding(times[..., None].to(dt), train)
        rep_time = self.full_rep_embedding.to(dt).expand(B, 1, tt_dim)
        time_emb = torch.cat([time_emb, rep_time], dim=1)      # [B,T+1,tt]
        event_pos = self.full_event_embedding.to(dt)

        for i in range(cfg.n_layers):
            # event axis: tokens = variables, channels = all timesteps
            ev = psi.permute(0, 2, 1, 3).reshape(B, V + 1, et_dim) + event_pos
            ev = getattr(self, f"event_transformer_{i}")(ev, train, gen)
            psi = ev.reshape(B, V + 1, T + 1, d).permute(0, 2, 1, 3)
            # time axis: tokens = hours, channels = all variables
            tt = psi.reshape(B, T + 1, tt_dim) + time_emb
            tt = getattr(self, f"time_transformer_{i}")(tt, train, gen)
            psi = tt.reshape(B, T + 1, V + 1, d)
        return psi.reshape(B, T + 1, tt_dim), psi


class DuettPretrainModel(nn.Module):
    """SSL pretraining: ``encoder`` plus the reconstruction heads (JAX
    ``duett.py:256-296``, reference heads duett.py:110-122). The masked
    timesteps' contextual tokens feed ``pretrain_value_proj`` and
    ``pretrain_presence_proj`` ([B, S, V] each); with ``predict_events``
    the masked variable's psi column, flattened over time to ``et_dim``,
    feeds ``predict_events_proj`` and ``predict_events_presence_proj``
    ([B, T] each). A head whose flag is off is absent and its output None.
    Every head is a ``SimpleMLP`` with hidden BatchNorm."""

    def __init__(self, cfg: DuettConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = DuettEncoder(cfg)

        def head(d_in, d_out):
            return SimpleMLP(d_in, d_out, cfg.pretrain_n_hidden,
                             cfg.pretrain_d_hidden, hidden_batch_norm=True)

        V, T = cfg.n_variables, cfg.n_timesteps
        if cfg.pretrain_value:
            self.pretrain_value_proj = head(cfg.tt_dim, V)
        if cfg.pretrain_presence:
            self.pretrain_presence_proj = head(cfg.tt_dim, V)
        if cfg.predict_events:
            self.predict_events_proj = head(cfg.et_dim, T)
            if cfg.pretrain_presence:
                self.predict_events_presence_proj = head(cfg.et_dim, T)

    def forward(self, pb: PretrainBatch, x_static: torch.Tensor,
                times: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> dict:
        cfg = self.cfg
        tokens, psi = self.encoder(pb.x_in, x_static, times, train, gen)
        B, _, R = tokens.shape
        # the masked timesteps' contextual tokens [B, S, R]
        z = torch.gather(tokens, 1, pb.mask_idx[..., None].expand(
            B, pb.mask_idx.shape[1], R))

        def run(name, inp):
            head = getattr(self, name, None)
            return None if head is None else head(inp, train)

        out = {"y_hat_value": run("pretrain_value_proj", z),
               "y_hat_presence": run("pretrain_presence_proj", z),
               "y_hat_events": None, "y_hat_events_presence": None}
        if cfg.predict_events:
            # psi column of the masked variable, flattened over time
            z_events = psi[torch.arange(B, device=psi.device), :,
                           pb.event_var].reshape(B, cfg.et_dim)
            out["y_hat_events"] = run("predict_events_proj", z_events)
            out["y_hat_events_presence"] = run(
                "predict_events_presence_proj", z_events)
        return out


FUSION_METHODS = ("rep_token", "averaging")


class DuettClassifier(nn.Module):
    """The supervised fine-tuning model (JAX ``duett.py:302-325``, reference
    pooling duett.py:282-298): ``encoder``, then the [REP] token
    (``rep_token``) or the mean of the time tokens (``averaging``) into
    ``head``, a ``SimpleMLP`` with hidden BatchNorm. Returns the logits,
    [B] when ``d_target`` is 1, and with ``return_representation`` the
    pooled representation [B, R] beside them."""

    def __init__(self, cfg: DuettConfig, d_target: int = 1,
                 fusion_method: str = "rep_token"):
        super().__init__()
        if fusion_method not in FUSION_METHODS:
            raise ValueError(f"unknown fusion_method {fusion_method!r}")
        self.cfg = cfg
        self.d_target = d_target
        self.fusion_method = fusion_method
        self.encoder = DuettEncoder(cfg)
        self.head = SimpleMLP(cfg.tt_dim, d_target, cfg.n_hidden_head,
                              cfg.d_hidden_head, hidden_batch_norm=True)

    def forward(self, x_in: torch.Tensor, x_static: torch.Tensor,
                times: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None,
                return_representation: bool = False):
        tokens, _ = self.encoder(x_in, x_static, times, train, gen)
        z = tokens[:, -1, :] if self.fusion_method == "rep_token" \
            else tokens[:, :-1, :].mean(dim=1)
        logits = self.head(z, train)
        if self.d_target == 1:
            logits = logits.squeeze(-1)
        return (logits, z) if return_representation else logits


def init_classifier(cfg: DuettConfig, seed: int, d_target: int = 1,
                    fusion_method: str = "rep_token") -> DuettClassifier:
    """A ``DuettClassifier`` initialized from ``seed`` after the flax
    modules' initializers (in distribution, as ``init_pretrain_model``)."""
    return init_like_flax(DuettClassifier(cfg, d_target, fusion_method), seed)


def init_pretrain_model(cfg: DuettConfig, seed: int) -> DuettPretrainModel:
    """A ``DuettPretrainModel`` initialized from ``seed`` after the flax
    modules' initializers (``layers.init_like_flax``; in distribution, as
    ``init_teacher``)."""
    return init_like_flax(DuettPretrainModel(cfg), seed)
