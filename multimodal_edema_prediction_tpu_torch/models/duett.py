"""DuETT dual-axis transformer over the (time × event) grid, eval-mode: the
PyTorch counterpart of ``multimodal_edema_prediction_tpu/models/duett.py``
(``feats_to_input`` and ``DuettEncoder``).

Shape conventions
    x_ts    [B, T, 2V]   dense window: values(V) | counts(V)
    x_in    [B, T, 2V+1] after feats_to_input: values | counts | mask-col
    times   [B, T]       bin end times (hours / 24)
    tokens  [B, T+1, R]  R = d_embedding·(V+1); row T is the [REP] token
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..config import DuettConfig
from .layers import CVE, PerVariableMLP, SimpleMLP, TransformerEncoder

MASKED_KEY = 0           # duett.py:79
REP_KEY = 1              # duett.py:80


def feats_to_input(x_ts: torch.Tensor, x_static: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append the (all-zero, eval-mode) mask column: (x_in [B,T,2V+1],
    x_static). Train-time augmentation is not ported in this slice."""
    B, T, _ = x_ts.shape
    mask_col = torch.zeros(B, T, 1, dtype=x_ts.dtype, device=x_ts.device)
    return torch.cat([x_ts, mask_col], dim=-1), x_static


class DuettEncoder(nn.Module):
    """Dual-axis encoder: returns all T+1 contextual tokens and the psi
    grid [B, T+1, V+1, d]."""

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
                    cfg.scalenorm))

    def forward(self, x_in: torch.Tensor, x_static: torch.Tensor,
                times: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
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
        emb = self.embedding_layers(cell_in)                    # [B,T,V,d]
        static_emb = self.tab_encoder(x_static.to(dt))         # [B,d]
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
        time_emb = self.full_time_embedding(times[..., None].to(dt))
        rep_time = self.full_rep_embedding.to(dt).expand(B, 1, tt_dim)
        time_emb = torch.cat([time_emb, rep_time], dim=1)      # [B,T+1,tt]
        event_pos = self.full_event_embedding.to(dt)

        for i in range(cfg.n_layers):
            # event axis: tokens = variables, channels = all timesteps
            ev = psi.permute(0, 2, 1, 3).reshape(B, V + 1, et_dim) + event_pos
            ev = getattr(self, f"event_transformer_{i}")(ev)
            psi = ev.reshape(B, V + 1, T + 1, d).permute(0, 2, 1, 3)
            # time axis: tokens = hours, channels = all variables
            tt = psi.reshape(B, T + 1, tt_dim) + time_emb
            tt = getattr(self, f"time_transformer_{i}")(tt)
            psi = tt.reshape(B, T + 1, V + 1, d)
        return psi.reshape(B, T + 1, tt_dim), psi
