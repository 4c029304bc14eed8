"""LocalTrajectoryEncoder: a per-variable GRU over the 24 h window, the
counterpart of ``multimodal_edema_prediction_tpu/models/trajectory.py``
(reference ``models/main_architecture_duett.py:1242-1391``).

Each variable's trajectory is encoded before any cross-variable mixing:
a 5-feature input per (variable, hour) (value, observed flag, normalized
log-count, time since the last observation, time to the anchor), one GRU
shared by the B·V independent sequences, then a mean over each
non-overlapping recency window: one token per (variable, window), and a
REP token. The padding mask marks the (variable, window) tokens with no
observation (True = ignore, ``key_padding_mask``'s sense).

The GRU is flax's ``GRUCell``, written out (``GRUCell``): ``ir``, ``iz``,
``in`` carry a bias, ``hr`` and ``hz`` none, ``hn`` one, so the parameter
tree is JAX's (``encoder/GRUCell_0/{ir,iz,in,hr,hz,hn}``) and
``convert.load_flax`` takes a JAX checkpoint as it is. ``torch.nn.GRU``
is not used: it carries two more biases (``b_hr``, ``b_hz``), which AdamW
would move apart from JAX's single ones. The three input projections run
once over all T steps; the loop over T multiplies the [B·V, d] state by
the three recurrent kernels at once.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .layers import Dense, LayerNorm, dropout, gelu_exact


def time_since_last_observation(observed: torch.Tensor) -> torch.Tensor:
    """[B, T, V] bool → [B, T, V] float32: grid steps since the previous
    observation, counting the current slot (reference :1312-1327; JAX's
    ``lax.scan`` over T as a loop on the [B, V] state)."""
    B, T, V = observed.shape
    elapsed = torch.zeros(B, V, device=observed.device)
    out = []
    for t in range(T):
        elapsed = elapsed + 1.0
        out.append(elapsed)
        elapsed = torch.where(observed[:, t], torch.zeros_like(elapsed),
                              elapsed)
    return torch.stack(out, dim=1)


class GRUCell(nn.Module):
    """flax ``nn.GRUCell``: r = σ(ir(x) + hr(h)), z = σ(iz(x) + hz(h)),
    n = tanh(in(x) + r·hn(h)), h' = (1 − z)·n + z·h."""

    def __init__(self, d_in: int, d: int):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, Dense(d_in, d))
        for name in ("hr", "hz"):
            self.add_module(name, Dense(d, d, bias=False))
        self.hn = Dense(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, T, d_in] → every step's state [N, T, d], from a zero
        state, in float32 (flax promotes the input to the parameters'
        float32)."""
        x = x.float()
        N, T, _ = x.shape
        gi = torch.cat([getattr(self, k)(x) for k in ("ir", "iz", "in")],
                       dim=-1)                               # [N, T, 3d]
        w_h = torch.cat([self.hr.weight, self.hz.weight, self.hn.weight])
        b_h = torch.cat([torch.zeros_like(self.hn.bias),
                         torch.zeros_like(self.hn.bias), self.hn.bias])
        h = x.new_zeros(N, self.hn.weight.shape[0])
        out = []
        for t in range(T):
            i_r, i_z, i_n = gi[:, t].chunk(3, dim=-1)
            h_r, h_z, h_n = torch.addmm(b_h, h, w_h.t()).chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            h = (1.0 - z) * n + z * h
            out.append(h)
        return torch.stack(out, dim=1)


class LocalTrajectoryEncoder(nn.Module):
    """x_ts [B, T, 2V] → tokens [B, V·W + 1, d] (+ the padding mask
    [B, V·W + 1]), W the number of recency windows."""

    def __init__(self, n_vars: int, n_timesteps: int = 24,
                 d_model: int = 128, dropout: float = 0.1,
                 recency_windows: Sequence[int] = (6, 12, 24)):
        super().__init__()
        windows = tuple(sorted(set(int(w) for w in recency_windows)))
        if not windows or windows[-1] != n_timesteps:
            raise ValueError(f"recency_windows must end at n_timesteps="
                             f"{n_timesteps}, got {windows}")
        self.windows = windows
        self.n_vars, self.n_timesteps, self.d_model = n_vars, n_timesteps, \
            d_model
        self.dropout = dropout
        d = d_model
        self.input_proj = Dense(5, d)
        self.input_norm = LayerNorm(d)
        self.variable_embedding = nn.Embedding(n_vars, d)
        self.hour_embedding = nn.Embedding(n_timesteps, d)
        self.GRUCell_0 = GRUCell(d, d)
        self.window_embedding = nn.Parameter(torch.zeros(len(windows), d))
        self.output_norm = LayerNorm(d)
        self.rep_token = nn.Parameter(torch.zeros(1, 1, d))

    @property
    def d_representation(self) -> int:
        return self.d_model

    def forward(self, x_ts: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None,
                return_padding_mask: bool = False):
        B, T, C = x_ts.shape
        V, d = self.n_vars, self.d_model
        if T != self.n_timesteps or C != 2 * V:
            raise ValueError(f"expected [B,{self.n_timesteps},{2 * V}], got "
                             f"{tuple(x_ts.shape)}")
        dt = x_ts.dtype
        values = x_ts[..., :V]
        counts = x_ts[..., V:].clamp_min(0.0)
        observed = counts > 0
        values = torch.where(observed, values, torch.zeros_like(values))
        log_count = torch.log1p(counts) / math.log(16.0)
        delta = time_since_last_observation(observed).to(dt) / T
        ttc = (torch.arange(T, 0, -1, device=x_ts.device).to(dt) / T)[
            None, :, None].expand(B, T, V)
        local = torch.stack([values, observed.to(dt), log_count, delta, ttc],
                            dim=-1)                          # [B, T, V, 5]
        local = local.permute(0, 2, 1, 3).reshape(B * V, T, 5)

        h = self.input_norm(gelu_exact(self.input_proj(local)))
        var_emb = self.variable_embedding.weight.repeat(B, 1)[:, None, :]
        hour_emb = self.hour_embedding.weight[None]
        h = dropout(h + var_emb.to(h.dtype) + hour_emb.to(h.dtype),
                    self.dropout, train, gen)
        h = self.GRUCell_0(h)                                # [B·V, T, d]

        observed_by_var = observed.transpose(1, 2)           # [B, V, T]
        pooled, valid = [], []
        prev = 0
        for wi, boundary in enumerate(self.windows):
            start, end = T - boundary, T - prev
            token = h[:, start:end, :].mean(dim=1)           # [B·V, d]
            pooled.append(token + self.window_embedding[wi].to(token.dtype))
            valid.append(observed_by_var[:, :, start:end].any(dim=-1))
            prev = boundary
        W = len(self.windows)
        tokens = torch.stack(pooled, dim=1).reshape(B, V, W, d)
        tokens = self.output_norm(tokens).to(dt).reshape(B, V * W, d)
        tokens = torch.cat([tokens, self.rep_token.to(dt).expand(B, 1, d)],
                           dim=1)
        if not return_padding_mask:
            return tokens
        valid_mask = torch.stack(valid, dim=2).reshape(B, V * W)
        padding_mask = ~torch.cat(
            [valid_mask, torch.ones(B, 1, dtype=torch.bool,
                                    device=x_ts.device)], dim=1)
        return tokens, padding_mask
