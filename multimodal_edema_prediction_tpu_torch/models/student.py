"""Student: a DuETT backbone and an MLP head on the time series alone, the
PyTorch counterpart of ``multimodal_edema_prediction_tpu/models/student.py``
(reference ``models/main_architecture_duett.py:1202-1235``). The submodule
names ``duett``, ``head_in`` and ``head_out`` are flax's, so ``convert.py``
carries the weights both ways.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import StudentConfig
from .duett import DuettEncoder
from .layers import Dense, dropout, gelu_exact, init_like_flax


class StudentModel(nn.Module):
    def __init__(self, cfg: StudentConfig):
        super().__init__()
        if cfg.pool not in ("mean", "rep_token"):
            raise ValueError(f"unknown pool {cfg.pool!r}")
        self.cfg = cfg
        self.duett = DuettEncoder(cfg.duett)
        self.head_in = Dense(cfg.duett.d_representation, cfg.head_hidden)
        self.head_out = Dense(cfg.head_hidden, 1)

    def forward(self, x_in: torch.Tensor, x_static: torch.Tensor,
                times: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """One logit per sample [B]: the tokens pooled (``mean`` over the
        time tokens, leaving out the [REP] token, or ``rep_token``), then
        ``head_in`` → exact GELU → dropout → ``head_out``."""
        tokens, _ = self.duett(x_in, x_static, times, train, gen)
        if self.cfg.pool == "rep_token":
            feat = tokens[:, -1, :]
        else:
            feat = tokens[:, :-1, :].mean(dim=1)
        h = gelu_exact(self.head_in(feat))
        h = dropout(h, self.cfg.head_dropout, train, gen)
        return self.head_out(h).squeeze(-1)


def init_student(cfg: StudentConfig, seed: int) -> StudentModel:
    """A ``StudentModel`` initialized from ``seed`` after the flax modules'
    initializers (in distribution; ``layers.init_like_flax``)."""
    return init_like_flax(StudentModel(cfg), seed)
