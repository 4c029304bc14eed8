"""Frozen-ViT CXR linear head over the CheXpert labels: the counterpart of
``multimodal_edema_prediction_tpu/models/cxr_head.py`` (reference
``cxr_linear_training.ipynb`` cells 6-13).

Dropout, then ``linear`` on the frozen RAD-DINO CLS token. Its checkpoint
(the weights and ``label_cols``) is what a ``dual`` teacher loads into its
``pretrained_cxr_head`` (``train/cxr_head_loop.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import Dense, dropout


class CXRLinearHead(nn.Module):
    def __init__(self, d_in: int, n_labels: int, dropout: float = 0.2):
        super().__init__()
        self.dropout = dropout
        self.linear = Dense(d_in, n_labels)

    def forward(self, cls: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.linear(dropout(cls, self.dropout, train, gen))
