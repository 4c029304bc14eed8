"""Train state: the step count, the model (parameters, and BatchNorm
running statistics as buffers) and its optimizer. The counterpart of
``multimodal_edema_prediction_tpu/train/state.py``; where the JAX state is
replaced by a new one at every step, this one updates in place."""
from __future__ import annotations

import torch
from torch import nn

from ..parallel.multihost import all_reduce_grads
from .optim import MultiGroupAdamW


class TrainState:
    def __init__(self, model: nn.Module, optimizer: MultiGroupAdamW):
        self.step = 0
        self.model = model
        self.optimizer = optimizer

    def apply_gradients(self, loss: torch.Tensor) -> None:
        """Backpropagate ``loss`` and update: the learning rate is read at
        the step count before the increment, as optax does. In a
        multi-process run the gradients are summed over the ranks before
        the update (``parallel/multihost.all_reduce_grads``), so clipping
        and AdamW see the global batch's gradient."""
        self.optimizer.zero_grad()
        loss.backward()
        # a multi-process step's gradient is the sum of the ranks' shares
        all_reduce_grads([p for p in self.model.parameters()
                          if p.requires_grad])
        self.optimizer.step(self.step)
        self.step += 1


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
