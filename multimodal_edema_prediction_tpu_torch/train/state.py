"""Train state: the step count, the model (parameters, and BatchNorm
running statistics as buffers) and its optimizer. The counterpart of
``multimodal_edema_prediction_tpu/train/state.py``; where the JAX state is
replaced by a new one at every step, this one updates in place.

The step count is kept twice: ``step``, a host int, and ``step_t``, the
same count as a device int64 scalar that the update reads its learning
rate from (``optim.MultiGroupAdamW.step``) and advances in place, so that
a captured CUDA graph of K updates (``engine.scan_steps``) replays with the
count it finds on the device. Setting ``step`` sets both."""
from __future__ import annotations

import torch
from torch import nn

from ..parallel.multihost import all_reduce_grads
from .optim import MultiGroupAdamW


class TrainState:
    def __init__(self, model: nn.Module, optimizer: MultiGroupAdamW):
        self.model = model
        self.optimizer = optimizer
        device = next((p.device for p in model.parameters()),
                      torch.device("cpu"))
        self.step_t = torch.zeros((), dtype=torch.long, device=device)
        self._step = 0

    @property
    def step(self) -> int:
        return self._step

    @step.setter
    def step(self, n: int) -> None:
        self._step = int(n)
        self.step_t.fill_(self._step)

    def advance_host_step(self, n: int) -> None:
        """Count ``n`` updates that ran on the device alone (a graph's
        replay advanced ``step_t`` itself)."""
        self._step += int(n)

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
        self.optimizer.step(self._step, self.step_t)
        self.step_t.add_(1)
        self._step += 1


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
