"""Optimizer: AdamW with differential-LR parameter groups + warmup/cosine,
the counterpart of ``multimodal_edema_prediction_tpu/train/optim.py:24-93``.

Group rules (reference ``training_duett/trainer.py:77-125``), decided on
each parameter's flax path (``convert.flax_paths``), so a torch parameter
lands in the group its flax counterpart lands in:

    backbone (duett/* , cxr/*)               lr × backbone_lr_mult
    pathology queries (…queries…)            lr × query_lr_mult
    correction_head/* and beta               lr × correction_lr_mult
    everything else                          lr
    frozen prefixes                          left out of the optimizer

(``label_fn`` replaces these rules, as ``make_optimizer``'s does in JAX:
LP mode's ``teacher_loop.lp_frozen_label_fn`` puts everything but the
correction head and β in the frozen group.)

What ``optax.multi_transform`` of per-group ``optax.adamw`` does, in torch:
every group has its own warmup/cosine schedule read at the step count
before the update; weight decay applies to every trainable parameter; with
``grad_clip > 0`` each group's gradients are clipped by the global norm of
that group alone. Frozen parameters get no update and no decay, and stop
requiring gradients. The Adam state lives beside the parameters (two
float32 tensors each); ``state_dict`` hands it to the loops' full-state
checkpoint (``train/checkpoint.py::FullStateResumer``).

Each update's learning rates and float32 bias corrections come from a
device table (``scalars``: one row per step count, one ``(bc1, bc2, -lr)``
triple per group, filled on the host from the schedules), indexed by a
device step counter. So an update reads no host value that changes from
step to step, and a CUDA graph that captured K updates
(``engine.scan_steps``) replays the schedule as K eager updates read it,
bit for bit.

SSL pretraining (``ssl_loop.py:82-85``) takes one group over every
parameter: ``MultiGroupAdamW.one_group`` with ``invsqrt_warmup``, behind
``clip_by_global_norm(grad_clip)``; the supervised fine-tuning loop takes
``simple_adamw``, one group on warmup/cosine or a constant rate.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import OptimConfig
from ..convert import flax_paths

# the parameter groups, sorted as optax keeps ``multi_transform``'s
# ``inner_states``: ``frozen`` takes no update (JAX ``make_optimizer``'s
# ``set_to_zero``), each other group AdamW at its own learning-rate
# multiplier
FROZEN = "frozen"
GROUPS = ("backbone", "correction", FROZEN, "queries", "rest")


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_lr_ratio: float = 0.01,
                  warmup_start_factor: float = 1e-4) -> Callable[[int], float]:
    """Linear warmup from ``base_lr·warmup_start_factor`` to ``base_lr``,
    then cosine to ``base_lr·min_lr_ratio`` (optax's ``join_schedules`` of
    ``linear_schedule`` and ``cosine_decay_schedule``, as the JAX package
    builds it)."""
    warmup = max(int(warmup_steps), 1)
    cosine_steps = max(int(total_steps) - warmup, 1)
    init = base_lr * warmup_start_factor

    def schedule(step: int) -> float:
        if step < warmup:
            frac = 1.0 - min(max(step, 0), warmup) / warmup
            return (init - base_lr) * frac + base_lr
        count = min(step - warmup, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / cosine_steps))
        return base_lr * ((1.0 - min_lr_ratio) * cosine + min_lr_ratio)

    return schedule


def invsqrt_warmup(base_lr: float, warmup_steps: int = 2000
                   ) -> Callable[[int], float]:
    """The reference's WarmUp callback (duett/train_duett_ssl.py:27-50), as
    the JAX package writes it in float32: lr(s) = base·s/w for s < w, then
    base·(w/s)^0.5; the first update (s = 0) has lr 0."""
    w = float(warmup_steps)
    a, b = np.float32(base_lr * w ** 0.5), np.float32(w ** -1.5)

    def schedule(step: int) -> float:
        s = np.float32(step)
        inv = s ** np.float32(-0.5) if step > 0 else np.float32(0.0)
        return float(a * min(inv, s * b))

    return schedule


def simple_adamw(model: nn.Module, lr: float, weight_decay: float = 1e-2,
                 warmup_steps: int = 0, total_steps: int = 10_000,
                 min_lr_ratio: float = 0.0, grad_clip: float = 0.0
                 ) -> "MultiGroupAdamW":
    """Single-group AdamW over every parameter of ``model`` (JAX
    ``optim.py:96-107``): ``warmup_cosine`` when ``warmup_steps > 0``, else
    the constant ``lr``; ``grad_clip > 0`` puts a global-norm clip in
    front."""
    schedule = warmup_cosine(lr, warmup_steps, total_steps, min_lr_ratio) \
        if warmup_steps > 0 else (lambda step: lr)
    return MultiGroupAdamW.one_group(model, schedule, weight_decay, grad_clip)


def default_label_fn(path: str) -> str:
    """Reference group rules (trainer.py:88-102); ``path`` is '/'-joined."""
    if path.startswith(("duett/", "cxr/", "vit/")):
        return "backbone"
    if "correction_head" in path or path.endswith("/beta") or path == "beta":
        return "correction"
    if "queries" in path:
        return "queries"
    return "rest"


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place, with no host sync: when the
    global norm g is at least ``max_norm``, every gradient becomes
    (t / g) · max_norm."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


class MultiGroupAdamW:
    """AdamW over parameter groups, each with its own schedule: the update
    of ``optax.adamw`` (``scale_by_adam`` → ``add_decayed_weights`` →
    ``scale_by_learning_rate``), written out with ``torch._foreach`` ops so
    that it follows optax's arithmetic, float32 bias corrections included.

    ``step(count)`` applies one update, with each group's learning rate read
    at ``count`` (the number of updates before this one) from the device
    table ``scalars``."""

    def __init__(self, model: nn.Module, cfg: OptimConfig, total_steps: int,
                 frozen_prefixes: Sequence[str] = (),
                 label_fn: Callable[[str], str] = default_label_fn):
        mults = {"backbone": cfg.backbone_lr_mult,
                 "queries": cfg.query_lr_mult,
                 "correction": cfg.correction_lr_mult, "rest": 1.0}
        paths = flax_paths(model)
        groups = {}
        for name, p in model.named_parameters():
            path = paths[name][1]
            label = FROZEN if any(path.startswith(f)
                                  for f in frozen_prefixes) \
                else label_fn(path)
            if label == FROZEN:
                p.requires_grad_(False)
            else:
                groups.setdefault(label, []).append(p)
        self.labels = list(groups)
        self.params = [groups[label] for label in self.labels]
        self._init_state(total_steps)
        self.schedules = []
        for label in self.labels:
            mult = mults[label]
            # torch CosineAnnealingLR's eta_min = lr·min_lr_ratio is an
            # ABSOLUTE floor shared by every group (trainer.py:124)
            alpha = min(cfg.min_lr_ratio / mult, 1.0) if mult > 0 \
                else cfg.min_lr_ratio
            self.schedules.append(warmup_cosine(
                cfg.lr * mult, cfg.warmup_steps, total_steps, alpha))
        self.cfg = cfg

    @classmethod
    def one_group(cls, model: nn.Module, schedule: Callable[[int], float],
                  weight_decay: float, grad_clip: float = 0.0,
                  b1: float = 0.9, b2: float = 0.999) -> "MultiGroupAdamW":
        """One group over every parameter of ``model`` with ``schedule``:
        ``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule,
        weight_decay=weight_decay))`` (no clip when ``grad_clip`` is 0)."""
        self = cls.__new__(cls)
        self.labels = ["all"]
        self.params = [list(model.parameters())]
        self._init_state()
        self.schedules = [schedule]
        self.cfg = OptimConfig(weight_decay=weight_decay, grad_clip=grad_clip,
                               b1=b1, b2=b2)
        return self

    def _init_state(self, horizon: int = 0) -> None:
        # the schedule table is built at the first update
        self.scalars: Optional[torch.Tensor] = None
        self.version, self._horizon = 0, int(horizon)
        self.mu = [[torch.zeros_like(p) for p in ps] for ps in self.params]
        self.nu = [[torch.zeros_like(p) for p in ps] for ps in self.params]

    def state_dict(self) -> Dict[str, List[np.ndarray]]:
        """The Adam moments as float32 numpy arrays, in parameter order."""
        return {k: [t.detach().cpu().numpy() for ts in getattr(self, k)
                    for t in ts] for k in ("mu", "nu")}

    def load_state_dict(self, sd: Dict[str, List[np.ndarray]]) -> None:
        for k in ("mu", "nu"):
            flat = [t for ts in getattr(self, k) for t in ts]
            if len(sd[k]) != len(flat):
                raise ValueError(f"optimizer state holds {len(sd[k])} {k} "
                                 f"tensors, the optimizer {len(flat)}")
            with torch.no_grad():
                for t, a in zip(flat, sd[k]):
                    t.copy_(torch.as_tensor(np.asarray(a)).reshape(t.shape))

    def zero_grad(self) -> None:
        for ps in self.params:
            for p in ps:
                p.grad = None

    def _rows(self, lo: int, hi: int) -> np.ndarray:
        """The scalars of counts ``lo..hi-1``: [hi - lo, groups, 3] float32
        (bc1, bc2, -lr), as optax computes them (bias corrections and the
        learning rate in float32)."""
        b1, b2 = np.float32(self.cfg.b1), np.float32(self.cfg.b2)
        out = np.empty((hi - lo, len(self.schedules), 3), np.float32)
        for i, count in enumerate(range(lo, hi)):
            n = np.float32(count + 1)
            for g, schedule in enumerate(self.schedules):
                out[i, g] = (1 - b1 ** n, 1 - b2 ** n,
                             -np.float32(schedule(count)))
        return out

    def reserve(self, n_steps: int) -> None:
        """Make ``scalars`` cover the counts ``0..n_steps-1``. Growing it
        makes a new tensor (``version`` counts them), which a graph that
        read the old one must not replay."""
        have = 0 if self.scalars is None else self.scalars.shape[0]
        if n_steps <= have:
            return
        n = max(n_steps, 2 * have, self._horizon, 64)
        device = next((p.device for ps in self.params for p in ps),
                      torch.device("cpu"))
        rows = torch.from_numpy(self._rows(have, n)).to(device)
        self.scalars = rows if self.scalars is None \
            else torch.cat([self.scalars, rows])
        self.version += 1

    @torch.no_grad()
    def step(self, count: int, count_t: Optional[torch.Tensor] = None
             ) -> None:
        """One update at step count ``count`` (the number of updates before
        this one). ``count_t``: the same count as a device int64 tensor
        (``TrainState.step_t``), from which the update reads its scalars;
        when it is None, one is made from ``count``."""
        cfg = self.cfg
        b1, b2 = cfg.b1, cfg.b2
        self.reserve(count + 1)
        if count_t is None:
            count_t = torch.full((), count, dtype=torch.long,
                                 device=self.scalars.device)
        # [groups, 3]: this count's row, read on the device
        row = self.scalars.index_select(0, count_t.reshape(1))[0]
        for g, (ps, mu, nu) in enumerate(zip(self.params, self.mu, self.nu)):
            bc1, bc2, neg_lr = row[g, 0], row[g, 1], row[g, 2]
            # optax decays and moves a parameter with no gradient all the same
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in ps]
            if cfg.grad_clip > 0:
                clip_by_global_norm_(grads, cfg.grad_clip)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - b2))
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, 1e-8)
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            torch._foreach_add_(upd, torch._foreach_mul(ps, cfg.weight_decay))
            torch._foreach_mul_(upd, neg_lr)
            torch._foreach_add_(ps, upd)
