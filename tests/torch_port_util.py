"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

Each test builds one module in both packages with the same weights: the
flax module is initialized, every leaf is perturbed with numpy noise (the
zero-init correction output, zero biases and unit BatchNorm statistics would
otherwise hide whole paths), and the trees are carried into the port by
``convert.load_flax``. Inputs come from a seeded numpy Generator.
"""
from __future__ import annotations

import jax
import numpy as np
import torch

from multimodal_edema_prediction_tpu.config import (DuettConfig,
                                                    PerceiverConfig,
                                                    TeacherConfig, ViTConfig)


def perturb(tree, seed: int = 0, scale: float = 0.05):
    """numpy copy of a flax tree with every leaf perturbed: N(0, scale²)
    added, BatchNorm variances redrawn in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            a = np.asarray(v, np.float32)
            if k == "var":
                out[k] = (0.5 + rng.random(a.shape)).astype(np.float32)
            else:
                out[k] = (a + scale * rng.standard_normal(a.shape)
                          ).astype(np.float32)
        return out

    return walk(jax.tree.map(np.asarray, dict(tree)))


def init_perturbed(module, *inputs, seed: int = 0, scale: float = 0.05,
                   **kw):
    """(params, batch_stats) of a flax module, initialized and perturbed
    by N(0, ``scale``²)."""
    variables = jax.jit(lambda *a: module.init(jax.random.key(seed), *a,
                                               **kw))(*inputs)
    params = perturb(variables["params"], seed, scale)
    stats = perturb(variables.get("batch_stats", {}), seed + 1, scale)
    return params, stats


def t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x))


def tiny_teacher_cfg(image_size: int = 28) -> TeacherConfig:
    """The JAX serve tests' tiny geometry (tests/test_serve.py)."""
    return TeacherConfig(
        duett=DuettConfig(n_variables=6, n_timesteps=24, d_embedding=8,
                          n_layers=1, d_feedforward=16,
                          d_hidden_mlp_embedding=8, d_hidden_tab_encoder=8),
        vit=ViTConfig(image_size=image_size, patch_size=14, d_model=16,
                      n_layers=1, n_heads=2, d_feedforward=32),
        perceiver=PerceiverConfig(d_latent=16, n_heads=2, head_hidden=8))


def window_inputs(cfg: TeacherConfig, B: int, seed: int = 0):
    """Request-shaped numpy inputs: x_ts [B,T,2V] with integer counts (some
    -1 event-mask cells), static [B,D], bin_ends [B,T], pixel_u8."""
    rng = np.random.default_rng(seed)
    d = cfg.duett
    T, V, S = d.n_timesteps, d.n_variables, cfg.vit.image_size
    values = rng.normal(size=(B, T, V)).astype(np.float32)
    counts = rng.integers(-1, 4, size=(B, T, V)).astype(np.float32)
    x_ts = np.concatenate([values, counts], axis=-1)
    static = rng.normal(size=(B, d.d_static)).astype(np.float32)
    bin_ends = np.broadcast_to((np.arange(1, T + 1) / 24.0)
                               .astype(np.float32), (B, T)).copy()
    pixel_u8 = rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    return x_ts, static, bin_ends, pixel_u8
