"""Teacher: DuETT (time series) + RAD-DINO (CXR) + pathology-query perceiver
fusion, eval-mode: the PyTorch counterpart of
``multimodal_edema_prediction_tpu/models/teacher.py`` in its default
``dual_patch`` mode (ViT patch tokens → img_proj → perceiver).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import TeacherConfig
from .duett import DuettEncoder
from .layers import BatchNormLastDim, Dense, LayerNorm
from .perceiver import PatchDualPathologyPerceiver
from .vit import DinoViT

# the other perceiver modes, queued as ROADMAP P13
_NOT_PORTED = ("dual", "single", "legacy", "dual_patch_event")


class TeacherModel(nn.Module):
    def __init__(self, cfg: TeacherConfig):
        super().__init__()
        if cfg.perceiver_type in _NOT_PORTED:
            raise NotImplementedError(
                f"perceiver_type={cfg.perceiver_type!r} is not ported yet "
                "(ROADMAP P13); the port serves 'dual_patch'")
        if cfg.perceiver_type != "dual_patch":
            raise ValueError(f"unknown perceiver_type "
                             f"{cfg.perceiver_type!r}")
        self.cfg = cfg
        self.duett = DuettEncoder(cfg.duett)
        self.cxr = DinoViT(cfg.vit)
        self.img_proj = Dense(cfg.vit.d_model, cfg.perceiver.d_latent)
        self.perceiver = PatchDualPathologyPerceiver(
            cfg.perceiver, cfg.duett.d_representation)

    def forward(self, x_in: torch.Tensor, x_static: torch.Tensor,
                times: torch.Tensor, pixel_values: Optional[torch.Tensor]
                ) -> dict:
        ts_tokens, _ = self.duett(x_in, x_static, times)
        _, patches = self.cxr(pixel_values)
        out = self.perceiver(ts_tokens, self.img_proj(patches))
        return {
            "main_logit": out["fusion_logits"][:, 0],
            "img_logits": out["img_logits"],
            "ts_logits": out["ts_logits"],
            "fusion_logits": out["fusion_logits"],
            "ts_correction": out["ts_correction"],
            "scaled_correction": out["scaled_correction"],
        }


def seeded_init(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and buffer from a ``torch.Generator``: weight
    matrices N(0, 1/fan_in); norm gains, LayerScale and ``beta``
    1 + N(0, 0.02²); BatchNorm running variances in [0.5, 1.5); everything
    else (biases, running means, embeddings, queries) N(0, 0.02²). No output
    layer is left at zero (the JAX init zeroes the correction head's output,
    which would hide that path)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, m in model.named_modules():
            tensors = list(m.named_parameters(recurse=False)) + \
                list(m.named_buffers(recurse=False))
            for name, t in tensors:
                shape = tuple(t.shape)
                if (name == "weight" and isinstance(
                        m, (LayerNorm, BatchNormLastDim))) or name in (
                        "g", "beta", "bn_scale", "layerscale1",
                        "layerscale2"):
                    vals = 1.0 + 0.02 * torch.randn(shape, generator=g)
                elif name == "running_var":
                    vals = 0.5 + torch.rand(shape, generator=g)
                elif (name == "weight" and isinstance(m, Dense)) or name in (
                        "w1", "w2"):
                    # Dense [out, in]; PerVariableMLP [V, in, out]
                    fan_in = shape[1]
                    vals = torch.randn(shape, generator=g) * fan_in ** -0.5
                else:
                    vals = 0.02 * torch.randn(shape, generator=g)
                t.copy_(vals.to(t.device, t.dtype))
    return model
