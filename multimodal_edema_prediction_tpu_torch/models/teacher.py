"""Teacher: DuETT (time series) + RAD-DINO (CXR) + pathology-query perceiver
fusion: the PyTorch counterpart of
``multimodal_edema_prediction_tpu/models/teacher.py`` in its default
``dual_patch`` mode (ViT patch tokens → img_proj → perceiver).

Freezing is functional, as in the JAX package: a frozen branch runs in eval
mode under ``torch.no_grad()`` and its outputs are detached, and the
optimizer leaves its parameters out (``train/optim.py``).
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import TeacherConfig
from .duett import DuettEncoder
from .layers import Dense, init_like_flax
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
                times: torch.Tensor, pixel_values: Optional[torch.Tensor],
                train: bool = False, gen: Optional[torch.Generator] = None,
                cxr_feats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> dict:
        """``cxr_feats=(cls, patches)``: the encode-once tier's cached ViT
        tokens, which replace the ViT forward (JAX ``teacher.py:72-87``);
        only legal in a training step when the CXR branch is frozen."""
        cfg = self.cfg
        frozen = cfg.freeze_duett
        with torch.no_grad() if frozen else nullcontext():
            ts_tokens, _ = self.duett(x_in, x_static, times,
                                      train and not frozen, gen)
        if frozen:
            ts_tokens = ts_tokens.detach()
        if cxr_feats is not None:
            if train and not cfg.freeze_cxr:
                raise ValueError("cxr_feats in a train step requires "
                                 "freeze_cxr=True: cached tokens would leave "
                                 "a trainable CXR branch untrained")
            _, patches = cxr_feats
        else:
            # a trainable ViT trains (attention dropout of ViTConfig.dropout
            # from gen, JAX teacher.py:64,83-84); a frozen one runs in eval
            # mode without a graph
            cxr_train = train and not cfg.freeze_cxr
            with torch.no_grad() if cfg.freeze_cxr else nullcontext():
                _, patches = self.cxr(pixel_values, cxr_train, gen)
        if cfg.freeze_cxr:
            patches = patches.detach()
        out = self.perceiver(ts_tokens, self.img_proj(patches), train=train,
                             gen=gen)
        return {
            "main_logit": out["fusion_logits"][:, 0],
            "img_logits": out["img_logits"],
            "ts_logits": out["ts_logits"],
            "fusion_logits": out["fusion_logits"],
            "ts_correction": out["ts_correction"],
            "scaled_correction": out["scaled_correction"],
        }


def init_teacher(cfg: TeacherConfig, seed: int) -> "TeacherModel":
    """A ``TeacherModel`` initialized from ``seed`` after the flax modules'
    initializers (the counterpart of ``teacher_loop.init_teacher``, in
    distribution; the rules are ``layers.init_like_flax``'s), LayerScale at
    ``layerscale_init``."""
    return init_like_flax(TeacherModel(cfg), seed, cfg.vit.layerscale_init)

