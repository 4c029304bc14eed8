"""Teacher: DuETT (time series) + RAD-DINO (CXR) + pathology-query perceiver
fusion: the PyTorch counterpart of
``multimodal_edema_prediction_tpu/models/teacher.py`` in its two runnable
modes:

- ``dual_patch`` (default): ViT patch tokens → img_proj → perceiver
  cross-attention (reference :1097-1129);
- ``dual``: ViT CLS → the frozen pretrained CXR linear head → per-label
  logits as the image branch, re-indexed into the pathology order by
  ``static_keep_idx`` (reference :1047-1071, :1131-1150).

Freezing is functional, as in the JAX package: a frozen branch runs in eval
mode under ``torch.no_grad()`` and its outputs are detached, and the
optimizer leaves its parameters out (``train/optim.py``).
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..config import TeacherConfig
from .cxr_head import CXRLinearHead
from .duett import DuettEncoder
from .layers import Dense, init_like_flax
from .perceiver import DualPathologyPerceiver, PatchDualPathologyPerceiver
from .vit import DinoViT

# the other perceiver modes, queued as ROADMAP P13
_NOT_PORTED = ("single", "legacy", "dual_patch_event")


class TeacherModel(nn.Module):
    """``n_pretrained_labels`` and ``static_keep_idx`` (``dual`` only): the
    pretrained head's width and, when its labels are not the pathology
    labels in order, the head outputs that make up the image branch. The
    index is a plain attribute, not a weight: it rides the checkpoint's
    config sidecar (``train/teacher_loop.py``)."""

    def __init__(self, cfg: TeacherConfig, n_pretrained_labels: int = 7,
                 static_keep_idx: Optional[Sequence[int]] = None):
        super().__init__()
        if cfg.perceiver_type in _NOT_PORTED:
            raise NotImplementedError(
                f"perceiver_type={cfg.perceiver_type!r} is not ported yet "
                "(ROADMAP P13); the port runs 'dual_patch' and 'dual'")
        if cfg.perceiver_type not in ("dual_patch", "dual"):
            raise ValueError(f"unknown perceiver_type "
                             f"{cfg.perceiver_type!r}")
        self.cfg = cfg
        self.duett = DuettEncoder(cfg.duett)
        self.cxr = DinoViT(cfg.vit)
        d_ts = cfg.duett.d_representation
        if cfg.perceiver_type == "dual":
            # the head the CXR stage trains (train/cxr_head_loop.py), in
            # eval mode: JAX's PretrainedCXRHead (teacher.py:32-44)
            self.pretrained_cxr_head = CXRLinearHead(
                cfg.vit.d_model, n_pretrained_labels)
            self.perceiver = DualPathologyPerceiver(cfg.perceiver, d_ts)
        else:
            self.img_proj = Dense(cfg.vit.d_model, cfg.perceiver.d_latent)
            self.perceiver = PatchDualPathologyPerceiver(cfg.perceiver, d_ts)
        self.static_keep_idx = None if static_keep_idx is None else \
            tuple(int(i) for i in static_keep_idx)
        self._keep_idx = {}     # device → the index as a tensor there

    def _image_logits(self, cls: torch.Tensor) -> torch.Tensor:
        """``dual``: the frozen head's logits of ``cls``, detached, in the
        pathology order."""
        with torch.no_grad():
            logits = self.pretrained_cxr_head(cls)
        if self.static_keep_idx is None:
            return logits
        idx = self._keep_idx.get(logits.device)
        if idx is None:
            idx = torch.tensor(self.static_keep_idx, device=logits.device)
            self._keep_idx[logits.device] = idx
        return logits.index_select(1, idx)

    def forward(self, x_in: torch.Tensor, x_static: torch.Tensor,
                times: torch.Tensor, pixel_values: Optional[torch.Tensor],
                train: bool = False, gen: Optional[torch.Generator] = None,
                cxr_feats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> dict:
        """``cxr_feats=(cls, patches)``: the encode-once tier's cached ViT
        tokens, which replace the ViT forward (JAX ``teacher.py:72-87``);
        only legal in a training step when the CXR branch is frozen. A
        ``dual`` teacher reads only ``cls`` (``patches`` may be None)."""
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
            cls, patches = cxr_feats
        else:
            # a trainable ViT trains (attention dropout of ViTConfig.dropout
            # from gen, JAX teacher.py:64,83-84); a frozen one runs in eval
            # mode without a graph
            cxr_train = train and not cfg.freeze_cxr
            with torch.no_grad() if cfg.freeze_cxr else nullcontext():
                cls, patches = self.cxr(pixel_values, cxr_train, gen)
        if cfg.perceiver_type == "dual":
            # the head's logits are detached (JAX teacher.py:160-171): with
            # --unfreeze_cxr the ViT gets no gradient, only weight decay
            out = self.perceiver(ts_tokens, self._image_logits(cls),
                                 train=train, gen=gen)
        else:
            if cfg.freeze_cxr:
                patches = patches.detach()
            out = self.perceiver(ts_tokens, self.img_proj(patches),
                                 train=train, gen=gen)
        return {
            "main_logit": out["fusion_logits"][:, 0],
            "img_logits": out["img_logits"],
            "ts_logits": out["ts_logits"],
            "fusion_logits": out["fusion_logits"],
            "ts_correction": out["ts_correction"],
            "scaled_correction": out["scaled_correction"],
        }


def init_teacher(cfg: TeacherConfig, seed: int, **kw) -> "TeacherModel":
    """A ``TeacherModel`` (``kw``: its ``n_pretrained_labels`` and
    ``static_keep_idx``) initialized from ``seed`` after the flax modules'
    initializers (the counterpart of ``teacher_loop.init_teacher``, in
    distribution; the rules are ``layers.init_like_flax``'s), LayerScale at
    ``layerscale_init``."""
    return init_like_flax(TeacherModel(cfg, **kw), seed,
                          cfg.vit.layerscale_init)

