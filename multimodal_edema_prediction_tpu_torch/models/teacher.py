"""Teacher: DuETT (time series) + RAD-DINO (CXR) + pathology-query perceiver
fusion: the PyTorch counterpart of
``multimodal_edema_prediction_tpu/models/teacher.py`` in all its modes:

- ``dual_patch`` (default): ViT patch tokens → img_proj → perceiver
  cross-attention (reference :1097-1129);
- ``dual_patch_event``: the same image branch; the temporal branch reads
  DuETT's event grid, one key per clinical variable, the variables never
  observed in the window masked (JAX ``teacher.py:93-113``);
- ``single``: the 37 × 37 patches pooled to 7 × 7, projected, through the
  4-stage ``PathologyPerceiver``; ``main_logit`` is stage 4's first label
  (JAX ``teacher.py:123-144``);
- ``legacy``: CLS before the 49 pooled patches, projected, through the
  ``TemporalPerceiver`` and a binary head, with an auxiliary head on the
  projected CLS (JAX ``teacher.py:145-174``);
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
from .layers import Dense, dropout, gelu_exact, init_like_flax
from .perceiver import (DualPathologyPerceiver, EventPatchPerceiver,
                        PathologyPerceiver, PatchDualPathologyPerceiver,
                        TemporalPerceiver, adaptive_avg_pool_tokens)
from .vit import DinoViT

MODES = ("dual_patch", "dual_patch_event", "single", "legacy", "dual")
# the legacy heads' hidden width (JAX teacher.py:156, :166)
LEGACY_HIDDEN = 128


class TeacherModel(nn.Module):
    """``n_pretrained_labels`` and ``static_keep_idx`` (``dual`` only): the
    pretrained head's width and, when its labels are not the pathology
    labels in order, the head outputs that make up the image branch. The
    index is a plain attribute, not a weight: it rides the checkpoint's
    config sidecar (``train/teacher_loop.py``)."""

    def __init__(self, cfg: TeacherConfig, n_pretrained_labels: int = 7,
                 static_keep_idx: Optional[Sequence[int]] = None):
        super().__init__()
        mode = cfg.perceiver_type
        if mode not in MODES:
            raise ValueError(f"unknown perceiver_type {mode!r}")
        self.cfg = cfg
        self.duett = DuettEncoder(cfg.duett)
        self.cxr = DinoViT(cfg.vit)
        d_ts, pc = cfg.duett.d_representation, cfg.perceiver
        if mode == "dual":
            # the head the CXR stage trains (train/cxr_head_loop.py), in
            # eval mode: JAX's PretrainedCXRHead (teacher.py:32-44)
            self.pretrained_cxr_head = CXRLinearHead(
                cfg.vit.d_model, n_pretrained_labels)
            self.perceiver = DualPathologyPerceiver(pc, d_ts)
        else:
            self.img_proj = Dense(cfg.vit.d_model, pc.d_latent)
        if mode == "dual_patch":
            self.perceiver = PatchDualPathologyPerceiver(pc, d_ts)
        elif mode == "dual_patch_event":
            self.perceiver = EventPatchPerceiver(
                pc, cfg.duett.n_timesteps * cfg.duett.d_embedding)
        elif mode == "single":
            self.perceiver = PathologyPerceiver(pc, d_ts)
        elif mode == "legacy":
            self.perceiver = TemporalPerceiver(pc, d_ts)
            self.head_in = Dense(pc.d_latent, LEGACY_HIDDEN)
            self.head_out = Dense(LEGACY_HIDDEN, 1)
            self.aux_in = Dense(pc.d_latent, LEGACY_HIDDEN)
            self.aux_out = Dense(LEGACY_HIDDEN, 1)
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
        ``dual`` teacher reads only ``cls`` (``patches`` may be None).
        Returns the JAX teacher's outputs for its mode: ``main_logit``
        [B] always; the branch logits of the residual modes, stage 2's and
        4's of ``single``, ``aux_logit`` of ``legacy``."""
        cfg = self.cfg
        mode = cfg.perceiver_type
        frozen = cfg.freeze_duett
        with torch.no_grad() if frozen else nullcontext():
            ts_tokens, psi_grid = self.duett(x_in, x_static, times,
                                             train and not frozen, gen)
        if frozen:
            ts_tokens, psi_grid = ts_tokens.detach(), psi_grid.detach()
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
        if cfg.freeze_cxr:
            cls = cls.detach()
            patches = None if patches is None else patches.detach()

        if mode == "dual":
            # the head's logits are detached (JAX teacher.py:160-171): with
            # --unfreeze_cxr the ViT gets no gradient, only weight decay
            out = self.perceiver(ts_tokens, self._image_logits(cls),
                                 train=train, gen=gen)
        elif mode == "dual_patch":
            out = self.perceiver(ts_tokens, self.img_proj(patches),
                                 train=train, gen=gen)
        elif mode == "dual_patch_event":
            # the dynamic grid: psi without the [REP] row and the static
            # column; a variable with no observation in the window (its
            # counts at x_in[..., V:2V]) is a padded-out key
            V = cfg.duett.n_variables
            observed = (x_in[:, :, V:2 * V] > 0).any(dim=1)
            out = self.perceiver(psi_grid[:, :-1, :-1, :],
                                 self.img_proj(patches), train=train,
                                 gen=gen, ts_padding_mask=~observed)
        elif mode == "single":
            out = self.perceiver(
                ts_tokens, self.img_proj(adaptive_avg_pool_tokens(patches)),
                train=train, gen=gen)
            return {"main_logit": out["stage4_logits"][:, 0],
                    "stage2_logits": out["stage2_logits"],
                    "stage4_logits": out["stage4_logits"]}
        else:
            return self._legacy(ts_tokens, cls, patches, train, gen)
        return {
            "main_logit": out["fusion_logits"][:, 0],
            "img_logits": out["img_logits"],
            "ts_logits": out["ts_logits"],
            "fusion_logits": out["fusion_logits"],
            "ts_correction": out["ts_correction"],
            "scaled_correction": out["scaled_correction"],
        }

    def _legacy(self, ts_tokens, cls, patches, train, gen) -> dict:
        """CLS before the 49 pooled patches, projected; the temporal
        perceiver's fused vector through head_in → GELU → dropout →
        head_out; the auxiliary CXR head reads the projected CLS."""
        p = self.cfg.perceiver.head_dropout
        img_kv = torch.cat([cls[:, None, :],
                            adaptive_avg_pool_tokens(patches)], dim=1)
        img_kv_proj = self.img_proj(img_kv)
        fused = self.perceiver(ts_tokens, img_kv_proj, train, gen)
        h = dropout(gelu_exact(self.head_in(fused)), p, train, gen)
        a = dropout(gelu_exact(self.aux_in(img_kv_proj[:, 0])), p, train,
                    gen)
        return {"main_logit": self.head_out(h).squeeze(-1).float(),
                "aux_logit": self.aux_out(a).squeeze(-1).float()}


def init_teacher(cfg: TeacherConfig, seed: int, **kw) -> "TeacherModel":
    """A ``TeacherModel`` (``kw``: its ``n_pretrained_labels`` and
    ``static_keep_idx``) initialized from ``seed`` after the flax modules'
    initializers (the counterpart of ``teacher_loop.init_teacher``, in
    distribution; the rules are ``layers.init_like_flax``'s), LayerScale at
    ``layerscale_init``."""
    return init_like_flax(TeacherModel(cfg, **kw), seed,
                          cfg.vit.layerscale_init)

