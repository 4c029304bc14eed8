"""RAD-DINO-style DINOv2 ViT-B/14 CXR encoder: the PyTorch counterpart of
``multimodal_edema_prediction_tpu/models/vit.py``.

Patch embedding → CLS + learned position embeddings → pre-LN blocks with
LayerScale → final LN; returns (CLS [B, D], patches [B, N, D]). The public
input stays NHWC ``[B, S, S, 3]`` as in the JAX package. The patch
embedding, a non-overlapping P×P convolution, is written as an unfold plus a
matmul: its weight is ``[D, P·P·3]`` in (row, column, channel) order, which
is the flax HWIO kernel flattened, and keeps cuDNN (and its default TF32)
out of the float32 path.

The JAX package pads the 1370 tokens once to 1408, the TPU's 128-lane
multiple, and masks the pad through ``valid_len``. The port does not pad:
its kernel masks its own ragged edge, so every row is a real token and
nothing is sliced off. ``MultiHeadAttention`` keeps ``valid_len`` for
callers that pre-pad.

``ViTConfig.quant="int8"`` runs every matmul of the blocks (the four
attention projections, both MLP layers) on int8 products (``ops/int8.py``)
with the same float32 weights, as the JAX package does; the patch
embedding stays in the input's dtype. It is for a frozen ViT only
(``TeacherConfig`` checks it).

As in the JAX package, ``train=True`` turns on the attention-probability
dropout of ``ViTConfig.dropout`` (drawn from ``gen``), which closes the
flash gate; the teacher trains the ViT so only with ``freeze_cxr=False``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import ViTConfig
from ..ops.int8 import int8_dense
from .layers import Dense, LayerNorm, MultiHeadAttention, gelu_exact

# Image normalization applied by the HF AutoImageProcessor for rad-dino.
IMAGE_MEAN = (0.5307, 0.5307, 0.5307)
IMAGE_STD = (0.2583, 0.2583, 0.2583)


# (device, dtype, mean, std) → the two constants on that device, made once:
# a copy from the host inside a step would stop a CUDA graph's capture
_NORM_CONSTANTS: dict = {}


def normalize_image(pixels: torch.Tensor, mean=IMAGE_MEAN, std=IMAGE_STD
                    ) -> torch.Tensor:
    """[B, H, W, 3] in [0, 1] → normalized, in the input's dtype."""
    key = (pixels.device, pixels.dtype, tuple(mean), tuple(std))
    ms = _NORM_CONSTANTS.get(key)
    if ms is None:
        ms = _NORM_CONSTANTS[key] = tuple(
            torch.tensor(v, dtype=pixels.dtype, device=pixels.device)
            for v in (mean, std))
    return (pixels - ms[0]) / ms[1]


class DinoBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.d_model
        self.norm1 = LayerNorm(d)
        self.attn = MultiHeadAttention(d, cfg.n_heads, d // cfg.n_heads,
                                       qkv_bias=True,
                                       use_flash=cfg.use_flash_attention,
                                       dropout=cfg.dropout, quant=cfg.quant)
        self.quant = cfg.quant
        self.layerscale1 = nn.Parameter(torch.full((d,), cfg.layerscale_init))
        self.norm2 = LayerNorm(d)
        self.mlp_in = Dense(d, cfg.d_feedforward)
        self.mlp_out = Dense(cfg.d_feedforward, d)
        self.layerscale2 = nn.Parameter(torch.full((d,), cfg.layerscale_init))

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.norm1(x)
        h = self.attn(h, h, train=train, gen=gen).to(x.dtype)
        x = x + h * self.layerscale1.to(x.dtype)
        h = self.norm2(x)
        if self.quant == "int8":
            # the same weights as the Dense layers, quantized at each call
            h = int8_dense(h, self.mlp_in.weight, self.mlp_in.bias)
            h = int8_dense(gelu_exact(h), self.mlp_out.weight,
                           self.mlp_out.bias)
        else:
            h = self.mlp_out(gelu_exact(self.mlp_in(h)))
        return x + h * self.layerscale2.to(x.dtype)


class DinoViT(nn.Module):
    """Returns (cls [B, D], patches [B, N, D]) for NHWC pixels."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        if cfg.image_size % cfg.patch_size:
            raise ValueError(f"image_size {cfg.image_size} is not a multiple "
                             f"of patch_size {cfg.patch_size}")
        self.cfg = cfg
        P, d = cfg.patch_size, cfg.d_model
        self.patch_embed = Dense(P * P * 3, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.n_patches + 1, d))
        for i in range(cfg.n_layers):
            self.add_module(f"block_{i}", DinoBlock(cfg))
        self.final_norm = LayerNorm(d)

    def forward(self, pixel_values: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        B = pixel_values.shape[0]
        P, n = cfg.patch_size, cfg.image_size // cfg.patch_size
        if tuple(pixel_values.shape[1:]) != (cfg.image_size, cfg.image_size,
                                             3):
            raise ValueError(f"pixel_values must be [B, {cfg.image_size}, "
                             f"{cfg.image_size}, 3], got "
                             f"{list(pixel_values.shape)}")
        patches = pixel_values.reshape(B, n, P, n, P, 3) \
            .permute(0, 1, 3, 2, 4, 5).reshape(B, n * n, P * P * 3)
        x = self.patch_embed(patches)                        # [B, N, D]
        cls = self.cls_token.to(x.dtype).expand(B, 1, cfg.d_model)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for i in range(cfg.n_layers):
            x = getattr(self, f"block_{i}")(x, train, gen)
        x = self.final_norm(x).to(pixel_values.dtype)
        return x[:, 0], x[:, 1:]


# =============================================================================
# HF Dinov2 checkpoint conversion (HF state_dict → this module's state_dict)
# =============================================================================
def hf_dinov2_shapes(cfg: ViTConfig) -> List[Tuple[str, tuple]]:
    """(name, shape) of every array of a HF ``Dinov2Model`` state dict at
    this geometry, in the order ``convert_hf_dinov2`` maps them (the
    unused ``embeddings.mask_token`` last)."""
    d, f, P = cfg.d_model, cfg.d_feedforward, cfg.patch_size
    out = [("embeddings.patch_embeddings.projection.weight", (d, 3, P, P)),
           ("embeddings.patch_embeddings.projection.bias", (d,)),
           ("embeddings.cls_token", (1, 1, d)),
           ("embeddings.position_embeddings", (1, cfg.n_patches + 1, d))]
    for i in range(cfg.n_layers):
        b = f"encoder.layer.{i}"
        out += [(f"{b}.norm1.weight", (d,)), (f"{b}.norm1.bias", (d,)),
                (f"{b}.norm2.weight", (d,)), (f"{b}.norm2.bias", (d,))]
        for name in ("attention.attention.query", "attention.attention.key",
                     "attention.attention.value", "attention.output.dense"):
            out += [(f"{b}.{name}.weight", (d, d)), (f"{b}.{name}.bias", (d,))]
        out += [(f"{b}.mlp.fc1.weight", (f, d)), (f"{b}.mlp.fc1.bias", (f,)),
                (f"{b}.mlp.fc2.weight", (d, f)), (f"{b}.mlp.fc2.bias", (d,)),
                (f"{b}.layer_scale1.lambda1", (d,)),
                (f"{b}.layer_scale2.lambda1", (d,))]
    out += [("layernorm.weight", (d,)), ("layernorm.bias", (d,)),
            ("embeddings.mask_token", (1, d))]
    return out


def convert_hf_dinov2(state_dict: dict, cfg: ViTConfig) -> dict:
    """A HF ``Dinov2Model`` state dict (e.g. microsoft/rad-dino; numpy or
    torch values) → this module's ``state_dict``. Linear weights are already
    ``[out, in]``; the patch conv ``[D, 3, P, P]`` becomes ``[D, P·P·3]``."""
    sd = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
          for k, v in state_dict.items()}
    out = {}
    emb = "embeddings"
    conv = sd[f"{emb}.patch_embeddings.projection.weight"]
    out["patch_embed.weight"] = conv.permute(0, 2, 3, 1).reshape(
        conv.shape[0], -1)
    out["patch_embed.bias"] = sd[f"{emb}.patch_embeddings.projection.bias"]
    out["cls_token"] = sd[f"{emb}.cls_token"]
    pos = sd[f"{emb}.position_embeddings"]
    if pos.shape[1] != cfg.n_patches + 1:
        raise ValueError(
            f"position embedding length {pos.shape[1]} != "
            f"{cfg.n_patches + 1}; interpolate before conversion")
    out["pos_embed"] = pos
    names = {"norm1": "norm1", "norm2": "norm2",
             "attn.q": "attention.attention.query",
             "attn.k": "attention.attention.key",
             "attn.v": "attention.attention.value",
             "attn.out": "attention.output.dense",
             "mlp_in": "mlp.fc1", "mlp_out": "mlp.fc2"}
    for i in range(cfg.n_layers):
        b = f"encoder.layer.{i}"
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"block_{i}.{ours}.{leaf}"] = sd[f"{b}.{theirs}.{leaf}"]
        out[f"block_{i}.layerscale1"] = sd[f"{b}.layer_scale1.lambda1"]
        out[f"block_{i}.layerscale2"] = sd[f"{b}.layer_scale2.lambda1"]
    out["final_norm.weight"] = sd["layernorm.weight"]
    out["final_norm.bias"] = sd["layernorm.bias"]
    return out


def load_vit_params(path: str, cfg: ViTConfig) -> dict:
    """A converted RAD-DINO checkpoint (``cli/convert_rad_dino.py``'s or
    ``scripts/convert_rad_dino.py``'s output, the JAX package's
    ``save_checkpoint`` format) as a ``DinoViT``
    state dict, every array's presence and shape checked against
    ``DinoViT(cfg)``: the counterpart of the JAX package's
    ``models/vit.py::load_vit_params``. Raises ``ValueError`` on a missing,
    left-over or misshapen array (a checkpoint of another geometry)."""
    from ..convert import check_fit, flax_to_state_dict
    from ..train.checkpoint import load_checkpoint
    sd = flax_to_state_dict(load_checkpoint(path)["params"])
    with torch.device("meta"):
        want = DinoViT(cfg).state_dict()
    check_fit(sd, want, f"{path} (ViT {cfg.n_layers} layers, "
                        f"d={cfg.d_model}, image {cfg.image_size})")
    return sd
