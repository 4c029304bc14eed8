"""Shared PyTorch building blocks: the eval-mode counterparts of
``multimodal_edema_prediction_tpu/models/layers.py``.

Every module keeps its parameters in float32 and casts them to the input's
dtype at use, as the flax modules do (``param_dtype=float32``,
``dtype=x.dtype``). Submodule and parameter names mirror the flax tree, so
``convert.py`` maps a flax checkpoint onto ``state_dict()`` by a fixed rule.
Only inference is ported in this slice: dropout is the identity and
BatchNorm reads its running statistics.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_mha


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU in float32; the tanh form in bfloat16, as the JAX
    package does (its ``gelu_exact``: the tanh form's error is below the
    bf16 rounding of the next matmul)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16
                  else "none")


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight [out, in]`` (the transpose of the flax
    kernel) and ``bias [out]``, both float32, cast to the input dtype."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics in float32. The output is in the
    input's dtype, or float32 with ``f32_out`` (flax ``dtype=float32``
    without a cast back)."""

    def __init__(self, d: int, eps: float = 1e-6, f32_out: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps
        self.f32_out = f32_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                         self.eps)
        return y if self.f32_out else y.to(x.dtype)


class ScaleNorm(nn.Module):
    """g * x / max(||x|| * d^-0.5, eps), the norm taken in float32."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)
        norm = norm * (x.shape[-1] ** -0.5)
        return x / norm.clamp_min(self.eps).to(x.dtype) * self.g.to(x.dtype)


class BatchNormLastDim(nn.Module):
    """BatchNorm1d over the last axis in eval mode (eps 1e-5): the flax
    ``BatchNormLastDim``/``_TorchBatchNorm`` pair reading its running
    statistics, which are buffers here."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.register_buffer("running_mean", torch.zeros(d))
        self.register_buffer("running_var", torch.ones(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + 1e-5) * self.weight
        return (x - self.running_mean.to(x.dtype)) * inv.to(x.dtype) \
            + self.bias.to(x.dtype)


class SimpleMLP(nn.Module):
    """``simple_mlp`` (reference duett/duett.py:24-39), ReLU activation.

    For n_hidden >= 1: in act {[bn_i] hidden_i act}*(n_hidden-1) [bn_out]
    out. (The flax module's ``input_batch_norm`` and ``final_activation``
    have no caller in either package and are not ported.)"""

    def __init__(self, d_in: int, d_out: int, n_hidden: int = 1,
                 d_hidden: int = 64, hidden_batch_norm: bool = False):
        super().__init__()
        self.n_hidden = n_hidden
        if n_hidden == 0:
            self.add_module("out", Dense(d_in, d_out))
            self.bn_out = None
            return
        self.add_module("in", Dense(d_in, d_hidden))
        for i in range(n_hidden - 1):
            if hidden_batch_norm:
                self.add_module(f"bn_{i}", BatchNormLastDim(d_hidden))
            self.add_module(f"hidden_{i}", Dense(d_hidden, d_hidden))
        self.bn_out = BatchNormLastDim(d_hidden) if hidden_batch_norm \
            else None
        self.add_module("out", Dense(d_hidden, d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.n_hidden > 0:
            x = F.relu(getattr(self, "in")(x))
            for i in range(self.n_hidden - 1):
                bn = getattr(self, f"bn_{i}", None)
                if bn is not None:
                    x = bn(x)
                x = F.relu(getattr(self, f"hidden_{i}")(x))
            if self.bn_out is not None:
                x = self.bn_out(x)
        return self.out(x)


class CVE(nn.Module):
    """Continuous value embedding: Linear(1,√d) → tanh → [BN] → Linear(√d,d)
    (reference duett/duett.py:151-157)."""

    def __init__(self, d_embedding: int, batch_norm: bool = False):
        super().__init__()
        d_hidden = int(d_embedding ** 0.5)
        self.add_module("in", Dense(1, d_hidden))
        self.bn = BatchNormLastDim(d_hidden) if batch_norm else None
        self.out = Dense(d_hidden, d_embedding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(getattr(self, "in")(x))
        if self.bn is not None:
            h = self.bn(h)
        return self.out(h)


class PerVariableMLP(nn.Module):
    """V independent 2→d_hidden→d_out MLPs as one batched einsum stack, with
    per-variable BatchNorm statistics of shape [V, d_hidden]."""

    def __init__(self, n_variables: int, d_out: int, d_hidden: int = 64):
        super().__init__()
        V, dh = n_variables, d_hidden
        self.w1 = nn.Parameter(torch.zeros(V, 2, dh))
        self.b1 = nn.Parameter(torch.zeros(V, dh))
        self.w2 = nn.Parameter(torch.zeros(V, dh, d_out))
        self.b2 = nn.Parameter(torch.zeros(V, d_out))
        self.bn_scale = nn.Parameter(torch.ones(V, dh))
        self.bn_bias = nn.Parameter(torch.zeros(V, dh))
        self.register_buffer("running_mean", torch.zeros(V, dh))
        self.register_buffer("running_var", torch.ones(V, dh))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        h = torch.einsum("...vc,vcd->...vd", x, self.w1.to(dt)) \
            + self.b1.to(dt)
        h = F.relu(h)
        inv = torch.rsqrt(self.running_var + 1e-5) * self.bn_scale
        h = (h - self.running_mean.to(dt)) * inv.to(dt) + self.bn_bias.to(dt)
        return torch.einsum("...vd,vdo->...vo", h, self.w2.to(dt)) \
            + self.b2.to(dt)


class MultiHeadAttention(nn.Module):
    """Softmax attention with a decoupled head dim (DuETT: token dims
    600/840, 2 heads × d_head 12). ``q``/``k``/``v`` weights are
    ``[H·d_head, d_model]``; ``out`` is ``[d_model, H·d_head]``.

    With ``use_flash`` and a 3-D input whose key length is at least 256 and
    whose head dim is at least 64, the attention goes through ``flash_mha``
    (the JAX gate at ``models/layers.py:292-296``; the eval-only port has no
    returned weights, key padding mask or dropout to exclude). ``valid_len``
    is the true token count of a pre-padded sequence: keys at or past it get
    zero probability and the outputs of those rows are garbage, to be sliced
    off by the caller."""

    def __init__(self, d_model: int, n_heads: int,
                 d_head: Optional[int] = None, qkv_bias: bool = True,
                 out_bias: bool = True, use_flash: bool = False):
        super().__init__()
        self.n_heads = n_heads
        self.d_head = d_head or d_model // n_heads
        inner = n_heads * self.d_head
        self.q = Dense(d_model, inner, qkv_bias)
        self.k = Dense(d_model, inner, qkv_bias)
        self.v = Dense(d_model, inner, qkv_bias)
        self.out = Dense(inner, d_model, out_bias)
        self.use_flash = use_flash

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                valid_len: Optional[int] = None) -> torch.Tensor:
        H, dh = self.n_heads, self.d_head
        flash_ok = (self.use_flash and q_in.dim() == 3
                    and kv_in.shape[-2] >= 256 and dh >= 64)
        if flash_ok:
            B, Nq, Nk = q_in.shape[0], q_in.shape[1], kv_in.shape[1]
            # [B, N, H·dh] → [B, H, N, dh] as strided views: the kernel
            # reads them in place and writes its output in [B, N, H, dh]
            q = self.q(q_in).view(B, Nq, H, dh).transpose(1, 2)
            k = self.k(kv_in).view(B, Nk, H, dh).transpose(1, 2)
            v = self.v(kv_in).view(B, Nk, H, dh).transpose(1, 2)
            o = flash_mha(q, k, v, sm_scale=dh ** -0.5,
                          q_valid=valid_len, kv_valid=valid_len)
            return self.out(o.transpose(1, 2).reshape(B, Nq, H * dh))

        def heads(y):
            return y.view(*y.shape[:-1], H, dh)

        q, k, v = heads(self.q(q_in)), heads(self.k(kv_in)), \
            heads(self.v(kv_in))
        logits = torch.einsum("...qhd,...khd->...hqk", q, k) * (dh ** -0.5)
        Nk = k.shape[-3]
        if valid_len is not None and valid_len < Nk:
            pad = torch.arange(Nk, device=logits.device) >= valid_len
            logits = logits.masked_fill(pad, -1e30)
        weights = torch.softmax(logits.float(), dim=-1).to(q_in.dtype)
        out = torch.einsum("...hqk,...khd->...qhd", weights, v)
        return self.out(out.reshape(*out.shape[:-2], H * dh))


class TransformerEncoderLayer(nn.Module):
    """Pre-norm block: x + attn(norm(x)); x + ff(norm(x)); no qkv bias."""

    def __init__(self, d_model: int, n_heads: int,
                 d_head: Optional[int] = None, d_feedforward: int = 512,
                 scalenorm: bool = True):
        super().__init__()
        norm = (lambda: ScaleNorm()) if scalenorm else \
            (lambda: LayerNorm(d_model, f32_out=True))
        self.norm_attn = norm()
        self.attn = MultiHeadAttention(d_model, n_heads, d_head,
                                       qkv_bias=False)
        self.norm_ff = norm()
        self.ff_in = Dense(d_model, d_feedforward)
        self.ff_out = Dense(d_feedforward, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm_attn(x)
        x = x + self.attn(h, h)
        h = self.ff_out(gelu_exact(self.ff_in(self.norm_ff(x))))
        return x + h


class TransformerEncoder(nn.Module):
    """x_transformers ``Encoder``: ``layer_{i}`` pre-norm layers + final
    norm."""

    def __init__(self, d_model: int, n_layers: int, n_heads: int,
                 d_head: Optional[int] = None, d_feedforward: int = 512,
                 scalenorm: bool = True):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                d_model, n_heads, d_head, d_feedforward, scalenorm))
        self.final_norm = ScaleNorm() if scalenorm else \
            LayerNorm(d_model, f32_out=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x)
        return self.final_norm(x)
