"""Shared PyTorch building blocks: the counterparts of
``multimodal_edema_prediction_tpu/models/layers.py``.

Every module keeps its parameters in float32 and casts them to the input's
dtype at use, as the flax modules do (``param_dtype=float32``,
``dtype=x.dtype``). Submodule and parameter names mirror the flax tree, so
``convert.py`` maps a flax checkpoint onto ``state_dict()`` by a fixed rule.

As in flax, every module takes an explicit ``train`` flag rather than
reading ``nn.Module.training``, so that a frozen submodule can run in eval
mode inside a training step. With ``train=True`` dropout draws from the
``torch.Generator`` passed as ``gen`` (flax's ``"dropout"`` rng), and
BatchNorm normalizes with batch statistics and updates its running buffers
in place (flax's mutable ``"batch_stats"``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_mha


def dropout(x: torch.Tensor, p: float, train: bool,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: each element is kept with probability 1 - p and
    scaled by 1/(1 - p), the rest set to zero. The identity unless training
    with p > 0."""
    if not train or p == 0.0:
        return x
    if gen is None:
        raise ValueError("dropout while training needs a torch.Generator")
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _batch_moments(x: torch.Tensor, dims: tuple, running_mean: torch.Tensor,
                   running_var: torch.Tensor):
    """Batch mean and biased variance over ``dims`` in float32, with the
    running update of torch BatchNorm1d: momentum 0.1 and the UNBIASED
    variance (×n/(n−1)), as the JAX ``_TorchBatchNorm`` does."""
    x32 = x.float()
    mean = x32.mean(dim=dims)
    var = x32.var(dim=dims, unbiased=False)
    n = 1
    for d in dims:
        n *= x.shape[d]
    with torch.no_grad():
        running_mean.copy_(0.9 * running_mean + 0.1 * mean)
        running_var.copy_(0.9 * running_var
                          + 0.1 * (var * (n / max(n - 1, 1))))
    return mean, var


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
    """BatchNorm1d over the last axis, statistics over all leading axes
    (eps 1e-5): the flax ``BatchNormLastDim``/``_TorchBatchNorm`` pair. Its
    running statistics are buffers here."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.register_buffer("running_mean", torch.zeros(d))
        self.register_buffer("running_var", torch.ones(d))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            mean, var = _batch_moments(x.reshape(-1, x.shape[-1]), (0,),
                                       self.running_mean, self.running_var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + 1e-5) * self.weight
        return (x - mean.to(x.dtype)) * inv.to(x.dtype) \
            + self.bias.to(x.dtype)


class SimpleMLP(nn.Module):
    """``simple_mlp`` (reference duett/duett.py:24-39), ReLU activation.

    For n_hidden >= 1: in act {[bn_i] hidden_i act}*(n_hidden-1) [bn_out]
    out. (The flax module's ``input_batch_norm``, ``final_activation`` and
    ``dropout`` have no caller in the teacher and are not ported.)"""

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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.n_hidden > 0:
            x = F.relu(getattr(self, "in")(x))
            for i in range(self.n_hidden - 1):
                bn = getattr(self, f"bn_{i}", None)
                if bn is not None:
                    x = bn(x, train)
                x = F.relu(getattr(self, f"hidden_{i}")(x))
            if self.bn_out is not None:
                x = self.bn_out(x, train)
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = torch.tanh(getattr(self, "in")(x))
        if self.bn is not None:
            h = self.bn(h, train)
        return self.out(h)


class PerVariableMLP(nn.Module):
    """V independent 2→d_hidden→d_out MLPs as one batched einsum stack, with
    per-variable BatchNorm statistics of shape [V, d_hidden] (taken over all
    leading axes while training). The flax module's ``dropout`` has no caller
    in the teacher and is not ported."""

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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = x.dtype
        h = torch.einsum("...vc,vcd->...vd", x, self.w1.to(dt)) \
            + self.b1.to(dt)
        h = F.relu(h)
        if train:
            mean, var = _batch_moments(h, tuple(range(h.dim() - 2)),
                                       self.running_mean, self.running_var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + 1e-5) * self.bn_scale
        h = (h - mean.to(dt)) * inv.to(dt) + self.bn_bias.to(dt)
        return torch.einsum("...vd,vdo->...vo", h, self.w2.to(dt)) \
            + self.b2.to(dt)


class MultiHeadAttention(nn.Module):
    """Softmax attention with a decoupled head dim (DuETT: token dims
    600/840, 2 heads × d_head 12). ``q``/``k``/``v`` weights are
    ``[H·d_head, d_model]``; ``out`` is ``[d_model, H·d_head]``.

    With ``use_flash``, no attention dropout in force, and a 3-D input whose
    key length is at least 256 and whose head dim is at least 64, the
    attention goes through ``flash_mha`` (the JAX gate at
    ``models/layers.py:292-296``; the port has no returned weights to
    exclude), gradient included: ``flash_mha``'s autograd Function backs it
    with K1's dkv and dq kernels on the card. While training, ``dropout``
    applies to the attention probabilities (and so closes the gate).
    ``key_padding_mask`` [..., K] bool, True = ignore that key (torch
    ``MultiheadAttention``'s sense): its logits are set to -1e30 before
    the float32 softmax, and it closes the gate. ``valid_len`` is the true
    token count of a pre-padded sequence: keys at or past it get zero
    probability (the mask ``valid_len`` stands for when no mask is given)
    and the outputs of those rows are garbage, to be sliced off by the
    caller."""

    def __init__(self, d_model: int, n_heads: int,
                 d_head: Optional[int] = None, qkv_bias: bool = True,
                 out_bias: bool = True, use_flash: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.n_heads = n_heads
        self.d_head = d_head or d_model // n_heads
        inner = n_heads * self.d_head
        self.q = Dense(d_model, inner, qkv_bias)
        self.k = Dense(d_model, inner, qkv_bias)
        self.v = Dense(d_model, inner, qkv_bias)
        self.out = Dense(inner, d_model, out_bias)
        self.use_flash = use_flash

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                valid_len: Optional[int] = None, train: bool = False,
                gen: Optional[torch.Generator] = None,
                key_padding_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        H, dh = self.n_heads, self.d_head
        flash_ok = (self.use_flash and key_padding_mask is None
                    and (self.dropout == 0.0 or not train)
                    and q_in.dim() == 3 and kv_in.shape[-2] >= 256
                    and dh >= 64)
        if flash_ok:
            B, Nq, Nk = q_in.shape[0], q_in.shape[1], kv_in.shape[1]
            # [B, N, H·dh] → [B, H, N, dh] as strided views: the kernels
            # read them in place and write the output (and, training, the
            # gradients of q, k, v) in [B, N, H, dh]
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
        if valid_len is not None and valid_len < Nk \
                and key_padding_mask is None:
            key_padding_mask = torch.arange(Nk, device=logits.device) \
                >= valid_len
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[..., None, None, :],
                                        -1e30)
        weights = torch.softmax(logits.float(), dim=-1).to(q_in.dtype)
        weights = dropout(weights, self.dropout, train, gen)
        out = torch.einsum("...hqk,...khd->...qhd", weights, v)
        return self.out(out.reshape(*out.shape[:-2], H * dh))


class TransformerEncoderLayer(nn.Module):
    """Pre-norm block: x + attn(norm(x)); x + ff(norm(x)); no qkv bias;
    ``dropout`` on the attention probabilities and after each FF layer."""

    def __init__(self, d_model: int, n_heads: int,
                 d_head: Optional[int] = None, d_feedforward: int = 512,
                 scalenorm: bool = True, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        norm = (lambda: ScaleNorm()) if scalenorm else \
            (lambda: LayerNorm(d_model, f32_out=True))
        self.norm_attn = norm()
        self.attn = MultiHeadAttention(d_model, n_heads, d_head,
                                       qkv_bias=False, dropout=dropout)
        self.norm_ff = norm()
        self.ff_in = Dense(d_model, d_feedforward)
        self.ff_out = Dense(d_feedforward, d_model)

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        p = self.dropout
        h = self.norm_attn(x)
        x = x + self.attn(h, h, train=train, gen=gen)
        h = dropout(gelu_exact(self.ff_in(self.norm_ff(x))), p, train, gen)
        return x + dropout(self.ff_out(h), p, train, gen)


class TransformerEncoder(nn.Module):
    """x_transformers ``Encoder``: ``layer_{i}`` pre-norm layers + final
    norm."""

    def __init__(self, d_model: int, n_layers: int, n_heads: int,
                 d_head: Optional[int] = None, d_feedforward: int = 512,
                 scalenorm: bool = True, dropout: float = 0.0):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                d_model, n_heads, d_head, d_feedforward, scalenorm, dropout))
        self.final_norm = ScaleNorm() if scalenorm else \
            LayerNorm(d_model, f32_out=True)

    def forward(self, x: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, train, gen)
        return self.final_norm(x)


def init_like_flax(model: nn.Module, seed: int,
                   layerscale_init: float = 1.0) -> nn.Module:
    """Fill ``model`` in place from ``seed`` after the flax modules'
    initializers (in distribution: ``torch.Generator`` draws are not
    ``jax.random``'s), in the order of ``named_modules``: dense, conv and
    per-variable kernels truncated-normal with variance 1/fan_in (flax
    ``lecun_normal``; the per-label heads' stacked ``w1 [K, d, H]`` and
    ``w2 [K, H, 1]`` with fan-in ``d`` and ``H``, flax's
    ``lecun_normal(batch_axis=(0,))``), biases zero, norm scales and
    ``beta`` one, LayerScale ``layerscale_init``, the correction head's
    output zero, the DuETT
    special/rep/event embeddings and count embedding N(0, 1), the query
    banks, the ``legacy`` latents, CLS token and position embedding
    N(0, 0.02²), BatchNorm statistics
    (0, 1). Returns ``model``."""
    from .perceiver import StackedLabelHeads
    g = torch.Generator().manual_seed(seed)

    def lecun(t, fan_in):
        std = math.sqrt(1.0 / fan_in) / .87962566103423978
        vals = torch.randn(t.shape, generator=g)
        while True:     # redraw outside ±2σ, as jax.random.truncated_normal
            bad = vals.abs() > 2.0
            if not bad.any():
                break
            vals[bad] = torch.randn(int(bad.sum()), generator=g)
        t.copy_(vals * std)

    ones = ("g", "beta", "bn_scale", "running_var")
    unit_normal = ("special_embeddings", "full_rep_embedding",
                   "full_event_embedding")
    small_normal = ("shared_queries", "image_queries", "temporal_queries",
                    "pathology_queries", "latents", "cls_token", "pos_embed")
    with torch.no_grad():
        for mname, m in model.named_modules():
            for name, t in list(m.named_parameters(recurse=False)) + \
                    list(m.named_buffers(recurse=False)):
                if isinstance(m, Dense) and name == "weight":
                    if mname.endswith("correction_head.head.out"):
                        t.zero_()
                    else:
                        lecun(t, t.shape[1])
                elif isinstance(m, PerVariableMLP) and name in ("w1", "w2"):
                    lecun(t, t.shape[0] * t.shape[1])   # flax's fan_in
                elif isinstance(m, StackedLabelHeads) and name in ("w1",
                                                                   "w2"):
                    lecun(t, t.shape[1])    # axis 0 is the batch of heads
                elif name in ("layerscale1", "layerscale2"):
                    t.fill_(layerscale_init)
                elif name in ones or (name == "weight" and isinstance(
                        m, (LayerNorm, BatchNormLastDim))):
                    t.fill_(1.0)
                elif name in unit_normal or (name == "weight" and isinstance(
                        m, nn.Embedding)):
                    t.copy_(torch.randn(t.shape, generator=g))
                elif name in small_normal:
                    t.copy_(0.02 * torch.randn(t.shape, generator=g))
                else:
                    t.zero_()
    return model
