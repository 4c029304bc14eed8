"""One DuETT dual-axis encoder block, fused (K3).

``fused_encoder_block`` is the counterpart of
``multimodal_edema_prediction_tpu/ops/pallas_dual_axis.py::
fused_encoder_block``: the ``TransformerEncoder(n_layers=1)`` block that
DuETT runs on each axis,

    z = x + Wo·MHA(ScaleNorm1(x)) + bo
    y = ScaleNorm_f(z + W2·gelu_tanh(W1·ScaleNorm2(z) + b1) + b2),

on x [B, L, D] with the JAX parameter dict (flax ``[in, out]`` layouts):
``g1``, ``g2``, ``gf`` [1]; ``wq``, ``wk``, ``wv`` [D, H·dh]; ``wo``
[H·dh, D]; ``bo`` [D]; ``w1`` [D, F]; ``b1`` [F]; ``w2`` [F, D]; ``b2``
[D]. The arithmetic is the TPU kernel's: weights and biases cast to x's
dtype, then everything upcast to float32 (the gains stay float32); every
sum, the softmax and the GELU (its tanh form, ``jax.nn.gelu``'s default)
in float32; the output cast to x's dtype. At float32 this is the JAX
``encoder_block_reference`` exactly.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/dual_axis_block.cu`` (one thread block per batch element) and raises
if it cannot; on a CPU tensor it runs ``encoder_block_reference``, the plain
version, which is also the kernel's oracle in the tests and in
``chip_smoke.py``. The gradient is an autograd Function whose backward
recomputes through ``encoder_block_reference``, as JAX's custom VJP does
(``pallas_dual_axis.py:197-209``): neither package has a backward kernel.
No model calls this op, in either package: it is an opt-in op.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

# launches of the kernel wrapper; chip_smoke.py resets and reads it
LAUNCHES = {"dual_axis_block": 0}

GAINS = ("g1", "g2", "gf")
WEIGHTS = ("wq", "wk", "wv", "wo", "bo", "w1", "b1", "w2", "b2")
PARAM_KEYS = GAINS + WEIGHTS

# shared memory one thread block may take on an H100 (227 KB)
SMEM_LIMIT = 232448
_FF_CHUNK = 128            # csrc/dual_axis_block.cu kFFChunk
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _scalenorm(t: torch.Tensor, g: torch.Tensor, d: int) -> torch.Tensor:
    """float32 ``t / max(||t|| · d^-0.5, 1e-5) · g`` over the last axis."""
    n = torch.sqrt((t * t).sum(-1, keepdim=True)) * (d ** -0.5)
    return t / n.clamp_min(1e-5) * g


def encoder_block_reference(x: torch.Tensor, params: Dict[str, torch.Tensor],
                            n_heads: int, d_head: int) -> torch.Tensor:
    """The plain version: [B, L, D] → [B, L, D] in the kernel's arithmetic
    (module docstring), differentiable."""
    dt = x.dtype
    B, L, D = x.shape
    g1, g2, gf = (params[k].reshape(()).float() for k in GAINS)
    w = {k: params[k].to(dt).float() for k in WEIGHTS}
    xf = x.float()
    h = _scalenorm(xf, g1, D)

    def heads(a):
        return a.reshape(B, L, n_heads, d_head)

    q, k, v = heads(h @ w["wq"]), heads(h @ w["wk"]), heads(h @ w["wv"])
    logits = torch.einsum("blhd,bmhd->bhlm", q, k) * (d_head ** -0.5)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhlm,bmhd->blhd", p, v).reshape(B, L, n_heads * d_head)
    z = xf + o @ w["wo"] + w["bo"]
    f = F.gelu(_scalenorm(z, g2, D) @ w["w1"] + w["b1"], approximate="tanh")
    z = z + f @ w["w2"] + w["b2"]
    return _scalenorm(z, gf, D).to(dt)


def params_from_encoder(encoder) -> Dict[str, torch.Tensor]:
    """K3's parameter dict from a one-layer ``models/layers.
    TransformerEncoder`` (a DuETT axis): the gains of ``layer_0.norm_attn``,
    ``layer_0.norm_ff`` and ``final_norm``, and each ``Dense`` weight
    transposed to the flax ``[in, out]`` layout. At bfloat16 the block then
    computes what the encoder does (both take GELU's tanh form there)."""
    if encoder.n_layers != 1:
        raise ValueError(f"K3 fuses one layer, the encoder has "
                         f"{encoder.n_layers}")
    layer = encoder.layer_0
    attn = layer.attn
    return {"g1": layer.norm_attn.g, "g2": layer.norm_ff.g,
            "gf": encoder.final_norm.g,
            "wq": attn.q.weight.t(), "wk": attn.k.weight.t(),
            "wv": attn.v.weight.t(), "wo": attn.out.weight.t(),
            "bo": attn.out.bias, "w1": layer.ff_in.weight.t(),
            "b1": layer.ff_in.bias, "w2": layer.ff_out.weight.t(),
            "b2": layer.ff_out.bias}


def smem_bytes(L: int, D: int, n_heads: int, d_head: int) -> int:
    """Shared memory the kernel asks for (``smem_floats`` in the source)."""
    def r4(n):
        return (n + 3) // 4 * 4
    inner = n_heads * d_head
    attn = L * r4(3 * inner) + L * r4(inner) + n_heads * L * L
    return 4 * (2 * L * r4(D) + max(attn, L * _FF_CHUNK))


def _check(x: torch.Tensor, params: Dict[str, torch.Tensor], n_heads: int,
           d_head: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be [B, L, D], got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_encoder_block: no kernel for device "
                         f"{x.device}")
    missing = [k for k in PARAM_KEYS if k not in params]
    if missing:
        raise ValueError(f"fused_encoder_block: missing params {missing}")
    _, _, D = x.shape
    inner = n_heads * d_head
    Fh = params["w1"].shape[-1]
    want = {"wq": (D, inner), "wk": (D, inner), "wv": (D, inner),
            "wo": (inner, D), "bo": (D,), "w1": (D, Fh), "b1": (Fh,),
            "w2": (Fh, D), "b2": (D,), "g1": (1,), "g2": (1,), "gf": (1,)}
    bad = {k: tuple(params[k].shape) for k, s in want.items()
           if tuple(params[k].shape) != s}
    if bad:
        raise ValueError(f"fused_encoder_block: params of the wrong shape "
                         f"{bad} for x {tuple(x.shape)}, {n_heads} heads x "
                         f"{d_head}")


def block_kernel(x: torch.Tensor, params: Dict[str, torch.Tensor],
                 n_heads: int, d_head: int) -> torch.Tensor:
    """K3 on a CUDA tensor: one launch, no gradient."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_encoder_block kernel takes float32 or "
                         f"bfloat16, got {x.dtype}")
    B, L, D = x.shape
    smem = smem_bytes(L, D, n_heads, d_head)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_encoder_block kernel: [{L}, {D}] needs "
                         f"{smem} bytes of shared memory, over {SMEM_LIMIT}")
    dt, dev = x.dtype, x.device
    x = x.contiguous()
    w = {k: params[k].detach().to(device=dev, dtype=dt).contiguous()
         for k in WEIGHTS}
    wqkv = torch.cat([w["wq"], w["wk"], w["wv"]], dim=1).contiguous()
    g = torch.cat([params[k].detach().reshape(1) for k in GAINS]).to(
        device=dev, dtype=torch.float32)
    out = torch.empty_like(x)

    from .build import load
    fn = load("dual_axis_block").dual_axis_block
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + \
            [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPES[dt], x.data_ptr(), wqkv.data_ptr(),
                 *(w[k].data_ptr() for k in ("wo", "bo", "w1", "b1", "w2",
                                             "b2")),
                 g.data_ptr(), out.data_ptr(), B, L, D, n_heads, d_head,
                 w["w1"].shape[1], D ** -0.5, d_head ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"dual_axis_block kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["dual_axis_block"] += 1
    return out


class _FusedBlock(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain version) forward; the backward
    recomputes ``encoder_block_reference`` under autograd."""

    @staticmethod
    def forward(ctx, x, n_heads, d_head, *tensors):
        params = dict(zip(PARAM_KEYS, tensors))
        ctx.save_for_backward(x, *tensors)
        ctx.heads = (n_heads, d_head)
        if x.device.type == "cpu":
            return encoder_block_reference(x, params, n_heads, d_head)
        return block_kernel(x, params, n_heads, d_head)

    @staticmethod
    def backward(ctx, gout):
        x, *tensors = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in (x, *tensors)]
        with torch.enable_grad():
            y = encoder_block_reference(
                leaves[0], dict(zip(PARAM_KEYS, leaves[1:])), *ctx.heads)
            grads = torch.autograd.grad(y, leaves, gout, allow_unused=True)
        return (grads[0], None, None, *grads[1:])


def fused_encoder_block(x: torch.Tensor, params: Dict[str, torch.Tensor],
                        n_heads: int, d_head: int) -> torch.Tensor:
    """[B, L, D] → [B, L, D]: K3 on a CUDA tensor, the plain version on a
    CPU tensor; differentiable in x and every parameter."""
    _check(x, params, n_heads, d_head)
    tensors = [params[k] for k in PARAM_KEYS]
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, *tensors)):
        return _FusedBlock.apply(x, n_heads, d_head, *tensors)
    if x.device.type == "cpu":
        return encoder_block_reference(x, params, n_heads, d_head)
    return block_kernel(x, params, n_heads, d_head)
