"""LayerNorm → Q, K, V projections, fused (K4).

``fused_ln_qkv`` is the counterpart of
``multimodal_edema_prediction_tpu/ops/pallas_ln_qkv.py::fused_ln_qkv``:

    h = LN(x) · ln_scale + ln_bias      (float32 statistics, biased
                                         variance, eps; h in x's dtype)
    q, k, v = h · W{q,k,v} + b{q,k,v}   (x's dtype operands, float32
                                         accumulation, bias added in float32)

from x [B, N, D] to three [B, H, N, dh] head-major tensors (K1's input
layout), with the JAX parameter dict: ``ln_scale``, ``ln_bias`` [D];
``wq``, ``wk``, ``wv`` [D, H·dh]; ``bq``, ``bk``, ``bv`` [H·dh]. The LN rows,
weights and biases are cast to x's dtype first, as the TPU wrapper does
(``pallas_ln_qkv.py:92-98``). At float32 this is the JAX
``ln_qkv_reference`` exactly. The JAX contract stays: N must be below 512
or a multiple of 512 (``:86-88``), so both packages take the same inputs.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/ln_qkv.cu`` (bfloat16: a GEMM on warpgroup MMAs with x and W
streamed by TMA and the LayerNorm applied to each x tile in shared memory,
256 output columns a tile; float32: each row's statistics first, into a
scratch the wrapper allocates, then the same GEMM with its products as
3xTF32 tensor-core products, ``csrc/mma_tf32.cuh``; head dim 64, D a
multiple of 32) and raises if it cannot; on a CPU tensor it runs
``ln_qkv_reference``, the plain version, which is also the kernel's oracle
in the tests and in ``chip_smoke.py``. The gradient is an autograd Function
whose backward recomputes through ``ln_qkv_reference``, as JAX's custom VJP
does (``:131-143``). No model calls this op, in either package.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

# launches of the kernel wrapper, by kernel: the bfloat16 kernel under
# "ln_qkv", the float32 one under "ln_qkv_f32"; chip_smoke.py resets and
# reads them
LAUNCHES = {"ln_qkv": 0, "ln_qkv_f32": 0}

PARAM_KEYS = ("ln_scale", "ln_bias", "wq", "wk", "wv", "bq", "bk", "bv")
BLOCK_N = 512              # the JAX wrapper's token block (its N contract)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entry point of csrc/ln_qkv.cu: its library and its ctypes signature
# (dtype, x, scale, bias, w, b, out, stats, B, N, D, H, eps, stream)
ENTRY_POINTS = {
    "ln_qkv": ("ln_qkv", [_I] + [_P] * 7 + [_I] * 4
               + [ctypes.c_float, _P]),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def ln_qkv_reference(x: torch.Tensor, params: Dict[str, torch.Tensor],
                     n_heads: int, d_head: int, eps: float = 1e-6
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version: (q, k, v), each [B, H, N, dh] in x's dtype, in
    the kernel's arithmetic (module docstring), differentiable."""
    dt = x.dtype
    B, N, D = x.shape
    p = {k: params[k].to(dt).float() for k in PARAM_KEYS}
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    h = ((xf - mean) * torch.rsqrt(var + eps) * p["ln_scale"]
         + p["ln_bias"]).to(dt).float()

    def proj(w, b):
        y = torch.einsum("bnd,dhk->bhnk", h,
                         w.reshape(D, n_heads, d_head))
        return (y + b.reshape(n_heads, 1, d_head)).to(dt)

    return proj(p["wq"], p["bq"]), proj(p["wk"], p["bk"]), \
        proj(p["wv"], p["bv"])


def _check(x: torch.Tensor, params: Dict[str, torch.Tensor], n_heads: int,
           d_head: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, D], got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ln_qkv: no kernel for device {x.device}")
    _, N, D = x.shape
    if not (N % BLOCK_N == 0 or N < BLOCK_N):
        raise ValueError(f"token dim {N} must be a multiple of block_n="
                         f"{BLOCK_N} (pad once at the model level)")
    inner = n_heads * d_head
    want = {"ln_scale": (D,), "ln_bias": (D,), "wq": (D, inner),
            "wk": (D, inner), "wv": (D, inner), "bq": (inner,),
            "bk": (inner,), "bv": (inner,)}
    missing = [k for k in want if k not in params]
    if missing:
        raise ValueError(f"fused_ln_qkv: missing params {missing}")
    bad = {k: tuple(params[k].shape) for k, s in want.items()
           if params[k].numel() != s[0] * (s[1] if len(s) > 1 else 1)}
    if bad:
        raise ValueError(f"fused_ln_qkv: params of the wrong shape {bad} "
                         f"for x {tuple(x.shape)}, {n_heads} heads x "
                         f"{d_head}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if contiguous on a 16-byte boundary (the bf16 kernel's 16-byte
    loads and tensor map need it), else a contiguous copy."""
    return t if t.is_contiguous() and t.data_ptr() % 16 == 0 else \
        t.clone(memory_format=torch.contiguous_format)


def ln_qkv_kernel(x: torch.Tensor, params: Dict[str, torch.Tensor],
                  n_heads: int, d_head: int, eps: float = 1e-6
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 on a CUDA tensor: one launch, no gradient. The three outputs are
    slices of one [3, B, H, N, dh] tensor."""
    B, N, D = x.shape
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_ln_qkv kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if d_head != 64 or D % 32:
        raise ValueError(f"fused_ln_qkv kernel takes head dim 64 and D a "
                         f"multiple of 32, got {d_head} and {D}")
    dt, dev = x.dtype, x.device
    inner = n_heads * d_head

    def cast(k, shape):
        return params[k].detach().to(device=dev, dtype=dt).reshape(shape)

    x = _aligned(x)
    scale, bias = _aligned(cast("ln_scale", (D,))), \
        _aligned(cast("ln_bias", (D,)))
    w = torch.stack([cast(k, (D, inner)) for k in ("wq", "wk", "wv")])
    b = torch.stack([cast(k, (inner,)) for k in ("bq", "bk", "bv")])
    out = torch.empty(3, B, n_heads, N, d_head, dtype=dt, device=dev)
    if out.numel() == 0:
        return out[0], out[1], out[2]
    # the float32 kernel's scratch: each row's (mean, rstd), from its first
    # launch to its second
    stats = torch.empty(B * N, 2, dtype=torch.float32, device=dev) \
        if dt == torch.float32 else None

    from .build import load
    lib, argtypes = ENTRY_POINTS["ln_qkv"]
    fn = load(lib).ln_qkv
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPES[dt], x.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 None if stats is None else stats.data_ptr(),
                 B, N, D, n_heads, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"ln_qkv kernel launch failed: CUDA error {err}")
    LAUNCHES["ln_qkv_f32" if dt == torch.float32 else "ln_qkv"] += 1
    return out[0], out[1], out[2]


class _FusedLnQkv(torch.autograd.Function):
    """The kernel (or, on the CPU, the plain version) forward; the backward
    recomputes ``ln_qkv_reference`` under autograd."""

    @staticmethod
    def forward(ctx, x, n_heads, d_head, eps, *tensors):
        params = dict(zip(PARAM_KEYS, tensors))
        ctx.save_for_backward(x, *tensors)
        ctx.args = (n_heads, d_head, eps)
        if x.device.type == "cpu":
            return ln_qkv_reference(x, params, n_heads, d_head, eps)
        return ln_qkv_kernel(x, params, n_heads, d_head, eps)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        x, *tensors = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in (x, *tensors)]
        with torch.enable_grad():
            outs = ln_qkv_reference(
                leaves[0], dict(zip(PARAM_KEYS, leaves[1:])), *ctx.args)
            grads = torch.autograd.grad(outs, leaves, (gq, gk, gv),
                                        allow_unused=True)
        return (grads[0], None, None, None, *grads[1:])


def fused_ln_qkv(x: torch.Tensor, params: Dict[str, torch.Tensor],
                 n_heads: int, d_head: int, eps: float = 1e-6
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, N, D] → (q, k, v), each [B, H, N, dh]: K4 on a CUDA tensor, the
    plain version on a CPU tensor; differentiable in x and every
    parameter."""
    _check(x, params, n_heads, d_head)
    tensors = [params[k] for k in PARAM_KEYS]
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, *tensors)):
        return _FusedLnQkv.apply(x, n_heads, d_head, float(eps), *tensors)
    if x.device.type == "cpu":
        return ln_qkv_reference(x, params, n_heads, d_head, eps)
    return ln_qkv_kernel(x, params, n_heads, d_head, eps)
