"""Flash attention (the ViT self-attention, 1370 tokens) for the port.

``flash_mha`` is the counterpart of ``multimodal_edema_prediction_tpu/ops/
attention.py::flash_mha``: non-causal softmax(Q Kᵀ·sm_scale)·V on
``[B, H, N, D]``, differentiable. On a CUDA tensor it launches the
hand-written kernels (D = 64, float32 or bfloat16): the forward in
``csrc/flash_attention.cu`` (bfloat16 on warpgroup MMAs, float32 on 3xTF32
tensor-core products, ``csrc/mma_tf32.cuh``) and, when q, k or v needs a
gradient, the D (rowsum(dO∘O)), dkv and dq backward kernels in
``csrc/flash_attention_bwd.cu`` behind a ``torch.autograd.Function``,
whose forward also keeps each query row's log-sum-exp for them. On a CPU
tensor the same Function runs the plain versions, ``flash_mha_reference``,
``flash_mha_backward_reference`` and ``delta_reference``, which are also
the kernels' oracles in the tests and in ``chip_smoke.py``. There is no fallback from one to the other: a
kernel that cannot build or launch raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

# launches of each kernel, by kernel: a wrapper counts its bfloat16 kernel
# under its own name and its float32 kernel (the reference-precision path)
# under that name with "_f32" (``launch_key``); chip_smoke.py resets and
# reads them
LAUNCHES = {name + suffix: 0 for name in (
    "flash_attention", "flash_attention_bwd_delta", "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq") for suffix in ("", "_f32")}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_I, _P = ctypes.c_int, ctypes.c_void_p
# each C entry point: its library and its ctypes signature, the dtype first
# and the stream last; the three attention kernels take pointers, then
# B, H, Nq, Nk and kv_valid, the scale, the strides and the tensor maps
ENTRY_POINTS = {
    "flash_attention_fwd": ("flash_attention", [_I] + [_P] * 5 + [_I] * 5
                            + [ctypes.c_float] + [_P] * 3),
    "flash_attention_bwd_delta": ("flash_attention_bwd",
                                  [_I] + [_P] * 3 + [_I] * 3 + [_P] * 2),
    "flash_attention_bwd_dkv": ("flash_attention_bwd", [_I] + [_P] * 8
                                + [_I] * 5 + [ctypes.c_float] + [_P] * 3),
    "flash_attention_bwd_dq": ("flash_attention_bwd", [_I] + [_P] * 7
                               + [_I] * 5 + [ctypes.c_float] + [_P] * 3),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_key(name: str, dtype: torch.dtype) -> str:
    """The key of ``LAUNCHES`` that wrapper ``name`` counts a launch of its
    kernel for ``dtype`` under."""
    return name + ("_f32" if dtype == torch.float32 else "")


def _count(name: str, dtype: torch.dtype) -> None:
    LAUNCHES[launch_key(name, dtype)] += 1


def _scaled_logits(q: torch.Tensor, k: torch.Tensor, sm_scale: float,
                   kv_valid: Optional[int]) -> torch.Tensor:
    """float32 Q Kᵀ with keys at or past ``kv_valid`` biased by -1e30, then
    scaled (the order of the JAX package's masked ``mha_reference``)."""
    Nk = k.shape[2]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if kv_valid is not None and kv_valid < Nk:
        pad = torch.arange(Nk, device=q.device) >= kv_valid
        logits = logits + pad.float() * -1e30
    return logits * sm_scale


def flash_mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float = 1.0, q_valid: Optional[int] = None,
                        kv_valid: Optional[int] = None) -> torch.Tensor:
    """Plain attention, the masked ``mha_reference`` path of the JAX
    package (``ops/attention.py:93-99``): keys at or past ``kv_valid`` get
    a -1e30 bias before the scale. Computed in float32 (the kernel's
    accumulation type), returned in the input dtype. ``q_valid`` is accepted
    for parity: rows past it are garbage by contract either way."""
    del q_valid
    weights = torch.softmax(_scaled_logits(q, k, sm_scale, kv_valid), dim=-1)
    return torch.matmul(weights, v.float()).to(q.dtype)


def flash_mha_lse_reference(q: torch.Tensor, k: torch.Tensor,
                            sm_scale: float = 1.0,
                            kv_valid: Optional[int] = None) -> torch.Tensor:
    """The forward kernel's second output, plainly: float32 [B, H, Nq]
    log-sum-exp of each query row's scaled, masked scores (JAX's ``m +
    log(l)`` of ``mha_reference_no_custom_vjp(save_residuals=True)``)."""
    return torch.logsumexp(_scaled_logits(q, k, sm_scale, kv_valid), dim=-1)


def flash_mha_backward_reference(q, k, v, o, lse, do, sm_scale: float = 1.0,
                                 kv_valid: Optional[int] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """(dq, dk, dv) of ``flash_mha`` at ``do``, plainly and in float32, as
    JAX 0.9.0's ``mha_reference_bwd`` writes them out
    (``flash_attention.py:1615-1674``), with the scale carried through:
    P = exp(S·scale − lse), dV = Pᵀ·dO, dP = dO·Vᵀ, D = rowsum(dO∘O),
    dS = P∘(dP − D), dQ = dS·K·scale, dK = dSᵀ·Q·scale. Returned in the
    inputs' dtypes."""
    p = torch.exp(_scaled_logits(q, k, sm_scale, kv_valid)
                  - lse.float()[..., None])
    dof = do.float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = p * (dp - (o.float() * dof).sum(-1, keepdim=True))
    dq = torch.matmul(ds, k.float()) * sm_scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _layout_ok(x: torch.Tensor) -> bool:
    """The kernels' one layout rule: head dim contiguous, base 16-byte
    aligned, every other stride a multiple of 8 elements and not 0 (a
    broadcast dim) unless its dim has one element. It is what the kernels'
    16-byte row loads need, and what a bf16 tensor map describes."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st % 8 == 0 and (st > 0 or size == 1)
                    for size, st in zip(x.shape[:-1], x.stride()[:-1])))


def _kernel_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` if it keeps ``_layout_ok``'s rule, else a contiguous copy."""
    return x if _layout_ok(x) else \
        x.clone(memory_format=torch.contiguous_format)


def tma_geometry(x: torch.Tensor, rows: int) -> Tuple[int, ...]:
    """The bf16 attention kernels' tensor map of [B, H, N, 64] ``x``, as the
    C entry points take it: dims (64, rows, H, B), innermost first, then the
    byte strides of rows, heads and batches. Rows at or past ``rows``
    (≤ N) read as zeros. A dim of one element gets the stride of one row (it
    is never stepped over). Raises on a float32 tensor (its kernels read
    through the strides) and on a layout that breaks ``_layout_ok``'s rule,
    which ``_kernel_ready`` copies first."""
    B, H, N, D = x.shape
    if x.dtype != torch.bfloat16 or D != 64 or not _layout_ok(x):
        raise ValueError(f"no tensor map for a {x.dtype} tensor of shape "
                         f"{tuple(x.shape)}, strides {x.stride()}")
    if not 1 <= rows <= N:
        raise ValueError(f"tensor map rows {rows} outside [1, {N}]")
    strides = tuple(st * 2 if size > 1 else D * 2
                    for size, st in ((N, x.stride(2)), (H, x.stride(1)),
                                     (B, x.stride(0))))
    return (D, rows, H, B) + strides


def _tma_maps(a: torch.Tensor, b: torch.Tensor, rows: int):
    """The geometry of the tensor maps of a bf16 attention kernel's two
    streamed tensors (the forward and dq: k and v, ``n_keys`` rows; dkv: q
    and dO, Nq rows), flattened for ctypes; None for float32, whose kernels
    read through the strides."""
    if a.dtype != torch.bfloat16:
        return None
    geo = tma_geometry(a, rows) + tma_geometry(b, rows)
    return (ctypes.c_ulonglong * len(geo))(*geo)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_valid: Optional[int]) -> int:
    """What the kernels take; returns the number of keys that take part."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    if D != 64:
        raise ValueError(f"flash_mha kernel takes head dim 64, got {D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_mha kernel takes float32 or bfloat16 "
                         f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if k.shape != (B, H, Nk, D) or v.shape != k.shape:
        raise ValueError(f"flash_mha: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_mha: q, k, v on different devices")
    n_keys = Nk if kv_valid is None else int(kv_valid)
    if not 1 <= n_keys <= Nk:
        raise ValueError(f"flash_mha: kv_valid {kv_valid} outside [1, {Nk}]")
    return n_keys


def _strides(*tensors):
    """The (b, h, n) element strides of each tensor, flattened for ctypes."""
    return (ctypes.c_longlong * (3 * len(tensors)))(*(
        st for t in tensors for st in t.stride()[:3]))


def _launch(name: str, dtype: torch.dtype, args, device) -> None:
    """Launch the C entry point ``name`` (``ENTRY_POINTS``) on the current
    stream; ``args`` are what comes between the dtype and the stream:
    tensors (as their data pointers, None as a null pointer), ints, floats
    and ctypes arrays (as their addresses). Raise if CUDA refused it."""
    from .build import load
    lib, argtypes = ENTRY_POINTS[name]
    fn = getattr(load(lib), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    conv = [a.data_ptr() if isinstance(a, torch.Tensor)
            else ctypes.addressof(a) if isinstance(a, ctypes.Array) else a
            for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(_DTYPES[dtype], *conv, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _bnhd_empty(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor like [B, H, N, D] ``x``, laid out as [B, N, H, D]
    (the layout of the projections the ViT views q, k, v from) and returned
    as a [B, H, N, D] view."""
    B, H, N, D = x.shape
    return torch.empty(B, N, H, D, dtype=x.dtype,
                       device=x.device).permute(0, 2, 1, 3)


def forward_kernel(q, k, v, sm_scale: float, n_keys: int, with_lse: bool):
    """K1's forward on ready tensors: (o, lse or None). ``o`` is laid out
    as [B, Nq, H, D] and returned as a [B, H, Nq, D] view."""
    B, H, Nq, D = q.shape
    o = _bnhd_empty(q)
    lse = torch.empty(B, H, Nq, dtype=torch.float32, device=q.device) \
        if with_lse else None
    _launch("flash_attention_fwd", q.dtype,
            [q, k, v, o, lse, B, H, Nq, k.shape[2], n_keys, float(sm_scale),
             _strides(q, k, v, o), _tma_maps(k, v, n_keys)], q.device)
    _count("flash_attention", q.dtype)
    return o, lse


def delta_reference(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO∘O) in float32, [B, H, Nq] contiguous, plainly: the
    backward kernels' second row statistic, as JAX computes ``di``
    (``flash_attention.py:273-275``)."""
    return (o.float() * do.float()).sum(-1).contiguous()


def delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta_reference`` through the one-pass kernel
    (``flash_attention_bwd.cu::flash_bwd_delta_*``) for CUDA tensors: o and
    dO of one dtype (float32 or bfloat16), [B, H, Nq, 64] in any layout
    that keeps ``_layout_ok``'s rule (others are copied first). CPU tensors
    take the plain version."""
    if o.device.type == "cpu" and do.device.type == "cpu":
        return delta_reference(o, do)
    if o.device.type != "cuda" or do.device != o.device:
        raise ValueError(f"delta: no kernel for o on {o.device} and dO on "
                         f"{do.device}")
    if o.shape != do.shape or o.shape[-1] != 64:
        raise ValueError(f"delta kernel takes o and dO of one [B, H, N, 64] "
                         f"shape, got {tuple(o.shape)} / {tuple(do.shape)}")
    if o.dtype not in _DTYPES or do.dtype != o.dtype:
        raise ValueError(f"delta kernel takes float32 or bfloat16 o and dO "
                         f"of one dtype, got {o.dtype}/{do.dtype}")
    o, do = _kernel_ready(o), _kernel_ready(do)
    B, H, Nq, _ = o.shape
    out = torch.empty(B, H, Nq, dtype=torch.float32, device=o.device)
    if out.numel():
        _launch("flash_attention_bwd_delta", o.dtype,
                [o, do, out, B, H, Nq, _strides(o, do)], o.device)
        _count("flash_attention_bwd_delta", o.dtype)
    return out


def dkv_kernel(q, k, v, do, lse, dlt, sm_scale: float, n_keys: int):
    """K1's dkv kernel on ready tensors: (dk, dv)."""
    dk, dv = _bnhd_empty(k), _bnhd_empty(v)
    _launch("flash_attention_bwd_dkv", q.dtype,
            [q, k, v, do, lse, dlt, dk, dv, q.shape[0], q.shape[1],
             q.shape[2], k.shape[2], n_keys, float(sm_scale),
             _strides(q, k, v, do, dk, dv), _tma_maps(q, do, q.shape[2])],
            q.device)
    _count("flash_attention_bwd_dkv", q.dtype)
    return dk, dv


def dq_kernel(q, k, v, do, lse, dlt, sm_scale: float, n_keys: int):
    """K1's dq kernel on ready tensors: dq."""
    dq = _bnhd_empty(q)
    _launch("flash_attention_bwd_dq", q.dtype,
            [q, k, v, do, lse, dlt, dq, q.shape[0], q.shape[1], q.shape[2],
             k.shape[2], n_keys, float(sm_scale), _strides(q, k, v, do, dq),
             _tma_maps(k, v, n_keys)], q.device)
    _count("flash_attention_bwd_dq", q.dtype)
    return dq


class _FlashMHA(torch.autograd.Function):
    """``flash_mha`` with a gradient: the kernels on a CUDA tensor, the plain
    versions on a CPU tensor, the same wiring (lse saved by the forward, D
    and the [B, N, H, D] gradient layouts in the backward) either way. On
    the card the backward is three launches: D, dkv, dq."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float, kv_valid: Optional[int]):
        if q.device.type == "cpu":
            o = flash_mha_reference(q, k, v, sm_scale, kv_valid=kv_valid)
            lse = flash_mha_lse_reference(q, k, sm_scale, kv_valid)
        else:
            n_keys = _check(q, k, v, kv_valid)
            q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
            o, lse = forward_kernel(q, k, v, sm_scale, n_keys, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale, ctx.kv_valid = sm_scale, kv_valid
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_mha_backward_reference(
                q, k, v, o, lse, do, ctx.sm_scale, ctx.kv_valid)
        else:
            do = _kernel_ready(do.to(q.dtype))
            n_keys = _check(q, k, v, ctx.kv_valid)
            dlt = delta(o, do)
            dk, dv = dkv_kernel(q, k, v, do, lse, dlt, ctx.sm_scale, n_keys)
            dq = dq_kernel(q, k, v, do, lse, dlt, ctx.sm_scale, n_keys)
        return dq, dk, dv, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float = 1.0, q_valid: Optional[int] = None,
              kv_valid: Optional[int] = None) -> torch.Tensor:
    """[B, H, Nq, D] x [B, H, Nk, D] attention. Keys at or past ``kv_valid``
    get zero probability; query rows at or past ``q_valid`` are computed but
    meaningless (the caller slices them off).

    CUDA tensors go through the kernels, whose outputs are laid out as
    [B, N, H, D] and returned as [B, H, N, D] views, so the caller's merge
    of heads (and the projections' gradients) are free. Without a gradient
    to keep, the forward writes no log-sum-exp. CPU tensors go through the
    plain versions.
    """
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_mha: no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashMHA.apply(q, k, v, float(sm_scale), kv_valid)
    if q.device.type == "cpu":
        return flash_mha_reference(q, k, v, sm_scale, q_valid, kv_valid)
    n_keys = _check(q, k, v, kv_valid)
    q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
    return forward_kernel(q, k, v, sm_scale, n_keys, False)[0]
