"""Flash attention (the ViT self-attention, 1370 tokens) for the port.

``flash_mha`` is the counterpart of ``multimodal_edema_prediction_tpu/ops/
attention.py::flash_mha``: non-causal softmax(Q Kᵀ·sm_scale)·V on
``[B, H, N, D]``. On a CUDA tensor it launches the hand-written kernel in
``csrc/flash_attention.cu`` (D = 64, float32 or bfloat16) and raises if it
cannot; on a CPU tensor it runs ``flash_mha_reference``, the plain version,
which is also the kernel's oracle in the tests and in ``chip_smoke.py``.
There is no fallback from one to the other. The kernel is forward only: on
a CUDA tensor that needs a gradient the wrapper raises (the CPU path stays
differentiable).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

# launches of each kernel wrapper; chip_smoke.py resets and reads them
LAUNCHES = {"flash_attention": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float = 1.0, q_valid: Optional[int] = None,
                        kv_valid: Optional[int] = None) -> torch.Tensor:
    """Plain attention, the masked ``mha_reference`` path of the JAX
    package (``ops/attention.py:93-99``): keys at or past ``kv_valid`` get
    a -1e30 bias before the scale. Computed in float32 (the kernel's
    accumulation type), returned in the input dtype. ``q_valid`` is accepted
    for parity: rows past it are garbage by contract either way."""
    del q_valid
    Nk = k.shape[2]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if kv_valid is not None and kv_valid < Nk:
        pad = torch.arange(Nk, device=q.device) >= kv_valid
        logits = logits + pad.float() * -1e30
    weights = torch.softmax(logits * sm_scale, dim=-1)
    return torch.matmul(weights, v.float()).to(q.dtype)


def _kernel_ready(x: torch.Tensor) -> torch.Tensor:
    """The kernel reads 16-byte rows: head dim contiguous, other strides a
    multiple of 8 elements, base 16-byte aligned. Other layouts are copied."""
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s % 8 == 0 for s in x.stride()[:-1]))
    return x if ok else x.contiguous()


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float = 1.0, q_valid: Optional[int] = None,
              kv_valid: Optional[int] = None) -> torch.Tensor:
    """[B, H, Nq, D] x [B, H, Nk, D] attention. Keys at or past ``kv_valid``
    get zero probability; query rows at or past ``q_valid`` are computed but
    meaningless (the caller slices them off).

    CUDA tensors go through the kernel, whose output is laid out as
    [B, Nq, H, D] and returned as a [B, H, Nq, D] view, so the caller's
    merge of heads is free. CPU tensors go through ``flash_mha_reference``.
    """
    if q.device.type == "cpu":
        return flash_mha_reference(q, k, v, sm_scale, q_valid, kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        # the forward kernel's output has no grad_fn: a gradient would be
        # dropped without a word
        raise NotImplementedError(
            "flash_mha on CUDA has no backward kernel yet (ROADMAP K1 "
            "backward); run the frozen ViT under torch.no_grad()")
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
    q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
    out = torch.empty(B, Nq, H, D, dtype=q.dtype, device=q.device)
    o = out.permute(0, 2, 1, 3)

    from .build import load
    fn = load("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p,
                                  ctypes.c_void_p]
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, o) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), B, H, Nq, Nk, n_keys, float(sm_scale),
                 ctypes.addressof(strides), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention"] += 1
    return o
