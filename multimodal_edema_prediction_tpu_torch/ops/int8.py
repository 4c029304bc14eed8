"""Int8 matmuls for the frozen CXR ViT (post-training quantization): the
counterpart of ``multimodal_edema_prediction_tpu/ops/int8.py``.

Symmetric absmax/127 quantization, per token for activations and per
output channel for weights, in float32 with ``torch.round`` (half to even,
as ``jnp.round``); an int8 × int8 → int32 product through
``torch._int_mm``, the counterpart of XLA's ``dot_general`` with an int32
result (the JAX package computes it outside any Pallas kernel, so a
library product stands here as ``torch.matmul`` does for the bf16
projections); dequantized by the product of both scales. The weights stay
float32 in the module tree and are quantized at every call, as in the JAX
package, so checkpoints and ``convert.py`` know nothing of int8.

The rounding order is JAX's: the dequant is ``(acc · s_x) · s_w`` in
float32; ``int8_dense`` casts to the input's dtype and then adds the bias
in that dtype, while ``int8_proj_bhnk`` and ``int8_out_bhnk`` add the
float32 bias before the cast. ``int8_out_bhnk`` takes one scale per token
over all heads (JAX's ``axis=(1, 3)``), which is the absmax of the token's
flattened ``[H·dh]`` row.

Weights are in the port's ``Dense`` layout, ``[out, in]``: per output
channel is per row, and the product reads the transposed view.

On a CUDA tensor the product is ``torch._int_mm`` or an error: it needs K
and N multiples of 8 (a ``ValueError`` here) and more than 16 rows (fewer
are padded with zero rows, which is exact). ``int_mm_reference`` is the
exact plain product the tests and ``chip_smoke.py`` hold it against: an
int32 matmul on the CPU, a float64 one on the card (exact while
|acc| < 2⁵³; ViT-B's is at most 127²·3072 ≈ 4.96e7). Every op takes
``mm`` (default ``int_mm``); the ``*_reference`` ops pass the plain one.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F

# int8 products run, by route; chip_smoke.py resets and reads them
CALLS = {"int_mm": 0}

# torch._int_mm on CUDA takes more than 16 rows
_MIN_ROWS = 17


def reset_calls() -> None:
    for name in CALLS:
        CALLS[name] = 0


def quantize_rows(x: torch.Tensor, dim: Union[int, Tuple[int, ...]] = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization along ``dim``: ``(q int8, scale
    float32)``, ``x ≈ q · scale``, the scale kept broadcastable."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=dim, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a host scalar multiplies
    # by its reciprocal, which moves some scales by an ulp off JAX's (and
    # the CPU's) correctly rounded quotient
    scale = absmax.clamp_min(1e-12) / torch.full_like(absmax, 127.0)
    q = torch.round(x32 / scale).clamp_(-127, 127)
    return q.to(torch.int8), scale


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ b [K, N] int8 → [M, N] int32`` through
    ``torch._int_mm``."""
    if a.is_cuda:
        # cuBLASLt takes a row-major a (a column-major one fails at small M)
        # and runs 4-6x faster on a column-major b, the transposed view of a
        # [N, K] weight, than on a row-major one (H100)
        a = a.contiguous()
        M, K = a.shape
        N = b.shape[1]
        if K % 8 or N % 8:
            raise ValueError(f"int8 product [{M}, {K}] @ [{K}, {N}] on the "
                             "card: torch._int_mm needs K and N multiples "
                             "of 8")
        if M < _MIN_ROWS:
            return int_mm(F.pad(a, (0, 0, 0, _MIN_ROWS - M)), b)[:M]
    CALLS["int_mm"] += 1
    return torch._int_mm(a, b)


def int_mm_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact plain int32 product of ``int_mm``: an int32 matmul on the
    CPU, a float64 one on the card (CUDA has no integer matmul)."""
    if a.is_cuda:
        return torch.matmul(a.double(), b.double()).to(torch.int32)
    return torch.matmul(a.int(), b.int())


def _dequant(x2: torch.Tensor, w: torch.Tensor, mm: Callable
             ) -> torch.Tensor:
    """``x2 [M, K] @ w.T`` (``w [N, K]``) quantized: the float32
    ``(acc · s_x) · s_w`` before any bias or cast."""
    xq, sx = quantize_rows(x2, -1)                   # per token [M, 1]
    wq, sw = quantize_rows(w, -1)                    # per out channel [N, 1]
    acc = mm(xq, wq.t())
    return acc.float() * sx * sw.t()


def int8_matmul(x: torch.Tensor, w: torch.Tensor, mm: Callable = int_mm
                ) -> torch.Tensor:
    """``x @ w.T`` with both sides quantized to int8; ``x [..., K]``,
    ``w [N, K]`` float32; the result in ``x.dtype``."""
    y = _dequant(x.reshape(-1, x.shape[-1]), w, mm).to(x.dtype)
    return y.view(*x.shape[:-1], w.shape[0])


def int8_dense(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None, mm: Callable = int_mm
               ) -> torch.Tensor:
    """The quantized ``Dense``: ``int8_matmul`` then the bias, cast to
    ``x.dtype``, added in that dtype (JAX ``ops/int8.py:60-65``)."""
    y = int8_matmul(x, w, mm)
    return y if b is None else y + b.to(y.dtype)


def int8_proj_bhnk(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor], H: int, dh: int,
                   mm: Callable = int_mm) -> torch.Tensor:
    """The quantized q/k/v projection into the head-major ``[B, H, N, dh]``
    the flash kernel reads (a strided view of ``[B, N, H, dh]``): ``x
    [B, N, d]``, ``w [H·dh, d]``; the float32 bias added before the cast
    (JAX ``ops/int8.py:68-83``)."""
    B, N, d = x.shape
    y = _dequant(x.reshape(B * N, d), w, mm)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype).view(B, N, H, dh).transpose(1, 2)


def int8_out_bhnk(o: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor], mm: Callable = int_mm
                  ) -> torch.Tensor:
    """The quantized attention output projection ``[B, H, N, dh] →
    [B, N, d]``, ``w [d, H·dh]``, one activation scale per token over all
    heads; the float32 bias added before the cast (JAX
    ``ops/int8.py:86-97``)."""
    B, H, N, dh = o.shape
    y = _dequant(o.transpose(1, 2).reshape(B * N, H * dh), w, mm)
    if b is not None:
        y = y + b.float()
    return y.to(o.dtype).view(B, N, w.shape[0])


def int8_dense_reference(x, w, b=None):
    return int8_dense(x, w, b, mm=int_mm_reference)


def int8_proj_bhnk_reference(x, w, b, H, dh):
    return int8_proj_bhnk(x, w, b, H, dh, mm=int_mm_reference)


def int8_out_bhnk_reference(o, w, b):
    return int8_out_bhnk(o, w, b, mm=int_mm_reference)
