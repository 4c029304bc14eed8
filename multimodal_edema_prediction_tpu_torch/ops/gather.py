"""Row gather (K2) for the encode-once feature bank.

``gather_rows`` is the counterpart of ``multimodal_edema_prediction_tpu/ops/
pallas_gather.py::gather_rows``: ``out[i] = bank[rows[i]]`` for a
``[N, P, D]`` or ``[N, D]`` bank and ``[B]`` int32 rows, a byte-exact copy
with no gradient. On a CUDA tensor it launches the hand-written kernel in
``csrc/gather_rows.cu`` and raises if it cannot; on a CPU tensor it runs
``gather_rows_reference``, the plain version, which is also the kernel's
oracle in the tests and in ``chip_smoke.py``. There is no fallback from one
to the other.

Row indices are not checked on the device (that would cost a sync every
step): callers map invalid ids to the bank's NaN sentinel row first
(``data/features.py``). A row outside ``[0, N)`` still never reads outside
the bank: both versions write NaN there for float32/bfloat16/float16 banks
and zeros for other dtypes.
"""
from __future__ import annotations

import ctypes
import math

import torch

# launches of the kernel wrapper; chip_smoke.py resets and reads it
LAUNCHES = {"gather_rows": 0}

# the 32-bit word an out-of-range output row is filled with
_NAN_FILL = {torch.float32: 0x7FC00000, torch.bfloat16: 0x7FC07FC0,
             torch.float16: 0x7E007E00}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(bank: torch.Tensor, rows: torch.Tensor) -> None:
    if bank.dim() not in (2, 3):
        raise ValueError(f"bank must be [N, D] or [N, P, D], got "
                         f"{tuple(bank.shape)}")
    if rows.dim() != 1 or rows.dtype != torch.int32:
        raise ValueError(f"rows must be a [B] int32 tensor, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if rows.device != bank.device:
        raise ValueError(f"bank on {bank.device} and rows on {rows.device}")
    if bank.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_rows: no kernel for device {bank.device}")


def gather_rows_reference(bank: torch.Tensor,
                          rows: torch.Tensor) -> torch.Tensor:
    """The plain version: one row copy per output row, in a loop."""
    _check(bank, rows)
    out = bank.new_empty((rows.shape[0],) + tuple(bank.shape[1:]))
    n = bank.shape[0]
    fill = float("nan") if bank.dtype in _NAN_FILL else 0
    for i, r in enumerate(rows.tolist()):
        if 0 <= r < n:
            out[i].copy_(bank[r])
        else:
            out[i].fill_(fill)
    return out


def _vec_bytes(*nbytes: int) -> int:
    """The widest power of two up to 16 that divides every argument."""
    w = 16
    while any(b % w for b in nbytes):
        w //= 2
    return w


def gather_rows(bank: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``bank[rows]`` for a [N, P, D] or [N, D] bank and [B] int32 rows.

    A [N, D] bank (the CLS tokens) runs as [N, 1, D], as the JAX wrapper
    does. CUDA tensors go through the kernel; CPU tensors through
    ``gather_rows_reference``."""
    _check(bank, rows)
    if bank.dim() == 2:
        return gather_rows(bank[:, None, :], rows)[:, 0, :]
    if bank.device.type == "cpu":
        return gather_rows_reference(bank, rows)
    if not bank.is_contiguous():
        raise ValueError("gather_rows kernel takes a contiguous bank")
    if rows.shape[0] > 65535:
        raise ValueError(f"gather_rows kernel takes at most 65535 rows, got "
                         f"{rows.shape[0]}")
    rows = rows.contiguous()
    out = torch.empty((rows.shape[0],) + tuple(bank.shape[1:]),
                      dtype=bank.dtype, device=bank.device)
    # from the row's shape, not bank[0]: an empty bank still fills B rows
    row_bytes = math.prod(bank.shape[1:]) * bank.element_size()
    if out.numel() == 0:                   # nothing to copy or fill
        return out
    vec = _vec_bytes(row_bytes, bank.data_ptr(), out.data_ptr())

    from .build import load
    fn = load("gather_rows").gather_rows
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + \
            [ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(bank.device):
        stream = torch.cuda.current_stream(bank.device).cuda_stream
        err = fn(bank.data_ptr(), rows.data_ptr(), out.data_ptr(),
                 bank.shape[0], row_bytes, rows.shape[0],
                 _NAN_FILL.get(bank.dtype, 0), vec, stream)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["gather_rows"] += 1
    return out
