"""Row gather (K2) for the encode-once feature bank.

``gather_rows`` is the counterpart of ``multimodal_edema_prediction_tpu/ops/
pallas_gather.py::gather_rows``: ``out[i] = bank[rows[i]]`` for a
``[N, P, D]`` or ``[N, D]`` bank and ``[B]`` int32 rows, a byte-exact copy
with no gradient. On a CUDA tensor it launches one of the two hand-written
kernels in ``csrc/gather_rows.cu`` and raises if it cannot: the TMA bulk
copy kernel where the row size and both base pointers are 16-byte aligned
(every shape of the main path), the vector copy kernel otherwise;
``route`` decides before the launch, from the alignment alone. On a CPU
tensor it runs ``gather_rows_reference``, the plain version, which is also
the kernels' oracle in the tests and in ``chip_smoke.py``. There is no
fallback from one to another.

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

# launches of each C entry point: the bulk copy (``gather_rows_bulk``) and
# the vector copy (``gather_rows``); chip_smoke.py resets and reads them
LAUNCHES = {"gather_rows_bulk": 0, "gather_rows": 0}

_P, _LL = ctypes.c_void_p, ctypes.c_longlong
# each C entry point of csrc/gather_rows.cu: its library and its ctypes
# signature (bank, rows, out, bank rows, row bytes, output rows, the fill
# word, the vector copy's word width, the stream)
ENTRY_POINTS = {
    "gather_rows_bulk": ("gather_rows", [_P] * 3 + [_LL] * 3
                         + [ctypes.c_uint, _P]),
    "gather_rows": ("gather_rows", [_P] * 3 + [_LL] * 3
                    + [ctypes.c_uint, ctypes.c_int, _P]),
}

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


def route(row_bytes: int, bank_ptr: int, out_ptr: int) -> str:
    """The kernel a gather takes: ``"bulk"`` (TMA bulk copies, 16-byte
    granules) when the row size and both base addresses are multiples of
    16 bytes, else ``"vector"``."""
    return "bulk" if _vec_bytes(row_bytes, bank_ptr, out_ptr) == 16 \
        else "vector"


_FNS: dict = {}


def _call(name: str, *args) -> None:
    fn = _FNS.get(name)
    if fn is None:
        from .build import load
        lib, argtypes = ENTRY_POINTS[name]
        fn = getattr(load(lib), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FNS[name] = fn
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def gather_rows(bank: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``bank[rows]`` for a [N, P, D] or [N, D] bank and [B] int32 rows.

    CUDA tensors go through the kernel ``route`` picks (a row is a run of
    bytes to either kernel, whatever the bank's rank); CPU tensors through
    ``gather_rows_reference``."""
    _check(bank, rows)
    if bank.device.type == "cpu":
        return gather_rows_reference(bank, rows)
    if not bank.is_contiguous():
        raise ValueError("gather_rows kernel takes a contiguous bank")
    rows = rows.contiguous()
    out = torch.empty((rows.shape[0],) + tuple(bank.shape[1:]),
                      dtype=bank.dtype, device=bank.device)
    # from the row's shape, not bank[0]: an empty bank still fills B rows
    row_bytes = math.prod(bank.shape[1:]) * bank.element_size()
    if out.numel() == 0:                   # nothing to copy or fill
        return out
    args = (bank.data_ptr(), rows.data_ptr(), out.data_ptr(), bank.shape[0],
            row_bytes, rows.shape[0], _NAN_FILL.get(bank.dtype, 0))
    with torch.cuda.device(bank.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route(row_bytes, args[0], args[2]) == "bulk":
            _call("gather_rows_bulk", *args, stream)
            LAUNCHES["gather_rows_bulk"] += 1
        else:
            _call("gather_rows", *args,
                  _vec_bytes(row_bytes, args[0], args[2]), stream)
            LAUNCHES["gather_rows"] += 1
    return out
