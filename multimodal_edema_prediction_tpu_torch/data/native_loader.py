"""ctypes bindings of the port's host data-path ops: the counterpart of
``multimodal_edema_prediction_tpu/data/native_loader.py``
(``decode_jpeg_batch_native``, ``decode_jpeg_batch_u8_native``,
``densify_events_native``, ``gather_windows_native``).

``densify_events_native`` and ``gather_windows_native`` run the port's own
copy of the JAX package's C++ ops (``csrc/host/data_ops.cpp``), built with
g++ and ``-pthread`` alone (no libjpeg, no ISA flag) at first use into
``build/torch_host/``, as the decoder's library is. As in the JAX package
nothing calls them: the main path densifies in numpy
(``data/pipeline.py::densify_events``) and gathers windows on the device
(``pipeline.gather_windows``). Where JAX returns None when its library
will not build, these raise with the compiler's output.

The JPEG decoder takes one of two routes, and the host decides which
before anything is built:

- ``libjpeg`` where the libjpeg headers are installed: the port's own copy
  of the JAX package's C++ decoder (``csrc/host/jpeg_decode.cpp``), built
  with g++ at first use into ``build/torch_host/`` (the library's name
  carries a hash of the source and the flags; the build writes a temporary
  file and renames it, so that parallel processes may race). The flags are
  fixed to ``-O3 -mavx2 -mfma``: their float contraction gives the JAX
  package's pixels bit for bit, where ``-march=native`` would tie the
  binary to the building host's ISA.
- ``nvjpeg`` where there is no libjpeg but the CUDA toolkit's nvJPEG and a
  card: each file is decoded on the card (``ops/jpeg.py``) and resized by a
  hand-written CUDA kernel that repeats ``bilinear_at`` and the u8
  rounding; the pixels stay on the card, as a CUDA tensor. nvJPEG's
  inverse DCT and color conversion are not libjpeg's, so these pixels are
  within 2 levels of the JAX package's, not equal.

No route gives way to another: a decoder that does not build or load
raises, naming what it could not find. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence, Tuple, Union

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "host", "jpeg_decode.cpp")
DATA_OPS_SOURCE = os.path.join(_PKG, "csrc", "host", "data_ops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_host")
# a batch's pixels: numpy from libjpeg, a CUDA tensor from nvJPEG
Pixels = Union[np.ndarray, "torch.Tensor"]
CXX_FLAGS = ("-O3", "-mavx2", "-mfma", "-fPIC", "-shared", "-std=c++17",
             "-pthread")
LIBS = ("-ljpeg",)
# the data ops' flags: no ISA flag and no float contraction to choose
# (each value is a subtraction and a division)
DATA_OPS_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
# where the libjpeg route looks for the library's headers
JPEG_HEADERS = ("/usr/include/jpeglib.h", "/usr/local/include/jpeglib.h")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_data_lib: Optional[ctypes.CDLL] = None

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# the C entry points of csrc/host/jpeg_decode.cpp: (blob, offsets, images,
# side, [mean, std,] out, status, threads)
ENTRY_POINTS = {"decode_jpeg_batch": [_P, _P, _LL, _I, _P, _P, _P, _P, _I],
                "decode_jpeg_batch_u8": [_P, _P, _LL, _I, _P, _P, _I]}
# those of csrc/host/data_ops.cpp
DATA_OPS_ENTRY_POINTS = {
    "densify_events": [_P, _LL, _P, _P, _P, _LL, _I, _P, _P, _I, _I, _P, _I],
    "gather_windows": [_P, _LL, _I, _I, _P, _P, _I, _LL, _P, _I]}


def route() -> str:
    """``"libjpeg"`` where the libjpeg headers are installed, else
    ``"nvjpeg"`` where the CUDA toolkit has nvJPEG and torch sees a card;
    raises where neither is."""
    if any(os.path.exists(p) for p in JPEG_HEADERS):
        return "libjpeg"
    from ..ops import jpeg
    if jpeg.nvjpeg_available():
        return "nvjpeg"
    raise RuntimeError(
        "no JPEG decoder: the libjpeg route needs libjpeg's headers "
        f"({' or '.join(JPEG_HEADERS)}) and g++; the nvjpeg route needs "
        "the CUDA toolkit's nvjpeg.h and libnvjpeg and a CUDA card")


def _lib_path(source: str, flags: tuple) -> str:
    """The library of ``source`` built with ``flags``: its name carries a
    hash of both."""
    digest = hashlib.sha256(" ".join(flags).encode())
    with open(source, "rb") as f:
        digest.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def _build(source: str, flags: tuple, libs: tuple, what: str) -> str:
    """Compile ``source`` with g++ unless its library is built; returns its
    path. Raises with the compiler's output where g++ (or a library it
    links) is missing or the source does not compile."""
    out = _lib_path(source, flags + libs)
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the port's {what} "
                           f"({os.path.relpath(source, _PKG)}) is built "
                           "with g++")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *flags, "-o", tmp, source, *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the {what} failed "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(path: str, entry_points: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name, argtypes in entry_points.items():
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = argtypes
    return lib


def lib_path() -> str:
    return _lib_path(SOURCE, CXX_FLAGS + LIBS)


def build() -> str:
    """Compile the libjpeg route's library unless it is built; returns its
    path. Raises with the compiler's output if g++ or libjpeg is
    missing."""
    return _build(SOURCE, CXX_FLAGS, LIBS, "JPEG decoder with libjpeg")


def load() -> ctypes.CDLL:
    """The libjpeg route's library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(build(), ENTRY_POINTS)
        return _lib


def build_data_ops() -> str:
    """Compile ``csrc/host/data_ops.cpp`` unless it is built; returns its
    path (raises as ``build``)."""
    return _build(DATA_OPS_SOURCE, DATA_OPS_FLAGS, (), "host data ops")


def load_data_ops() -> ctypes.CDLL:
    """The data ops' library, built first if needed."""
    global _data_lib
    with _lock:
        if _data_lib is None:
            _data_lib = _bind(build_data_ops(), DATA_OPS_ENTRY_POINTS)
        return _data_lib


def densify_events_native(offsets: np.ndarray, slot_idx: np.ndarray,
                          values: np.ndarray, counts: np.ndarray,
                          means: np.ndarray, stds: np.ndarray,
                          max_len: int, count_clip: int = 15,
                          n_threads: int = 4) -> np.ndarray:
    """Sparse event rows → the normalized dense grid [S, max_len, 2V] (JAX
    ``densify_events_native``): values z-scored by ``means``/``stds``
    where the count, clipped to [0, ``count_clip``], is above 0; rows whose
    slot is outside [0, ``max_len``) dropped. The same grid as
    ``data/pipeline.py::densify_events`` on an ``EventTable``'s arrays."""
    offsets = np.ascontiguousarray(offsets, np.int64)
    slot_idx = np.ascontiguousarray(slot_idx, np.int32)
    values = np.ascontiguousarray(values, np.float32)
    counts = np.ascontiguousarray(counts, np.int32)
    n_stays, (n_rows, V) = len(offsets) - 1, values.shape
    if counts.shape != values.shape or len(slot_idx) != n_rows \
            or n_stays < 0 or (n_stays and (
                offsets[0] < 0 or offsets[-1] > n_rows
                or np.any(np.diff(offsets) < 0))):
        raise ValueError(
            f"event rows do not fit: offsets {offsets.shape} spanning "
            f"[{offsets[:1]}, {offsets[-1:]}], slot_idx {slot_idx.shape}, "
            f"values {values.shape}, counts {counts.shape}")
    out = np.empty((n_stays, max_len, 2 * V), np.float32)
    load_data_ops().densify_events(
        offsets.ctypes.data, n_stays, slot_idx.ctypes.data,
        values.ctypes.data, counts.ctypes.data, n_rows, V,
        np.ascontiguousarray(means, np.float32).ctypes.data,
        np.ascontiguousarray(stds, np.float32).ctypes.data, max_len,
        count_clip, out.ctypes.data, n_threads)
    return out


def gather_windows_native(grid: np.ndarray, stay_rows: np.ndarray,
                          slot_end: np.ndarray, T: int,
                          n_threads: int = 4) -> np.ndarray:
    """[B] anchors → [B, T, C] float32 windows of ``grid`` [S, L, C] ending
    at ``slot_end`` (exclusive), bit for bit (JAX
    ``gather_windows_native``). A window outside its stay's grid raises
    (the C op would read past it)."""
    grid = np.ascontiguousarray(grid, np.float32)
    stay_rows = np.ascontiguousarray(stay_rows, np.int32)
    slot_end = np.ascontiguousarray(slot_end, np.int32)
    S, L, C = grid.shape
    if stay_rows.shape != slot_end.shape or stay_rows.ndim != 1:
        raise ValueError(f"stay_rows {stay_rows.shape} and slot_end "
                         f"{slot_end.shape} must be one [B] shape")
    bad = (stay_rows < 0) | (stay_rows >= S) | (slot_end < T) \
        | (slot_end > L)
    if np.any(bad):
        i = int(np.argmax(bad))
        raise ValueError(f"window {i} (stay row {stay_rows[i]}, slot_end "
                         f"{slot_end[i]}, T {T}) lies outside the grid "
                         f"[{S}, {L}, {C}]")
    out = np.empty((len(stay_rows), T, C), np.float32)
    load_data_ops().gather_windows(
        grid.ctypes.data, S, L, C, stay_rows.ctypes.data,
        slot_end.ctypes.data, T, len(stay_rows), out.ctypes.data, n_threads)
    return out


def _packed(blobs: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(blobs) + 1, np.int64)
    offsets[1:] = np.cumsum([len(b) for b in blobs])
    return np.frombuffer(b"".join(blobs), np.uint8), offsets


def decode_jpeg_batch_native(blobs: list, side: int, mean, std,
                             n_threads: int = 4) -> Tuple[Pixels, np.ndarray]:
    """list of JPEG byte strings → ([N, side, side, 3] float32, status):
    decoded, resized bilinearly, scaled to [0, 1] and normalized by
    ``mean``/``std`` per channel; ``status[i]`` nonzero where item ``i``
    failed to decode (its pixels are then zeros). ``n_threads``: the
    libjpeg route's decode threads (the nvjpeg route decodes one file at a
    time). The pixels are a numpy array on the libjpeg route and a tensor
    on the card on the nvjpeg route."""
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if route() == "nvjpeg":
        from ..ops import jpeg
        return jpeg.decoder().decode_batch(blobs, side, mean, std)
    blob, offsets = _packed(blobs)
    out = np.zeros((len(blobs), side, side, 3), np.float32)
    status = np.zeros(len(blobs), np.int32)
    load().decode_jpeg_batch(
        blob.ctypes.data, offsets.ctypes.data, len(blobs), side,
        mean.ctypes.data, std.ctypes.data, out.ctypes.data,
        status.ctypes.data, n_threads)
    return out, status


def decode_jpeg_batch_u8_native(blobs: list, side: int, n_threads: int = 4
                                ) -> Tuple[Pixels, np.ndarray]:
    """list of JPEG byte strings → ([N, side, side, 3] uint8, status): the
    decode-once fill, resized and rounded, not normalized; numpy or on the
    card, by route, as ``decode_jpeg_batch_native``."""
    if route() == "nvjpeg":
        from ..ops import jpeg
        return jpeg.decoder().decode_batch(blobs, side)
    blob, offsets = _packed(blobs)
    out = np.zeros((len(blobs), side, side, 3), np.uint8)
    status = np.zeros(len(blobs), np.int32)
    load().decode_jpeg_batch_u8(
        blob.ctypes.data, offsets.ctypes.data, len(blobs), side,
        out.ctypes.data, status.ctypes.data, n_threads)
    return out, status
