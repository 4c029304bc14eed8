"""ctypes binding of the port's JPEG decoder: the counterpart of
``multimodal_edema_prediction_tpu/data/native_loader.py``
(``decode_jpeg_batch_native``, ``decode_jpeg_batch_u8_native``).

Two routes, and the host decides which before anything is built:

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
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_host")
# a batch's pixels: numpy from libjpeg, a CUDA tensor from nvJPEG
Pixels = Union[np.ndarray, "torch.Tensor"]
CXX_FLAGS = ("-O3", "-mavx2", "-mfma", "-fPIC", "-shared", "-std=c++17",
             "-pthread")
LIBS = ("-ljpeg",)
# where the libjpeg route looks for the library's headers
JPEG_HEADERS = ("/usr/include/jpeglib.h", "/usr/local/include/jpeglib.h")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# the C entry points of csrc/host/jpeg_decode.cpp: (blob, offsets, images,
# side, [mean, std,] out, status, threads)
ENTRY_POINTS = {"decode_jpeg_batch": [_P, _P, _LL, _I, _P, _P, _P, _P, _I],
                "decode_jpeg_batch_u8": [_P, _P, _LL, _I, _P, _P, _I]}


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


def lib_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libjpeg_decode-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the libjpeg route's library unless it is built; returns its
    path. Raises with the compiler's output if g++ or libjpeg is
    missing."""
    out = lib_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's JPEG decoder "
                           f"({os.path.relpath(SOURCE, _PKG)}) is built "
                           "with g++ and libjpeg")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE, *LIBS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the JPEG decoder with libjpeg failed "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The libjpeg route's library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.restype = None
                fn.argtypes = argtypes
            _lib = lib
        return _lib


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
