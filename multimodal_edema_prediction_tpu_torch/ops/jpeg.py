"""JPEG decode on the card: the nvjpeg route of ``data/native_loader.py``,
for a host without libjpeg.

``NvjpegDecoder`` decodes each file with the CUDA toolkit's nvJPEG into a
``[H, W, C]`` uint8 tensor on the card (C = 1 for one grayscale component,
else RGB), and ``jpeg_resize`` brings it to ``[side, side, 3]`` as the host
decoder does (``bilinear_at`` of ``csrc/host/jpeg_decode.cpp``): rounded to
uint8, or with ``mean``/``std`` scaled to [0, 1] and normalized per channel
in float32. On a CUDA tensor ``jpeg_resize`` launches the hand-written
kernel of ``csrc/jpeg_resize.cu`` and raises if it cannot; on a CPU tensor
it runs ``jpeg_resize_reference``, the plain version, which is also the
kernel's oracle in ``chip_smoke.py``.

nvJPEG's inverse DCT and color conversion are not libjpeg's: the pixels of
this route are within 2 levels of the JAX package's (held on the card
against rows libjpeg decoded, ``tests/goldens/jpeg_rows_56.npz``), not equal
to them.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# launches of each resize kernel; chip_smoke.py resets and reads them
LAUNCHES = {"jpeg_resize_u8": 0, "jpeg_resize_f32": 0}

_P, _LL, _I, _F = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
# each C entry point of csrc/jpeg_resize.cu: its library and its ctypes
# signature
ENTRY_POINTS = {
    "jpeg_nvjpeg_open": ("jpeg_resize", [_P]),
    "jpeg_nvjpeg_info": ("jpeg_resize", [_P, _P, _LL, _P]),
    "jpeg_nvjpeg_decode": ("jpeg_resize", [_P, _P, _LL, _I, _P, _I, _P]),
    "jpeg_resize_u8": ("jpeg_resize", [_P, _I, _I, _I, _I, _P, _P]),
    "jpeg_resize_f32": ("jpeg_resize", [_P, _I, _I, _I, _I] + [_F] * 6
                        + [_P, _P]),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _cuda_home() -> str:
    return os.environ.get("CUDA_HOME", "/usr/local/cuda")


def nvjpeg_available() -> bool:
    """The CUDA toolkit has nvJPEG's header and library, and torch sees a
    card."""
    home = _cuda_home()
    lib = any(os.path.exists(os.path.join(home, d, "libnvjpeg.so"))
              for d in ("lib64", "targets/x86_64-linux/lib"))
    return (os.path.exists(os.path.join(home, "include", "nvjpeg.h"))
            and lib and torch.cuda.is_available())


def _fn(name: str):
    from .build import function
    lib, argtypes = ENTRY_POINTS[name]
    return function(lib, name, argtypes)


def _call(name: str, *args) -> None:
    err = _fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: error {err}")


def _check(src: torch.Tensor, side: int, mean, std) -> None:
    if src.dim() != 3 or src.shape[2] not in (1, 3) or \
            src.dtype != torch.uint8:
        raise ValueError(f"src must be a [H, W, 1 or 3] uint8 tensor, got "
                         f"{tuple(src.shape)} {src.dtype}")
    if side <= 0:
        raise ValueError(f"side must be positive, got {side}")
    if (mean is None) != (std is None):
        raise ValueError("give mean and std together, or neither")
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"jpeg_resize: no kernel for device {src.device}")


def jpeg_resize_reference(src: torch.Tensor, side: int, mean=None,
                          std=None) -> torch.Tensor:
    """The plain version, in float32 as the kernel computes: the bilinear
    sample of each output value, then rounded to uint8 or, with ``mean``
    and ``std``, scaled and normalized."""
    _check(src, side, mean, std)
    H, W, C = src.shape
    img = src.float()
    if C == 1:
        img = img.expand(H, W, 3)
    dev = src.device
    sx = torch.tensor(W, dtype=torch.float32) / side
    sy = torch.tensor(H, dtype=torch.float32) / side
    pos = torch.arange(side, dtype=torch.float32, device=dev) + 0.5
    fy = pos * sy.to(dev) - 0.5
    fx = pos * sx.to(dev) - 0.5
    y0 = fy.floor().long().clamp(0, H - 1)
    x0 = fx.floor().long().clamp(0, W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    wy = (fy - y0.float())[:, None, None]
    wx = (fx - x0.float())[None, :, None]
    v00 = img[y0][:, x0]
    v01 = img[y0][:, x1]
    v10 = img[y1][:, x0]
    v11 = img[y1][:, x1]
    v = (1 - wy) * ((1 - wx) * v00 + wx * v01) + \
        wy * ((1 - wx) * v10 + wx * v11)
    if mean is None:
        # lround: halves away from zero
        v = v.clamp(0.0, 255.0)
        r = v.floor()
        return (r + (v - r >= 0.5).float()).to(torch.uint8)
    m = torch.as_tensor(np.asarray(mean, np.float32), device=dev)
    s = torch.as_tensor(np.asarray(std, np.float32), device=dev)
    return (v / 255.0 - m) / s


def jpeg_resize(src: torch.Tensor, side: int, mean=None, std=None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[H, W, C]`` uint8 → ``[side, side, 3]``: uint8, or float32
    normalized by ``mean``/``std``. CUDA tensors go through the kernel
    (into ``out`` if given), CPU tensors through the plain version."""
    _check(src, side, mean, std)
    if src.device.type == "cpu":
        return jpeg_resize_reference(src, side, mean, std)
    src = src.contiguous()
    dtype = torch.uint8 if mean is None else torch.float32
    if out is None:
        out = torch.empty((side, side, 3), dtype=dtype, device=src.device)
    elif out.shape != (side, side, 3) or out.dtype != dtype or \
            not out.is_contiguous() or out.device != src.device:
        raise ValueError(f"out must be a contiguous [{side}, {side}, 3] "
                         f"{dtype} tensor on {src.device}")
    H, W, C = src.shape
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        if mean is None:
            _call("jpeg_resize_u8", src.data_ptr(), H, W, C, side,
                  out.data_ptr(), stream)
            LAUNCHES["jpeg_resize_u8"] += 1
        else:
            m = [float(x) for x in np.asarray(mean, np.float32)]
            s = [float(x) for x in np.asarray(std, np.float32)]
            _call("jpeg_resize_f32", src.data_ptr(), H, W, C, side, *m, *s,
                  out.data_ptr(), stream)
            LAUNCHES["jpeg_resize_f32"] += 1
    return out


class NvjpegDecoder:
    """One nvJPEG handle and decode state on ``device``, used by one thread
    at a time (a lock), with a high-priority stream of its own so that
    decoding does not queue behind the training step's work."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._handles = (ctypes.c_void_p * 2)()
        self._lock = threading.Lock()
        with torch.cuda.device(self.device):
            _call("jpeg_nvjpeg_open", ctypes.addressof(self._handles))
            self.stream = torch.cuda.Stream(self.device, priority=-1)

    def decode(self, blob: bytes) -> Optional[torch.Tensor]:
        """One file → ``[H, W, C]`` uint8 on the card (on this decoder's
        stream), or None if nvJPEG cannot read it."""
        data = np.frombuffer(blob, np.uint8)
        info = np.zeros(3, np.int32)
        h = ctypes.addressof(self._handles)
        if len(data) == 0 or _fn("jpeg_nvjpeg_info")(
                h, data.ctypes.data, len(data), info.ctypes.data) != 0:
            return None
        comps, W, H = (int(x) for x in info)
        C = 1 if comps == 1 else 3
        img = torch.empty((H, W, C), dtype=torch.uint8, device=self.device)
        err = _fn("jpeg_nvjpeg_decode")(
            h, data.ctypes.data, len(data), C, img.data_ptr(), W,
            self.stream.cuda_stream)
        # nvJPEG reuses the decode state's buffers for the next file: its
        # host phase must not start before this file's device phase has
        # read them (without this wait, files decoded while the card is
        # busy came out wrong)
        self.stream.synchronize()
        return None if err != 0 else img

    def decode_batch(self, blobs: Sequence[bytes], side: int, mean=None,
                     std=None) -> Tuple[torch.Tensor, np.ndarray]:
        """``[N, side, side, 3]`` on the card (uint8, or float32 normalized
        with ``mean``/``std``) and the status of each file (nonzero: not
        decoded, its pixels zeros). Returns when the work is done; the
        pixels stay on the card, marked used on the caller's stream so that
        the allocator orders their reuse after the caller's work."""
        dtype = torch.uint8 if mean is None else torch.float32
        status = np.zeros(len(blobs), np.int32)
        with self._lock, torch.cuda.device(self.device):
            caller = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.stream):
                out = torch.zeros((len(blobs), side, side, 3), dtype=dtype,
                                  device=self.device)
                for i, blob in enumerate(blobs):
                    img = self.decode(blob)
                    if img is None:
                        status[i] = 1
                        continue
                    jpeg_resize(img, side, mean, std, out=out[i])
                self.stream.synchronize()
            out.record_stream(caller)
        return out, status


_decoders: dict = {}
_decoders_lock = threading.Lock()


def decoder(device="cuda") -> NvjpegDecoder:
    """The process's decoder on ``device``, opened at first use."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _decoders_lock:
        if device not in _decoders:
            _decoders[device] = NvjpegDecoder(device)
        return _decoders[device]
