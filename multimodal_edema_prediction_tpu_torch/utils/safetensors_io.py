"""The safetensors file format read and written in numpy, without the
``safetensors`` package, which the port does not depend on.

A file is an 8-byte little-endian header length, a JSON header naming each
tensor's ``dtype``, ``shape`` and ``data_offsets`` (begin and end, from the
first byte after the header) and an optional ``__metadata__`` map of
strings, then the tensors' little-endian bytes in C order. ``load_file``
checks that every tensor's bytes lie in the file, match its shape and do
not overlap; BF16 tensors come back as float32 (exactly: a bfloat16 is the
top half of a float32). ``save_file`` writes the format with the header
padded by spaces to a multiple of 8 bytes, as the package does, the
tensors in the order of their names.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import numpy as np

# safetensors dtype → numpy dtype (little-endian); BF16 is read as uint16
DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
          "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1",
          "BOOL": "?"}
_NAMES = {np.dtype(v).str: k for k, v in DTYPES.items() if k != "BF16"}


def read_header(path: str) -> dict:
    """The JSON header of ``path``, with ``__header_bytes__`` (where the
    tensors' bytes start)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than "
                             "its 8-byte header length)")
        (n,) = struct.unpack("<Q", head)
        raw = f.read(n)
    if len(raw) != n:
        raise ValueError(f"{path}: header of {n} bytes runs past the file")
    try:
        header = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise ValueError(f"{path}: the header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    header["__header_bytes__"] = 8 + n
    return header


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """BF16 bit patterns (uint16) → the float32 values they hold."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def load_file(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of ``path`` as a numpy array (BF16 as float32), in
    the header's order."""
    header = read_header(path)
    start = header.pop("__header_bytes__")
    header.pop("__metadata__", None)
    with open(path, "rb") as f:
        f.seek(0, 2)
        size = f.tell() - start
        spans = []
        out = {}
        for name, info in header.items():
            try:
                code, shape = info["dtype"], [int(d) for d in info["shape"]]
                begin, end = (int(o) for o in info["data_offsets"])
            except (KeyError, TypeError, ValueError):
                raise ValueError(f"{path}: tensor {name!r} has no dtype, "
                                 f"shape or data_offsets: {info}") from None
            if code not in DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {code}, "
                                 f"not one of {sorted(DTYPES)}")
            dt = np.dtype(DTYPES[code])
            count = int(np.prod(shape, dtype=np.int64))
            if not 0 <= begin <= end <= size or \
                    end - begin != count * dt.itemsize:
                raise ValueError(
                    f"{path}: tensor {name!r} ({code} {shape}) spans bytes "
                    f"[{begin}, {end}) of {size}")
            spans.append((begin, end, name))
            f.seek(start + begin)
            arr = np.fromfile(f, dtype=dt, count=count).reshape(shape)
            out[name] = bf16_to_f32(arr) if code == "BF16" else arr
    spans.sort()
    for (_, e0, a), (b1, _, b) in zip(spans, spans[1:]):
        if b1 < e0:
            raise ValueError(f"{path}: tensors {a!r} and {b!r} overlap")
    return out


def save_file(tensors: Dict[str, np.ndarray], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (numpy arrays of a dtype in DTYPES) to ``path``."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        data = np.ascontiguousarray(arr, arr.dtype.newbyteorder("<"))
        code = _NAMES.get(data.dtype.str)
        if code is None:
            raise ValueError(f"tensor {name!r}: no safetensors dtype for "
                             f"{arr.dtype}")
        raw = data.tobytes()
        header[name] = {"dtype": code, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)
