"""Read the JAX package's checkpoints without JAX, flax or ``msgpack``.

``save_checkpoint`` there (``train/checkpoint.py:30-44``) writes
``flax.serialization.msgpack_serialize({"params", "batch_stats", "step",
"metric", "extra"})`` plus a ``<path>.config.json`` sidecar.
``_unpack`` decodes the msgpack subset that writer emits: maps, arrays
(lists), str, bin, ints, floats, nil/bools, and ext type 1 (an ndarray
packed as ``(shape, dtype name, C-order bytes)``) or 3 (a numpy scalar, the
same encoding).
"""
from __future__ import annotations

import json
import os
import struct
from typing import Tuple

import numpy as np

from ..config import TeacherConfig


def _unpack(buf: bytes, pos: int = 0) -> Tuple[object, int]:
    """Decode one msgpack object at ``pos``; returns (value, next pos)."""
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _unpack_map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_list(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return bytes(buf[pos:pos + n]).decode(), pos + n
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
             0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fixed:
        fmt = fixed[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
             0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
             0xDC: ("list", ">H"), 0xDD: ("list", ">I"),
             0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
             0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
    if b in sized:
        kind, fmt = sized[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
        if kind == "bin":
            return bytes(buf[pos:pos + n]), pos + n
        if kind == "str":
            return bytes(buf[pos:pos + n]).decode(), pos + n
        if kind == "list":
            return _unpack_list(buf, pos, n)
        if kind == "map":
            return _unpack_map(buf, pos, n)
        code = struct.unpack_from(">b", buf, pos)[0]
        return _ext(code, buf[pos + 1:pos + 1 + n]), pos + 1 + n
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        n = fixext[b]
        code = struct.unpack_from(">b", buf, pos)[0]
        return _ext(code, buf[pos + 1:pos + 1 + n]), pos + 1 + n
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at {pos - 1}")


def _unpack_list(buf, pos, n):
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos)
        out.append(v)
    return out, pos


def _unpack_map(buf, pos, n):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    if "__msgpack_chunked_array__" in out:
        raise ValueError("chunked arrays (over 1 GiB) are not supported")
    return out, pos


def _ext(code: int, data: bytes):
    if code not in (1, 3):
        raise ValueError(f"unsupported msgpack ext type {code}")
    (shape, dtype, raw), end = _unpack(data, 0)
    if end != len(data):
        raise ValueError("trailing bytes in an ndarray ext payload")
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
    return arr if code == 1 else arr[()]


def msgpack_restore(data: bytes):
    """The counterpart of ``flax.serialization.msgpack_restore``."""
    value, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"trailing bytes after msgpack object at {end}")
    return value


def load_checkpoint(path: str) -> dict:
    """{"params", "batch_stats", "step", "metric", "extra"[, "config"]}
    with numpy leaves; ``config`` is the JSON sidecar when present."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    cfg_path = path + ".config.json"
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            payload["config"] = json.load(f)
    return payload


def load_teacher_from_ckpt(path: str, device="cuda"):
    """Rebuild the teacher from a JAX checkpoint and its config sidecar (the
    counterpart of ``train/kd_loop.py::load_teacher_from_ckpt``):
    (model in eval mode on ``device``, TeacherConfig, raw checkpoint)."""
    from ..convert import load_flax
    from ..models.teacher import TeacherModel
    from ..utils import resolve_device

    dev = resolve_device(device)
    ckpt = load_checkpoint(path)
    if "config" not in ckpt:
        raise ValueError(f"{path} has no config sidecar")
    tcfg = TeacherConfig.from_dict(ckpt["config"]["model"])
    model = load_flax(TeacherModel(tcfg), ckpt["params"],
                      ckpt["batch_stats"])
    return model.to(dev).eval(), tcfg, ckpt
