"""XXH32 and XXH64 (the xxHash specification, version 0.1.1), in Python.

The frame formats of :mod:`.lz4` and :mod:`.zstd` carry these checksums:
LZ4's frame descriptor ends in ``(XXH32(descriptor) >> 8) & 0xFF`` and its
optional block and content checksums are XXH32; a Zstandard frame's
optional content checksum is the low 32 bits of XXH64. The card's host has
no ``xxhash`` package, so the port keeps its own. Both functions take
``bytes``-like data and a seed and return an unsigned int.
"""
from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF

P32_1, P32_2, P32_3, P32_4, P32_5 = (2654435761, 2246822519, 3266489917,
                                     668265263, 374761393)
P64_1 = 11400714785074694791
P64_2 = 14029467366897019727
P64_3 = 1609587929392839161
P64_4 = 9650029242287828579
P64_5 = 2870177450012600261


def _lanes(data: bytes, n: int, dtype) -> list:
    """The first ``n`` little-endian words of ``data`` as Python ints."""
    return np.frombuffer(data, dtype, n).tolist() if n else []


def xxh32(data, seed: int = 0) -> int:
    data = bytes(data)
    n = len(data)
    p = 0
    if n >= 16:
        v1 = (seed + P32_1 + P32_2) & _M32
        v2 = (seed + P32_2) & _M32
        v3 = seed & _M32
        v4 = (seed - P32_1) & _M32
        words = _lanes(data, (n // 16) * 4, "<u4")
        for k in range(0, len(words), 4):
            v1 = (v1 + words[k] * P32_2) & _M32
            v1 = (((v1 << 13) | (v1 >> 19)) & _M32) * P32_1 & _M32
            v2 = (v2 + words[k + 1] * P32_2) & _M32
            v2 = (((v2 << 13) | (v2 >> 19)) & _M32) * P32_1 & _M32
            v3 = (v3 + words[k + 2] * P32_2) & _M32
            v3 = (((v3 << 13) | (v3 >> 19)) & _M32) * P32_1 & _M32
            v4 = (v4 + words[k + 3] * P32_2) & _M32
            v4 = (((v4 << 13) | (v4 >> 19)) & _M32) * P32_1 & _M32
        h = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12)
             + _rotl32(v4, 18)) & _M32
        p = (n // 16) * 16
    else:
        h = (seed + P32_5) & _M32
    h = (h + n) & _M32
    while p + 4 <= n:
        w = int.from_bytes(data[p:p + 4], "little")
        h = _rotl32((h + w * P32_3) & _M32, 17) * P32_4 & _M32
        p += 4
    while p < n:
        h = _rotl32((h + data[p] * P32_5) & _M32, 11) * P32_1 & _M32
        p += 1
    h ^= h >> 15
    h = h * P32_2 & _M32
    h ^= h >> 13
    h = h * P32_3 & _M32
    h ^= h >> 16
    return h


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round64(acc: int, lane: int) -> int:
    acc = (acc + lane * P64_2) & _M64
    return _rotl64(acc, 31) * P64_1 & _M64


def xxh64(data, seed: int = 0) -> int:
    data = bytes(data)
    n = len(data)
    p = 0
    if n >= 32:
        v1 = (seed + P64_1 + P64_2) & _M64
        v2 = (seed + P64_2) & _M64
        v3 = seed & _M64
        v4 = (seed - P64_1) & _M64
        words = _lanes(data, (n // 32) * 4, "<u8")
        for k in range(0, len(words), 4):
            v1 = (v1 + words[k] * P64_2) & _M64
            v1 = (((v1 << 31) | (v1 >> 33)) & _M64) * P64_1 & _M64
            v2 = (v2 + words[k + 1] * P64_2) & _M64
            v2 = (((v2 << 31) | (v2 >> 33)) & _M64) * P64_1 & _M64
            v3 = (v3 + words[k + 2] * P64_2) & _M64
            v3 = (((v3 << 31) | (v3 >> 33)) & _M64) * P64_1 & _M64
            v4 = (v4 + words[k + 3] * P64_2) & _M64
            v4 = (((v4 << 31) | (v4 >> 33)) & _M64) * P64_1 & _M64
        h = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12)
             + _rotl64(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h ^= _round64(0, v)
            h = (h * P64_1 + P64_4) & _M64
        p = (n // 32) * 32
    else:
        h = (seed + P64_5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round64(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl64(h, 27) * P64_1 + P64_4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= int.from_bytes(data[p:p + 4], "little") * P64_1 & _M64
        h = (_rotl64(h, 23) * P64_2 + P64_3) & _M64
        p += 4
    while p < n:
        h ^= data[p] * P64_5 & _M64
        h = _rotl64(h, 11) * P64_1 & _M64
        p += 1
    h ^= h >> 33
    h = h * P64_2 & _M64
    h ^= h >> 29
    h = h * P64_3 & _M64
    h ^= h >> 32
    return h
