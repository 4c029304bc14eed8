"""CRC-32C (Castagnoli; RFC 3720 B.4), in Python and numpy.

Every file of an OCDBT store (:mod:`.ocdbt`: manifests and B+tree nodes)
ends in the CRC-32C of the bytes before it, little-endian. The card's host
has no ``crc32c`` package, so the port keeps its own: the reflected
polynomial 0x82F63B78, initial value and final XOR 0xFFFFFFFF, computed
eight bytes a step ("slicing by 8") with eight 256-entry tables that numpy
builds once.
"""
from __future__ import annotations

import numpy as np

POLY = 0x82F63B78


def _tables() -> list:
    t0 = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t0 = np.where(t0 & 1, (t0 >> 1) ^ np.uint32(POLY), t0 >> 1)
    tables = [t0]
    for _ in range(7):
        prev = tables[-1]
        tables.append((prev >> 8) ^ t0[prev & 0xFF])
    return [t.astype(np.uint32).tolist() for t in tables]


_T = _tables()


def crc32c(data) -> int:
    """The CRC-32C of ``data`` (bytes-like) as an unsigned int."""
    data = memoryview(data).cast("B")
    t0, t1, t2, t3, t4, t5, t6, t7 = _T
    c = 0xFFFFFFFF
    n8 = len(data) // 8
    if n8:
        words = np.frombuffer(data[:n8 * 8], "<u4").tolist()
        for i in range(0, 2 * n8, 2):
            lo = c ^ words[i]
            hi = words[i + 1]
            c = (t7[lo & 0xFF] ^ t6[(lo >> 8) & 0xFF]
                 ^ t5[(lo >> 16) & 0xFF] ^ t4[lo >> 24]
                 ^ t3[hi & 0xFF] ^ t2[(hi >> 8) & 0xFF]
                 ^ t1[(hi >> 16) & 0xFF] ^ t0[hi >> 24])
    for b in data[n8 * 8:]:
        c = t0[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF
