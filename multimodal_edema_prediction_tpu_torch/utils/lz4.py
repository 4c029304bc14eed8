"""The LZ4 frame format (LZ4 Frame Format Description 1.6.x) in Python.

Arrow's IPC format compresses each buffer of a record batch as one LZ4
frame (``BodyCompression`` LZ4_FRAME), and ``DataFrame.to_feather`` uses
it by default. The card's host has no lz4 library, so the port keeps its
own codec:

- :func:`decompress` reads every frame of its input (concatenated frames
  and skippable frames included): linked or independent blocks,
  uncompressed blocks, an optional content size, optional block and
  content checksums (XXH32, verified), 64 KB to 4 MB blocks. Sequences are
  copied byte for byte where a match overlaps its own output (offset <
  length). A malformed frame raises ``ValueError``.
- :func:`compress` writes one frame as pyarrow does (FLG ``0x40``: linked
  blocks, no checksums, no content size; BD ``0x40``: 64 KB blocks). Its
  block compressor is greedy: a table keyed by each position's 4 bytes
  holds one candidate, the most recent earlier position with the same 4
  bytes (found for every position at once by a stable sort); the search
  steps over unmatched positions with LZ4's acceleration (the step grows
  by one every 64 misses); a match is extended forward and backward. A
  block that does not shrink is stored uncompressed.
"""
from __future__ import annotations

import struct
from typing import List

import numpy as np

from .xxhash import xxh32

MAGIC = 0x184D2204
_SKIPPABLE = 0x184D2A50             # .. 0x184D2A5F
_BLOCK_SIZES = {4: 1 << 16, 5: 1 << 18, 6: 1 << 20, 7: 1 << 22}
_WINDOW = 65535                     # the largest offset
_MFLIMIT = 12                       # a match starts this far from the end
_LASTLITERALS = 5                   # the last bytes of a block are literals
_MINMATCH = 4


# =============================================================================
# Decoding
# =============================================================================
def decompress(data) -> bytes:
    """Every frame of ``data``, decoded and concatenated."""
    data = bytes(data)
    out = bytearray()
    p, n = 0, len(data)
    if not n:
        raise ValueError("lz4: empty input")
    while p < n:
        if p + 4 > n:
            raise ValueError("lz4: truncated frame magic")
        magic = int.from_bytes(data[p:p + 4], "little")
        if magic & 0xFFFFFFF0 == _SKIPPABLE:
            if p + 8 > n:
                raise ValueError("lz4: truncated skippable frame")
            size = int.from_bytes(data[p + 4:p + 8], "little")
            p += 8 + size
            if p > n:
                raise ValueError("lz4: truncated skippable frame")
            continue
        if magic != MAGIC:
            raise ValueError(f"lz4: bad frame magic {magic:#010x}")
        try:
            p = _decode_frame(data, p + 4, out)
        except IndexError as e:
            raise ValueError("lz4: truncated frame") from e
    return bytes(out)


def _decode_frame(data: bytes, p: int, out: bytearray) -> int:
    n = len(data)
    if p + 3 > n:
        raise ValueError("lz4: truncated frame descriptor")
    flg, bd = data[p], data[p + 1]
    if flg >> 6 != 1:
        raise ValueError(f"lz4: frame version {flg >> 6}")
    if flg & 0x02 or bd & 0x8F:
        raise ValueError("lz4: reserved descriptor bits set")
    independent = bool(flg & 0x20)
    block_sum = bool(flg & 0x10)
    content_size_flag = bool(flg & 0x08)
    content_sum = bool(flg & 0x04)
    has_dict = bool(flg & 0x01)
    block_max = _BLOCK_SIZES.get(bd >> 4)
    if block_max is None:
        raise ValueError(f"lz4: block size code {bd >> 4}")
    q = p + 2
    content_size = None
    if content_size_flag:
        content_size = int.from_bytes(data[q:q + 8], "little")
        q += 8
    if has_dict:
        q += 4
    if q >= n:
        raise ValueError("lz4: truncated frame descriptor")
    if data[q] != (xxh32(data[p:q]) >> 8) & 0xFF:
        raise ValueError("lz4: frame descriptor checksum mismatch")
    if has_dict:
        raise ValueError("lz4: frames with a dictionary are not supported")
    q += 1
    start = len(out)
    while True:
        if q + 4 > n:
            raise ValueError("lz4: truncated block header")
        size = int.from_bytes(data[q:q + 4], "little")
        q += 4
        if size == 0:
            break
        raw = bool(size & 0x80000000)
        size &= 0x7FFFFFFF
        if size > block_max or q + size > n:
            raise ValueError("lz4: block larger than its frame allows")
        block = data[q:q + size]
        q += size
        if block_sum:
            if q + 4 > n:
                raise ValueError("lz4: truncated block checksum")
            if int.from_bytes(data[q:q + 4], "little") != xxh32(block):
                raise ValueError("lz4: block checksum mismatch")
            q += 4
        if raw:
            out += block
        else:
            lowest = len(out) if independent else start
            decode_block(block, out, lowest, block_max)
    if content_sum:
        if q + 4 > n:
            raise ValueError("lz4: truncated content checksum")
        if int.from_bytes(data[q:q + 4], "little") != xxh32(out[start:]):
            raise ValueError("lz4: content checksum mismatch")
        q += 4
    if content_size is not None and len(out) - start != content_size:
        raise ValueError(f"lz4: frame holds {len(out) - start} bytes, its "
                         f"header says {content_size}")
    return q


def decode_block(src: bytes, out: bytearray, lowest: int,
                 limit: int) -> None:
    """Append the decoded LZ4 block ``src`` to ``out``. A match may reach
    back to ``out[lowest]`` (the start of the frame for linked blocks, of
    the block for independent ones); the block may decode to at most
    ``limit`` bytes."""
    n = len(src)
    p = 0
    base = len(out)
    if n == 0:
        raise ValueError("lz4: empty block")
    while True:
        token = src[p]
        p += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if p >= n:
                    raise ValueError("lz4: truncated literal length")
                b = src[p]
                p += 1
                lit += b
                if b != 255:
                    break
        if p + lit > n:
            raise ValueError("lz4: literals run past the block")
        out += src[p:p + lit]
        p += lit
        if p == n:                          # the last sequence: literals
            break
        if p + 2 > n:
            raise ValueError("lz4: truncated match offset")
        off = src[p] | (src[p + 1] << 8)
        p += 2
        ml = token & 15
        if ml == 15:
            while True:
                if p >= n:
                    raise ValueError("lz4: truncated match length")
                b = src[p]
                p += 1
                ml += b
                if b != 255:
                    break
        ml += _MINMATCH
        pos = len(out)
        if off == 0 or pos - off < lowest:
            raise ValueError(f"lz4: match offset {off} reaches before the "
                             "window")
        s = pos - off
        if off >= ml:
            out += out[s:s + ml]
        else:                               # overlaps its own output
            out += (out[s:pos] * (ml // off + 1))[:ml]
        if len(out) - base > limit:
            raise ValueError("lz4: block decodes past its size limit")
    if len(out) - base > limit:
        raise ValueError("lz4: block decodes past its size limit")


# =============================================================================
# Encoding
# =============================================================================
_FLG, _BD = 0x40, 0x40                  # as pyarrow's frames
_HEADER = struct.pack("<IBB", MAGIC, _FLG, _BD) + bytes(
    [(xxh32(bytes([_FLG, _BD])) >> 8) & 0xFF])
_BLOCK = 1 << 16


def compress(data) -> bytes:
    """One LZ4 frame of ``data``: 64 KB linked blocks, no checksums."""
    data = bytes(data)
    n = len(data)
    out = bytearray(_HEADER)
    prev = _previous_occurrences(data)
    for start in range(0, n, _BLOCK):
        end = min(start + _BLOCK, n)
        block = compress_block(data, start, end, prev)
        if len(block) >= end - start:
            out += struct.pack("<I", (end - start) | 0x80000000)
            out += data[start:end]
        else:
            out += struct.pack("<I", len(block))
            out += block
    out += b"\0\0\0\0"
    return bytes(out)


def _previous_occurrences(data: bytes) -> List[int]:
    """For each position, the most recent earlier position whose 4 bytes
    are the same, if it lies within the window (else -1): one stable sort
    of the positions' 4-byte keys."""
    n = len(data)
    if n < _MINMATCH:
        return [-1] * n
    d = np.frombuffer(data, np.uint8).astype(np.uint32)
    keys = d[:-3] | (d[1:-2] << 8) | (d[2:-1] << 16) | (d[3:] << 24)
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    same = ks[1:] == ks[:-1]
    prev = np.full(n, -1, np.int64)
    prev[order[1:][same]] = order[:-1][same]
    prev[np.arange(n) - prev > _WINDOW] = -1
    return prev.tolist()


def _match_end(d: bytes, i: int, j: int, limit: int) -> int:
    """How many bytes from ``i`` equal those from ``j`` (at least the 4 a
    candidate shares), stopping at ``limit``: doubling steps, then a
    binary search inside the step that differs."""
    n = _MINMATCH
    step = 8
    while True:
        m = limit - i - n
        if m <= 0:
            return n
        if m > step:
            m = step
        if d[i + n:i + n + m] == d[j + n:j + n + m]:
            n += m
            if step < 65536:
                step += step
            continue
        lo, hi = n, n + m                   # the first difference is here
        while hi - lo > 1:
            mid = (lo + hi) >> 1
            if d[i + lo:i + mid] == d[j + lo:j + mid]:
                lo = mid
            else:
                hi = mid
        return lo


def _put_length(out: bytearray, k: int) -> None:
    while k >= 255:
        out.append(255)
        k -= 255
    out.append(k)


def compress_block(data: bytes, start: int, end: int,
                   prev: List[int]) -> bytes:
    """The LZ4 block of ``data[start:end]``; matches may reach into the
    previous 64 KB (linked blocks). ``prev`` is
    :func:`_previous_occurrences` of ``data``."""
    out = bytearray()
    anchor = start
    last_start = end - _MFLIMIT         # a match starts before this
    match_limit = end - _LASTLITERALS   # and ends at or before this
    ip = start
    while ip < last_start:
        misses = 1 << 6                 # LZ4's acceleration 1
        pos = ip
        while pos < last_start and prev[pos] < 0:
            pos += misses >> 6
            misses += 1
        if pos >= last_start:
            break
        ref = prev[pos]
        ml = _match_end(data, pos, ref, match_limit)
        while pos > anchor and ref > 0 and data[pos - 1] == data[ref - 1]:
            pos -= 1
            ref -= 1
            ml += 1
        lit = pos - anchor
        mcode = ml - _MINMATCH
        out.append(((lit if lit < 15 else 15) << 4)
                   | (mcode if mcode < 15 else 15))
        if lit >= 15:
            _put_length(out, lit - 15)
        out += data[anchor:pos]
        off = pos - ref
        out.append(off & 0xFF)
        out.append(off >> 8)
        if mcode >= 15:
            _put_length(out, mcode - 15)
        ip = anchor = pos + ml
    lit = end - anchor
    out.append((lit if lit < 15 else 15) << 4)
    if lit >= 15:
        _put_length(out, lit - 15)
    out += data[anchor:end]
    return bytes(out)
