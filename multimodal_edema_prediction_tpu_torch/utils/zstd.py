"""A Zstandard decoder (RFC 8878) in Python and numpy.

Arrow's IPC format may compress its buffers as Zstandard frames
(``BodyCompression`` ZSTD, ``to_feather(compression="zstd")``), and an
orbax OCDBT checkpoint stores every data file and manifest as one. The
card's host has no zstd library, so the port keeps its own decoder.

:func:`decompress` reads every frame of its input, concatenated frames and
skippable frames included:

- frame header: window descriptor, single segment, content size, checksum
  flag; a frame with a dictionary ID raises ``ValueError`` (neither pyarrow
  nor orbax writes one);
- raw, RLE and compressed blocks;
- literals: raw, RLE, and Huffman-coded in 1 or 4 streams, treeless
  literals reusing the frame's previous Huffman table;
- sequences: predefined, RLE, FSE-compressed and repeat modes, the tables
  carried across blocks; repeat offsets; matches across blocks within the
  window;
- the content checksum (the low 32 bits of XXH64), verified when present.

A malformed frame raises ``ValueError``.

:func:`compress_raw` is the one encoder: a single-segment frame of raw
blocks (at most 128 KiB each, no checksum), valid Zstandard that any decoder
reads, with no entropy coding. The port's orbax states store their zarr
chunks so (``compressor: zstd`` in each ``.zarray``, as orbax writes it),
and restoring them copies blocks instead of running the entropy decoder
above. Feather files the port writes are LZ4 (:mod:`.lz4`), as pandas
writes by default.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .xxhash import xxh64

MAGIC = 0xFD2FB528
_SKIPPABLE = 0x184D2A50                 # .. 0x184D2A5F
_BLOCK_MAX = 1 << 17

# predefined distributions (RFC 8878 3.1.1.3.2.2)
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
                2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, -1, -1, -1, -1, -1], 5)
# (baseline, extra bits) of each literals-length and match-length code
_LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
_ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)]
_LL_MAX, _ML_MAX, _OF_MAX = 35, 52, 31
_LL_AL, _ML_AL, _OF_AL, _HUF_WEIGHT_AL = 9, 9, 8, 6
_HUF_MAX_BITS = 11


# =============================================================================
# Bit streams
# =============================================================================
class _Forward:
    """Little-endian bits read from the start (FSE table headers)."""

    def __init__(self, data: bytes, p: int):
        self.d, self.bit = data, p * 8

    def peek(self, n: int) -> int:
        b = self.bit >> 3
        v = int.from_bytes(self.d[b:b + 8], "little") >> (self.bit & 7)
        return v & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.bit += n
        if self.bit > len(self.d) * 8:
            raise ValueError("zstd: table header runs past its block")

    def end(self) -> int:
        return (self.bit + 7) >> 3


class _Backward:
    """A bit stream read from its end, as every FSE and Huffman stream is:
    the highest set bit of the last byte marks the start; reading past the
    first byte yields zeros and counts as overflow."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ValueError("zstd: bit stream without its end marker")
        self.d = bytes(8) + data        # zeros below the stream's start
        self.pos = (len(data) - 1) * 8 + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        q = self.pos + 64
        if q < 0:
            raise ValueError("zstd: bit stream overflow")
        v = int.from_bytes(self.d[q >> 3:(q >> 3) + 8], "little")
        return (v >> (q & 7)) & ((1 << n) - 1)


# =============================================================================
# FSE
# =============================================================================
def _read_ncount(data: bytes, p: int, max_symbol: int,
                 max_al: int) -> Tuple[List[int], int, int]:
    """An FSE table description: (normalized counts, accuracy log, the
    position after it)."""
    r = _Forward(data, p)
    al = r.peek(4) + 5
    r.skip(4)
    if al > max_al:
        raise ValueError(f"zstd: FSE accuracy log {al} > {max_al}")
    remaining = (1 << al) + 1
    threshold = 1 << al
    nbits = al + 1
    norm: List[int] = []
    prev0 = False
    while remaining > 1:
        if prev0:
            while True:
                rep = r.peek(2)
                r.skip(2)
                norm += [0] * rep
                if rep != 3:
                    break
        if len(norm) > max_symbol:
            raise ValueError("zstd: FSE table has too many symbols")
        mx = (2 * threshold - 1) - remaining
        low = r.peek(nbits - 1) & (threshold - 1)
        if low < mx:
            count = low
            r.skip(nbits - 1)
        else:
            count = r.peek(nbits) & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            r.skip(nbits)
        count -= 1
        remaining -= abs(count)
        norm.append(count)
        prev0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(norm) > max_symbol + 1:
        raise ValueError("zstd: malformed FSE table description")
    return norm, al, r.end()


def _fse_table(norm: List[int], al: int):
    """The decoding table: (symbol, bits to read, baseline) per state."""
    size = 1 << al
    sym = [0] * size
    high = size - 1
    nxt = []
    for s, c in enumerate(norm):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    pos, step, mask = 0, (size >> 1) + (size >> 3) + 3, size - 1
    for s, c in enumerate(norm):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ValueError("zstd: FSE table counts do not fill the table")
    nb, base = [0] * size, [0] * size
    for u in range(size):
        x = nxt[sym[u]]
        nxt[sym[u]] += 1
        k = al - (x.bit_length() - 1)
        nb[u] = k
        base[u] = (x << k) - size
    return sym, nb, base, al


def _rle_table(symbol: int):
    return [symbol], [0], [0], 0


_LL_TABLE = _fse_table(*_LL_DEFAULT)
_ML_TABLE = _fse_table(*_ML_DEFAULT)
_OF_TABLE = _fse_table(*_OF_DEFAULT)


# =============================================================================
# Huffman literals
# =============================================================================
def _huffman_weights(data: bytes, p: int) -> Tuple[List[int], int]:
    head = data[p]
    p += 1
    if head >= 128:                     # direct: 4 bits a weight
        n = head - 127
        raw = data[p:p + (n + 1) // 2]
        if len(raw) < (n + 1) // 2:
            raise ValueError("zstd: truncated Huffman weights")
        w = []
        for b in raw:
            w += [b >> 4, b & 15]
        return w[:n], p + (n + 1) // 2
    # FSE-compressed weights: two interleaved states
    end = p + head
    if end > len(data):
        raise ValueError("zstd: truncated Huffman weights")
    norm, al, q = _read_ncount(data[:end], p, 255, _HUF_WEIGHT_AL)
    sym, nb, base, _ = _fse_table(norm, al)
    r = _Backward(data[q:end])
    s1, s2 = r.read(al), r.read(al)
    w: List[int] = []
    while True:                         # until the stream overflows
        if len(w) > 253:
            raise ValueError("zstd: too many Huffman weights")
        w.append(sym[s1])
        s1 = base[s1] + r.read(nb[s1])
        if r.pos < 0:
            w.append(sym[s2])
            break
        w.append(sym[s2])
        s2 = base[s2] + r.read(nb[s2])
        if r.pos < 0:
            w.append(sym[s1])
            break
    return w, end


def _huffman_table(weights: List[int]):
    """(symbol per index, bits per index, max bits) of the prefix code
    the weights describe; the last symbol's weight is implied."""
    if any(x > _HUF_MAX_BITS for x in weights):
        raise ValueError("zstd: Huffman weight too large")
    total = sum(1 << (x - 1) for x in weights if x)
    if total == 0:
        raise ValueError("zstd: Huffman weights all zero")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ValueError("zstd: Huffman weights do not complete a tree")
    weights = weights + [rest.bit_length()]
    if max_bits > _HUF_MAX_BITS:
        raise ValueError("zstd: Huffman code longer than 11 bits")
    sym = np.zeros(1 << max_bits, np.int64)
    nb = np.zeros(1 << max_bits, np.int64)
    at = 0
    for w in range(1, max_bits + 1):
        for s, x in enumerate(weights):
            if x == w:
                k = 1 << (w - 1)
                sym[at:at + k] = s
                nb[at:at + k] = max_bits + 1 - w
                at += k
    return sym, nb, max_bits


def _huffman_stream(stream: bytes, n: int, table) -> bytes:
    """``n`` symbols of one Huffman stream. The bits are peeked at every
    position at once, then the decoder walks the positions it visits."""
    sym, nb, mb = table
    if not stream or stream[-1] == 0:
        raise ValueError("zstd: Huffman stream without its end marker")
    pos = (len(stream) - 1) * 8 + stream[-1].bit_length() - 1
    bits = np.unpackbits(np.frombuffer(stream, np.uint8),
                         bitorder="little")[:pos]
    pad = np.concatenate([np.zeros(mb, np.uint8), bits]).astype(np.int64)
    peek = np.zeros(pos + 1, np.int64)
    for k in range(mb):
        peek |= pad[k:k + pos + 1] << k
    s_at, n_at = sym[peek].tolist(), nb[peek].tolist()
    out = bytearray(n)
    p = pos
    for i in range(n):
        if p < 0:
            raise ValueError("zstd: Huffman stream overflow")
        out[i] = s_at[p]
        p -= n_at[p]
    if p != 0:
        raise ValueError("zstd: Huffman stream not consumed exactly")
    return bytes(out)


# =============================================================================
# Blocks
# =============================================================================
class _FrameState:
    def __init__(self, window: int):
        self.window = window
        self.huf = None
        self.tables = [None, None, None]      # LL, OF, ML
        self.rep = [1, 4, 8]


def _literals(block: bytes, st: _FrameState) -> Tuple[bytes, int]:
    b0 = block[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):                      # raw, RLE
        if fmt in (0, 2):
            regen, p = b0 >> 3, 1
        elif fmt == 1:
            regen, p = (b0 >> 4) + (block[1] << 4), 2
        else:
            regen, p = (b0 >> 4) + (block[1] << 4) + (block[2] << 12), 3
        if regen > _BLOCK_MAX:
            raise ValueError("zstd: literals larger than a block")
        if kind == 0:
            if p + regen > len(block):
                raise ValueError("zstd: truncated raw literals")
            return block[p:p + regen], p + regen
        if p >= len(block):
            raise ValueError("zstd: truncated RLE literals")
        return bytes([block[p]]) * regen, p + 1
    # Huffman-coded (2) or treeless (3)
    hsize, bits = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
    if len(block) < hsize:
        raise ValueError("zstd: truncated literals header")
    v = int.from_bytes(block[:hsize], "little") >> 4
    regen, comp = v & ((1 << bits) - 1), (v >> bits) & ((1 << bits) - 1)
    if regen > _BLOCK_MAX:
        raise ValueError("zstd: literals larger than a block")
    p, end = hsize, hsize + comp
    if end > len(block):
        raise ValueError("zstd: truncated Huffman literals")
    if kind == 2:
        weights, p = _huffman_weights(block[:end], p)
        st.huf = _huffman_table(weights)
    elif st.huf is None:
        raise ValueError("zstd: treeless literals without a previous table")
    if fmt == 0:
        return _huffman_stream(block[p:end], regen, st.huf), end
    if p + 6 > end:
        raise ValueError("zstd: truncated jump table")
    s1, s2, s3 = (int.from_bytes(block[p + 2 * i:p + 2 * i + 2], "little")
                  for i in range(3))
    p += 6
    s4 = end - p - s1 - s2 - s3
    seg = (regen + 3) // 4
    if s4 < 1 or regen < 3 * seg:
        raise ValueError("zstd: malformed jump table")
    out = bytearray()
    for size, count in ((s1, seg), (s2, seg), (s3, seg),
                        (s4, regen - 3 * seg)):
        out += _huffman_stream(block[p:p + size], count, st.huf)
        p += size
    return bytes(out), end


def _seq_table(block: bytes, p: int, mode: int, slot: int, default,
               max_symbol: int, max_al: int, st: _FrameState):
    if mode == 0:
        t = default
    elif mode == 1:
        if p >= len(block):
            raise ValueError("zstd: truncated RLE sequence table")
        if block[p] > max_symbol:
            raise ValueError("zstd: RLE symbol out of range")
        t = _rle_table(block[p])
        p += 1
    elif mode == 2:
        norm, al, p = _read_ncount(block, p, max_symbol, max_al)
        t = _fse_table(norm, al)
    else:
        t = st.tables[slot]
        if t is None:
            raise ValueError("zstd: repeat mode without a previous table")
    st.tables[slot] = t
    return t, p


def _compressed_block(block: bytes, out: bytearray, st: _FrameState,
                      frame_start: int) -> None:
    if not block:
        raise ValueError("zstd: empty compressed block")
    lits, p = _literals(block, st)
    if p >= len(block):
        raise ValueError("zstd: missing sequences section")
    b0 = block[p]
    if b0 == 0:
        nseq, p = 0, p + 1
    elif b0 < 128:
        nseq, p = b0, p + 1
    elif b0 < 255:
        nseq, p = ((b0 - 128) << 8) + block[p + 1], p + 2
    else:
        nseq, p = block[p + 1] + (block[p + 2] << 8) + 0x7F00, p + 3
    if nseq == 0:
        if p != len(block):
            raise ValueError("zstd: bytes after an empty sequences section")
        out += lits
        return
    modes = block[p]
    p += 1
    if modes & 3:
        raise ValueError("zstd: reserved sequence mode bits set")
    ll_t, p = _seq_table(block, p, modes >> 6, 0, _LL_TABLE, _LL_MAX,
                         _LL_AL, st)
    of_t, p = _seq_table(block, p, (modes >> 4) & 3, 1, _OF_TABLE, _OF_MAX,
                         _OF_AL, st)
    ml_t, p = _seq_table(block, p, (modes >> 2) & 3, 2, _ML_TABLE, _ML_MAX,
                         _ML_AL, st)
    r = _Backward(block[p:])
    ll_sym, ll_nb, ll_base, ll_al = ll_t
    of_sym, of_nb, of_base, of_al = of_t
    ml_sym, ml_nb, ml_base, ml_al = ml_t
    s_ll, s_of, s_ml = r.read(ll_al), r.read(of_al), r.read(ml_al)
    rep = st.rep
    lp = 0
    window = st.window
    for i in range(nseq):
        ofc = of_sym[s_of]
        if ofc > _OF_MAX:
            raise ValueError("zstd: offset code out of range")
        ofv = (1 << ofc) + r.read(ofc)
        mbase, mbits = _ML_CODES[ml_sym[s_ml]]
        ml = mbase + r.read(mbits)
        lbase, lbits = _LL_CODES[ll_sym[s_ll]]
        ll = lbase + r.read(lbits)
        if i != nseq - 1:
            s_ll = ll_base[s_ll] + r.read(ll_nb[s_ll])
            s_ml = ml_base[s_ml] + r.read(ml_nb[s_ml])
            s_of = of_base[s_of] + r.read(of_nb[s_of])
        if r.pos < 0:
            raise ValueError("zstd: sequence bit stream overflow")
        if ofv > 3:
            off = ofv - 3
            rep = [off, rep[0], rep[1]]
        else:
            k = ofv + (ll == 0)
            if k == 1:
                off = rep[0]
            elif k == 2:
                off = rep[1]
                rep = [off, rep[0], rep[2]]
            elif k == 3:
                off = rep[2]
                rep = [off, rep[0], rep[1]]
            else:
                off = rep[0] - 1
                if off == 0:
                    raise ValueError("zstd: repeat offset of 0")
                rep = [off, rep[0], rep[1]]
        if lp + ll > len(lits):
            raise ValueError("zstd: sequence takes more literals than "
                             "the block holds")
        out += lits[lp:lp + ll]
        lp += ll
        pos = len(out)
        if off > pos - frame_start or off > window:
            raise ValueError(f"zstd: match offset {off} reaches before "
                             "the window")
        s = pos - off
        if off >= ml:
            out += out[s:s + ml]
        else:
            out += (out[s:pos] * (ml // off + 1))[:ml]
    if r.pos != 0:
        raise ValueError("zstd: sequence bit stream not consumed exactly")
    st.rep = rep
    out += lits[lp:]


# =============================================================================
# Frames
# =============================================================================
def decompress(data) -> bytes:
    """Every frame of ``data``, decoded and concatenated."""
    data = bytes(data)
    out = bytearray()
    p, n = 0, len(data)
    if not n:
        raise ValueError("zstd: empty input")
    while p < n:
        if p + 4 > n:
            raise ValueError("zstd: truncated frame magic")
        magic = int.from_bytes(data[p:p + 4], "little")
        if magic & 0xFFFFFFF0 == _SKIPPABLE:
            if p + 8 > n:
                raise ValueError("zstd: truncated skippable frame")
            p += 8 + int.from_bytes(data[p + 4:p + 8], "little")
            if p > n:
                raise ValueError("zstd: truncated skippable frame")
            continue
        if magic != MAGIC:
            raise ValueError(f"zstd: bad frame magic {magic:#010x}")
        try:
            p = _frame(data, p + 4, out)
        except IndexError as e:
            raise ValueError("zstd: truncated frame") from e
    return bytes(out)


def _header(data: bytes, p: int):
    if p >= len(data):
        raise ValueError("zstd: truncated frame header")
    fhd = data[p]
    p += 1
    fcs_flag, single = fhd >> 6, bool(fhd & 0x20)
    if fhd & 0x08:
        raise ValueError("zstd: reserved frame header bit set")
    checksum = bool(fhd & 0x04)
    did_size = (0, 1, 2, 4)[fhd & 3]
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    need = (0 if single else 1) + did_size + fcs_size
    if p + need > len(data):
        raise ValueError("zstd: truncated frame header")
    window = None
    if not single:
        wd = data[p]
        p += 1
        wlog = 10 + (wd >> 3)
        window = (1 << wlog) + ((1 << wlog) >> 3) * (wd & 7)
    if did_size:
        if int.from_bytes(data[p:p + did_size], "little"):
            raise ValueError("zstd: frames with a dictionary are not "
                             "supported")
        p += did_size
    size = None
    if fcs_size:
        size = int.from_bytes(data[p:p + fcs_size], "little")
        if fcs_size == 2:
            size += 256
        p += fcs_size
    if window is None:
        window = size
    return p, size, window, checksum


def _frame(data: bytes, p: int, out: bytearray) -> int:
    p, size, window, checksum = _header(data, p)
    n = len(data)
    start = len(out)
    st = _FrameState(window)
    block_max = min(window, _BLOCK_MAX)
    while True:
        if p + 3 > n:
            raise ValueError("zstd: truncated block header")
        h = int.from_bytes(data[p:p + 3], "little")
        p += 3
        last, kind, bsize = h & 1, (h >> 1) & 3, h >> 3
        if kind == 3:
            raise ValueError("zstd: reserved block type")
        if kind == 1:                       # RLE: one byte, bsize times
            if p >= n or bsize > block_max:
                raise ValueError("zstd: malformed RLE block")
            out += bytes([data[p]]) * bsize
            p += 1
        else:
            if bsize > block_max or p + bsize > n:
                raise ValueError("zstd: block larger than its frame allows")
            if kind == 0:
                out += data[p:p + bsize]
            else:
                before = len(out)
                _compressed_block(data[p:p + bsize], out, st, start)
                if len(out) - before > block_max:
                    raise ValueError("zstd: block decodes past its size")
            p += bsize
        if last:
            break
    if size is not None and len(out) - start != size:
        raise ValueError(f"zstd: frame holds {len(out) - start} bytes, its "
                         f"header says {size}")
    if checksum:
        if p + 4 > n:
            raise ValueError("zstd: truncated content checksum")
        want = int.from_bytes(data[p:p + 4], "little")
        if want != xxh64(out[start:]) & 0xFFFFFFFF:
            raise ValueError("zstd: content checksum mismatch")
        p += 4
    return p


def compress_raw(data) -> bytes:
    """``data`` as one Zstandard frame (RFC 8878) of raw blocks: the frame
    header names the content size (single segment, so the window is the
    content), then blocks of at most 128 KiB, the last one flagged."""
    data = memoryview(data).cast("B")
    n = len(data)
    if n < 256:
        fhd, fcs = 0x20, n.to_bytes(1, "little")
    elif n < 65536 + 256:
        fhd, fcs = 0x60, (n - 256).to_bytes(2, "little")
    elif n < 1 << 32:
        fhd, fcs = 0xA0, n.to_bytes(4, "little")
    else:
        fhd, fcs = 0xE0, n.to_bytes(8, "little")
    out = [MAGIC.to_bytes(4, "little"), bytes([fhd]), fcs]
    p = 0
    while True:
        size = min(n - p, _BLOCK_MAX)
        last = p + size == n
        out.append((int(last) | size << 3).to_bytes(3, "little"))
        out.append(data[p:p + size])
        p += size
        if last:
            return b"".join(out)
