"""Baseline grayscale JPEG writer in numpy (no PIL).

One grayscale component, baseline sequential DCT, the standard tables of
ITU-T T.81 Annex K (luminance quantization scaled by ``quality`` as
libjpeg scales it, the luminance DC and AC Huffman tables), no restart
markers. ``data/synthetic_raw.py`` writes its rehearsal JPEGs with it, and
``scripts/jpeg_fixtures.py`` its chest-X-ray-like test images, since the
card's host has no PIL.
"""
from __future__ import annotations

import struct

import numpy as np

# ITU-T T.81 Annex K.1, table K.1: luminance quantization (natural order)
LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
# Annex K.3, tables K.3 and K.5: code counts per length 1..16, then values
DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
DC_VALS = tuple(range(12))
AC_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d)
AC_VALS = (
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa)
# MIMIC-CXR-JPG's files are of the order of 3056 x 2544, one component



def _zigzag() -> np.ndarray:
    """Natural index of each zig-zag position (T.81 figure 5)."""
    order = sorted(((i, j) for i in range(8) for j in range(8)),
                   key=lambda p: (p[0] + p[1],
                                  p[0] if (p[0] + p[1]) % 2 else p[1]))
    return np.array([i * 8 + j for i, j in order], np.int64)


ZIGZAG = _zigzag()


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    c = np.cos((2 * n + 1) * k * np.pi / 16) * 0.5
    c[0] /= np.sqrt(2.0)
    return c


DCT = _dct_matrix()


def _huffman_table(bits, vals) -> tuple:
    """(code, length) of each symbol 0..255 of a canonical table (T.81
    Annex C); length 0 for a symbol the table lacks."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c = 0
    k = 0
    for n_bits, count in enumerate(bits, start=1):
        for _ in range(count):
            code[vals[k]] = c
            length[vals[k]] = n_bits
            c += 1
            k += 1
        c <<= 1
    return code, length


DC_CODE, DC_LEN = _huffman_table(DC_BITS, DC_VALS)
AC_CODE, AC_LEN = _huffman_table(AC_BITS, AC_VALS)


def quant_table(quality: int) -> np.ndarray:
    """The luminance table scaled as libjpeg's ``jpeg_quality_scaling``."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((LUMA_QUANT * scale + 50) // 100, 1, 255)


def _size(v: np.ndarray) -> np.ndarray:
    """Bit length of |v| (the JPEG category; 0 for 0)."""
    a = np.abs(v)
    out = np.zeros(a.shape, np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def _extra_bits(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The value's additional bits: v itself if positive, else the low
    ``size`` bits of v - 1."""
    return np.where(v >= 0, v, v - 1 + (1 << size)) & ((1 << size) - 1)


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate the codes MSB first, pad the last byte with ones and
    stuff a 0 after every 0xFF. Each code (at most 27 bits) lands in the
    5 bytes from the one its first bit falls in; codes never share a bit,
    so summing each byte's parts assembles it."""
    ends = np.cumsum(lengths)
    start = ends - lengths
    total = int(ends[-1]) if len(ends) else 0
    n_bytes = (total + 7) // 8
    pad = n_bytes * 8 - total
    # the code placed in a 40-bit window that starts at its first byte
    window = values << (40 - lengths - (start & 7))
    first = start >> 3
    out = np.zeros(n_bytes + 5, np.float64)
    for j in range(5):
        part = (window >> (8 * (4 - j))) & 0xFF
        out[:n_bytes + 5] += np.bincount(first + j, weights=part,
                                         minlength=n_bytes + 5)
    data = out[:n_bytes].astype(np.uint8)
    if pad:
        data[-1] |= (1 << pad) - 1
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def encode_gray(img: np.ndarray, quality: int = 90) -> bytes:
    """[H, W] uint8 → the bytes of a baseline grayscale JPEG."""
    img = np.asarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"a grayscale [H, W] image, got {img.shape}")
    H, W = img.shape
    qt = quant_table(quality)
    ph, pw = (-H) % 8, (-W) % 8
    x = np.pad(img, ((0, ph), (0, pw)), mode="edge").astype(np.float64)
    bh, bw = x.shape[0] // 8, x.shape[1] // 8
    blocks = (x - 128.0).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) \
        .reshape(-1, 8, 8)
    # DCT · block · DCTᵀ for every block, as two plain products
    rows = (blocks.reshape(-1, 8) @ DCT.T).reshape(-1, 8, 8)
    coef = (rows.transpose(0, 2, 1).reshape(-1, 8) @ DCT.T) \
        .reshape(-1, 8, 8).transpose(0, 2, 1)
    q = np.rint(coef.reshape(-1, 64)[:, ZIGZAG] / qt[ZIGZAG]).astype(
        np.int64)
    nb = q.shape[0]

    # the entries of the stream, each (block, order in the block, code,
    # length): DC first (order 0), each AC value at zig-zag k after its
    # ZRLs (order 2k - 1, then 2k), EOB last (order 128)
    dc = q[:, 0]
    diff = np.diff(dc, prepend=0)
    s = _size(diff)
    dc_val = (DC_CODE[s] << s) | _extra_bits(diff, s)
    dc_len = DC_LEN[s] + s

    b, k = np.nonzero(q[:, 1:])
    k = k + 1
    v = q[b, k]
    prev = np.zeros_like(k)
    same = np.r_[False, b[1:] == b[:-1]]
    prev[same] = k[:-1][same[1:]]
    run = k - prev - 1
    s = _size(v)
    sym = ((run % 16) << 4) | s
    ac_val = (AC_CODE[sym] << s) | _extra_bits(v, s)
    ac_len = AC_LEN[sym] + s
    n_zrl = run // 16
    zb = np.repeat(b, n_zrl)
    zk = np.repeat(2 * k - 1, n_zrl)

    last = np.zeros(nb, np.int64)
    np.maximum.at(last, b, k)
    eob = np.nonzero(last < 63)[0]

    blk = np.concatenate([np.arange(nb), b, zb, eob])
    order = np.concatenate([np.zeros(nb, np.int64), 2 * k, zk,
                            np.full(len(eob), 128, np.int64)])
    vals = np.concatenate([dc_val, ac_val,
                           np.full(len(zb), AC_CODE[0xF0], np.int64),
                           np.full(len(eob), AC_CODE[0x00], np.int64)])
    lens = np.concatenate([dc_len, ac_len,
                           np.full(len(zb), AC_LEN[0xF0], np.int64),
                           np.full(len(eob), AC_LEN[0x00], np.int64)])
    idx = np.argsort(blk * 256 + order, kind="stable")
    scan = _pack(vals[idx], lens[idx])

    def dht(tc_th, bits, table_vals):
        return bytes([tc_th, *bits, *table_vals])

    return b"".join([
        b"\xff\xd8",
        _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
        _segment(0xFFDB, bytes([0]) + bytes(qt[ZIGZAG].astype(np.uint8))),
        _segment(0xFFC0, struct.pack(">BHHB", 8, H, W, 1) + bytes([1, 0x11,
                                                                    0])),
        _segment(0xFFC4, dht(0x00, DC_BITS, DC_VALS)
                 + dht(0x10, AC_BITS, AC_VALS)),
        _segment(0xFFDA, bytes([1, 1, 0x00, 0, 63, 0])),
        scan, b"\xff\xd9"])
