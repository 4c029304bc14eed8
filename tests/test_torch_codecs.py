"""The port's codecs (``utils/xxhash.py``, ``utils/lz4.py``,
``utils/zstd.py``; the standard library and numpy only) byte for byte
against the published XXH32/XXH64 vectors, pyarrow's LZ4 frames and the
``zstandard`` package: every decoded output equals the input, the port's
LZ4 frames decode in pyarrow, and a corrupted frame raises."""
import struct

import numpy as np
import pyarrow as pa
import pytest

from multimodal_edema_prediction_tpu_torch.utils import lz4, xxhash, zstd

zstandard = pytest.importorskip("zstandard")


def _inputs():
    rng = np.random.default_rng(0)
    small = rng.integers(0, 4, 1 << 17, dtype=np.uint8).tobytes()
    return {
        "empty": b"",
        "one_byte": b"x",
        "64k_minus_1": small[:65535],
        "64k": small[:65536],
        "64k_plus_1": small[:65537],
        "int64_deltas_4.8MB": np.cumsum(rng.integers(0, 5, 600_000))
        .astype(np.int64).tobytes(),
        "random": rng.bytes(200_000),
        "long_runs": b"a" * 150_000 + b"b" * 70_000 + bytes(range(256)) * 40,
        "text": b" ".join(rng.choice(
            [b"2150-03-01 08:00:00", b"heart_rate", b"bpm", b"NaN", b"x" * 40],
            20_000)),
    }


INPUTS = _inputs()


# =============================================================================
# xxHash
# =============================================================================
@pytest.mark.parametrize("fn,seed,want", [
    (xxhash.xxh32, 0, 0x02CC5D05), (xxhash.xxh32, 1, 0x0B2CB792),
    (xxhash.xxh64, 0, 0xEF46DB3751D8E999),
    (xxhash.xxh64, 1, 0xD5AFBA1336A3BE4B)])
def test_xxhash_published_vectors(fn, seed, want):
    assert fn(b"", seed) == want


def test_xxhash_against_the_reference_library():
    ref = pytest.importorskip("xxhash")
    rng = np.random.default_rng(1)
    for n in list(range(70)) + [255, 1000, 4097, 65_539]:
        d = rng.bytes(n)
        for seed in (0, 1, 0x9E3779B1):
            assert xxhash.xxh32(d, seed) == ref.xxh32_intdigest(d, seed), n
            assert xxhash.xxh64(d, seed) == ref.xxh64_intdigest(d, seed), n


# =============================================================================
# LZ4
# =============================================================================
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_lz4_decodes_pyarrow_frames(name):
    data = INPUTS[name]
    frame = pa.compress(data, codec="lz4", asbytes=True)
    if len(data) > 65536:                    # linked 64 KB blocks
        assert frame[4:6] == b"\x40\x40"
    assert lz4.decompress(frame) == data


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_pyarrow_decodes_lz4_frames_of_the_port(name):
    data = INPUTS[name]
    frame = lz4.compress(data)
    assert pa.decompress(frame, len(data), codec="lz4", asbytes=True) == data
    assert lz4.decompress(frame) == data
    if name in ("long_runs", "text", "int64_deltas_4.8MB"):
        assert len(frame) < len(data) // 2
    if name == "random":                     # stored, not expanded
        assert len(frame) <= len(data) + 4 * (len(data) // 65536 + 2) + 7


def _blocks(frame: bytes):
    """(raw flag, payload) of each block of a pyarrow LZ4 frame."""
    p, out = 7, []
    while True:
        size = struct.unpack_from("<I", frame, p)[0]
        p += 4
        if size == 0:
            return out
        out.append((bool(size & 0x80000000), frame[p:p + (size & 0x7FFFFFFF)]))
        p += size & 0x7FFFFFFF


def _reframe(data: bytes, blocks, independent=False, block_sum=False,
             content_sum=False, content_size=False) -> bytes:
    """A frame with the given options around ``blocks``; the checksums by
    the reference ``xxhash`` package."""
    ref = pytest.importorskip("xxhash")
    flg = 0x40 | (0x20 * independent) | (0x10 * block_sum) \
        | (0x08 * content_size) | (0x04 * content_sum)
    desc = bytes([flg, 0x40]) + (struct.pack("<Q", len(data))
                                 if content_size else b"")
    out = bytearray(struct.pack("<I", lz4.MAGIC) + desc)
    out.append((ref.xxh32_intdigest(desc) >> 8) & 0xFF)
    for raw, payload in blocks:
        out += struct.pack("<I", len(payload) | (0x80000000 * raw)) + payload
        if block_sum:
            out += struct.pack("<I", ref.xxh32_intdigest(payload))
    out += b"\0\0\0\0"
    if content_sum:
        out += struct.pack("<I", ref.xxh32_intdigest(data))
    return bytes(out)


def test_lz4_frame_options():
    """Checksums, a content size, independent and uncompressed blocks,
    concatenated and skippable frames."""
    data = INPUTS["text"]
    blocks = _blocks(pa.compress(data, codec="lz4", asbytes=True))
    full = _reframe(data, blocks, block_sum=True, content_sum=True,
                    content_size=True)
    assert lz4.decompress(full) == data
    small = data[:40_000]                    # one block: independent
    one = _reframe(small, _blocks(pa.compress(small, codec="lz4",
                                              asbytes=True)),
                   independent=True)
    assert lz4.decompress(one) == small
    stored = _reframe(small, [(True, small[:30_000]), (True, small[30_000:])],
                      content_sum=True)
    assert lz4.decompress(stored) == small
    skip = struct.pack("<II", 0x184D2A53, 5) + b"12345"
    assert lz4.decompress(skip + one + skip + full) == small + data
    with pytest.raises(ValueError, match="header says"):
        lz4.decompress(_reframe(small[:-1], _blocks(lz4.compress(small)),
                                content_size=True))


def test_lz4_overlapping_matches():
    """A match longer than its offset repeats its own output."""
    data = b"ab" + b"ab" * 5000 + b"xyz" * 3000 + b"q"
    frame = lz4.compress(data)
    assert lz4.decompress(frame) == data
    assert pa.decompress(frame, len(data), codec="lz4", asbytes=True) == data


def test_lz4_corruption_raises():
    data = INPUTS["text"][:50_000]
    blocks = _blocks(pa.compress(data, codec="lz4", asbytes=True))
    frame = _reframe(data, blocks, block_sum=True, content_sum=True)
    for pos in range(4, len(frame), max(1, len(frame) // 200)):
        bad = bytearray(frame)
        bad[pos] ^= 0x5A
        with pytest.raises(ValueError):
            lz4.decompress(bytes(bad))
    with pytest.raises(ValueError):
        lz4.decompress(frame[:-3])
    with pytest.raises(ValueError):
        lz4.decompress(b"\0" + frame[1:])


# =============================================================================
# Zstandard
# =============================================================================
ZSTD_INPUTS = ("int64_deltas_300KB", "text", "random", "long_runs",
               "64k_plus_1", "one_byte", "empty")


def _zinput(name: str) -> bytes:
    if name == "int64_deltas_300KB":
        return INPUTS["int64_deltas_4.8MB"][:300_000]
    return INPUTS[name]


@pytest.mark.parametrize("level", [-5, 1, 3, 19])
def test_zstd_decodes_zstandard_frames(level):
    for name in ZSTD_INPUTS:
        data = _zinput(name)
        c = zstandard.ZstdCompressor(level=level).compress(data)
        assert zstd.decompress(c) == data, name


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("content_size", [False, True])
def test_zstd_frame_flags(checksum, content_size):
    data = _zinput("int64_deltas_300KB") + _zinput("text")[:100_000]
    assert len(data) > 1 << 17                   # several blocks
    for level in (1, 19):
        c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                     write_content_size=content_size
                                     ).compress(data)
        fhd = c[4]
        assert bool(fhd & 0x04) == checksum
        assert bool(fhd >> 6 or fhd & 0x20) == content_size
        assert zstd.decompress(c) == data


def test_zstd_streamed_frame_without_content_size():
    data = _zinput("text") * 2
    cctx = zstandard.ZstdCompressor(level=3, write_checksum=True)
    chunks = [cctx.compressobj()]
    c = chunks[0].compress(data[:70_000]) + chunks[0].compress(data[70_000:])
    c += chunks[0].flush()
    assert c[4] >> 6 == 0 and not c[4] & 0x20          # no content size
    assert zstd.decompress(c) == data


def test_zstd_rle_raw_concatenated_skippable_and_pyarrow():
    rle = b"\x07" * 300_000
    raw = INPUTS["random"]
    a = zstandard.ZstdCompressor(level=3).compress(rle)
    b = zstandard.ZstdCompressor(level=1, write_checksum=True).compress(raw)
    assert len(a) < 100                     # RLE blocks
    assert zstd.decompress(a) == rle
    assert zstd.decompress(b) == raw        # raw blocks
    skip = struct.pack("<II", 0x184D2A5E, 3) + b"abc"
    assert zstd.decompress(a + skip + b) == rle + raw
    for name in ("int64_deltas_300KB", "text", "long_runs"):
        data = _zinput(name)
        assert zstd.decompress(pa.compress(data, codec="zstd",
                                           asbytes=True)) == data
    huge = zstandard.ZstdCompressor(level=19).compress(INPUTS["text"] * 2)
    assert zstd.decompress(huge) == INPUTS["text"] * 2


def test_zstd_dictionary_frames_raise():
    c = zstandard.ZstdCompressor(level=3, write_content_size=False,
                                 write_dict_id=False).compress(b"hello " * 50)
    fhd = c[4]
    assert fhd & 3 == 0
    with_dict = c[:4] + bytes([fhd | 1]) + c[5:6] + b"\x2a" + c[6:] \
        if not fhd & 0x20 else c[:4] + bytes([fhd | 1]) + b"\x2a" + c[5:]
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(with_dict)


def test_zstd_corruption_raises():
    data = _zinput("text")[:60_000] + _zinput("int64_deltas_300KB")[:60_000]
    c = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    assert zstd.decompress(c) == data
    flipped = 0
    for pos in range(len(c) // 4, len(c) - 4, max(1, len(c) // 80)):
        bad = bytearray(c)
        bad[pos] ^= 0xFF
        with pytest.raises(ValueError):
            zstd.decompress(bytes(bad))
        flipped += 1
    assert flipped > 50
    with pytest.raises(ValueError):
        zstd.decompress(c[:-5])
    with pytest.raises(ValueError):
        zstd.decompress(b"\0" + c[1:])


def _one_block_frame(block: bytes, size=None) -> bytes:
    """A frame of one compressed block, written by hand: single segment
    with a 1-byte content size, or a 1 KB window and no content size."""
    head = bytes([0x20, size]) if size is not None else bytes([0x00, 0x00])
    return (struct.pack("<I", zstd.MAGIC) + head
            + (len(block) << 3 | 2 << 1 | 1).to_bytes(3, "little") + block)


def test_zstd_hand_written_literal_only_blocks():
    """RLE and raw literals sections with no sequence."""
    rle = bytes([20 << 3 | 1, ord("q"), 0])
    assert zstd.decompress(_one_block_frame(rle, 20)) == b"q" * 20
    assert zstd.decompress(_one_block_frame(rle)) == b"q" * 20
    raw = bytes([5 << 3 | 0]) + b"hello" + b"\0"
    assert zstd.decompress(_one_block_frame(raw)) == b"hello"
    with pytest.raises(ValueError, match="header says"):
        zstd.decompress(_one_block_frame(rle, 21))
    with pytest.raises(ValueError, match="larger"):   # block > content
        zstd.decompress(_one_block_frame(raw, 5))
