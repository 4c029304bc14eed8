"""The port's orbax storage layers against tensorstore and zstandard:
CRC-32C (``utils/crc32c.py``), the raw-block Zstandard encoder
(``utils/zstd.py::compress_raw``), the OCDBT key-value store
(``utils/ocdbt.py``) and zarr v2 arrays (``utils/zarr2.py``).

Stores are written here by tensorstore's ``ocdbt`` kvstore (nodes
uncompressed and zstd; small inline limits and node sizes, so that values
go to data files and the B+tree has interior levels) and by this host's
orbax; every key must read the same bytes in the port as in tensorstore's
``kv.read``. The other way, tensorstore lists a store the port wrote and
reads the same bytes from it. The readers raise on what they do not read:
zarr v3, another compressor or dtype, a CRC-32C mismatch, another format
version or compression method, a numbered manifest, a data file outside
the store.
"""
import json
import os
import shutil

import ml_dtypes
import numpy as np
import pytest
import tensorstore as ts
import zstandard

from multimodal_edema_prediction_tpu_torch.utils import ocdbt, zarr2
from multimodal_edema_prediction_tpu_torch.utils.crc32c import crc32c
from multimodal_edema_prediction_tpu_torch.utils.zstd import (compress_raw,
                                                              decompress)


# -- CRC-32C ----------------------------------------------------------------
@pytest.mark.parametrize("data,want", [
    (b"123456789", 0xE3069283),
    (bytes(32), 0x8A9136AA),                     # RFC 3720 B.4
    (b"\xff" * 32, 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
    (bytes(range(31, -1, -1)), 0x113FDB5C),
    (bytes.fromhex(
        "01c00000000000000000000000000000" "14000000000004000000001400000018"
        "28000000000000000200000000000000"), 0xD9963A56),
    (b"", 0)])
def test_crc32c_rfc3720_vectors(data, want):
    assert crc32c(data) == want
    # every prefix, so every length the slicing-by-8 loop leaves to the
    # byte loop, against the bit-at-a-time definition
    for cut in range(len(data) + 1):
        assert crc32c(data[:cut]) == _crc32c_bitwise(data[:cut])


def _crc32c_bitwise(data: bytes) -> int:
    """CRC-32C one bit at a time (reflected polynomial 0x82F63B78)."""
    c = 0xFFFFFFFF
    for b in data:
        c ^= b
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
    return c ^ 0xFFFFFFFF


# -- zstd raw-block frames ---------------------------------------------------
@pytest.mark.parametrize("n", [0, 1, 255, 256, 65791, 65792, 131072,
                               131073, 400_000])
def test_compress_raw_is_a_frame_zstandard_reads(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    frame = compress_raw(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert decompress(frame) == data
    # raw blocks: the frame is the data plus headers
    assert len(frame) == n + 5 + (1 if n < 256 else 2 if n < 65792 else 4) \
        + 3 * max(1, -(-n // 131072))


# -- OCDBT against tensorstore -----------------------------------------------
def _ts_items(d) -> dict:
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + d}).result()
    return {bytes(k): bytes(kv.read(k).result().value)
            for k in kv.list().result()}


def _assert_same(d):
    want = _ts_items(d)
    store = ocdbt.Store(d)
    assert store.keys() == sorted(want)
    for k, v in want.items():
        assert store.read(k) == v, k
    return store


def _items(n, seed=0, long=60):
    rng = np.random.default_rng(seed)
    return {f"k{int(rng.integers(0, 10 ** 6))}/{i}."
            f"{'x' * int(rng.integers(0, 20))}":
            rng.integers(0, 256, int(rng.integers(0, long)),
                         np.uint8).tobytes() for i in range(n)}


@pytest.mark.parametrize("config", [
    {"compression": None},
    {"compression": {"id": "zstd", "level": 3}},
    {"compression": None, "max_inline_value_bytes": 8,
     "max_decoded_node_bytes": 300},
    {"compression": {"id": "zstd"}, "max_inline_value_bytes": 16,
     "max_decoded_node_bytes": 400}])
def test_reader_matches_tensorstore(config, tmp_path):
    d = str(tmp_path / "s")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + d,
                          "config": config}).result()
    items = _items(120, seed=1)
    txn = ts.Transaction()
    for k, v in items.items():
        kv.with_transaction(txn)[k] = v
    txn.commit_async().result()
    kv["late/key"] = b"second version"            # a second generation
    store = _assert_same(d)
    assert store.generation >= 2 and len(store) == len(items) + 1


@pytest.mark.parametrize("n,budget,inline", [
    (0, 100, 8), (1, 100, 8), (5, 10 ** 8, 1024), (300, 400, 16),
    (2000, 2000, 100)])
def test_tensorstore_reads_what_the_writer_wrote(n, budget, inline,
                                                 tmp_path):
    d = str(tmp_path / "w")
    items = _items(n, seed=n)
    stats = ocdbt.write_store(d, items, max_inline_value_bytes=inline,
                              max_decoded_node_bytes=budget)
    assert stats["num_keys"] == n
    if n >= 300:
        assert stats["height"] >= 2          # interior levels were needed
    got = _ts_items(d)
    assert {k.decode(): v for k, v in got.items()} == items
    store = ocdbt.Store(d)
    assert {k.decode(): store.read(k) for k in store.keys()} == items


@pytest.fixture(scope="module")
def orbax_step(tmp_path_factory):
    """A step this host's orbax wrote (zstd nodes and chunks, its two-level
    layout, an f4 array over the inline limit, bf16 and i4 leaves)."""
    import jax.numpy as jnp
    import optax

    from multimodal_edema_prediction_tpu.train.orbax_io import (make_manager,
                                                                save_state)
    from multimodal_edema_prediction_tpu.train.state import TrainState
    params = {"a": jnp.arange(3000, dtype=jnp.float32).reshape(30, 100),
              "b": jnp.linspace(-2, 2, 5).astype(jnp.bfloat16),
              "c": jnp.arange(7, dtype=jnp.int32)}
    st = TrainState.create(params, {}, optax.adam(1e-3))
    d = str(tmp_path_factory.mktemp("orbax"))
    mgr = make_manager(d)
    save_state(mgr, 5, st)
    mgr.wait_until_finished()
    return os.path.join(d, "5", "default"), params


def test_reader_matches_tensorstore_on_an_orbax_store(orbax_step):
    item, params = orbax_step
    assert os.path.isdir(os.path.join(item, "ocdbt.process_0"))
    store = _assert_same(item)
    # a value over the inline limit lives in the process store's data file
    assert store._entries[b"params.a/0.0"][0].startswith("ocdbt.process_0/")
    for name, want in params.items():
        arr, dtype = zarr2.decode(
            store.read(f"params.{name}/.zarray"),
            lambda k, n=name: store.read(f"params.{n}/{k}"))
        np.testing.assert_array_equal(
            zarr2.to_torch(arr, dtype).float().numpy(),
            np.asarray(want, np.float32))
        # the port's .zarray for the same array is orbax's, byte for byte
        assert zarr2.encode(arr, dtype)[".zarray"] == \
            store.read(f"params.{name}/.zarray")


# -- zarr v2 -----------------------------------------------------------------
@pytest.mark.parametrize("dtype,shape,chunks,compressor", [
    ("<f4", [7, 5], [3, 2], {"id": "zstd", "level": 3}),
    ("<i4", [11], [4], None),
    ("<i8", [2, 3, 4], [1, 2, 3], {"id": "zstd", "level": 1}),
    ("bfloat16", [6, 4], [4, 4], {"id": "zstd", "level": 1})])
def test_zarr_reads_tensorstore_chunk_grids(dtype, shape, chunks, compressor,
                                            tmp_path):
    d = str(tmp_path / "z")
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(shape) * 100).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else zarr2.DTYPES[dtype])
    t = ts.open({"driver": "zarr", "kvstore": {
        "driver": "ocdbt", "base": "file://" + d, "path": "arr/"},
        "metadata": {"chunks": chunks, "compressor": compressor,
                     "dtype": dtype, "shape": shape,
                     "dimension_separator": "."},
        "create": True}).result()
    t.write(a).result()
    store = ocdbt.Store(d)
    arr, got_dtype = zarr2.decode(
        store.read("arr/.zarray"),
        lambda k: store.read(f"arr/{k}") if f"arr/{k}" in store else None)
    assert got_dtype == dtype
    want = np.asarray(t.read().result())
    if dtype == "bfloat16":
        np.testing.assert_array_equal(
            zarr2.to_torch(arr, dtype).float().numpy(),
            want.astype(np.float32))
    else:
        np.testing.assert_array_equal(arr, want)


def test_zarr_round_trip_and_scalar_keys():
    for arr in (np.float32(3.5), np.arange(6, dtype=np.int32).reshape(2, 3)):
        enc = zarr2.encode(np.asarray(arr))
        key = "0" if np.ndim(arr) == 0 else "0.0"
        assert set(enc) == {".zarray", key}
        got, _ = zarr2.decode(enc[".zarray"], enc.get)
        assert got.shape == np.shape(arr)
        np.testing.assert_array_equal(got, arr)


# -- what the readers refuse -------------------------------------------------
def _zarray(**kw):
    meta = json.loads(zarr2.zarray([2], "<f4"))
    meta.update(kw)
    return json.dumps(meta).encode()


@pytest.mark.parametrize("meta,match", [
    (_zarray(zarr_format=3), "zarr v2 only"),
    (_zarray(compressor={"id": "blosc", "cname": "lz4"}), "compressor"),
    (_zarray(dtype="<f2"), "dtype"),
    (_zarray(order="F"), "order"),
    (_zarray(filters=[{"id": "delta"}]), "filters"),
    (_zarray(dimension_separator="/"), "dimension_separator")])
def test_zarr_refuses_what_it_does_not_read(meta, match):
    with pytest.raises(ValueError, match=match):
        zarr2.decode(meta, lambda k: None)


def test_zarr_refuses_a_missing_chunk_and_a_short_one():
    meta = zarr2.zarray([4], "<f4")
    with pytest.raises(ValueError, match="missing"):
        zarr2.decode(meta, lambda k: None)
    with pytest.raises(ValueError, match="holds 8 bytes"):
        zarr2.decode(meta, lambda k: compress_raw(bytes(8)))


def _written(tmp_path, n=40):
    d = str(tmp_path / "s")
    ocdbt.write_store(d, _items(n), max_inline_value_bytes=8,
                      max_decoded_node_bytes=300)
    (data,) = os.listdir(os.path.join(d, "d"))
    return d, os.path.join(d, ocdbt.MANIFEST), os.path.join(d, "d", data)


def _patch(path, offset, byte, fix_crc=False):
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    raw[offset] = byte
    if fix_crc:
        raw[-4:] = crc32c(bytes(raw[:-4])).to_bytes(4, "little")
    with open(path, "wb") as f:
        f.write(raw)


@pytest.mark.parametrize("where,offset,byte,fix_crc,match", [
    ("manifest", 30, None, False, "CRC-32C mismatch"),
    ("node", -20, None, False, "CRC-32C mismatch"),
    ("manifest", 12, 1, True, "format version 1"),
    ("manifest", 13, 2, True, "compression format 2"),
    ("manifest", 0, 0x0D, True, "magic"),
    ("manifest", 14 + 16, 1, True, "manifest kind 1")])
def test_store_refuses_a_damaged_or_unknown_file(where, offset, byte, fix_crc,
                                                 match, tmp_path):
    d, manifest, data = _written(tmp_path)
    if where == "node":
        # the root node, at the end of the data file
        offset += os.path.getsize(data)
    path = manifest if where == "manifest" else data
    with open(path, "rb") as f:
        old = f.read()[offset]
    _patch(path, offset, old ^ 0x40 if byte is None else byte, fix_crc)
    with pytest.raises(ValueError, match=match):
        ocdbt.Store(d)


def test_store_refuses_a_data_file_outside_the_store(tmp_path):
    d = str(tmp_path / "s")
    ocdbt.write_store(d, {"k": b"v" * 40}, max_inline_value_bytes=8)
    (name,) = os.listdir(os.path.join(d, "d"))
    shutil.move(os.path.join(d, "d", name), str(tmp_path / name))
    with open(os.path.join(d, ocdbt.MANIFEST), "rb") as f:
        raw = f.read()
    path = f"d/{name}".encode()
    raw = raw.replace(path, b"../" + name.encode()[:len(path) - 3])
    raw = raw[:-4] + crc32c(raw[:-4]).to_bytes(4, "little")
    with open(os.path.join(d, ocdbt.MANIFEST), "wb") as f:
        f.write(raw)
    with pytest.raises(ValueError, match="not a path inside the store"):
        ocdbt.Store(d)
