"""Zarr v2 arrays over a key-value store, read and written in numpy.

Orbax keeps each array of a checkpoint as a zarr v2 array inside its OCDBT
store (:mod:`.ocdbt`): ``<name>/.zarray`` holds the metadata and
``<name>/<i>.<j>...`` each chunk, the chunk grid in C order (``"0"`` for a
scalar's one chunk). orbax writes one chunk an array, compressed by
Zstandard level 1:

    {"chunks":[3,4],"compressor":{"id":"zstd","level":1},
     "dimension_separator":".","dtype":"<f4","fill_value":null,
     "filters":null,"order":"C","shape":[3,4],"zarr_format":2}

:func:`zarray` writes that metadata byte for byte, and :func:`encode`
stores each chunk as a Zstandard frame of raw blocks
(:func:`.zstd.compress_raw`). :func:`decode` reads arrays of any chunk
grid, with the compressor ``zstd`` or none, and the dtypes ``<f4``,
``<i4``, ``<i8`` and ``bfloat16`` (returned as its ``uint16`` bits,
which :func:`to_torch` views as ``torch.bfloat16``).
Anything else raises ``ValueError`` naming it: zarr v3 metadata, another
compressor, filters, Fortran order, another separator or dtype, a chunk of
the wrong size, or a missing chunk with no fill value.
"""
from __future__ import annotations

import itertools
import json
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from .zstd import compress_raw, decompress as zstd_decompress

ZARRAY = ".zarray"
# zarr dtype string → numpy dtype of the stored bytes
DTYPES = {"<f4": np.dtype("<f4"), "<i4": np.dtype("<i4"),
          "<i8": np.dtype("<i8"), "bfloat16": np.dtype("<u2")}


def zarray(shape: Sequence[int], dtype: str) -> bytes:
    """The ``.zarray`` orbax writes for an array of ``shape`` and zarr
    ``dtype``, in one chunk compressed by zstd level 1."""
    if dtype not in DTYPES:
        raise ValueError(f"zarr dtype {dtype!r} is not supported "
                         f"({sorted(DTYPES)})")
    meta = {"chunks": list(shape),
            "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": dtype,
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(shape), "zarr_format": 2}
    return json.dumps(meta, separators=(",", ":")).encode()


def zarr_dtype(arr) -> str:
    """The zarr dtype of a numpy array or a torch tensor's dtype name."""
    name = str(getattr(arr, "dtype", arr)).replace("torch.", "")
    for key, dt in (("float32", "<f4"), ("int32", "<i4"), ("int64", "<i8"),
                    ("bfloat16", "bfloat16")):
        if name == key:
            return dt
    raise ValueError(f"dtype {name} has no zarr v2 counterpart here")


def parse(raw: bytes, what: str = "zarr array") -> dict:
    """The checked ``.zarray`` metadata."""
    try:
        meta = json.loads(raw)
    except ValueError as e:
        raise ValueError(f"{what}: .zarray is not JSON ({e})") from e
    fmt = meta.get("zarr_format")
    if fmt != 2:
        raise ValueError(f"{what}: zarr_format {fmt!r} is not supported "
                         "(zarr v2 only; zarr v3 keeps zarr.json)")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{what}: compressor {comp!r} is not supported "
                         "(zstd or none)")
    if meta.get("filters"):
        raise ValueError(f"{what}: filters {meta['filters']!r} are not "
                         "supported")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{what}: order {meta['order']!r} is not "
                         "supported (C only)")
    if meta.get("dimension_separator", ".") != ".":
        raise ValueError(f"{what}: dimension_separator "
                         f"{meta['dimension_separator']!r} is not supported")
    if meta.get("dtype") not in DTYPES:
        raise ValueError(f"{what}: dtype {meta.get('dtype')!r} is not "
                         f"supported ({sorted(DTYPES)})")
    shape, chunks = list(meta["shape"]), list(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ValueError(f"{what}: chunks {chunks} do not fit shape "
                         f"{shape}")
    return meta


def chunk_keys(shape: Sequence[int], chunks: Sequence[int]):
    """(grid index, key) of every chunk, the grid in C order."""
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*(range(g) for g in grid)):
        yield idx, ".".join(map(str, idx)) if idx else "0"


def decode(raw_meta: bytes, get: Callable[[str], Optional[bytes]],
           what: str = "zarr array") -> Tuple[np.ndarray, str]:
    """(array, zarr dtype) of the array whose ``.zarray`` is ``raw_meta``;
    ``get(key)`` returns a chunk's stored bytes, or None when it is
    absent."""
    meta = parse(raw_meta, what)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dt = DTYPES[meta["dtype"]]
    out = np.empty(shape, dt)
    want = int(np.prod(chunks)) * dt.itemsize
    for idx, key in chunk_keys(shape, chunks):
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        data = get(key)
        if data is None:
            if meta.get("fill_value") is None:
                raise ValueError(f"{what}: chunk {key} is missing and the "
                                 "array has no fill_value")
            out[region] = meta["fill_value"]
            continue
        if meta.get("compressor") is not None:
            data = zstd_decompress(data)
        if len(data) != want:
            raise ValueError(f"{what}: chunk {key} holds {len(data)} bytes, "
                             f"a {list(chunks)} chunk of {meta['dtype']} "
                             f"is {want}")
        block = np.frombuffer(data, dt).reshape(chunks)
        out[region] = block[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    return out, meta["dtype"]


def encode(arr: np.ndarray, dtype: Optional[str] = None
           ) -> Dict[str, bytes]:
    """{".zarray": metadata, "<chunk key>": chunk} of one array in one
    chunk; ``dtype`` names the zarr dtype when it is not the array's own
    (``bfloat16`` given as its ``uint16`` bits)."""
    dtype = dtype or zarr_dtype(arr)
    # (``ascontiguousarray`` would make a scalar 1-d)
    arr = np.asarray(arr, DTYPES[dtype], order="C")
    (_, key), = chunk_keys(arr.shape, arr.shape)
    return {ZARRAY: zarray(arr.shape, dtype),
            key: compress_raw(memoryview(arr).cast("B"))}


def to_torch(arr: np.ndarray, dtype: str):
    """The decoded array as a CPU tensor of its dtype (``bfloat16`` from
    its bits)."""
    import torch
    t = torch.from_numpy(np.asarray(arr, order="C"))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t
