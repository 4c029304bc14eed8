"""The Arrow IPC file format (Feather V2), and Feather V1, without pyarrow.

A Feather V2 file is an Arrow IPC file: the ``ARROW1`` magic, a schema
message, dictionary batches and record batches (each a flatbuffer
``Message`` and a body of buffers), and a footer that lists the blocks.
The flatbuffers are read and built here by hand (``format/Schema.fbs``,
``Message.fbs``, ``File.fbs`` of the Arrow project), with numpy for the
buffers and :mod:`..utils.lz4` / :mod:`..utils.zstd` for a body compressed
buffer by buffer (``BodyCompression``: each non-empty buffer is its int64
uncompressed length, or -1 for one stored raw, then one frame).

What is read: int8-int64, uint8-uint64, float16/32/64, bool, null,
``utf8``, ``large_utf8``, timestamps in s, ms, us and ns, and
dictionary-encoded columns of those; validity bitmaps
(LSB first, absent when a column has no null); any number of record
batches; uncompressed, LZ4_FRAME and ZSTD bodies. A Feather V1 file
(``FEA1``) is read too. What is written: Feather V2 with the same types as
:func:`write_table`'s caller gives, in record batches of 65,536 rows, as
pyarrow's ``write_feather`` does, LZ4_FRAME-compressed or uncompressed.

A column comes back as :class:`Column`: a numpy array of values (object
``str`` for the string types, ``None`` in a null slot;
``datetime64[unit]`` for timestamps) and the validity mask, or None when
no value is null. Every array owns its memory and is writeable.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import lz4, zstd

MAGIC = b"ARROW1"
MAGIC_V1 = b"FEA1"
CHUNK_ROWS = 1 << 16
_UNITS = ("s", "ms", "us", "ns")

# the Type union of Schema.fbs
_T_NULL, _T_INT, _T_FLOAT, _T_UTF8, _T_BOOL = 1, 2, 3, 5, 6
_T_TIMESTAMP, _T_LARGE_UTF8 = 10, 20
_STRINGS = ("utf8", "large_utf8")
_MSG_SCHEMA, _MSG_DICT, _MSG_BATCH = 1, 2, 3


@dataclass(frozen=True)
class ArrowType:
    """One Arrow type: ``kind`` is int, uint, float, bool, null, utf8,
    large_utf8 or timestamp; ``bits`` the width of an int, uint or float;
    ``unit`` and ``tz`` a timestamp's."""
    kind: str
    bits: int = 0
    unit: str = ""
    tz: Optional[str] = None

    def __str__(self) -> str:
        if self.kind in ("int", "uint"):
            return f"{self.kind}{self.bits}"
        if self.kind == "float":
            return {16: "halffloat", 32: "float", 64: "double"}[self.bits]
        if self.kind == "timestamp":
            return f"timestamp[{self.unit}" + (f", tz={self.tz}]"
                                               if self.tz else "]")
        return {"utf8": "string", "large_utf8": "large_string"}.get(
            self.kind, self.kind)

    def numpy_dtype(self) -> np.dtype:
        if self.kind == "int":
            return np.dtype(f"<i{self.bits // 8}")
        if self.kind == "uint":
            return np.dtype(f"<u{self.bits // 8}")
        if self.kind == "float":
            return np.dtype(f"<f{self.bits // 8}")
        if self.kind == "timestamp":
            return np.dtype(f"datetime64[{self.unit}]")
        raise ValueError(f"{self} has no fixed-width numpy dtype")


@dataclass(frozen=True)
class Field:
    name: str
    type: ArrowType
    nullable: bool = True
    dictionary: Optional[Tuple[int, ArrowType]] = None    # (id, index type)


@dataclass
class Column:
    values: np.ndarray
    valid: Optional[np.ndarray] = None          # None: no null


@dataclass
class Table:
    fields: List[Field]
    columns: List[Column]
    metadata: Dict[str, str] = field(default_factory=dict)


# =============================================================================
# Flatbuffers, read
# =============================================================================
class _FB:
    """A flatbuffer table at ``pos`` of ``buf``."""

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt, self.vt_len = vt, struct.unpack_from("<H", buf, vt)[0]

    @classmethod
    def root(cls, buf: bytes, base: int = 0) -> "_FB":
        return cls(buf, base + struct.unpack_from("<I", buf, base)[0])

    def _at(self, slot: int) -> Optional[int]:
        o = 4 + 2 * slot
        if o + 2 > self.vt_len:
            return None
        off = struct.unpack_from("<H", self.buf, self.vt + o)[0]
        return self.pos + off if off else None

    def scalar(self, slot: int, fmt: str, default=0):
        p = self._at(slot)
        return default if p is None else struct.unpack_from(
            "<" + fmt, self.buf, p)[0]

    def _ref(self, slot: int) -> Optional[int]:
        p = self._at(slot)
        return None if p is None else p + struct.unpack_from(
            "<I", self.buf, p)[0]

    def table(self, slot: int) -> Optional["_FB"]:
        p = self._ref(slot)
        return None if p is None else _FB(self.buf, p)

    def string(self, slot: int) -> Optional[str]:
        p = self._ref(slot)
        if p is None:
            return None
        n = struct.unpack_from("<I", self.buf, p)[0]
        return self.buf[p + 4:p + 4 + n].decode("utf-8")

    def vector(self, slot: int) -> Tuple[int, int]:
        """(position of the first element, length)."""
        p = self._ref(slot)
        if p is None:
            return 0, 0
        return p + 4, struct.unpack_from("<I", self.buf, p)[0]

    def tables(self, slot: int) -> List["_FB"]:
        p, n = self.vector(slot)
        return [_FB(self.buf, p + 4 * i
                    + struct.unpack_from("<I", self.buf, p + 4 * i)[0])
                for i in range(n)]


# =============================================================================
# Flatbuffers, built front to back: a table's children follow it, so every
# uoffset points forward; scalars are aligned to their size
# =============================================================================
class FBTable:
    def __init__(self, *fields):
        # (slot, struct format or "off", value)
        self.fields = [f for f in fields if f[2] is not None]


class FBStructs:
    def __init__(self, data: bytes, n: int):
        self.data, self.n = data, n


class FBVector:
    def __init__(self, items: Sequence):
        self.items = list(items)


class _Builder:
    def __init__(self):
        self.buf = bytearray(4)

    def _pad(self, align: int, extra: int = 0) -> None:
        self.buf += bytes((-(len(self.buf) + extra)) % align)

    def finish(self, root: FBTable) -> bytes:
        struct.pack_into("<I", self.buf, 0, self._place(root))
        self._pad(8)
        return bytes(self.buf)

    def _place(self, obj) -> int:
        if isinstance(obj, FBTable):
            return self._table(obj)
        if isinstance(obj, str):
            obj = obj.encode("utf-8")
        if isinstance(obj, bytes):
            self._pad(4)
            at = len(self.buf)
            self.buf += struct.pack("<I", len(obj)) + obj + b"\0"
            return at
        if isinstance(obj, FBStructs):
            self._pad(8, 4)
            at = len(self.buf)
            self.buf += struct.pack("<I", obj.n) + obj.data
            return at
        if isinstance(obj, FBVector):
            self._pad(4)
            at = len(self.buf)
            self.buf += struct.pack("<I", len(obj.items))
            slots = len(self.buf)
            self.buf += bytes(4 * len(obj.items))
            for i, item in enumerate(obj.items):
                p = self._place(item)
                struct.pack_into("<I", self.buf, slots + 4 * i,
                                 p - (slots + 4 * i))
            return at
        raise TypeError(f"cannot place {type(obj)}")

    def _table(self, t: FBTable) -> int:
        sizes = [4 if fmt == "off" else struct.calcsize("<" + fmt)
                 for _, fmt, _ in t.fields]
        layout, cur = {}, 4
        for i in sorted(range(len(t.fields)), key=lambda i: -sizes[i]):
            cur += (-cur) % sizes[i]
            layout[i] = cur
            cur += sizes[i]
        size = cur + (-cur) % 4
        n_slots = max((s for s, _, _ in t.fields), default=-1) + 1
        vt = [0] * n_slots
        for i, (slot, _, _) in enumerate(t.fields):
            vt[slot] = layout[i]
        vtable = struct.pack(f"<{2 + n_slots}H", 4 + 2 * n_slots, size, *vt)
        self._pad(2)
        v_at = len(self.buf)
        self.buf += vtable
        self._pad(8)
        at = len(self.buf)
        body = bytearray(size)
        struct.pack_into("<i", body, 0, at - v_at)
        for i, (_, fmt, val) in enumerate(t.fields):
            if fmt != "off":
                struct.pack_into("<" + fmt, body, layout[i], val)
        self.buf += body
        for i, (_, fmt, val) in enumerate(t.fields):
            if fmt == "off":
                p = self._place(val)
                struct.pack_into("<I", self.buf, at + layout[i],
                                 p - (at + layout[i]))
        return at


def build_flatbuffer(root: FBTable) -> bytes:
    return _Builder().finish(root)


# =============================================================================
# Schema
# =============================================================================
def _parse_type(f: _FB) -> ArrowType:
    kind = f.scalar(2, "B")
    t = f.table(3)
    if kind == _T_NULL:
        return ArrowType("null")
    if kind == _T_INT:
        bits, signed = t.scalar(0, "i"), t.scalar(1, "?", False)
        return ArrowType("int" if signed else "uint", bits)
    if kind == _T_FLOAT:
        return ArrowType("float", (16, 32, 64)[t.scalar(0, "h")])
    if kind == _T_BOOL:
        return ArrowType("bool")
    if kind == _T_UTF8:
        return ArrowType("utf8")
    if kind == _T_LARGE_UTF8:
        return ArrowType("large_utf8")
    if kind == _T_TIMESTAMP:
        return ArrowType("timestamp", unit=_UNITS[t.scalar(0, "h")],
                         tz=t.string(1))
    raise ValueError(f"arrow: type id {kind} of field {f.string(0)!r} is "
                     "not supported")


def _parse_schema(s: _FB) -> Tuple[List[Field], Dict[str, str]]:
    if s.scalar(0, "h") != 0:
        raise ValueError("arrow: big-endian files are not supported")
    fields = []
    for f in s.tables(1):
        if f.vector(5)[1]:
            raise ValueError(f"arrow: nested field {f.string(0)!r} is not "
                             "supported")
        d = f.table(4)
        dictionary = None
        if d is not None:
            it = d.table(1)
            idx = ArrowType("int", 32) if it is None else ArrowType(
                "int" if it.scalar(1, "?", False) else "uint",
                it.scalar(0, "i"))
            dictionary = (d.scalar(0, "q"), idx)
        fields.append(Field(f.string(0) or "", _parse_type(f),
                            f.scalar(1, "?", False), dictionary))
    meta = {kv.string(0): kv.string(1) for kv in s.tables(2)}
    return fields, meta


def _type_table(t: ArrowType) -> Tuple[int, FBTable]:
    if t.kind in ("int", "uint"):
        return _T_INT, FBTable((0, "i", t.bits), (1, "?", t.kind == "int"))
    if t.kind == "float":
        return _T_FLOAT, FBTable((0, "h", {16: 0, 32: 1, 64: 2}[t.bits]))
    if t.kind == "timestamp":
        return _T_TIMESTAMP, FBTable((0, "h", _UNITS.index(t.unit)),
                                     (1, "off", t.tz))
    kind = {"null": _T_NULL, "bool": _T_BOOL, "utf8": _T_UTF8,
            "large_utf8": _T_LARGE_UTF8}[t.kind]
    return kind, FBTable()


def _schema_table(fields: Sequence[Field], meta: Dict[str, str]) -> FBTable:
    fs = []
    for f in fields:
        kind, tt = _type_table(f.type)
        # an empty children vector: pyarrow refuses a field without one
        fs.append(FBTable((0, "off", f.name), (1, "?", f.nullable),
                          (2, "B", kind), (3, "off", tt),
                          (5, "off", FBVector([]))))
    kvs = [FBTable((0, "off", k), (1, "off", v)) for k, v in meta.items()]
    return FBTable((0, "h", 0), (1, "off", FBVector(fs)),
                   (2, "off", FBVector(kvs) if kvs else None))


# =============================================================================
# Buffers
# =============================================================================
def _bitmap(buf: bytes, n: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(buf, np.uint8), bitorder="little")
    if len(bits) < n:
        raise ValueError("arrow: bitmap shorter than its column")
    return bits[:n].astype(bool)


def _fixed(buf: bytes, dtype: np.dtype, n: int) -> np.ndarray:
    if len(buf) < n * dtype.itemsize:
        raise ValueError("arrow: buffer shorter than its column")
    return np.frombuffer(buf, dtype, n).copy()


def _strings(offsets: np.ndarray, data: bytes) -> np.ndarray:
    n = len(offsets) - 1
    out = np.empty(n, object)
    if n == 0:
        return out
    if offsets[0] < 0 or offsets[-1] > len(data) or \
            (np.diff(offsets) < 0).any():
        raise ValueError("arrow: malformed string offsets")
    lo, hi = offsets[:-1].tolist(), offsets[1:].tolist()
    if data.isascii():
        text = data.decode("ascii")
        out[:] = [text[a:b] for a, b in zip(lo, hi)]
    else:
        out[:] = [data[a:b].decode("utf-8") for a, b in zip(lo, hi)]
    return out


def _array(t: ArrowType, n: int, null_count: int,
           take) -> Column:
    """One column of a record batch; ``take()`` gives its next buffer."""
    if t.kind == "null":
        return Column(np.full(n, None, object), np.zeros(n, bool))
    validity = take()
    valid = _bitmap(validity, n) if null_count and len(validity) else None
    if null_count and valid is None:
        raise ValueError("arrow: nulls without a validity bitmap")
    if t.kind == "bool":
        values = _bitmap(take(), n)
    elif t.kind in _STRINGS:
        odt = np.dtype("<i8" if t.kind == "large_utf8" else "<i4")
        offsets = _fixed(take(), odt, n + 1).astype(np.int64)
        values = _strings(offsets, bytes(take()))
        if valid is not None:
            values[~valid] = None
    else:
        values = _fixed(take(), t.numpy_dtype(), n)
    return Column(values, valid)


def _decompress(buf: bytes, codec: Optional[int]) -> bytes:
    if codec is None or not len(buf):
        return buf
    if len(buf) < 8:
        raise ValueError("arrow: compressed buffer without its length")
    size = struct.unpack_from("<q", buf, 0)[0]
    if size == -1:
        return buf[8:]
    out = (lz4.decompress if codec == 0 else zstd.decompress)(buf[8:])
    if len(out) != size:
        raise ValueError(f"arrow: buffer decompressed to {len(out)} bytes, "
                         f"its prefix says {size}")
    return out


def _read_batch(b: _FB, body: bytes, types: Sequence[ArrowType]
                ) -> List[Column]:
    n = b.scalar(0, "q")
    npos, nn = b.vector(1)
    bpos, nb = b.vector(2)
    comp = b.table(3)
    codec = None if comp is None else comp.scalar(0, "b")
    if codec not in (None, 0, 1):
        raise ValueError(f"arrow: compression codec {codec}")
    if nn != len(types):
        raise ValueError("arrow: record batch has the wrong number of "
                         "columns")
    buffers = []
    for i in range(nb):
        off, length = struct.unpack_from("<qq", b.buf, bpos + 16 * i)
        if off < 0 or off + length > len(body):
            raise ValueError("arrow: buffer outside its message body")
        buffers.append(body[off:off + length])
    it = iter(buffers)

    def take():
        try:
            return _decompress(next(it), codec)
        except StopIteration:
            raise ValueError("arrow: record batch has too few buffers")

    cols = []
    for i, t in enumerate(types):
        length, nulls = struct.unpack_from("<qq", b.buf, npos + 16 * i)
        if length != n:
            raise ValueError("arrow: column length differs from its batch")
        cols.append(_array(t, length, nulls, take))
    return cols


def _message(data: bytes, offset: int) -> Tuple[_FB, bytes]:
    """The message at ``offset``: its flatbuffer and its body."""
    p = offset
    size = struct.unpack_from("<i", data, p)[0]
    p += 4
    if size == -1:                          # the continuation marker
        size = struct.unpack_from("<i", data, p)[0]
        p += 4
    if size <= 0 or p + size > len(data):
        raise ValueError("arrow: malformed message")
    msg = _FB.root(data, p)
    body_len = msg.scalar(3, "q")
    start = p + size
    if body_len < 0 or start + body_len > len(data):
        raise ValueError("arrow: message body runs past the file")
    return msg, data[start:start + body_len]


def _concat(parts: List[Column]) -> Column:
    if len(parts) == 1:
        return parts[0]
    values = np.concatenate([c.values for c in parts])
    if all(c.valid is None for c in parts):
        return Column(values)
    return Column(values, np.concatenate(
        [np.ones(len(c.values), bool) if c.valid is None else c.valid
         for c in parts]))


def _decode_dictionary(idx: Column, dictionary: Column) -> Column:
    codes = idx.values.astype(np.int64)
    valid = idx.valid
    use = codes if valid is None else np.where(valid, codes, 0)
    if len(use) and (use.min() < 0 or use.max() >= len(dictionary.values)):
        raise ValueError("arrow: dictionary index out of range")
    values = dictionary.values[use] if len(dictionary.values) else \
        np.empty(len(use), dictionary.values.dtype)
    dv = dictionary.valid
    if dv is not None:
        valid = dv[use] if valid is None else valid & dv[use]
    if valid is not None and values.dtype == object:
        values = values.copy()
        values[~valid] = None
    return Column(values, valid)


def read_table(path: str) -> Table:
    """A Feather V1 or V2 (Arrow IPC) file."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] == MAGIC_V1:
        return _read_v1(data)
    if data[:6] != MAGIC or data[-6:] != MAGIC or len(data) < 18:
        raise ValueError(f"{path}: not an Arrow IPC (Feather V2) file")
    flen = struct.unpack_from("<i", data, len(data) - 10)[0]
    fstart = len(data) - 10 - flen
    if flen <= 0 or fstart < 8:
        raise ValueError(f"{path}: malformed Arrow footer")
    footer = _FB.root(data[fstart:len(data) - 10])
    fields, meta = _parse_schema(footer.table(1))
    dict_types: Dict[int, ArrowType] = {f.dictionary[0]: f.type
                                        for f in fields if f.dictionary}
    dicts: Dict[int, Column] = {}

    def blocks(slot):
        p, n = footer.vector(slot)
        return [struct.unpack_from("<qiiq", footer.buf, p + 24 * i)
                for i in range(n)]

    for off, _, _, _ in blocks(2):
        msg, body = _message(data, off)
        if msg.scalar(1, "B") != _MSG_DICT:
            raise ValueError(f"{path}: a dictionary block is not a "
                             "dictionary batch")
        d = msg.table(2)
        did = d.scalar(0, "q")
        if did not in dict_types:
            raise ValueError(f"{path}: dictionary {did} has no field")
        col = _read_batch(d.table(1), body, [dict_types[did]])[0]
        if d.scalar(2, "?", False) and did in dicts:
            col = _concat([dicts[did], col])
        dicts[did] = col
    parts: List[List[Column]] = [[] for _ in fields]
    types = [f.dictionary[1] if f.dictionary else f.type for f in fields]
    for off, _, _, _ in blocks(3):
        msg, body = _message(data, off)
        if msg.scalar(1, "B") != _MSG_BATCH:
            raise ValueError(f"{path}: a record batch block is not a "
                             "record batch")
        for i, c in enumerate(_read_batch(msg.table(2), body, types)):
            parts[i].append(c)
    columns = []
    for f, p in zip(fields, parts):
        if not p:
            t = f.type
            p = [Column(np.empty(0, object if t.kind == "null"
                                 or t.kind in _STRINGS else bool
                                 if t.kind == "bool" else t.numpy_dtype()))]
        col = _concat(p)
        if f.dictionary:
            if f.dictionary[0] not in dicts:
                raise ValueError(f"{path}: dictionary of {f.name!r} missing")
            col = _decode_dictionary(col, dicts[f.dictionary[0]])
        columns.append(col)
    return Table(fields, columns, meta)


# =============================================================================
# Feather V1
# =============================================================================
_V1_TYPES = {0: ArrowType("bool"), 1: ArrowType("int", 8),
             2: ArrowType("int", 16), 3: ArrowType("int", 32),
             4: ArrowType("int", 64), 5: ArrowType("uint", 8),
             6: ArrowType("uint", 16), 7: ArrowType("uint", 32),
             8: ArrowType("uint", 64), 9: ArrowType("float", 32),
             10: ArrowType("float", 64), 11: ArrowType("utf8"),
             17: ArrowType("large_utf8")}


def _v1_array(data: bytes, a: _FB, t: ArrowType) -> Column:
    off, n, nulls = a.scalar(2, "q"), a.scalar(3, "q"), a.scalar(4, "q")
    total = a.scalar(5, "q")
    if off < 0 or off + total > len(data):
        raise ValueError("feather v1: column outside the file")
    p = off
    bufs = []
    if nulls:
        nbytes = (n + 7) // 8
        bufs.append(data[p:p + nbytes])
        p += nbytes + (-nbytes) % 8
    else:
        bufs.append(b"")
    if t.kind in _STRINGS:
        osize = 8 if t.kind == "large_utf8" else 4
        nbytes = (n + 1) * osize
        bufs.append(data[p:p + nbytes])
        p += nbytes + (-nbytes) % 8
    bufs.append(data[p:off + total])
    it = iter(bufs)
    return _array(t, n, nulls, lambda: next(it))


def _read_v1(data: bytes) -> Table:
    if data[-4:] != MAGIC_V1:
        raise ValueError("feather v1: missing trailing magic")
    size = struct.unpack_from("<i", data, len(data) - 8)[0]
    ct = _FB.root(data[len(data) - 8 - size:len(data) - 8])
    fields, columns = [], []
    for c in ct.tables(2):
        name = c.string(0) or ""
        values = c.table(1)
        meta_kind, meta = c.scalar(2, "B"), c.table(3)
        vtype = values.scalar(0, "b")
        if meta_kind == 2:                  # TimestampMetadata
            t = ArrowType("timestamp", unit=_UNITS[meta.scalar(0, "b")],
                          tz=meta.string(1))
            col = _v1_array(data, values, ArrowType("int", 64))
            col = Column(col.values.view(t.numpy_dtype()), col.valid)
        elif meta_kind == 1:                # CategoryMetadata
            levels = meta.table(0)
            lt = _V1_TYPES.get(levels.scalar(0, "b"))
            it = _V1_TYPES.get(vtype)
            if lt is None or it is None:
                raise ValueError(f"feather v1: column {name!r}'s category "
                                 "types are not supported")
            col = _decode_dictionary(_v1_array(data, values, it),
                                     _v1_array(data, levels, lt))
            t = lt
        elif meta_kind == 0 and vtype in _V1_TYPES:
            t = _V1_TYPES[vtype]
            col = _v1_array(data, values, t)
        else:
            raise ValueError(f"feather v1: column {name!r} of type {vtype} "
                             "is not supported")
        if col.valid is not None and col.values.dtype.kind == "M":
            col.values[~col.valid] = np.datetime64("NaT")
        fields.append(Field(name, t))
        columns.append(col)
    return Table(fields, columns, {})


# =============================================================================
# Writing
# =============================================================================
def _pack_bits(mask: np.ndarray) -> bytes:
    return np.packbits(mask.astype(bool), bitorder="little").tobytes()


def _column_buffers(t: ArrowType, col: Column, lo: int, hi: int
                    ) -> Tuple[int, List[bytes]]:
    """(null count, the buffers) of rows ``lo:hi`` of one column."""
    n = hi - lo
    valid = None if col.valid is None else col.valid[lo:hi]
    nulls = 0 if valid is None else int(n - valid.sum())
    if t.kind == "null":
        return n, []
    bufs = [_pack_bits(valid) if nulls else b""]
    v = col.values[lo:hi]
    if t.kind == "bool":
        bufs.append(_pack_bits(np.asarray(v, bool) if v.dtype != object
                               else np.array([bool(x) if x is not None
                                              else False for x in v])))
    elif t.kind in _STRINGS:
        items = [b"" if x is None else x.encode("utf-8") for x in v.tolist()]
        if valid is not None:
            items = [x if ok else b"" for x, ok in zip(items,
                                                       valid.tolist())]
        lens = np.fromiter(map(len, items), np.int64, n)
        odt = "<i8" if t.kind == "large_utf8" else "<i4"
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        if odt == "<i4" and offsets[-1] >= 1 << 31:
            raise ValueError("arrow: string column too large for utf8")
        bufs += [offsets.astype(odt).tobytes(), b"".join(items)]
    else:
        bufs.append(np.ascontiguousarray(
            v.astype(t.numpy_dtype(), copy=False)).view(np.uint8).tobytes())
    return nulls, bufs


def _compress(buf: bytes, codec: Optional[int]) -> bytes:
    if codec is None or not buf:
        return buf
    frame = lz4.compress(buf)
    if len(frame) >= len(buf):
        return struct.pack("<q", -1) + buf
    return struct.pack("<q", len(buf)) + frame


def _encapsulate(fb: bytes) -> bytes:
    pad = (-(8 + len(fb))) % 8
    return struct.pack("<Ii", 0xFFFFFFFF, len(fb) + pad) + fb + bytes(pad)


def _message_fb(kind: int, header: FBTable, body_len: int) -> bytes:
    return build_flatbuffer(FBTable((0, "h", 4), (1, "B", kind),
                                    (2, "off", header), (3, "q", body_len)))


def write_table(path: str, fields: Sequence[Field],
                columns: Sequence[Column], metadata: Dict[str, str],
                compression: str = "lz4") -> None:
    """An Arrow IPC file (Feather V2) of ``columns`` in record batches of
    CHUNK_ROWS rows; ``compression`` is ``"lz4"`` or ``"uncompressed"``."""
    codecs = {"lz4": 0, "uncompressed": None}
    if compression not in codecs:
        raise ValueError(f"arrow: compression {compression!r} is not "
                         "written")
    codec = codecs[compression]
    if any(f.dictionary for f in fields):
        raise ValueError("arrow: dictionary-encoded fields are not written")
    n = len(columns[0].values) if columns else 0
    out = bytearray(MAGIC + b"\0\0")
    schema = _schema_table(fields, metadata)
    out += _encapsulate(_message_fb(_MSG_SCHEMA, schema, 0))
    blocks = []
    starts = range(0, n, CHUNK_ROWS) if n else [0]
    for lo in starts:
        hi = min(lo + CHUNK_ROWS, n)
        nodes, specs, body = [], [], bytearray()
        for f, col in zip(fields, columns):
            nulls, bufs = _column_buffers(f.type, col, lo, hi)
            nodes.append(struct.pack("<qq", hi - lo, nulls))
            for b in bufs:
                b = _compress(b, codec)
                specs.append(struct.pack("<qq", len(body), len(b)))
                body += b + bytes((-len(b)) % 8)
        batch = FBTable(
            (0, "q", hi - lo),
            (1, "off", FBStructs(b"".join(nodes), len(nodes))),
            (2, "off", FBStructs(b"".join(specs), len(specs))),
            (3, "off", None if codec is None else
             FBTable((0, "b", codec), (1, "b", 0))))
        meta = _encapsulate(_message_fb(_MSG_BATCH, batch, len(body)))
        blocks.append(struct.pack("<qiiq", len(out), len(meta), 0,
                                  len(body)))
        out += meta + body
    out += struct.pack("<Ii", 0xFFFFFFFF, 0)         # end of stream
    footer = build_flatbuffer(FBTable(
        (0, "h", 4), (1, "off", schema),
        (2, "off", FBStructs(b"", 0)),
        (3, "off", FBStructs(b"".join(blocks), len(blocks)))))
    out += footer + struct.pack("<i", len(footer)) + MAGIC
    with open(path, "wb") as fh:
        fh.write(out)
