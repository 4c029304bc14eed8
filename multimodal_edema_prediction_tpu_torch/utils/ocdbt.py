"""The OCDBT key-value store (tensorstore's "OCDBT on-disk format") over a
directory, read and written in Python and numpy.

An orbax checkpoint keeps its arrays in one: ``<step>/default/`` holds a
``manifest.ocdbt`` and data files under ``d/``. The card's host has neither
orbax nor tensorstore, so the port keeps its own store.

Every file of the format starts with a header and ends with a footer:

    magic      uint32 big-endian (0x0CDB3A2A manifest, 0x0CDB20DE node)
    length     uint64 little-endian, the whole file's
    version    varint (0)
    compression varint (0 none, 1 zstd: the rest up to the footer is one
               Zstandard frame)
    ...body...
    crc32c     uint32 little-endian, of every byte before it

Varints are LEB128. The manifest's body is the config (uuid, manifest kind,
``max_inline_value_bytes``, ``max_decoded_node_bytes``,
``version_tree_arity_log2``, compression method with an int32 zstd level),
a data-file table, and the inline versions of the version tree, each a
B+tree root (generation, height, location, key count, node bytes, indirect
value bytes, commit time). A data-file table lists paths relative to the
store's directory, each coded against the one before it (shared prefix
length, suffix length, base-path length, then the suffixes), so that the
top store of orbax's two-level layout refers into
``ocdbt.process_0/d/``.

A B+tree node's body is its height, its own data-file table and its
entries in columns. Keys are prefix-coded against the entry before, and
relative to the prefix that the parent's entry strips from the whole
subtree (``subtree_common_prefix_length``). A leaf's values are inline
(bytes in the node) or indirect (a data file, an offset and the value's
length); an interior entry points to a child node by data file, offset and
length, with the subtree's key count, node bytes and indirect bytes.

:class:`Store` reads the latest version of a store (nodes uncompressed or
zstd, every CRC checked) and :func:`write_store` writes one version: the
values longer than ``max_inline_value_bytes`` and then the nodes, leaves
first, into one data file, uncompressed, in as many levels as the key count
needs, and the manifest last. Anything else raises ``ValueError`` naming
what it met: another magic or format version, a compression method other
than none or zstd, a CRC-32C mismatch, a numbered manifest, trailing or
missing bytes, a data file outside the store.
"""
from __future__ import annotations

import os
import time
import uuid as uuidlib
from typing import Dict, Iterable, List, NamedTuple, Tuple, Union

from .crc32c import crc32c
from .zstd import decompress as zstd_decompress

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
MANIFEST = "manifest.ocdbt"
# orbax's settings (``max_inline_value_bytes``, ``max_decoded_node_bytes``)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
_MISSING = (1 << 64) - 1          # the location of an empty tree's root
_HEADER = 4 + 8                   # magic and length, before the varints

Key = Union[str, bytes]


def _key(k: Key) -> bytes:
    return k.encode() if isinstance(k, str) else bytes(k)


# =============================================================================
# Files: header, body, footer
# =============================================================================
class _Cursor:
    """Reads varints, bytes and little-endian words from a body."""

    def __init__(self, buf: bytes, what: str):
        self.buf, self.p, self.what = buf, 0, what

    def varint(self) -> int:
        v = shift = 0
        while True:
            if self.p >= len(self.buf):
                raise ValueError(f"{self.what}: truncated varint")
            b = self.buf[self.p]
            self.p += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.p + n > len(self.buf):
            raise ValueError(f"{self.what}: truncated ({n} bytes wanted at "
                             f"{self.p} of {len(self.buf)})")
        out = self.buf[self.p:self.p + n]
        self.p += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def u64s(self, n: int) -> List[int]:
        return [int.from_bytes(self.take(8), "little") for _ in range(n)]

    def end(self) -> None:
        if self.p != len(self.buf):
            raise ValueError(f"{self.what}: {len(self.buf) - self.p} "
                             "trailing bytes")


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(vs: Iterable[int]) -> bytes:
    return b"".join(_varint(v) for v in vs)


def decode_file(raw: bytes, magic: int, what: str) -> bytes:
    """The body of one manifest or node, its header and CRC-32C checked
    and its compression undone."""
    raw = bytes(raw)
    if len(raw) < _HEADER + 2 + 4:
        raise ValueError(f"{what}: {len(raw)} bytes is too short")
    got = int.from_bytes(raw[:4], "big")
    if got != magic:
        raise ValueError(f"{what}: magic {got:#010x}, expected "
                         f"{magic:#010x}")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise ValueError(f"{what}: header says {length} bytes, the file "
                         f"holds {len(raw)}")
    want = int.from_bytes(raw[-4:], "little")
    crc = crc32c(raw[:-4])
    if crc != want:
        raise ValueError(f"{what}: CRC-32C mismatch (stored {want:#010x}, "
                         f"computed {crc:#010x})")
    c = _Cursor(raw[:-4], what)
    c.p = _HEADER
    version = c.varint()
    if version != FORMAT_VERSION:
        raise ValueError(f"{what}: format version {version} is not "
                         f"supported (only {FORMAT_VERSION})")
    method = c.varint()
    body = raw[c.p:-4]
    if method == 0:
        return body
    if method == 1:
        return zstd_decompress(body)
    raise ValueError(f"{what}: compression format {method} is not "
                     "supported (0 none, 1 zstd)")


def encode_file(body: bytes, magic: int) -> bytes:
    """A manifest or node around ``body``, uncompressed."""
    head = _varint(FORMAT_VERSION) + _varint(0)
    n = _HEADER + len(head) + len(body) + 4
    raw = magic.to_bytes(4, "big") + n.to_bytes(8, "little") + head + body
    return raw + crc32c(raw).to_bytes(4, "little")


def _read_file_table(c: _Cursor) -> List[str]:
    n = c.varint()
    prefix = [0] + c.varints(max(n - 1, 0))
    suffix = c.varints(n)
    base = c.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{c.what}: data file {i} shares {prefix[i]} "
                             f"bytes with a {len(prev)}-byte path")
        prev = prev[:prefix[i]] + c.take(suffix[i])
        if base[i] > len(prev):
            raise ValueError(f"{c.what}: data file {i}'s base path is "
                             "longer than its path")
        paths.append(prev.decode())
    return paths


def _write_file_table(paths: List[str]) -> bytes:
    raw = [p.encode() for p in paths]
    prefix = [_common(a, b) for a, b in zip(raw, raw[1:])]
    suffix = [raw[0]] + [b[k:] for b, k in zip(raw[1:], prefix)] \
        if raw else []
    return (_varint(len(raw)) + _varints(prefix)
            + _varints(len(s) for s in suffix) + _varints(0 for _ in raw)
            + b"".join(suffix))


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _safe_path(directory: str, rel: str, what: str) -> str:
    parts = rel.split("/")
    if not rel or rel.startswith("/") or ".." in parts:
        raise ValueError(f"{what}: data file {rel!r} is not a path inside "
                         "the store")
    return os.path.join(directory, *parts)


# =============================================================================
# Reader
# =============================================================================
class Store:
    """The latest version of the OCDBT store in ``directory``: its keys
    (bytes, sorted) and their values, read on demand."""

    def __init__(self, directory: str):
        self.directory = directory
        path = os.path.join(directory, MANIFEST)
        with open(path, "rb") as f:
            body = decode_file(f.read(), MANIFEST_MAGIC, path)
        c = _Cursor(body, path)
        c.take(16)                  # the store's uuid
        kind = c.varint()
        if kind != 0:
            raise ValueError(f"{path}: manifest kind {kind} (numbered "
                             "manifests) is not supported, only 0 (single)")
        # max_inline_value_bytes, max_decoded_node_bytes: a writer's limits
        c.varints(2)
        c.byte()                    # version_tree_arity_log2
        method = c.varint()
        if method == 1:
            c.take(4)               # the writer's zstd level, int32
        elif method != 0:
            raise ValueError(f"{path}: compression method {method} is not "
                             "supported (0 none, 1 zstd)")
        files = _read_file_table(c)
        n = c.varint()
        if n == 0:
            raise ValueError(f"{path}: the manifest holds no version")
        gen = c.varints(n)
        height = [c.byte() for _ in range(n)]
        file_id, offset, length = c.varints(n), c.varints(n), c.varints(n)
        self._stats = list(zip(c.varints(n), c.varints(n), c.varints(n)))
        commit = c.u64s(n)
        # the older versions' tree nodes follow; only the latest is read
        i = max(range(n), key=gen.__getitem__)
        self.generation, self.commit_time_ns = gen[i], commit[i]
        self.num_keys = self._stats[i][0]
        self._entries: Dict[bytes, tuple] = {}
        if offset[i] == _MISSING and length[i] == _MISSING:
            if self.num_keys:
                raise ValueError(f"{path}: an empty root with "
                                 f"{self.num_keys} keys")
        else:
            if file_id[i] >= len(files):
                raise ValueError(f"{path}: root in data file {file_id[i]} "
                                 f"of {len(files)}")
            self._node(files[file_id[i]], offset[i], length[i], height[i],
                       b"")
        if len(self._entries) != self.num_keys:
            raise ValueError(f"{path}: the tree holds {len(self._entries)} "
                             f"keys, the manifest says {self.num_keys}")

    def _slice(self, rel: str, offset: int, length: int, what: str) -> bytes:
        path = _safe_path(self.directory, rel, what)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{what}: {path} holds {len(data)} bytes at "
                             f"{offset}, {length} wanted")
        return data

    def _node(self, rel: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        what = f"{self.directory}: node {rel}@{offset}"
        c = _Cursor(decode_file(self._slice(rel, offset, length, what),
                                NODE_MAGIC, what), what)
        got = c.byte()
        if got != height:
            raise ValueError(f"{what}: height {got}, its parent says "
                             f"{height}")
        files = _read_file_table(c)
        n = c.varint()
        key_prefix = [0] + c.varints(max(n - 1, 0))
        key_suffix = c.varints(n)
        subtree = c.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            if key_prefix[i] > len(prev):
                raise ValueError(f"{what}: key {i} shares {key_prefix[i]} "
                                 f"bytes with a {len(prev)}-byte key")
            prev = prev[:key_prefix[i]] + c.take(key_suffix[i])
            keys.append(prev)

        def file_of(j: int) -> str:
            if j >= len(files):
                raise ValueError(f"{what}: data file {j} of {len(files)}")
            return files[j]

        if height:
            ids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
            c.varints(3 * n)            # the subtrees' statistics
            c.end()
            for i in range(n):
                if subtree[i] > len(keys[i]):
                    raise ValueError(f"{what}: subtree prefix longer than "
                                     "its key")
                self._node(file_of(ids[i]), offs[i], lens[i], height - 1,
                           prefix + keys[i][:subtree[i]])
            return
        lengths = c.varints(n)
        kinds = c.varints(n)
        if any(k > 1 for k in kinds):
            raise ValueError(f"{what}: value kind {max(kinds)} (0 inline, "
                             "1 indirect)")
        k = sum(kinds)
        ids, offs = c.varints(k), c.varints(k)
        j = 0
        for i in range(n):
            if kinds[i]:
                ref = (file_of(ids[j]), offs[j], lengths[i])
                j += 1
            else:
                ref = (None, c.take(lengths[i]), lengths[i])
            self._entries[prefix + keys[i]] = ref
        c.end()

    def keys(self) -> List[bytes]:
        return sorted(self._entries)

    def __contains__(self, key: Key) -> bool:
        return _key(key) in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def read(self, key: Key) -> bytes:
        """The value of ``key``; ``KeyError`` when the store has none."""
        k = _key(key)
        if k not in self._entries:
            raise KeyError(f"{self.directory}: no key {k!r}")
        rel, data, length = self._entries[k]
        if rel is None:
            return data
        return self._slice(rel, data, length, f"{self.directory}: value "
                                              f"{k!r}")


# =============================================================================
# Writer
# =============================================================================
def _leaf_body(keys: List[bytes], values: List[Tuple[bool, object, int]],
               data_file: str) -> bytes:
    """``values``: (indirect, inline bytes or offset, length) per key."""
    indirect = [v for v in values if v[0]]
    return b"".join([
        b"\x00", _write_file_table([data_file] if indirect else []),
        _varint(len(keys)),
        _varints(_common(a, b) for a, b in zip(keys, keys[1:])),
        _varints(len(k) - p for k, p in zip(keys, [0] + [
            _common(a, b) for a, b in zip(keys, keys[1:])])),
        _suffixes(keys),
        _varints(v[2] for v in values), _varints(int(v[0]) for v in values),
        _varints(0 for _ in indirect), _varints(v[1] for v in indirect),
        b"".join(v[1] for v in values if not v[0])])


def _suffixes(keys: List[bytes]) -> bytes:
    out, prev = [], b""
    for k in keys:
        out.append(k[_common(prev, k):])
        prev = k
    return b"".join(out)


def _interior_body(height: int, keys: List[bytes], subtree: List[int],
                   children: List[tuple], data_file: str) -> bytes:
    """``children``: (offset, length, keys, tree bytes, indirect bytes)."""
    shared = [_common(a, b) for a, b in zip(keys, keys[1:])]
    return b"".join([
        bytes([height]), _write_file_table([data_file]),
        _varint(len(keys)), _varints(shared),
        _varints(len(k) - p for k, p in zip(keys, [0] + shared)),
        _varints(subtree), _suffixes(keys),
        _varints(0 for _ in children),
        *(_varints(ch[i] for ch in children) for i in range(5))])


class _Subtree(NamedTuple):
    """A node the writer wrote: its subtree's first and last keys, the
    prefix its keys are stored without, and what its parent's entry
    holds."""
    first: bytes
    last: bytes
    prefix: bytes
    offset: int
    length: int
    num_keys: int
    tree_bytes: int
    indirect_bytes: int


def _lcp(keys: List[bytes]) -> bytes:
    """The longest common prefix of sorted ``keys``."""
    return keys[0][:_common(keys[0], keys[-1])]


def write_store(directory: str, items: Dict[Key, bytes],
                max_inline_value_bytes: int = MAX_INLINE_VALUE_BYTES,
                max_decoded_node_bytes: int = MAX_DECODED_NODE_BYTES) -> dict:
    """Write ``items`` as a new OCDBT store (one version, generation 1)
    into ``directory``, which holds no store yet. Nodes hold at most
    ``max_decoded_node_bytes`` bytes each where a node of two entries
    fits. Returns the version's statistics."""
    if os.path.exists(os.path.join(directory, MANIFEST)):
        raise ValueError(f"{directory} already holds an OCDBT store")
    os.makedirs(os.path.join(directory, "d"), exist_ok=True)
    data_file = "d/" + uuidlib.uuid4().hex
    entries = sorted((_key(k), v) for k, v in items.items())
    with open(_safe_path(directory, data_file, directory), "wb") as f:
        offset = 0
        values = []
        for _, v in entries:
            v = bytes(v)
            if len(v) > max_inline_value_bytes:
                f.write(v)
                values.append((True, offset, len(v)))
                offset += len(v)
            else:
                values.append((False, v, len(v)))
        indirect_total = offset
        level: List[_Subtree] = []      # the nodes of one level
        height = 0

        def emit(body: bytes) -> Tuple[int, int]:
            nonlocal offset
            raw = encode_file(body, NODE_MAGIC)
            f.write(raw)
            offset += len(raw)
            return offset - len(raw), len(raw)

        if entries:
            groups = _pack([len(k) + v[2] * (not v[0]) + 24
                            for (k, _), v in zip(entries, values)],
                           max_decoded_node_bytes)
            for lo, hi in groups:
                keys = [k for k, _ in entries[lo:hi]]
                # the root's keys are whole; a child's lose their prefix
                prefix = _lcp(keys) if len(groups) > 1 else b""
                off, n = emit(_leaf_body(
                    [k[len(prefix):] for k in keys], values[lo:hi],
                    data_file))
                level.append(_Subtree(
                    keys[0], keys[-1], prefix, off, n, hi - lo, n,
                    sum(v[2] for v in values[lo:hi] if v[0])))
            while len(level) > 1:
                height += 1
                groups = _pack([len(e.first) + 40 for e in level],
                               max_decoded_node_bytes)
                up = []
                for lo, hi in groups:
                    kids = level[lo:hi]
                    first, last = kids[0].first, kids[-1].last
                    prefix = first[:_common(first, last)] \
                        if len(groups) > 1 else b""
                    off, n = emit(_interior_body(
                        height, [e.first[len(prefix):] for e in kids],
                        [len(e.prefix) - len(prefix) for e in kids],
                        [e[3:] for e in kids], data_file))
                    up.append(_Subtree(
                        first, last, prefix, off, n,
                        sum(e.num_keys for e in kids),
                        n + sum(e.tree_bytes for e in kids),
                        sum(e.indirect_bytes for e in kids)))
                level = up
    root = level[0] if level else None
    manifest = b"".join([
        uuidlib.uuid4().bytes, _varint(0), _varint(max_inline_value_bytes),
        _varint(max_decoded_node_bytes), bytes([VERSION_TREE_ARITY_LOG2]),
        _varint(0),
        _write_file_table([data_file] if root else [""]),
        _varint(1), _varint(1), bytes([height]), _varint(0),
        _varint(root.offset if root else _MISSING),
        _varint(root.length if root else _MISSING),
        _varint(len(entries)), _varint(root.tree_bytes if root else 0),
        _varint(indirect_total),
        time.time_ns().to_bytes(8, "little"),
        _varint(0)])
    with open(os.path.join(directory, MANIFEST), "wb") as f:
        f.write(encode_file(manifest, MANIFEST_MAGIC))
    return {"num_keys": len(entries), "height": height,
            "num_tree_bytes": root.tree_bytes if root else 0,
            "num_indirect_value_bytes": indirect_total}


def _pack(sizes: List[int], budget: int) -> List[Tuple[int, int]]:
    """Consecutive runs of ``sizes`` of at most ``budget`` each (at least
    two entries a run, so that every level shrinks)."""
    runs, lo, total = [], 0, 0
    for i, s in enumerate(sizes):
        if i - lo >= 2 and total + s > budget:
            runs.append((lo, i))
            lo, total = i, 0
        total += s
    runs.append((lo, len(sizes)))
    if len(runs) > 1 and runs[-1][1] - runs[-1][0] < 2:
        # a lone last entry joins the run before it
        (a, _), (_, b) = runs[-2], runs[-1]
        runs[-2:] = [(a, b)]
    return runs
