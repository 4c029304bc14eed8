"""Tables as dicts of numpy columns, and the verbs the L0 chain needs.

The JAX package's L0 chain (``data/raw_mimic.py``) is written on pandas;
the port's is not, since the card's host has neither pandas nor pyarrow. A
"frame" here is a plain ``dict[str, np.ndarray]`` of equal-length columns,
in column order:

- integers are ``int64``, floats ``float64`` (``NaN`` for a missing value),
  booleans ``bool``;
- datetimes are ``datetime64[ns]`` with ``NaT`` (the CXR catalog's
  ``cxrtime`` stays ``datetime64[ms]``, as JAX's frame has it);
- strings are ``object`` arrays of ``str``, with ``None`` where pandas
  has NaN.

Each verb reproduces what the pandas call it stands for does, down to the
order of rows and of floating-point operations: ``read_csv`` infers the
column types as pandas' C parser does and parses floats with that parser's
own algorithm (``precise_xstrtod``, which is not correctly rounded);
grouped sums and means use pandas' Kahan summation; ``merge`` keeps the
left frame's order (``inner`` / ``left``) or sorts the keys (``outer``);
sorts are stable. ``read_feather`` and ``write_feather`` stand for
``pd.read_feather`` and ``DataFrame.to_feather``, on :mod:`.arrow_ipc`.
"""
from __future__ import annotations

import csv
import gzip
import io
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import arrow_ipc

Frame = Dict[str, np.ndarray]

# pandas' default ``na_values`` (``pandas/_libs/parsers.pyx``)
NA_VALUES = ("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
             "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN",
             "None", "n/a", "nan", "null")
_TRUE = ("True", "TRUE", "true")
_FALSE = ("False", "FALSE", "false")
_INF = {"inf": np.inf, "+inf": np.inf, "infinity": np.inf,
        "+infinity": np.inf, "-inf": -np.inf, "-infinity": -np.inf}
_POW10 = np.array([float(f"1e{k}") for k in range(309)])


# =============================================================================
# Columns
# =============================================================================
def nrows(f: Frame) -> int:
    return len(next(iter(f.values()))) if f else 0


def isnull(col: np.ndarray) -> np.ndarray:
    """pandas' ``isna`` for one column."""
    col = np.asarray(col)
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype.kind in "mM":
        return np.isnat(col)
    if col.dtype == object:
        return np.fromiter((v is None or (isinstance(v, float) and v != v)
                            for v in col), bool, len(col))
    return np.zeros(len(col), bool)


def take(f: Frame, rows) -> Frame:
    """Rows by position or boolean mask, every column."""
    return {k: v[rows] for k, v in f.items()}


def select(f: Frame, cols: Sequence[str]) -> Frame:
    return {c: f[c] for c in cols}


def concat(frames: Sequence[Frame]) -> Frame:
    """``pd.concat(..., ignore_index=True)`` of frames with the same
    columns."""
    return {c: np.concatenate([f[c] for f in frames]) for c in frames[0]}


def with_nulls(col: np.ndarray, missing: np.ndarray) -> np.ndarray:
    """``col`` with the rows of ``missing`` set to null, upcast as pandas
    does when a merge or a reindex brings in missing rows: integers to
    float64, booleans to object."""
    if not missing.any():
        return col
    if col.dtype.kind in "iu":
        col = col.astype(np.float64)
    elif col.dtype.kind == "b":
        col = col.astype(object)
    else:
        col = col.copy()
    if col.dtype.kind == "f":
        col[missing] = np.nan
    elif col.dtype.kind in "mM":
        col[missing] = np.datetime64("NaT")
    else:
        col[missing] = None
    return col


def fillna(col: np.ndarray, value) -> np.ndarray:
    miss = isnull(col)
    if not miss.any():
        return col
    out = col.copy()
    out[miss] = value
    return out


# =============================================================================
# CSV
# =============================================================================
def read_csv(path: str, dates: Sequence[str] = ()) -> Frame:
    """``pd.read_csv(path)`` for a ``.csv`` or ``.csv.gz`` file, with the
    columns named in ``dates`` through ``pd.to_datetime`` as
    ``datetime64[ns]``."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8-sig", newline="") as fh:
        text = fh.read()
    if '"' in text or "\r" in text:
        rows = [r for r in csv.reader(io.StringIO(text, newline="")) if r]
    else:                               # no quoting: a plain split
        rows = [ln.split(",") for ln in text.split("\n") if ln]
    if not rows:
        raise ValueError(f"{path}: no columns to parse")
    header, body = rows[0], rows[1:]
    if len(set(header)) != len(header):
        raise ValueError(f"{path}: duplicate column names {header}")
    w = len(header)
    for i, r in enumerate(body):
        if len(r) > w:
            raise ValueError(f"{path}: row {i + 2} has {len(r)} fields, "
                             f"the header {w}")
        if len(r) < w:
            body[i] = r + [""] * (w - len(r))
    cols = list(zip(*body)) if body else [()] * w
    return {name: (_datetimes(c) if name in dates else infer_column(c))
            for name, c in zip(header, cols)}


_NA = frozenset(NA_VALUES)


def _datetimes(fields: Sequence[str]) -> np.ndarray:
    """``pd.to_datetime`` of a column of text fields (NA → NaT)."""
    return np.array(["NaT" if v in _NA else v for v in fields],
                    "datetime64[ns]")


def infer_column(fields: Sequence[str]) -> np.ndarray:
    """The dtype pandas' C parser gives a column of text fields: int64 when
    every field is an integer, bool when every field is a boolean word,
    float64 when every field that is not NA is a float (NA → NaN),
    otherwise strings (NA → None)."""
    n = len(fields)
    na = np.fromiter((v in _NA for v in fields), bool, n)
    if n == 0 or na.all():
        return np.full(n, np.nan)
    s = np.array(fields, dtype=str)
    if not na.any():
        try:
            ints = s.astype(np.int64)
            if not any("_" in v for v in fields):   # numpy takes "1_000"
                return ints
        except (ValueError, OverflowError):
            pass
        if np.isin(s, _TRUE + _FALSE).all():
            return np.isin(s, _TRUE)
    vals = parse_floats(s[~na])
    if vals is not None:
        out = np.full(n, np.nan)
        out[~na] = vals
        return out
    out = s.astype(object)
    out[na] = None
    if np.isin(s[~na], _TRUE + _FALSE).all():
        out[~na] = np.isin(s[~na], _TRUE)
    return out


def parse_floats(s: np.ndarray) -> Optional[np.ndarray]:
    """pandas' float parser (``precise_xstrtod`` of
    ``pandas/_libs/src/parser/tokenizer.c``), vectorized: up to 17 digits
    accumulated as ``number * 10 + digit`` in float64, then one division or
    multiplication by a power of ten. None if any field is not a float."""
    try:
        b = s.astype("S")
    except UnicodeEncodeError:
        return None
    n, w = len(b), max(b.dtype.itemsize, 1)
    m = np.frombuffer(b.tobytes(), np.uint8).reshape(n, w) if n \
        else np.zeros((0, w), np.uint8)
    number = np.zeros(n)
    nd = np.zeros(n, np.int64)           # mantissa digits taken (max 17)
    ndec = np.zeros(n, np.int64)         # of which after the point
    extra = np.zeros(n, np.int64)        # integer digits past the 17th
    ek = np.zeros(n, np.int64)           # exponent digits' value
    edig = np.zeros(n, np.int64)
    neg = np.zeros(n, bool)
    eneg = np.zeros(n, bool)
    # 0 start, 1 integer part, 2 fraction, 3 after 'e', 4 exponent, 5 end
    state = np.zeros(n, np.int8)
    ok = np.ones(n, bool)
    for j in range(w):
        c = m[:, j]
        digit = (c >= 48) & (c <= 57)
        d = c.astype(np.float64) - 48.0
        sign = (c == 43) | (c == 45)
        pad = c == 0
        e = (c == 101) | (c == 69)
        dot = c == 46
        s0, s1, s2 = state == 0, state == 1, state == 2
        s3, s4, s5 = state == 3, state == 4, state == 5
        # the mantissa's digits
        a = digit & (s0 | s1)
        take_ = a & (nd < 17)
        number[take_] = number[take_] * 10.0 + d[take_]
        nd[take_] += 1
        extra[a & ~take_] += 1
        f = digit & s2
        take_ = f & (nd < 17)
        number[take_] = number[take_] * 10.0 + d[take_]
        nd[take_] += 1
        ndec[take_] += 1
        # the exponent's digits
        x = digit & (s3 | s4)
        ok &= ~(x & (edig >= 17))
        ek[x] = ek[x] * 10 + (c[x].astype(np.int64) - 48)
        edig[x] += 1
        neg |= s0 & (c == 45)
        eneg |= s3 & (c == 45)
        new = state.copy()
        new[(s0 & sign) | a] = 1
        new[(s0 | s1) & dot] = 2
        new[(s1 | s2) & e] = 3
        new[(s3 & sign) | x] = 4
        new[(s1 | s2 | s4) & pad] = 5
        good = ((s0 & (sign | digit | dot)) | (s1 & (digit | dot | e | pad))
                | (s2 & (digit | e | pad)) | (s3 & (sign | digit))
                | (s4 & (digit | (pad & (edig > 0)))) | (s5 & pad))
        ok &= good
        state = new
        if not ok.all() and not np.isin(np.char.lower(s[~ok]),
                                        list(_INF)).all():
            return None                 # not a float column: stop early
    ok &= (state == 1) | (state == 2) | (state == 5) | ((state == 4)
                                                        & (edig > 0))
    ok &= nd > 0
    number = np.where(neg, -number, number)
    exp = extra - ndec + np.where(eneg, -ek, ek)
    ok &= exp <= 308
    expc = np.clip(exp, -616, 308)
    up = expc > 0
    mid = (expc <= 0) & (expc >= -308)
    low_ = (expc < -308) & (exp >= -616)
    out = number.copy()
    out[up] = number[up] * _POW10[expc[up]]
    out[mid] = number[mid] / _POW10[-expc[mid]]
    out[low_] = number[low_] / _POW10[-308 - expc[low_]] / _POW10[308]
    out[exp < -616] = 0.0
    ok &= ~np.isinf(out)
    if not ok.all():                    # the words pandas reads as ±inf
        low = np.char.lower(s[~ok])
        inf = np.isin(low, list(_INF))
        out[np.flatnonzero(~ok)[inf]] = [_INF[v] for v in low[inf]]
        ok[np.flatnonzero(~ok)[inf]] = True
    return out if ok.all() else None


def _format_column(col: np.ndarray) -> List[str]:
    """The text ``DataFrame.to_csv`` writes for each value of a column."""
    if col.dtype.kind == "M":
        ns = col.astype("datetime64[ns]")
        nat = np.isnat(ns)
        t = ns[~nat]
        if (t != t.astype("datetime64[s]")).any():
            raise ValueError("sub-second datetimes are not written")
        unit = "D" if (t == t.astype("datetime64[D]")).all() else "s"
        txt = np.char.replace(np.datetime_as_string(ns, unit=unit), "T", " ")
        return ["" if z else v for v, z in zip(txt.tolist(), nat)]
    if col.dtype.kind == "f":
        txt = col.astype(np.float64).astype(str)
        txt[np.isnan(col)] = ""
        return txt.tolist()
    if col.dtype.kind in "iub":
        return col.astype(str).tolist()
    return ["" if v is None or (isinstance(v, float) and v != v) else str(v)
            for v in col]


def write_csv(path: str, f: Frame) -> None:
    """``DataFrame.to_csv(path, index=False)``."""
    cols = [_format_column(np.asarray(v)) for v in f.values()]
    with open(path, "w", encoding="utf-8", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(list(f))
        w.writerows(zip(*cols))


# =============================================================================
# Keys, groups, sorts
# =============================================================================
def _ranks(cols: Sequence[np.ndarray]) -> Tuple[List[np.ndarray],
                                               np.ndarray]:
    """Per column: each row's rank among the column's sorted distinct
    values (nulls last, all equal), and which rows hold a null in any key
    column. The columns may be of several frames, concatenated."""
    ranks, null = [], np.zeros(len(cols[0]), bool)
    for c in cols:
        c = np.asarray(c)
        miss = isnull(c)
        null |= miss
        r = np.zeros(len(c), np.int64)
        vals = c[~miss]
        if len(vals) and vals.dtype == object:
            uniq = sorted(set(vals.tolist()))
            pos = {v: i for i, v in enumerate(uniq)}
            r[~miss] = [pos[v] for v in vals.tolist()]
            r[miss] = len(uniq)
        elif len(vals):
            _, inv = np.unique(vals, return_inverse=True)
            r[~miss] = inv.ravel()
            r[miss] = inv.max() + 1
        ranks.append(r)
    return ranks, null


def _combine(ranks: Sequence[np.ndarray]) -> np.ndarray:
    """One int64 code per row that orders rows as the tuples of their
    ranks do."""
    code = ranks[0]
    for r in ranks[1:]:
        width = int(r.max()) + 1 if len(r) else 1
        if len(code) and int(code.max()) + 1 > (2 ** 62) // width:
            code = np.unique(code, return_inverse=True)[1].ravel()
        code = code * width + r
    return code


def group_rows(keys: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """``groupby(keys, sort=True, dropna=True)``: each row's group number
    (-1 for a row with a null key) and, for each group in sorted order,
    the position of its first row."""
    ranks, null = _ranks(keys)
    n = len(null)
    order = np.lexsort(ranks[::-1]) if n else np.zeros(0, np.int64)
    order = order[~null[order]]
    if not len(order):
        return np.full(n, -1, np.int64), np.zeros(0, np.int64)
    r = np.stack([x[order] for x in ranks])
    new = np.r_[True, (r[:, 1:] != r[:, :-1]).any(0)]
    gid = np.cumsum(new) - 1
    codes = np.full(n, -1, np.int64)
    codes[order] = gid
    return codes, order[new]


def sort_values(f: Frame, by: Sequence[str]) -> Frame:
    """``sort_values(by)``: stable, nulls last."""
    ranks, _ = _ranks([f[c] for c in by])
    return take(f, np.lexsort(ranks[::-1]) if len(ranks[0])
                else np.zeros(0, np.int64))


def group_last(codes, n_groups, values) -> np.ndarray:
    """``agg("last")``: each group's last non-null value (null if none)."""
    rows = np.flatnonzero((codes >= 0) & ~isnull(values))
    last = np.full(n_groups, -1, np.int64)
    np.maximum.at(last, codes[rows], rows)
    return with_nulls(values[np.maximum(last, 0)], last < 0)


def group_count(codes, n_groups, values) -> np.ndarray:
    """``agg("count")``: non-null values per group."""
    ok = (codes >= 0) & ~isnull(values)
    return np.bincount(codes[ok], minlength=n_groups).astype(np.int64)


def group_sum(codes, n_groups, values) -> np.ndarray:
    """``agg("sum")`` of a float column: pandas' Kahan summation in row
    order, NaN skipped, 0.0 for a group with no value."""
    values = np.asarray(values, np.float64)
    ok = np.flatnonzero((codes >= 0) & ~np.isnan(values))
    order = ok[np.argsort(codes[ok], kind="stable")]
    g = codes[order]
    start = np.r_[0, np.flatnonzero(g[1:] != g[:-1]) + 1] if len(g) \
        else np.zeros(0, np.int64)
    rank = np.arange(len(g)) - np.repeat(start, np.diff(np.r_[start,
                                                              len(g)]))
    total = np.zeros(n_groups)
    comp = np.zeros(n_groups)
    for r in range(int(rank.max()) + 1 if len(rank) else 0):
        at = rank == r
        gi, v = g[at], values[order[at]]
        y = v - comp[gi]
        t = total[gi] + y
        c = (t - total[gi]) - y
        comp[gi] = np.where(np.isnan(c), 0.0, c)
        total[gi] = t
    return total


def group_mean(codes, n_groups, values) -> np.ndarray:
    """``agg("mean")``: the Kahan sum over the count (NaN for none)."""
    cnt = group_count(codes, n_groups, np.asarray(values, np.float64))
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(cnt > 0, group_sum(codes, n_groups, values) / cnt,
                        np.nan)


def group_min(codes, n_groups, values) -> np.ndarray:
    """``agg("min")`` of a datetime or float column, nulls skipped."""
    return _group_extreme(codes, n_groups, values, np.minimum)


def group_max(codes, n_groups, values) -> np.ndarray:
    return _group_extreme(codes, n_groups, values, np.maximum)


def _group_extreme(codes, n_groups, values, ufunc) -> np.ndarray:
    ok = (codes >= 0) & ~isnull(values)
    rows = np.flatnonzero(ok)
    best = np.full(n_groups, -1, np.int64)
    for i in rows:                      # few rows a group: a plain scan
        j = best[codes[i]]
        if j < 0 or ufunc(values[i], values[j]) != values[j]:
            best[codes[i]] = i
    return with_nulls(values[np.maximum(best, 0)], best < 0)


def row_nansum(mat: np.ndarray) -> np.ndarray:
    """``DataFrame.sum(axis=1)`` of float columns (NaN skipped), in pandas'
    order of additions: pandas fills the NaNs of a C-ordered copy with 0
    when there are any, which numpy then sums pairwise, and sums the
    column-major values in column order when there are none."""
    miss = np.isnan(mat)
    z = np.where(miss, 0.0, mat)
    return (np.ascontiguousarray(z) if miss.any()
            else np.asfortranarray(z)).sum(axis=1)


def drop_duplicates(f: Frame, subset: Sequence[str],
                    keep: str = "first") -> Frame:
    """``drop_duplicates(subset, keep=first|last)`` (nulls equal)."""
    n = nrows(f)
    if not n:
        return f
    ranks, _ = _ranks([f[c] for c in subset])
    _, first, inv = np.unique(_combine(ranks), return_index=True,
                              return_inverse=True)
    inv = inv.ravel()
    if keep == "first":
        pick = first
    else:
        pick = np.zeros(len(first), np.int64)
        np.maximum.at(pick, inv, np.arange(n))
    kept = np.zeros(n, bool)
    kept[pick] = True
    return take(f, kept)


# =============================================================================
# Merge
# =============================================================================
def merge(left: Frame, right: Frame, on: Sequence[str],
          how: str = "inner") -> Frame:
    """``left.merge(right, on=on, how=how)`` for ``inner``, ``left`` and
    ``outer``. Inner and left joins keep the left frame's order, each left
    row followed by its matches in the right frame's order; an outer join
    sorts the result by the keys. Null keys match null keys, as in pandas.
    Columns: the left frame's, then the right's other ones (``_x``/``_y``
    on a clash); a column that gains missing rows is upcast as pandas does
    (``with_nulls``)."""
    nl, nr = nrows(left), nrows(right)
    ranks, null = _ranks([np.concatenate([_obj(left[c], right[c]),
                                          _obj(right[c], left[c])])
                          for c in on])
    key = _combine(ranks)
    kl, kr = key[:nl], key[nl:]
    rorder = np.argsort(kr, kind="stable")
    rs = kr[rorder]
    lo, hi = np.searchsorted(rs, kl, "left"), np.searchsorted(rs, kl,
                                                              "right")
    cnt = hi - lo
    if how == "inner":
        li = np.repeat(np.arange(nl), cnt)
        ri = rorder[_ranges(lo, cnt)]
        if nl and len(li) == nl:
            numeric = len(on) > 1 or all(
                t[on[0]].dtype.kind in "iufbmM" for t in (left, right))
            li, ri = _inner_shortcut(ranks, null, nl, numeric, li, ri)
    elif how in ("left", "outer"):
        c1 = np.maximum(cnt, 1)
        li = np.repeat(np.arange(nl), c1)
        pos = _ranges(lo, c1)
        ri = np.where(np.repeat(cnt > 0, c1),
                      rorder[np.minimum(pos, max(nr - 1, 0))] if nr
                      else -1, -1)
        if how == "outer":
            only = np.setdiff1d(np.arange(nr), ri[ri >= 0])
            li = np.r_[li, np.full(len(only), -1)]
            ri = np.r_[ri, only]
            k = np.where(li >= 0, kl[np.maximum(li, 0)], kr[np.maximum(ri, 0)])
            o = np.argsort(k, kind="stable")
            li, ri = li[o], ri[o]
    else:
        raise ValueError(f"merge how={how!r}")
    out: Frame = {}
    lmiss, rmiss = li < 0, ri < 0
    for c, v in left.items():
        col = with_nulls(v[np.maximum(li, 0)], lmiss) if nl else \
            v[:0].repeat(len(li))
        if c in on and lmiss.any():             # outer: right-only keys
            rv = _obj(right[c], v)[np.maximum(ri, 0)]
            col = np.where(lmiss, rv, _obj(v, right[c])[np.maximum(li, 0)]
                           if nl else rv)
        out[c if c in on or c not in right else f"{c}_x"] = col
    for c, v in right.items():
        if c in on:
            continue
        col = with_nulls(v[np.maximum(ri, 0)], rmiss) if nr else \
            with_nulls(np.zeros(len(ri), v.dtype), np.ones(len(ri), bool))
        out[c if c not in left else f"{c}_y"] = col
    return out


def _first_seen(codes: np.ndarray, null: np.ndarray) -> np.ndarray:
    """Each value's number in the order of its first appearance (a
    hashtable's factorize), nulls after every value."""
    if not len(codes):
        return codes
    _, first, inv = np.unique(codes, return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    out = rank[inv.ravel()]
    out[null] = len(first)
    return out


def _inner_shortcut(ranks, null, nl, numeric, li, ri):
    """pandas' inner join when its result has as many rows as the left
    frame. Where pandas takes neither its sorted-keys path nor its hash
    join (the right keys repeat), ``libjoin.inner_join`` builds the result
    group by group and, to restore the left order, assumes that every
    left row matched exactly once (``len(left) == len(left_indexer)``):
    when some rows matched twice and others not at all, its rows come out
    in that assumption's order, which this reproduces."""
    if len(ranks) == 1:
        keys = ranks[0].copy()          # ordered as the values
    else:                               # pandas' flat codes of the levels
        keys = np.zeros(len(null), np.int64)
        for r in ranks:
            lev = _first_seen(r, null)
            keys = keys * (int(lev.max()) + 1) + lev
    kl, kr = keys[:nl], keys[nl:]

    def mono(a):
        return bool((a[1:] >= a[:-1]).all())

    def uniq(a):
        return len(np.unique(a)) == len(a)

    has_null = null.any()
    if not has_null and mono(kl) and mono(kr) and (uniq(kl) or uniq(kr)):
        return li, ri                   # Index.join of sorted keys
    if numeric and uniq(kr) and not null[nl:].any():
        return li, ri                   # hash join: the left order
    # group numbers as pandas factorizes them: the right keys first (hash
    # path), nulls last; the result group by group, then the shortcut
    seq = np.concatenate([kr, kl]) if numeric else keys
    nseq = np.concatenate([null[nl:], null[:nl]]) if numeric else null
    g = _first_seen(seq, nseq)
    gl = g[len(kr):] if numeric else g[:nl]
    o = np.argsort(gl[li], kind="stable")
    rev = np.empty(nl, np.int64)
    rev[np.argsort(gl, kind="stable")] = np.arange(nl)
    return li[o][rev], ri[o][rev]


def _obj(col, other):
    return col.astype(object) if (col.dtype == object) != \
        (other.dtype == object) else col


def _ranges(start, count) -> np.ndarray:
    """Concatenated ``arange(start[i], start[i] + count[i])``."""
    total = int(count.sum())
    if not total:
        return np.zeros(0, np.int64)
    first = np.repeat(start - np.r_[0, np.cumsum(count)[:-1]], count)
    return first + np.arange(total)


# =============================================================================
# One-hots
# =============================================================================
def get_dummies(f: Frame, columns: Sequence[str]) -> Frame:
    """``pd.get_dummies(f, columns=columns, dtype=int)``: the other columns
    first, then per column one int64 column ``{col}_{category}`` per
    category present, in sorted order; a null row is all zeros."""
    out = {c: v for c, v in f.items() if c not in columns}
    for c in columns:
        v = f[c]
        miss = isnull(v)
        cats = sorted(set(v[~miss].tolist()))
        for cat in cats:
            out[f"{c}_{cat}"] = ((v == cat) & ~miss).astype(np.int64)
    return out


# =============================================================================
# Feather
# =============================================================================
def read_feather(path: str) -> Frame:
    """``pd.read_feather(path)`` of a Feather V1 or V2 file, in this
    module's convention: integers with nulls become float64 with NaN,
    booleans with nulls object (``True``/``False``/``None``), strings
    (dictionary-encoded ones too) object ``str`` with ``None``, a null
    column object ``None``; timestamps keep their unit, with ``NaT``. A
    column that the file's pandas metadata names as the index is left
    out, as pandas moves it to the index."""
    t = arrow_ipc.read_table(path)
    index = set()
    if "pandas" in t.metadata:
        index = {c for c in json.loads(t.metadata["pandas"]).get(
            "index_columns", []) if isinstance(c, str)}
    return {f.name: _from_arrow(f, c) for f, c in zip(t.fields, t.columns)
            if f.name not in index}


def _from_arrow(f: "arrow_ipc.Field", c: "arrow_ipc.Column") -> np.ndarray:
    t, v, valid = f.type, c.values, c.valid
    if t.kind == "timestamp" and t.tz:
        raise ValueError(f"column {f.name!r}: time zones are not supported")
    if valid is None or t.kind in ("null", "utf8", "large_utf8"):
        return v
    miss = ~valid
    if t.kind in ("int", "uint"):
        v = v.astype(np.float64)
    elif t.kind == "bool":
        v = v.astype(object)
    v[miss] = (np.nan if v.dtype.kind == "f" else np.datetime64("NaT")
               if v.dtype.kind == "M" else None)
    return v


def _to_arrow(name: str, col: np.ndarray):
    """(Arrow field, column, pandas type, numpy type) of one column, as
    ``pa.Table.from_pandas`` types the pandas column JAX's frame holds."""
    col = np.asarray(col)
    kind = col.dtype.kind
    valid = None
    if kind in "iu":
        t = arrow_ipc.ArrowType("int" if kind == "i" else "uint",
                                col.dtype.itemsize * 8)
        ptype = ntype = col.dtype.name
    elif kind == "f":
        t = arrow_ipc.ArrowType("float", col.dtype.itemsize * 8)
        ptype = ntype = col.dtype.name
        miss = np.isnan(col)
        valid = ~miss if miss.any() else None
    elif kind == "b":
        t, ptype, ntype = arrow_ipc.ArrowType("bool"), "bool", "bool"
    elif kind == "M":
        unit = np.datetime_data(col.dtype)[0]
        if unit not in ("s", "ms", "us", "ns"):
            col, unit = col.astype("datetime64[s]"), "s"
        t = arrow_ipc.ArrowType("timestamp", unit=unit)
        ptype, ntype = "datetime", f"datetime64[{unit}]"
        miss = np.isnat(col)
        valid = ~miss if miss.any() else None
    elif col.dtype == object:
        miss = isnull(col)
        present = {type(x) for x in col[~miss].tolist()}
        if present <= {str}:
            t = arrow_ipc.ArrowType("large_utf8")
            ptype, ntype = "object", "str"
        elif present <= {bool, np.bool_}:
            t, ptype, ntype = arrow_ipc.ArrowType("bool"), "bool", "object"
        else:
            raise ValueError(f"column {name!r} mixes "
                             f"{sorted(map(str, present))}")
        if miss.any():
            valid = ~miss
            col = col.copy()
            col[miss] = None
    else:
        raise ValueError(f"column {name!r}: dtype {col.dtype} is not written")
    return (arrow_ipc.Field(name, t), arrow_ipc.Column(col, valid),
            ptype, ntype)


def write_feather(path: str, f: Frame, compression: str = "lz4") -> None:
    """``DataFrame.to_feather(path, compression=...)`` of the pandas frame
    JAX's chain holds where the port holds ``f``: the Arrow schema that
    pyarrow gives it (int and float widths kept, bool, ``timestamp[unit]``,
    strings as ``large_string``, every field nullable; NaN and NaT
    written as nulls), record batches of 65,536 rows, each buffer an LZ4
    frame (``compression="uncompressed"`` for none), and the ``pandas``
    schema metadata of a frame with a RangeIndex, so that
    ``pd.read_feather`` rebuilds the same dtypes."""
    fields, columns, cols_meta = [], [], []
    for name, col in f.items():
        fld, c, ptype, ntype = _to_arrow(name, col)
        fields.append(fld)
        columns.append(c)
        cols_meta.append({"name": name, "field_name": name,
                          "pandas_type": ptype, "numpy_type": ntype,
                          "metadata": None})
    meta = {"index_columns": [{"kind": "range", "name": None, "start": 0,
                               "stop": nrows(f), "step": 1}],
            "column_indexes": [{"name": None, "field_name": None,
                                "pandas_type": "unicode", "numpy_type": "str",
                                "metadata": {"encoding": "UTF-8"}}],
            "columns": cols_meta, "attributes": {},
            "creator": {"library": "multimodal_edema_prediction_tpu_torch"}}
    arrow_ipc.write_table(path, fields, columns,
                          {"pandas": json.dumps(meta)}, compression)
