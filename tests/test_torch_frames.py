"""The port's frame verbs (``data/frames.py``) against the pandas calls they
stand for, on inputs made from a seed: ``read_csv``'s type inference and
float parser, ``to_csv``'s text, grouped sums, means, "last" and "count",
merges, sorts, ``drop_duplicates``, ``get_dummies`` and the row sums of
``DataFrame.sum(axis=1)``. The port never imports pandas; these tests
do, as the oracle."""
import io

import numpy as np
import pandas as pd
import pytest

from multimodal_edema_prediction_tpu_torch.data import frames as F


def _col(s: pd.Series) -> np.ndarray:
    """A pandas column as the port holds it."""
    if s.dtype.kind == "M":
        return s.to_numpy("datetime64[ns]")
    if s.dtype == object or str(s.dtype) in ("str", "string"):
        return np.array([None if v is None or (isinstance(v, float)
                                               and v != v) else v
                         for v in s], object)
    return s.to_numpy()


def assert_column_equal(want: np.ndarray, got: np.ndarray, what=""):
    assert want.dtype == got.dtype, (what, want.dtype, got.dtype)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    if want.dtype.kind in "fmM":
        np.testing.assert_array_equal(want, got, err_msg=str(what))
    else:
        assert list(want) == list(got), what


def _floats(seed, n=20000):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.normal(0, 1e3, n), rng.random(n) * 1e-5, rng.normal(115, 3, n),
        rng.normal(0, 1, 50) * 1e-310, rng.normal(0, 1, 50) * 1e300,
        np.round(rng.normal(0, 100, n), 1), [0.0, -0.0, 1e16, 2.5e-8]])


@pytest.mark.parametrize("seed", [0, 1])
def test_float_parser_is_pandas_own(seed):
    """pandas' parser is not correctly rounded; the port's gives its
    doubles bit for bit, where Python's ``float`` does not."""
    x = _floats(seed)
    buf = io.StringIO()
    pd.DataFrame({"a": x}).to_csv(buf, index=False)
    text = buf.getvalue().split("\n")[1:-1]
    want = pd.read_csv(io.StringIO(buf.getvalue()))["a"].to_numpy()
    got = F.parse_floats(np.array(text))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(np.array([float(v) for v in text]), want)


@pytest.mark.parametrize("text", [
    "a,b,c,d,e,f,g\n1,2.5,x,True,,2150-03-01 08:00:00,-3\n"
    "2,,y,False,,,4\n",
    "a,b,c\n1,NA,n/a\n,7,z\n3,1e5,\n",
    "a,b\n0010,+5\n-7,.5\n",
    "a,b\ninf,-Infinity\n1_000,1.5e-3\n",
    'a,b\n"1,5",x\n2,"q""y"\n',
    "a,b\n1,°F\n2,%\n"])
def test_read_csv_infers_the_types_pandas_does(tmp_path, text):
    p = tmp_path / "t.csv"
    p.write_text(text, encoding="utf-8")
    want = pd.read_csv(p)
    got = F.read_csv(str(p))
    assert list(got) == list(want.columns)
    for c in want.columns:
        assert_column_equal(_col(want[c]), got[c], c)


def test_read_csv_dates_and_gzip(tmp_path):
    import gzip
    text = "t,u\n2150-03-01 08:00:00,\n,2150-03-02\n"
    p = tmp_path / "t.csv.gz"
    with gzip.open(p, "wt") as f:
        f.write(text)
    want = pd.read_csv(p)
    got = F.read_csv(str(p), dates=("t", "u"))
    for c in ("t", "u"):
        assert_column_equal(pd.to_datetime(want[c]).to_numpy(
            "datetime64[ns]"), got[c], c)


def _frame(seed, n=300):
    rng = np.random.default_rng(seed)
    ts = np.datetime64("2150-01-01T00:00", "ns") + rng.integers(
        0, 48, n) * np.timedelta64(30, "m")
    v = rng.normal(0, 1, n) * 10.0 ** rng.integers(-3, 6, n)
    v[rng.random(n) < 0.2] = np.nan
    s = np.array(["a", "bb", "c", None], object)[rng.integers(0, 4, n)]
    return {"k": rng.integers(0, 6, n), "t": ts, "v": v, "s": s,
            "i": rng.integers(0, 100, n)}


def _pd(f):
    return pd.DataFrame({k: (list(v) if v.dtype == object else v)
                         for k, v in f.items()})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grouped_sum_mean_last_count(seed):
    f = _frame(seed)
    want = _pd(f).groupby(["k", "t"], as_index=False).agg(
        s=("v", "sum"), m=("v", "mean"), l=("v", "last"), c=("v", "count"))
    codes, first = F.group_rows([f["k"], f["t"]])
    n = len(first)
    assert_column_equal(want["k"].to_numpy(), f["k"][first])
    assert_column_equal(want["t"].to_numpy("datetime64[ns]"), f["t"][first])
    assert_column_equal(want["s"].to_numpy(), F.group_sum(codes, n, f["v"]))
    assert_column_equal(want["m"].to_numpy(), F.group_mean(codes, n, f["v"]))
    assert_column_equal(want["l"].to_numpy(), F.group_last(codes, n, f["v"]))
    assert_column_equal(want["c"].to_numpy(), F.group_count(codes, n,
                                                            f["v"]))


def test_grouped_sum_is_kahan():
    codes = np.zeros(10, np.int64)
    v = np.full(10, 0.1)
    assert F.group_sum(codes, 1, v)[0] == pd.Series(v).groupby(
        codes).sum().iloc[0] == 1.0
    total = 0.0
    for x in v:                         # plain summation in row order
        total = total + x
    assert total != 1.0
    # Kahan, not Neumaier: [1, 1e100, 1, -1e100] sums to 0
    w = np.array([1.0, 1e100, 1.0, -1e100])
    assert F.group_sum(np.zeros(4, np.int64), 1, w)[0] == 0.0


@pytest.mark.parametrize("how", ["inner", "left", "outer"])
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_keeps_pandas_row_order(how, seed):
    rng = np.random.default_rng(seed)
    left = {"k": rng.integers(0, 8, 40), "j": rng.integers(0, 2, 40),
            "a": rng.normal(size=40), "b": rng.integers(0, 9, 40)}
    right = {"k": rng.integers(2, 10, 25), "j": rng.integers(0, 2, 25),
             "b": rng.normal(size=25),
             "f": rng.normal(size=25).astype(np.float32),
             "s": np.array(["x", "y", None], object)[rng.integers(0, 3, 25)]}
    if how == "outer":      # the L0 chain's outer merge has unique keys
        left = F.drop_duplicates(left, ["k", "j"])
        right = F.drop_duplicates(right, ["k", "j"])
    want = _pd(left).merge(_pd(right), on=["k", "j"], how=how)
    got = F.merge(left, right, ["k", "j"], how)
    assert list(got) == list(want.columns)
    for c in want.columns:
        assert_column_equal(_col(want[c]), got[c], c)


@pytest.mark.parametrize("keep", ["first", "last"])
def test_drop_duplicates_and_sort(keep):
    f = _frame(3)
    want = _pd(f).drop_duplicates(subset=["k", "s"], keep=keep)
    got = F.drop_duplicates(f, ["k", "s"], keep=keep)
    for c in want.columns:
        assert_column_equal(_col(want[c]), got[c], c)
    want = _pd(f).sort_values(["s", "k", "t"])
    got = F.sort_values(f, ["s", "k", "t"])
    for c in want.columns:
        assert_column_equal(_col(want[c]), got[c], c)


def test_get_dummies_and_row_sums():
    f = _frame(4)
    want = pd.get_dummies(_pd(f)[["k", "s"]], columns=["s"], dtype=int)
    got = F.get_dummies(F.select(f, ["k", "s"]), ["s"])
    assert list(got) == list(want.columns)
    for c in want.columns:
        assert_column_equal(want[c].to_numpy(), got[c], c)
    rng = np.random.default_rng(5)
    for nan in (False, True):
        m = rng.normal(0, 1, (40, 11)) * 10.0 ** rng.integers(-5, 5, (40, 11))
        if nan:
            m[rng.random(m.shape) < 0.3] = np.nan
        np.testing.assert_array_equal(
            F.row_nansum(m), pd.DataFrame(m).sum(axis=1).to_numpy())


def test_write_csv_is_to_csv(tmp_path):
    f = _frame(6, 50)
    f["t"][3] = np.datetime64("NaT")
    f["b"] = f["i"] > 50
    f["q"] = np.array(['he said "hi", then', "a\nb", None] * 16 + ["x", "y"],
                      object)
    p = tmp_path / "a.csv"
    F.write_csv(str(p), f)
    buf = io.StringIO()
    _pd(f).to_csv(buf, index=False)
    assert p.read_text(encoding="utf-8") == buf.getvalue()


@pytest.mark.parametrize("keys", [["k"], ["k", "j"]])
def test_inner_and_left_merges_on_random_keys(keys):
    """Repeated keys on both sides, sorted and unsorted, unmatched rows:
    every row pair in pandas' order, its inner join's shortcut (a result
    as long as the left frame, rows matched twice and not at all) among
    them."""
    for seed in range(150):
        rng = np.random.default_rng(seed)
        nl, nr = rng.integers(1, 30, 2)
        left = {"k": rng.integers(0, 8, nl), "j": rng.integers(0, 2, nl),
                "a": np.arange(nl)}
        right = {"k": rng.integers(0, 10, nr), "j": rng.integers(0, 2, nr),
                 "b": np.arange(nr)}
        if seed % 3 == 0:
            left["k"] = np.sort(left["k"])
            right["k"] = np.sort(right["k"])
        for how in ("inner", "left"):
            want = _pd(left).merge(_pd(right), on=keys, how=how)
            got = F.merge(left, right, keys, how)
            for c in want.columns:
                assert_column_equal(_col(want[c]), got[c], (seed, how, c))
