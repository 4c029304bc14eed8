"""Feather without pyarrow (``data/arrow_ipc.py``, ``data/frames.py``'s
``read_feather`` / ``write_feather``) against pandas and pyarrow, with no
tolerance: the port reads every supported Arrow type as
``pd.read_feather`` gives it (uncompressed, LZ4 and ZSTD bodies, one
record batch or several, Feather V1), writes files whose Arrow schema is
pyarrow's for the same pandas frame and which ``pd.read_feather`` reads
back equal, reads its own files back, and holds the committed feather
fixtures of the L0 chain to what ``scripts/make_feather_goldens.py``
writes now. The reference-artifact route (JAX's audit frames →
``from_reference_frames`` → ``save_npz``) gives the same arrays in both
packages."""
import os
import sys

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.feather as pf
import pyarrow.ipc  # noqa: F401
import pytest

from multimodal_edema_prediction_tpu_torch.data import arrow_ipc
from multimodal_edema_prediction_tpu_torch.data import frames as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "goldens", "feather_l0")


def as_port(df: pd.DataFrame) -> dict:
    """``pd.read_feather``'s frame in the port's convention: categorical
    and string columns as object ``str`` with None; object columns with
    None for NaN; every other column as its numpy array."""
    out = {}
    for c in df.columns:
        s = df[c]
        if isinstance(s.dtype, pd.CategoricalDtype) or s.dtype == object \
                or str(s.dtype) in ("str", "string"):
            out[c] = np.array([None if v is None or (isinstance(v, float)
                                                     and v != v) else v
                               for v in s.astype(object)], object)
        else:
            out[c] = s.to_numpy()
    return out


def assert_port_frame(want: dict, got: dict):
    assert list(got) == list(want)
    for c, w in want.items():
        g = got[c]
        assert g.dtype == w.dtype, (c, w.dtype, g.dtype)
        assert g.shape == w.shape, c
        if w.dtype == object:
            assert list(g) == list(w), c
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)
        assert g.flags.writeable and g.flags.owndata or g.base is not None, c


def _table(n: int = 300, seed: int = 0) -> pa.Table:
    """One column of every type the reader supports, with and without
    nulls."""
    rng = np.random.default_rng(seed)
    miss = rng.random(n) < 0.2
    cols = {}
    for t in ("int8", "int16", "int32", "int64", "uint8", "uint16",
              "uint32", "uint64"):
        info = np.iinfo(t)
        v = rng.integers(max(info.min, -1000), min(info.max, 1000), n)
        cols[t] = pa.array(v.astype(t), pa.from_numpy_dtype(np.dtype(t)))
        cols[t + "_nulls"] = pa.array(v.astype(t),
                                      pa.from_numpy_dtype(np.dtype(t)),
                                      mask=miss)
    for t in ("float32", "float64"):
        v = rng.normal(size=n).astype(t)
        cols[t] = pa.array(v)
        cols[t + "_nulls"] = pa.array(v, mask=miss)
    b = rng.random(n) < 0.5
    cols["bool"] = pa.array(b)
    cols["bool_nulls"] = pa.array(b, mask=miss)
    cols["null"] = pa.nulls(n)
    words = rng.choice(["edema", "", "pleural effusion", "élan", "x" * 30], n)
    cols["utf8"] = pa.array(words.tolist(), pa.string())
    cols["utf8_nulls"] = pa.array(words.tolist(), pa.string(), mask=miss)
    cols["large_utf8"] = pa.array(words.tolist(), pa.large_string(),
                                  mask=miss)
    ns = (np.datetime64("2150-03-01T08:00", "ns")
          + rng.integers(0, 10 ** 15, n).astype("timedelta64[ns]"))
    for unit in ("s", "ms", "us", "ns"):
        v = ns.astype(f"datetime64[{unit}]")
        cols[f"ts_{unit}"] = pa.array(v, pa.timestamp(unit), mask=miss)
    cols["ts_ns_full"] = pa.array(ns, pa.timestamp("ns"))
    cols["dict_utf8"] = pa.array(words.tolist(), pa.string(),
                                 mask=miss).dictionary_encode()
    cols["dict_no_nulls"] = pa.array(words.tolist()).dictionary_encode()
    return pa.table(cols)


@pytest.mark.parametrize("codec", [None, "lz4", "zstd"])
@pytest.mark.parametrize("batch", [None, 70])
def test_reader_equals_pandas_on_every_type(tmp_path, codec, batch):
    table = _table()
    path = str(tmp_path / "t.arrow")
    opts = pa.ipc.IpcWriteOptions(compression=codec)
    with pa.ipc.new_file(path, table.schema, options=opts) as w:
        w.write_table(table, max_chunksize=batch)
    n_batches = pa.ipc.open_file(path).num_record_batches
    assert n_batches == (1 if batch is None else 5)
    assert_port_frame(as_port(pd.read_feather(path)), F.read_feather(path))
    t = arrow_ipc.read_table(path)
    assert [str(f.type) for f in t.fields] == [
        str(f.type.value_type if pa.types.is_dictionary(f.type) else f.type)
        for f in table.schema]


def test_reader_equals_pandas_on_feather_v1(tmp_path):
    rng = np.random.default_rng(3)
    n = 200
    miss = rng.random(n) < 0.3
    df = pd.DataFrame({
        "i64": rng.integers(0, 10 ** 9, n),
        "i8": rng.integers(-100, 100, n).astype(np.int8),
        "u16": rng.integers(0, 60000, n).astype(np.uint16),
        "f32": rng.normal(size=n).astype(np.float32),
        "f64_nan": np.where(miss, np.nan, rng.normal(size=n)),
        "b": rng.random(n) < 0.5,
        "s": pd.Series(np.where(miss, None, rng.choice(["a", "bb", "é"], n)),
                       dtype=object),
        "t": pd.Series(np.datetime64("2150-01-01", "ns")
                       + rng.integers(0, 10 ** 14, n)
                       .astype("timedelta64[ns]")).where(~miss),
        "cat": pd.Categorical(rng.choice(["AP", "PA", "LL"], n)),
    })
    path = str(tmp_path / "v1.feather")
    pf.write_feather(df, path, version=1)
    with open(path, "rb") as fh:
        assert fh.read(4) == b"FEA1"
    assert_port_frame(as_port(pd.read_feather(path)), F.read_feather(path))


def _port_frame(n: int, seed: int = 0) -> dict:
    """A frame of each dtype the port's L0 chain holds."""
    rng = np.random.default_rng(seed)
    miss = (rng.random(n) < 0.25) | (np.arange(n) == 0)   # a null each
    f = {"subject_id": rng.integers(0, 10 ** 8, n),
         "value": np.where(miss, np.nan, rng.normal(size=n)),
         "label": np.where(miss, np.nan, rng.random(n)).astype(np.float32),
         "flag": rng.random(n) < 0.5,
         "maybe": np.array([None if m else bool(v) for m, v in
                            zip(miss, rng.random(n) < 0.5)], object),
         "t_ns": np.where(miss, np.datetime64("NaT"),
                          np.datetime64("2150-01-01T00:00", "ns")
                          + rng.integers(0, 10 ** 15, n)
                          .astype("timedelta64[ns]")),
         "t_ms": (np.datetime64("2150-01-01", "ms")
                  + rng.integers(0, 10 ** 11, n).astype("timedelta64[ms]")),
         "dicom_id": np.array([None if m else f"d{i:06d}" for i, m in
                               enumerate(miss)], object),
         "u8": rng.integers(0, 255, n).astype(np.uint8),
         "i32": rng.integers(-5, 5, n).astype(np.int32)}
    return f


def _as_pandas(f: dict) -> pd.DataFrame:
    """The pandas frame that JAX's chain holds where the port holds ``f``:
    strings as pandas' ``str`` dtype."""
    df = pd.DataFrame({c: v for c, v in f.items()})
    df["dicom_id"] = df["dicom_id"].astype("str")
    return df


@pytest.mark.parametrize("compression", ["lz4", "uncompressed"])
def test_writer_matches_pyarrow_schema_and_pandas(tmp_path, compression):
    f = _port_frame(70_000)                     # two record batches
    path = str(tmp_path / "p.ftr")
    F.write_feather(path, f, compression=compression)
    df = _as_pandas(f)
    ref = str(tmp_path / "ref.ftr")
    df.to_feather(ref, compression=compression)
    a, b = pa.ipc.open_file(ref), pa.ipc.open_file(path)
    assert [(x.name, x.type, x.nullable) for x in a.schema] == \
        [(x.name, x.type, x.nullable) for x in b.schema]
    assert b.num_record_batches == a.num_record_batches == 2
    pd.testing.assert_frame_equal(pd.read_feather(ref), pd.read_feather(path),
                                  check_exact=True)
    # the port reads its own file back unchanged
    g = F.read_feather(path)
    assert_port_frame(f, g)


def test_round_trip_of_small_and_empty_frames(tmp_path):
    for n in (0, 1, 37):
        f = _port_frame(n, seed=n)
        path = str(tmp_path / f"f{n}.ftr")
        F.write_feather(path, f)
        assert_port_frame(f, F.read_feather(path))
        want = _as_pandas(f)
        if not want["maybe"].notna().any():     # JAX's column: str dtype
            want["maybe"] = want["maybe"].astype("str")
        pd.testing.assert_frame_equal(pd.read_feather(path), want,
                                      check_exact=True)


def test_an_index_column_is_left_out_as_pandas_does(tmp_path):
    """A frame written with a non-default index: ``pd.read_feather`` moves
    the stored index column to the index, and the port leaves it out."""
    df = pd.DataFrame({"a": [1, 2, 3], "b": ["x", None, "z"]},
                      index=pd.Index([10, 20, 30], name="stay"))
    path = str(tmp_path / "ix.ftr")
    pf.write_feather(pa.Table.from_pandas(df), path)
    assert "stay" in pa.ipc.open_file(path).schema.names
    got = F.read_feather(path)
    assert list(got) == ["a", "b"]
    assert_port_frame(as_port(pd.read_feather(path).reset_index(drop=True)),
                      got)


def test_raw_buffers_in_a_compressed_file(tmp_path):
    """A buffer that LZ4 does not shrink is written raw (length -1), and
    both readers take it."""
    rng = np.random.default_rng(5)
    f = {"noise": rng.random(5000), "zeros": np.zeros(5000)}
    path = str(tmp_path / "raw.ftr")
    F.write_feather(path, f)
    g = pd.read_feather(path)
    np.testing.assert_array_equal(g["noise"].to_numpy(), f["noise"])
    assert_port_frame(f, F.read_feather(path))
    assert os.path.getsize(path) < 5000 * 8 * 1.2      # zeros compressed


def test_malformed_files_raise(tmp_path):
    f = _port_frame(100)
    path = str(tmp_path / "ok.ftr")
    F.write_feather(path, f)
    with open(path, "rb") as fh:
        data = fh.read()
    for name, bad in (("truncated", data[:len(data) // 2]),
                      ("no_magic", b"XXXXXX" + data[6:]),
                      ("tail", data[:-6] + b"ARROWX")):
        p = str(tmp_path / f"{name}.ftr")
        with open(p, "wb") as fh:
            fh.write(bad)
        with pytest.raises(ValueError):
            F.read_feather(p)
    with pytest.raises(ValueError, match="mixes"):
        F.write_feather(str(tmp_path / "mixed.ftr"),
                        {"x": np.array(["a", 1], object)})


def test_committed_goldens_are_what_the_script_writes(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_feather_goldens as mk
    finally:
        sys.path.pop(0)
    made = mk.make_goldens(str(tmp_path))
    for codec, tables in made.items():
        committed = sorted(
            os.path.relpath(os.path.join(d, n), os.path.join(GOLDENS, codec))
            for d, _, names in os.walk(os.path.join(GOLDENS, codec))
            for n in names)
        assert committed == sorted(tables), codec
        for rel in tables:
            old = os.path.join(GOLDENS, codec, rel)
            new = os.path.join(str(tmp_path), codec, rel)
            assert pa.ipc.open_file(old).schema.equals(
                pa.ipc.open_file(new).schema), rel
            pd.testing.assert_frame_equal(pd.read_feather(old),
                                          pd.read_feather(new),
                                          check_exact=True)
            assert_port_frame(as_port(pd.read_feather(old)),
                              F.read_feather(old))
        with open(os.path.join(GOLDENS, codec, tables[0]), "rb") as fh:
            head = fh.read()
        assert head[:6] == b"ARROW1"


def test_reference_artifact_route_equals_jax(tmp_path):
    """JAX's audit frames (``.ftr``) → ``from_reference_frames`` →
    ``save_npz`` in both packages: the same arrays."""
    from multimodal_edema_prediction_tpu.config import \
        DEFAULT_PATHOLOGY_LABELS
    from multimodal_edema_prediction_tpu.data import ingest as JI
    from multimodal_edema_prediction_tpu.data import raw_mimic as J
    from multimodal_edema_prediction_tpu.data.synthetic_raw import \
        make_raw_layout
    from multimodal_edema_prediction_tpu_torch.data import ingest as PI
    from multimodal_edema_prediction_tpu_torch.data import raw_mimic as P
    root = str(tmp_path / "raw")
    make_raw_layout(root, n_subjects=24, seed=1)
    paths = J.run_l0(root, str(tmp_path / "jax"))
    names = ("final_df", "static_full", "final_cxr_df")
    jf = [pd.read_feather(paths[k]) for k in names]
    pfr = [F.read_feather(paths[k]) for k in names]
    labels = [c for c in DEFAULT_PATHOLOGY_LABELS if c in jf[0].columns]
    jds = JI.from_reference_frames(*jf, J._schema_meta(jf[1], 24), labels)
    pds = PI.from_reference_frames(*pfr, P._schema_meta(pfr[1], 24), labels)
    JI.save_npz(str(tmp_path / "j.npz"), jds)
    PI.save_npz(str(tmp_path / "p.npz"), pds)
    a, b = np.load(str(tmp_path / "j.npz")), np.load(str(tmp_path / "p.npz"))
    assert sorted(a.files) == sorted(b.files) and len(a.files) == 22
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
