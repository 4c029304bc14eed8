"""The port's L0 chain (``data/raw_mimic.py``, numpy only) against the JAX
package's (pandas) on the same raw MIMIC-IV + MIMIC-CXR layouts: every
stage's frame column by column, then whole ``run_l0``: ``cohort.npz``
array for array (dtypes and shapes included), ``meta_with_stats.pkl``
bit for bit, and the audit frames against JAX's ``.ftr`` files. The
layouts are JAX's ``make_raw_layout`` (seeds 0 and 1 at 24 subjects, 120
subjects), and edge cases written from it: no BP rows, no pre-ICU ward
labs, no CXLSeg-mask table, no ``valueuom`` column, duplicate charttimes
within a slot; the same layouts with their tables as feather (LZ4, ZSTD,
uncompressed; times as strings or ``timestamp[ns|us]``; ``.feather``
names; a ``.ftr`` beside a different CSV), and feather tables that make
JAX's chain raise."""
import os
import pickle

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.ipc  # noqa: F401
import pytest

from multimodal_edema_prediction_tpu.data import raw_mimic as J
from multimodal_edema_prediction_tpu.data.synthetic_raw import \
    make_raw_layout
from multimodal_edema_prediction_tpu_torch.data import frames as F
from multimodal_edema_prediction_tpu_torch.data import raw_mimic as P


def as_columns(df: pd.DataFrame) -> dict:
    """A JAX DataFrame as the port holds a frame: datetimes in ns,
    strings as objects with None for NaN."""
    out = {}
    for c in df.columns:
        s = df[c]
        if s.dtype.kind == "M":
            out[c] = s.to_numpy("datetime64[ns]")
        elif s.dtype == object or str(s.dtype) in ("str", "string"):
            out[c] = np.array([None if v is None or (isinstance(v, float)
                                                     and v != v) else v
                               for v in s], object)
        else:
            out[c] = s.to_numpy()
    return out


def assert_frames_equal(want: pd.DataFrame, got: dict, what: str = ""):
    want = as_columns(want)
    assert list(got) == list(want), (what, list(want), list(got))
    for c, w in want.items():
        g = got[c]
        if g.dtype.kind == "M":
            g = g.astype("datetime64[ns]")
        assert w.dtype == g.dtype, (what, c, w.dtype, g.dtype)
        assert w.shape == g.shape, (what, c, w.shape, g.shape)
        if w.dtype.kind in "fmM":
            np.testing.assert_array_equal(w, g, err_msg=f"{what} {c}")
        else:
            assert list(w) == list(g), (what, c)


# =============================================================================
# Stage by stage on the 24-subject layout
# =============================================================================
@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raw"))
    make_raw_layout(root)
    out = {}
    for name, m in (("jax", J), ("port", P)):
        t = m.load_raw_tables(root)
        icu = t["icustays"]
        r = {f"read_{k}": v for k, v in t.items()}
        r["slot_grid"] = m.build_slot_grid(icu)
        r["slot_of"] = m._slot_of(t["chartevents"], icu)
        chart, lab, inputev = m.fix_units(t["chartevents"], t["labevents"],
                                          t["inputevents"])
        r.update(fix_units_chart=chart, fix_units_lab=lab,
                 fix_units_inputs=inputev)
        chart, lab = m.remove_outliers(chart, lab)
        r.update(outliers_chart=chart, outliers_lab=lab)
        r["gcs"] = m.build_gcs(chart)
        r["bp"] = m.build_bp(chart, icu)
        r["urine"] = m.build_urine(t["outputevents"], icu)
        r["fluid"] = m.build_fluid(inputev, icu)
        r["binned"] = m.bin_chart_lab(chart, lab, icu)
        r["events"] = m.assemble_icu_events(r["binned"], r["bp"], r["fluid"],
                                            r["urine"], icu)
        r["static"] = m.build_static(t["admissions"], t["patients"], icu)
        r["catalog"], r["anchors"] = m.build_cxr_frames(
            t["cxr_metadata"], t["cxr_chexpert"], icu, "to_positive",
            seg_mask=t.get("cxr_seg_mask"),
            lung_mask_root=os.path.join(root, "cxr"))
        r["final"] = m.build_final_df(r["events"], r["anchors"])
        r["schema"] = m._schema_meta(r["static"], 24)
        out[name] = r
    return out


STAGES = ["read_admissions", "read_patients", "read_labevents",
          "read_icustays", "read_chartevents", "read_inputevents",
          "read_outputevents", "read_cxr_metadata", "read_cxr_chexpert",
          "read_cxr_seg_mask", "slot_grid", "fix_units_chart",
          "fix_units_lab", "fix_units_inputs", "outliers_chart",
          "outliers_lab", "gcs", "bp", "urine", "fluid", "binned", "events",
          "static", "catalog", "anchors", "final"]


@pytest.mark.parametrize("stage", STAGES)
def test_stage_equals_jax(stages, stage):
    want, got = stages["jax"][stage], stages["port"][stage]
    assert F.nrows(got) > 0, stage
    assert_frames_equal(want.reset_index(drop=True), got, stage)


def test_slot_of_and_schema_meta_equal_jax(stages):
    j, p = stages["jax"], stages["port"]
    np.testing.assert_array_equal(j["slot_of"], p["slot_of"])
    assert j["slot_of"].dtype == p["slot_of"].dtype
    for f in ("all_vars", "all_counts", "onehot_static", "d_static",
              "label_col", "n_timesteps"):
        assert getattr(j["schema"], f) == getattr(p["schema"], f), f


def test_the_stages_hold_the_notebook_rules(stages):
    """The port's frames carry JAX's stage semantics on the fixture:
    Fahrenheit converted, FiO2 in percent, the impossible heart rate gone,
    the ward creatinine at slot 0 only, GCS triples summed to 15."""
    ev = stages["port"]["events"]
    t = ev["temperature"][ev["count_temperature"] > 0]
    assert len(t) and ((t > 36.5) & (t < 38.5)).all()
    assert (ev["fio2"][ev["count_fio2"] > 0] == 40.0).all()
    assert ev["heart_rate"][ev["count_heart_rate"] > 0].max() < 300.0
    cr = ev["count_creatinine"]
    assert (cr[ev["slot_idx"] == 0] == 1).all()
    assert (cr[ev["slot_idx"] > 0] == 0).all()
    assert (ev["gcs"][ev["count_gcs"] > 0] == 15.0).all()


# =============================================================================
# Whole run_l0, on layouts and edge cases
# =============================================================================
def _edit(root: str, rel: str, fn):
    p = os.path.join(root, rel + ".csv")
    df = fn(pd.read_csv(p))
    df.to_csv(p, index=False)


def _no_bp(root):
    ids = [220050, 225309, 220179, 220051, 225310, 220180, 220052, 225312,
           220181]
    _edit(root, "icu/chartevents", lambda d: d[~d["itemid"].isin(ids)])


def _no_ward_labs(root):
    _edit(root, "hosp/labevents", lambda d: d[d["itemid"] != 50912])


def _no_seg_mask(root):
    os.remove(os.path.join(root, "cxr", "CXLSeg-mask.csv"))


def _no_valueuom(root):
    _edit(root, "icu/chartevents", lambda d: d.drop(columns="valueuom"))
    _edit(root, "hosp/labevents", lambda d: d.drop(columns="valueuom"))


def _duplicate_charttimes(root):
    """Repeated (stay, charttime, itemid) rows — a mean in the BP pivot,
    the last kept by the chart/lab dedupe — and a second charttime within
    a slot, whose value is the slot's last."""
    def dup(d):
        hr = d[d["itemid"] == 220045].groupby("stay_id").head(3)
        bp = d[d["itemid"].isin([220050, 220051])].groupby(
            "stay_id").head(2)
        later = hr.assign(charttime=pd.to_datetime(hr["charttime"])
                          + pd.Timedelta(minutes=25),
                          valuenum=hr["valuenum"] + 7.0)
        later["charttime"] = later["charttime"].dt.strftime(
            "%Y-%m-%d %H:%M:%S")
        return pd.concat([d, hr.assign(valuenum=hr["valuenum"] + 1.5),
                          bp.assign(valuenum=bp["valuenum"] * 1.01), later],
                         ignore_index=True)
    _edit(root, "icu/chartevents", dup)


LAYOUTS = {
    "seed0_24": (24, 0, None), "seed1_24": (24, 1, None),
    "seed0_120": (120, 0, None), "no_bp": (24, 0, _no_bp),
    "no_ward_labs": (24, 0, _no_ward_labs),
    "no_seg_mask": (24, 0, _no_seg_mask),
    "no_valueuom": (24, 0, _no_valueuom),
    "duplicate_charttimes": (24, 1, _duplicate_charttimes)}


def run_both(root: str, tmp) -> tuple:
    """JAX's run_l0 and the port's on one raw layout → their out dirs."""
    jout, pout = os.path.join(tmp, "jax"), os.path.join(tmp, "port")
    jp = J.run_l0(root, jout)
    pp = P.run_l0(root, pout)
    assert sorted(jp) == sorted(pp)
    return jp, pp


def assert_outputs_equal(jp: dict, pp: dict):
    a, b = np.load(jp["cohort"]), np.load(pp["cohort"])
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(jp["meta"], "rb") as f:
        ma = pickle.load(f)
    with open(pp["meta"], "rb") as f:
        mb = pickle.load(f)
    assert sorted(ma) == sorted(mb)
    for k, v in ma.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == mb[k].dtype, k
            np.testing.assert_array_equal(v, mb[k], err_msg=k)
        else:           # names, ints, and float stats bit for bit
            assert type(v) is type(mb[k]) and v == mb[k], k
    for name in ("static_full", "final_df", "final_cxr_df"):
        assert jp[name].endswith(f"{name}.ftr")
        assert pp[name].endswith(f"{name}.ftr")
        assert_feather_equal(jp[name], pp[name])
        assert_frames_equal(pd.read_feather(jp[name]),
                            F.read_feather(pp[name]), name)


def assert_feather_equal(want_path: str, got_path: str):
    """Two feather files: Arrow schemas equal field for field (name,
    type, nullability), and ``pd.read_feather`` of the two equal with no
    tolerance."""
    a = pa.ipc.open_file(want_path).schema
    b = pa.ipc.open_file(got_path).schema
    assert [(f.name, f.type, f.nullable) for f in a] == \
        [(f.name, f.type, f.nullable) for f in b], got_path
    pd.testing.assert_frame_equal(pd.read_feather(want_path),
                                  pd.read_feather(got_path),
                                  check_exact=True)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_run_l0_equals_jax(layout, tmp_path):
    n, seed, edit = LAYOUTS[layout]
    root = str(tmp_path / "raw")
    make_raw_layout(root, n_subjects=n, seed=seed)
    if edit is not None:
        edit(root)
    jp, pp = run_both(root, str(tmp_path))
    assert_outputs_equal(jp, pp)
    z = np.load(pp["cohort"])
    assert len(z["ev_stay_ids"]) > 0 and len(z["an_image_ids"]) > 0
    if layout == "no_bp":
        assert (z["ev_counts"][:, P.ALL_VARS.index("map")] == 0).all()
    if layout == "no_seg_mask":
        assert "lung_mask_path" not in F.read_feather(pp["final_cxr_df"])


def _to_feather(root: str, compression: str = "lz4", times: str = "",
                suffix: str = ".ftr", only=None):
    """Each raw table as ``pd.read_csv(p).to_feather(q)`` (groundwork cell
    3), the CSV removed; ``times`` ("ns"/"us") stores the time columns as
    ``timestamp[unit]`` instead of strings; ``only`` limits the tables."""
    for d, _, names in os.walk(root):
        for n in names:
            if not n.endswith(".csv"):
                continue
            rel = os.path.relpath(os.path.join(d, n), root)[:-4]
            if only is not None and rel not in only:
                continue
            df = pd.read_csv(os.path.join(d, n))
            if times:
                for c in df.columns:
                    if c in J._TIME_COLS:
                        df[c] = pd.to_datetime(df[c]).astype(
                            f"datetime64[{times}]")
            df.to_feather(os.path.join(d, n[:-4] + suffix),
                          compression=compression)
            os.remove(os.path.join(d, n))


def _no_deaths(root: str):
    """No death anywhere: ``deathtime`` and ``dod`` are empty columns,
    which ``pd.read_csv`` reads as float64 NaN and feather stores as
    all-null doubles."""
    for rel, col in (("hosp/admissions", "deathtime"),
                     ("hosp/patients", "dod")):
        p = os.path.join(root, rel + ".csv")
        df = pd.read_csv(p)
        df[col] = np.nan
        df.to_csv(p, index=False)


FEATHER_LAYOUTS = {
    "lz4": dict(compression="lz4"),
    "zstd": dict(compression="zstd"),
    "uncompressed": dict(compression="uncompressed"),
    "timestamp_ns": dict(times="ns"),
    "timestamp_us": dict(times="us"),
    "feather_suffix": dict(suffix=".feather",
                           only={"icu/chartevents", "hosp/patients"}),
    "empty_time_columns": dict(edit=_no_deaths),
}


@pytest.mark.parametrize("layout", sorted(FEATHER_LAYOUTS))
def test_run_l0_on_feather_tables_equals_jax(layout, tmp_path):
    """Raw tables as feather (times as strings under each codec, or as
    ``timestamp[ns]`` / ``timestamp[us]``; ``.feather``-named tables
    beside CSVs; time columns with no time at all): the port reads them
    without pyarrow and gives JAX's cohort, meta and audit files."""
    root = str(tmp_path / "raw")
    make_raw_layout(root)
    opts = dict(FEATHER_LAYOUTS[layout])
    edit = opts.pop("edit", None)
    if edit is not None:
        edit(root)
    _to_feather(root, **opts)
    if edit is _no_deaths:
        t = pa.ipc.open_file(os.path.join(root, "hosp", "patients.ftr"))
        assert t.schema.field("dod").type == pa.float64()
    jp, pp = run_both(root, str(tmp_path))
    assert_outputs_equal(jp, pp)


def test_a_feather_table_wins_over_its_csv(tmp_path):
    """A stem with a ``.ftr`` and a different ``.csv``: both packages read
    the ``.ftr`` (two stays fewer than the CSV holds)."""
    root = str(tmp_path / "raw")
    make_raw_layout(root)
    csv = os.path.join(root, "icu", "icustays.csv")
    df = pd.read_csv(csv)
    df.iloc[:-2].to_feather(os.path.join(root, "icu", "icustays.ftr"))
    jp, pp = run_both(root, str(tmp_path))
    assert_outputs_equal(jp, pp)
    z = np.load(pp["cohort"])
    assert len(z["st_stay_ids"]) <= len(df) - 2
    assert not set(df["stay_id"].iloc[-2:]) & set(z["st_stay_ids"].tolist())


def _truncate(path: str):
    with open(path, "rb") as fh:
        data = fh.read()
    with open(path, "wb") as fh:
        fh.write(data[:len(data) // 2])


def _bad_time(path: str):
    df = pd.read_feather(path)
    df.loc[0, "intime"] = "not a time"
    df.to_feather(path)


def _bool_time(path: str):
    df = pd.read_feather(path)
    df["intime"] = True
    df.to_feather(path)


@pytest.mark.parametrize("edit", [_truncate, _bad_time, _bool_time],
                         ids=["truncated", "bad_time", "bool_time"])
def test_a_bad_feather_table_raises_in_both(edit, tmp_path):
    """Where JAX's chain raises on a feather table, the port raises too
    (``ValueError``)."""
    root = str(tmp_path / "raw")
    make_raw_layout(root)
    _to_feather(root, only={"icu/icustays"})
    edit(os.path.join(root, "icu", "icustays.ftr"))
    with pytest.raises(Exception):
        J.run_l0(root, str(tmp_path / "jax"))
    with pytest.raises(ValueError):
        P.run_l0(root, str(tmp_path / "port"))
