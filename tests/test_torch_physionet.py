"""The port's PhysioNet-2012 data (``data/physionet.py``, ROADMAP P14)
against the JAX package's, exactly: the synthetic P12-shaped cohort, and
the raw challenge-file reader on files this test writes (the published
layout: ``set-a/<RecordID>.txt`` + ``Outcomes-a.txt``, as
``tests/test_physionet_raw.py`` fabricates them) in ``absolute`` (hourly
means) and ``relative`` (the reference's own bins) binning, each with its
meta; then ``cli.train_physionet`` on the CPU."""
import os

import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.data import physionet as JPH
from multimodal_edema_prediction_tpu_torch.cli import train_physionet
from multimodal_edema_prediction_tpu_torch.data import physionet as PH
from multimodal_edema_prediction_tpu_torch.data.sliding import \
    build_stay_label_dataset


def _assert_same_cohort(got, want):
    (ds, meta), (jds, jmeta) = got, want
    for table in ("events", "static"):
        a, b = getattr(ds, table), getattr(jds, table)
        for f in vars(b):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"{table}.{f}")
            assert np.asarray(getattr(a, f)).dtype == \
                np.asarray(getattr(b, f)).dtype, f"{table}.{f}"
    assert ds.var_names == jds.var_names
    assert ds.onehot_names == jds.onehot_names
    for f in ("means", "stds", "train_ids", "val_ids", "test_ids"):
        np.testing.assert_array_equal(getattr(meta, f), getattr(jmeta, f),
                                      err_msg=f)
    for f in ("d_static", "label_col", "age_mean", "age_std", "all_vars",
              "onehot_static"):
        assert getattr(meta, f) == getattr(jmeta, f), f


def test_constants_match_jax():
    assert (PH.N_TS_VARS, PH.N_STATIC) == (JPH.N_TS_VARS, JPH.N_STATIC) \
        == (36, 8)
    assert PH.P12_TS_PARAMS == JPH.P12_TS_PARAMS
    assert PH.P12_STATIC_PARAMS == JPH.P12_STATIC_PARAMS


@pytest.mark.parametrize("kw", [{}, {"seed": 3, "n_patients": 50,
                                     "obs_rate": 0.4}])
def test_synthetic_physionet_matches_jax(kw):
    got = PH.make_synthetic_physionet(**kw)
    want = JPH.make_synthetic_physionet(**kw)
    _assert_same_cohort(got, want)
    np.testing.assert_array_equal(got[0].latent_by_stay,
                                  want[0].latent_by_stay)
    assert got[1].label_col == "death_adm"


def _write_record(d, rid, rows, statics):
    lines = ["Time,Parameter,Value", f"00:00,RecordID,{rid}"]
    lines += [f"00:00,{k},{v}" for k, v in statics.items()]
    lines += [f"{t},{p},{v}" for t, p, v in rows]
    with open(os.path.join(d, f"{rid}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    """Records over two sets with repeated, missing (-1) and out-of-range
    observations, a record without a RecordID row, unknown parameters and
    two outcome files."""
    root = tmp_path_factory.mktemp("p12")
    rng = np.random.default_rng(0)
    rids = []
    for s, first in (("set-a", 132539), ("set-b", 142539)):
        os.makedirs(root / s)
        for rid in range(first, first + 9):
            rows = []
            for _ in range(40):
                hh, mm = rng.integers(0, 60), rng.integers(0, 60)
                p = PH.P12_TS_PARAMS[rng.integers(0, PH.N_TS_VARS)] \
                    if rng.random() > 0.05 else "Unknown"
                v = round(float(rng.normal(100, 20)), 1) \
                    if rng.random() > 0.05 else -1
                rows.append((f"{hh:02d}:{mm:02d}", p, v))
            statics = {"Age": int(rng.integers(40, 90)),
                       "Gender": int(rng.integers(0, 2)),
                       "Height": round(float(rng.normal(170, 10)), 1)
                       if rng.random() > 0.2 else -1,
                       "ICUType": int(rng.integers(1, 5)),
                       "Weight": round(float(rng.normal(80, 15)), 1)}
            _write_record(str(root / s), rid, rows, statics)
            rids.append(rid)
    # a record whose id comes from its file name
    with open(root / "set-a" / "132999.txt", "w") as f:
        f.write("Time,Parameter,Value\n00:00,Age,55\n01:10,HR,80\n")
    for suffix, part in (("a", rids[:9] + [132999]), ("b", rids[9:])):
        with open(root / f"Outcomes-{suffix}.txt", "w") as f:
            f.write("RecordID,SAPS-I,SOFA,Length_of_stay,Survival,"
                    "In-hospital_death\n")
            for i, rid in enumerate(part):
                f.write(f"{rid},10,5,7,-1,{i % 2}\n")
    return str(root)


@pytest.mark.parametrize("kw", [{}, {"binning": "relative", "n_bins": 24},
                                {"binning": "relative", "n_bins": 6},
                                {"max_hours": 24, "sets": ("set-b",)}])
def test_raw_loader_matches_jax(raw_dir, kw):
    got = PH.load_physionet2012_raw(raw_dir, **kw)
    want = JPH.load_physionet2012_raw(raw_dir, **kw)
    _assert_same_cohort(got, want)
    assert len(got[0].events.stay_ids) == (9 if "sets" in kw else 19)


def test_raw_loader_refuses_what_jax_refuses(raw_dir, tmp_path):
    with pytest.raises(ValueError, match="binning"):
        PH.load_physionet2012_raw(raw_dir, binning="weekly")
    with pytest.raises(FileNotFoundError, match="no P12 records"):
        PH.load_physionet2012_raw(str(tmp_path))
    assert PH.load_physionet2012(raw_dir)[0].events.values.shape[1] == 36


def test_raw_cohort_flows_into_the_stay_label_dataset(raw_dir):
    ds, meta = PH.load_physionet2012_raw(raw_dir)
    sld = build_stay_label_dataset(ds, meta, n_timesteps=24)
    assert sld.grid.shape[2] == 2 * PH.N_TS_VARS
    assert sum(sld.split_size(s) for s in ("train", "val", "test")) == 19
    b = next(sld.iter_batches("train", 4, shuffle=False))
    assert set(b) == {"stay_rows", "slot_idx", "bin_ends", "y"}


def test_cli_on_the_cpu(raw_dir, tmp_path):
    """``cli.train_physionet``: SSL on sliding windows, then fine-tuning
    from its best checkpoint, on the synthetic cohort and on raw files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        extras = {}
        out = train_physionet.main([
            "--device", "cpu", "--n_patients", "60", "--pretrain_epochs",
            "1", "--finetune_epochs", "1", "--batch_size", "16", "--seeds",
            "0", "--top_k", "1", "--d_embedding", "8", "--ckpt_dir",
            str(tmp_path / "syn")], extras=extras)
        assert np.isfinite(out["test_auroc_mean"])
        assert extras["ssl"].best_path.startswith(str(tmp_path / "syn"
                                                      / "ssl"))
        assert os.listdir(tmp_path / "syn" / "finetune" / "seed0")
        raw = train_physionet.main([
            "--device", "cpu", "--data_dir", raw_dir, "--pretrain_epochs",
            "1", "--finetune_epochs", "1", "--batch_size", "4", "--seeds",
            "1", "--top_k", "1", "--d_embedding", "8", "--ckpt_dir",
            str(tmp_path / "raw")])
        assert [r["seed"] for r in raw["per_seed"]] == [1]
    finally:
        torch.set_num_threads(n)
