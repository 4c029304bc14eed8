"""The port's data path (``data/synthetic.py``, ``data/pipeline.py``,
``data/meta.py``) against the JAX package's: the same seed gives the same
cohort, pixels, meta, grids, splits (the port's numpy
``train_test_split`` against sklearn's), windows and batches; and the
port reads a cohort the JAX package's preprocessing wrote (``--data_dir``).

Tolerance: equal (numpy copies of numpy code; the window gather moves
values), except the meta statistics, which are equal too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import train_test_split as sk_split

from multimodal_edema_prediction_tpu.config import DataConfig as JData
from multimodal_edema_prediction_tpu.data import ingest as JI
from multimodal_edema_prediction_tpu.data import pipeline as JP
from multimodal_edema_prediction_tpu.data import synthetic as JS
from multimodal_edema_prediction_tpu_torch.config import DataConfig
from multimodal_edema_prediction_tpu_torch.data import ingest as I
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import synthetic as S


@pytest.fixture(scope="module")
def cohorts():
    kw = dict(seed=0, n_subjects=30, n_stays=60, n_variables=8, min_len=26,
              max_len=40)
    jds, ds = JS.make_synthetic(**kw), S.make_synthetic(**kw)
    jmeta = JP.meta_from_events(jds, JData())
    meta = P.meta_from_events(ds, DataConfig())
    return (jds, jmeta, JP.build_anchor_dataset(jds, jmeta, JData()),
            ds, meta, P.build_anchor_dataset(ds, meta, DataConfig()))


@pytest.mark.parametrize("n,test_size,seed", [
    (2, 0.3, 42), (7, 0.3, 42), (30, 0.3, 0), (101, 0.5, 42),
    (1000, 0.15, 3)])
def test_train_test_split_matches_sklearn(n, test_size, seed):
    x = np.arange(100, 100 + n) * 3
    for got, want in zip(P.train_test_split(x, test_size, seed),
                         sk_split(x, test_size=test_size, random_state=seed)):
        np.testing.assert_array_equal(got, want)


def test_synthetic_cohort_and_pixels(cohorts):
    jds, _, _, ds, _, _ = cohorts
    for part in ("events", "static", "anchors", "cxr_catalog"):
        a, b = getattr(jds, part), getattr(ds, part)
        for f in a.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    ids = jds.anchors.image_ids[:3]
    lab = jds.anchors.labels[:3]
    np.testing.assert_array_equal(
        S.synthetic_image_batch(None, ids, lab, 56),
        JS.synthetic_image_batch(None, ids, lab, 56))


def test_synthetic_pixels_do_not_depend_on_the_thread_pool():
    """The images are drawn on a pool of host threads: a batch equals its
    images drawn one at a time (one image takes no pool), and the hook's
    normalization equals ``(px - mean) / std`` of the raw images."""
    from multimodal_edema_prediction_tpu_torch.train import teacher_loop
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 10**6, 9)
    lab = np.where(rng.random((9, 7)) < 0.2, np.nan,
                   rng.random((9, 7)) > 0.5).astype(np.float32)
    batch = S.synthetic_image_batch(None, ids, lab, 56)
    one_by_one = np.concatenate([S.synthetic_image_batch(
        None, ids[i:i + 1], lab[i:i + 1], 56) for i in range(9)])
    np.testing.assert_array_equal(batch, one_by_one)
    mean = np.asarray(teacher_loop.IMAGE_MEAN, np.float32)
    std = np.asarray(teacher_loop.IMAGE_STD, np.float32)
    hooked = teacher_loop.make_synthetic_pixel_hook(56)(
        {"image_ids": ids, "y_multi": lab})["pixel_values"]
    np.testing.assert_array_equal(hooked, (batch - mean) / std)
    assert S.synthetic_image_batch(None, ids[:0], lab[:0], 56).shape == (
        0, 56, 56, 3)


def test_meta_grid_and_splits(cohorts):
    _, jmeta, jad, _, meta, ad = cohorts
    for f in ("means", "stds", "age_mean", "age_std", "train_ids",
              "val_ids", "test_ids"):
        np.testing.assert_array_equal(getattr(meta, f), getattr(jmeta, f))
    np.testing.assert_array_equal(ad.grid.numpy(), np.asarray(jad.grid))
    np.testing.assert_array_equal(ad.static.numpy(), np.asarray(jad.static))
    assert sorted(ad.splits) == sorted(jad.splits)
    for k in ad.splits:
        np.testing.assert_array_equal(ad.splits[k], jad.splits[k])
    for k in jad.anchor:
        np.testing.assert_array_equal(ad.anchor[k], jad.anchor[k])


@pytest.mark.parametrize("split,shuffle,bs", [("train", True, 16),
                                              ("val", False, 16),
                                              ("test", False, 5)])
def test_batches_and_windows(cohorts, split, shuffle, bs):
    _, _, jad, _, _, ad = cohorts
    want = list(jad.iter_batches(split, bs, shuffle=shuffle, seed=3))
    got = list(ad.iter_batches(split, bs, shuffle=shuffle, seed=3))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        win = P.gather_windows(ad.grid, torch.from_numpy(g["stay_rows"]),
                               torch.from_numpy(g["slot_idx"]), 24)
        jwin = JP.gather_windows(jad.grid, jnp.asarray(w["stay_rows"]),
                                 jnp.asarray(w["slot_idx"]), 24)
        np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    assert len(list(ad.iter_batches(split, bs, shuffle, limit=1))) == 1


def test_gather_windows_clamps_like_dynamic_slice():
    grid = np.arange(2 * 10 * 3, dtype=np.float32).reshape(2, 10, 3)
    rows, ends = np.array([0, 1, 1], np.int32), np.array([2, 10, 7],
                                                         np.int32)
    got = P.gather_windows(torch.from_numpy(grid), torch.from_numpy(rows),
                           torch.from_numpy(ends), 4)
    want = JP.gather_windows(jnp.asarray(grid), jnp.asarray(rows),
                             jnp.asarray(ends), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reads_a_cohort_the_jax_package_wrote(cohorts, tmp_path):
    """``cohort.npz`` + ``meta_with_stats.pkl`` as the JAX package writes
    them (``save_npz``, ``Meta.save``) load into the same anchor dataset;
    a directory without them names the port's ``cli.preprocess``."""
    jds, jmeta, jad, _, _, _ = cohorts
    JI.save_npz(str(tmp_path / "cohort.npz"), JI.IngestedDataset(
        jds.events, jds.static, jds.anchors, jds.cxr_catalog,
        jds.var_names, jds.onehot_names))
    jmeta.save(str(tmp_path / "meta_with_stats.pkl"))
    ds, meta = I.load_artifacts(str(tmp_path))
    assert meta.all_vars == jmeta.all_vars
    np.testing.assert_array_equal(meta.means, jmeta.means)
    ad = P.build_anchor_dataset(ds, meta, DataConfig())
    np.testing.assert_array_equal(ad.grid.numpy(), np.asarray(jad.grid))
    for k in jad.splits:
        np.testing.assert_array_equal(ad.splits[k], jad.splits[k])
    with pytest.raises(FileNotFoundError, match="cli.preprocess"):
        I.load_artifacts(str(tmp_path / "missing"))
