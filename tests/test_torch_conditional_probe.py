"""The conditional-information probes in the port
(``analysis/conditional_information_probe.py``,
``analysis/raw_trajectory_conditional_probe.py``) against the JAX
package's, on the CPU.

Tolerances: ``fit_logistic`` (scipy's L-BFGS-B on sklearn's objective,
rounding, start and options) within 1e-5 of the decision values' max abs
of sklearn's ``LogisticRegression(max_iter=2000, C=1.0)`` on the probes'
four shapes, in float32 (as the JAX script feeds it: sklearn then
computes in float32) and float64; the probes on equal inputs equal; the
raw-summary helpers, the folds and the offset correction's candidate
search equal (the same numpy and scipy code); ``fit_offset_weights``
within 1e-8. Each script's JSON, CSV and NPZ at float32 (both packages'
eval steps at float32, JAX's patched from the test) within 1e-4 of
max(1, |value|) for floats, and exactly for counts, subject ids, labels,
``selected_l2``, ``null_selected``, ``evidence`` and the permutation
p-values; token_linear's per-sample probabilities within 5e-3 end to
end (``UNSTABLE``: sklearn's early stop moves them with the float32
rounding of the inputs) and bit for bit on equal inputs.
"""
import csv
import os

import numpy as np
import pytest
import torch
from sklearn.linear_model import LogisticRegression

from analysis_port_util import _one_thread  # noqa: F401
from analysis_port_util import (assert_report_close, flags, jax_at_float32,
                                write_teacher)
from multimodal_edema_prediction_tpu.analysis import \
    conditional_information_probe as JC
from multimodal_edema_prediction_tpu.analysis import \
    raw_trajectory_conditional_probe as JR
from multimodal_edema_prediction_tpu_torch.analysis import \
    conditional_information_probe as C
from multimodal_edema_prediction_tpu_torch.analysis import \
    raw_trajectory_conditional_probe as R

STAYS = ["--synthetic_stays", "200"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_teacher(str(tmp_path_factory.mktemp("teacher")
                             / "teacher.msgpack"))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_features", [1, 2, 3, 257])
def test_fit_logistic_matches_sklearn(n_features, dtype):
    """The four probes' shapes (image_cal, logit_add, logit_interaction,
    token_linear at d_latent 256) on 442 train rows, in float32 (what the
    script hands it) and float64: decision values within 1e-5 of their
    max abs (in fact equal: the same objective, rounding and start)."""
    rng = np.random.default_rng(n_features)
    X = rng.normal(size=(442, n_features)).astype(dtype)
    X[:, 0] *= 2.5
    z = 0.8 * X[:, 0] + 0.3 * X[:, -1] - 0.4
    y = (rng.random(442) < 1 / (1 + np.exp(-z))).astype(np.float32)
    Xev = rng.normal(size=(126, n_features)).astype(dtype)
    want = LogisticRegression(max_iter=2000, C=1.0).fit(X, y)\
        .decision_function(Xev)
    got = C.logistic_decision(Xev, *C.fit_logistic(X, y))
    assert got.dtype == want.dtype
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_fit_logistic_refuses_one_class():
    """A train split of one class raises, as sklearn's fit does."""
    X = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="2 classes"):
        C.fit_logistic(X, np.zeros(40, np.float32))
    with pytest.raises(ValueError):
        LogisticRegression(max_iter=2000, C=1.0).fit(X, np.zeros(40))


def _windows(n=300, seed=0):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(n, 24, 6))
    counts = np.where(rng.random((n, 24, 6)) < 0.6, 0,
                      rng.integers(1, 4, (n, 24, 6)))
    counts[:3, :, 1] = 0                     # never observed
    counts[3:6, :, 2] = 0
    counts[3:6, 7, 2] = 2                    # observed once
    return np.concatenate([values, counts], -1).astype(np.float32)


def test_raw_helpers_equal_jax():
    """``raw_summaries`` per block and whole, ``Standardizer`` (with NaNs),
    ``_stratified_folds`` and ``fit_offset_correction``'s search: equal;
    ``fit_offset_weights`` within 1e-8."""
    xw = _windows()
    for blocks in (R.BLOCKS, ("level",), ("trajectory",), ("observation",)):
        a, b = R.raw_summaries(xw, blocks), JR.raw_summaries(xw, blocks)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    X = R.raw_summaries(xw)
    X[::7, 3] = np.nan
    X[:, 5] = np.nan
    s, js = R.Standardizer.fit(X), JR.Standardizer.fit(X)
    np.testing.assert_array_equal(s(X), js(X))
    rng = np.random.default_rng(1)
    y = (rng.random(len(X)) < 0.3).astype(np.float32)
    for seed in (0, 4):
        for (a, b), (c, d) in zip(R._stratified_folds(y, 5, seed),
                                  JR._stratified_folds(y, 5, seed)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    offset = rng.normal(size=len(X))
    Xs = s(X)
    np.testing.assert_allclose(R.fit_offset_weights(Xs, y, offset, 1e-2),
                               JR.fit_offset_weights(Xs, y, offset, 1e-2),
                               rtol=0, atol=1e-8)
    y2 = (rng.random(len(X)) < 1 / (1 + np.exp(-(offset + Xs[:, 0])))
          ).astype(np.float32)
    for yy in (y, y2):
        got = R.fit_offset_correction(X, yy, offset, seed=2)
        want = JR.fit_offset_correction(X, yy, offset, seed=2)
        assert got.selected_l2 == want.selected_l2
        assert got.cv_results == want.cv_results
        np.testing.assert_allclose(got.weights, want.weights, rtol=0,
                                   atol=1e-8)


def test_offset_correction_null_wins_on_noise():
    """JAX's case (tests/test_analysis_extended.py): pure-noise features
    lose to the exact null, features that carry the residual win."""
    rng = np.random.default_rng(0)
    N, F = 2000, 12
    X = rng.normal(size=(N, F))
    offset = rng.normal(size=N)
    y = (rng.random(N) < 1 / (1 + np.exp(-offset))).astype(np.float32)
    corr = R.fit_offset_correction(X, y, offset, seed=0)
    assert corr.null_selected
    assert np.all(corr.weights == 0.0)
    z = rng.normal(size=N)
    y2 = (rng.random(N) < 1 / (1 + np.exp(-(offset + 2 * z)))).astype(
        np.float32)
    X2 = np.concatenate([z[:, None], rng.normal(size=(N, F - 1))], axis=1)
    corr2 = R.fit_offset_correction(X2, y2, offset, seed=0)
    assert not corr2.null_selected
    assert "null" in corr2.cv_results and len(corr2.cv_results) == 1 + len(
        R.L2_GRID)


# token_linear's scores: sklearn's search stops at its gtol (1e-4), and
# on 1 + d_latent standardized features where that stop falls moves with
# the float32 rounding of its inputs: the two packages' fusion tokens
# (~4e-7 of their scale apart) move these probabilities by 1e-5 to 1.2e-3
# from run to run (torch's thread count alone moves them; ROADMAP Queue 3
# logs the readings). End to end they are held within UNSTABLE_TOL, above
# the largest reading and far below a wrong array's gap (~0.1 to 0.5: the
# wrong label, scores or sigmoid); on equal inputs they are equal bit for
# bit (test_probes_on_equal_inputs_equal_jax).
UNSTABLE = ("_token_linear_probability",)
UNSTABLE_TOL = 5e-3
EXACT = ("evidence", "p_conditional_perm", "selected_l2", "null_selected",
         "skipped")


def _exact(got, want, path=""):
    """The discrete entries of two reports equal."""
    if isinstance(want, dict):
        for k, v in want.items():
            if k in EXACT:
                assert got[k] == v, (path, k, got[k], v)
            else:
                _exact(got[k], v, f"{path}/{k}")


def _assert_files_close(port_dir, jax_dir, csv_name, npz_name):
    with open(os.path.join(port_dir, csv_name)) as f:
        got = list(csv.DictReader(f))
    with open(os.path.join(jax_dir, csv_name)) as f:
        want = list(csv.DictReader(f))
    assert len(got) == len(want) and got and list(got[0]) == list(want[0])
    for g, w in zip(got, want):
        for k, v in w.items():
            if k in EXACT or k in ("label", "probe") or not v:
                assert g[k] == v, k
            elif v.startswith("{"):
                import json
                assert_report_close(json.loads(g[k]), json.loads(v), 1e-4)
            else:
                assert abs(float(g[k]) - float(v)) <= 1e-4 * max(
                    1.0, abs(float(v))), k
    with np.load(os.path.join(port_dir, npz_name)) as z, \
            np.load(os.path.join(jax_dir, npz_name)) as zj:
        assert sorted(z.files) == sorted(zj.files) and z.files
        for k in zj.files:
            a, b = z[k], zj[k]
            assert a.shape == b.shape and a.dtype == b.dtype, k
            if k.endswith(("_y", "_subject_ids")):
                np.testing.assert_array_equal(a, b, err_msg=k)
            else:
                np.testing.assert_allclose(
                    a, b, rtol=0, err_msg=k,
                    atol=UNSTABLE_TOL if k.endswith(UNSTABLE) else 1e-4)


def test_probes_on_equal_inputs_equal_jax(ckpt, monkeypatch):
    """The port's collection of one label's splits within 1e-5 of JAX's
    (counts, labels and subject ids equal); then, on JAX's own
    collection, each probe's scores and AUROC and the conditional
    permutation nulls equal JAX's bit for bit."""
    import argparse
    from multimodal_edema_prediction_tpu.analysis import common as JCm
    from multimodal_edema_prediction_tpu_torch.analysis import common as Cm
    jax_at_float32(monkeypatch)
    argv = flags(ckpt, "-", STAYS)
    p = argparse.ArgumentParser()
    JCm.add_analysis_flags(p)
    args = p.parse_args(argv)
    model, cfg, params, stats, _ = JCm.load_teacher(args.ckpt)
    _, _, ds, _ = JCm.load_analysis_data(args,
                                         n_variables=cfg.duett.n_variables)
    src, _ = JCm.make_sources(args, ds, model, params, cfg)
    jtr, jev = (JC.collect_with_tokens(model, params, stats, ds, split, 16,
                                       src, 6) for split in ("train", "test"))
    p = argparse.ArgumentParser()
    Cm.add_analysis_flags(p)
    pm, _, pds, _, psrc, _ = Cm.load_for_analysis(
        p.parse_args(argv + ["--device", "cpu"]), torch.float32,
        grid_on_device=False)
    for split, want in (("train", jtr), ("test", jev)):
        got = C.collect_with_tokens(pm, pds, split, 16, psrc, 6,
                                    dtype=torch.float32)
        for k in ("y", "sid"):
            np.testing.assert_array_equal(got[k], want[k])
        for k in ("img", "ts", "tok"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
    for name in C.PROBES:
        got, want = C.fit_eval(name, jtr, jev), JC.fit_eval(name, jtr, jev)
        np.testing.assert_array_equal(got["scores"], want["scores"])
        assert got["auroc"] == want["auroc"]
    for name in ("logit_add", "token_linear"):
        np.testing.assert_array_equal(
            C.conditional_permutation_null(jtr, jev, name, 5, seed=1),
            JC.conditional_permutation_null(jtr, jev, name, 5, seed=1))


SCRIPTS = {
    # the conditional probe's 7-label sweep re-collects both splits per
    # label, as JAX does
    "conditional": (JC, C, ["--n_perm", "5"],
                    ("conditional_probe.csv",
                     "conditional_probe_predictions.npz")),
    "raw": (JR, R, ["--n_perm", "3"],
            ("raw_trajectory_probe.csv",
             "raw_trajectory_probe_predictions.npz")),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_report_and_files_match_jax(name, ckpt, tmp_path, monkeypatch):
    jax_mod, mod, extra, (csv_name, npz_name) = SCRIPTS[name]
    argv = STAYS + extra
    with monkeypatch.context() as mp:
        jax_at_float32(mp)
        want = jax_mod.main(flags(ckpt, tmp_path / "jax", argv))
    got = mod.main(flags(ckpt, tmp_path / "port", argv + ["--device",
                                                         "cpu"]),
                   dtype=torch.float32)
    assert any("skipped" not in r for r in want.values())
    assert_report_close(got, want, 1e-4)
    _exact(got, want)
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    _assert_files_close(tmp_path / "port", tmp_path / "jax", csv_name,
                        npz_name)


def test_scripts_refuse_to_fall_back_to_the_cpu(ckpt, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mod in (C, R):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(flags(ckpt, tmp_path))
