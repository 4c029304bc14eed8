"""The analysis suite's first half in the port (``analysis/``) against the
JAX package's, on the CPU: the shared helpers of ``common.py`` (numpy,
equal to JAX's bit for bit), the ``jax.random`` draws the probes start
from (``data/pipeline.jax_key``/``jax_split``/``jax_normal``), optax's
Adam (``common.adam``), and each script's report on one tiny teacher
checkpoint the JAX package wrote (``analysis_port_util.write_teacher``).

Tolerances: the reports at float32 (both packages' eval steps patched to
float32 from the test) agree within 1e-4 of max(1, |value|) for every
float, and exactly for counts, ids, labels and verdicts; the two Adam
probes (``logit_fusion_probe``, ``unimodal_linear_probe``) within 5e-3,
the repo's precedent for loops that differ in their autodiff's rounding.
``jax_normal`` is within 1.2e-7 of ``jax.random.normal`` (the same
threefry bits; ``log1p`` rounds apart, as ``jax_normal_f32``'s note says).
At the CLIs' default bf16 each script's report has the float32 report's
structure. The encode-once tier's complementarity matches the pixel
tier's at float32 (1e-5), and at bf16 differs by at most one sample per label
and accuracy.
"""
import argparse
import os

import jax
import numpy as np
import optax
import pytest
import torch

from analysis_port_util import (assert_report_close, flags, jax_at_float32,
                                write_teacher)
from multimodal_edema_prediction_tpu.analysis import common as JC
from multimodal_edema_prediction_tpu.analysis import complementarity as JCo
from multimodal_edema_prediction_tpu.analysis import \
    diagnose_temporal_usage as JD
from multimodal_edema_prediction_tpu.analysis import logit_fusion_probe as JL
from multimodal_edema_prediction_tpu.analysis import \
    residual_by_confidence as JR
from multimodal_edema_prediction_tpu.analysis import \
    trajectory_availability as JTA
from multimodal_edema_prediction_tpu.analysis import \
    unimodal_linear_probe as JU
from multimodal_edema_prediction_tpu_torch.analysis import common as C
from multimodal_edema_prediction_tpu_torch.analysis import (
    complementarity, diagnose_temporal_usage, logit_fusion_probe,
    residual_by_confidence, trajectory_availability, unimodal_linear_probe)
from multimodal_edema_prediction_tpu_torch.data import pipeline as P

SCRIPTS = {
    "residual_by_confidence": (JR, residual_by_confidence, [], 1e-4),
    "complementarity": (JCo, complementarity, [], 1e-4),
    "logit_fusion_probe": (JL, logit_fusion_probe,
                           ["--probe_steps", "60"], 5e-3),
    "diagnose_temporal_usage": (JD, diagnose_temporal_usage,
                                ["--max_batches", "2"], 1e-4),
    "unimodal_linear_probe": (JU, unimodal_linear_probe,
                              ["--probe_steps", "60"], 5e-3),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_teacher(str(tmp_path_factory.mktemp("teacher")
                             / "teacher.msgpack"))


def _data(pkg):
    p = argparse.ArgumentParser()
    pkg.add_analysis_flags(p, needs_ckpt=False)
    return pkg.load_analysis_data(p.parse_args(flags(None, "-")))[2]


def test_common_helpers_equal_jax():
    """``gather_host_windows`` on both packages' cohorts,
    ``different_subject_permutation`` (a derangement, and the roll
    fallback when one subject dominates), ``subject_cluster_bootstrap``
    and ``attention_entropy``: equal bit for bit."""
    jd, pd = _data(JC), _data(C)
    idx = jd.splits["test"][:10]
    for a, b in zip(JC.gather_host_windows(jd, idx),
                    C.gather_host_windows(pd, idx)):
        np.testing.assert_array_equal(a, b)
    for sid in (np.array([1, 1, 2, 3, 3, 4, 5, 6]), np.array([7] * 6 + [8])):
        for seed in range(3):
            np.testing.assert_array_equal(
                JC.different_subject_permutation(
                    sid, np.random.default_rng(seed)),
                C.different_subject_permutation(
                    sid, np.random.default_rng(seed)))
    rng = np.random.default_rng(0)
    sid = rng.integers(0, 12, 60)
    vals = rng.normal(size=60)

    def stat(i):
        return float(vals[i].mean()) if len(i) > 20 else float("nan")

    assert C.subject_cluster_bootstrap(sid, stat, 50, 3) == \
        JC.subject_cluster_bootstrap(sid, stat, 50, 3)
    attn = rng.random((5, 7, 11)).astype(np.float32)
    np.testing.assert_array_equal(C.attention_entropy(attn),
                                  JC.attention_entropy(attn))


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 + 5])
def test_threefry_helpers_match_jax_random(seed):
    """``jax.random.key``/``split`` bit for bit; ``normal`` within one
    float32 ulp of 1 (1.2e-7)."""
    k = jax.random.key(seed)
    assert P.jax_key(seed) == tuple(
        int(x) for x in np.asarray(jax.random.key_data(k)))
    assert P.jax_split(P.jax_key(seed)) == [
        tuple(int(x) for x in np.asarray(jax.random.key_data(s)))
        for s in jax.random.split(k)]
    for shape in ((14, 7), (33,)):
        np.testing.assert_allclose(
            P.jax_normal(P.jax_key(seed), shape).numpy(),
            np.asarray(jax.random.normal(k, shape)), rtol=0, atol=1.2e-7)


def test_adam_matches_optax():
    """100 full-batch steps of ``common.adam`` and of ``optax.adam`` on a
    masked multi-label logistic loss: parameters within 1e-5."""
    from multimodal_edema_prediction_tpu.ops.losses import \
        masked_per_label_bce as jbce
    from multimodal_edema_prediction_tpu_torch.ops.losses import \
        masked_per_label_bce as tbce
    rng = np.random.default_rng(1)
    x = rng.normal(size=(40, 6)).astype(np.float32)
    y = (rng.random((40, 3)) < 0.4).astype(np.float32)
    m = (rng.random((40, 3)) < 0.8).astype(np.float32)
    p0 = {"w": 0.1 * rng.normal(size=(6, 3)).astype(np.float32),
          "b": np.zeros(3, np.float32)}
    tx = optax.adam(5e-2)
    p, s = jax.tree.map(jax.numpy.asarray, p0), None
    s = tx.init(p)
    for _ in range(100):
        g = jax.grad(lambda q: jbce(x @ q["w"] + q["b"], y, m).sum())(p)
        u, s = tx.update(g, s, p)
        p = optax.apply_updates(p, u)
    xt, yt, mt = (torch.from_numpy(a) for a in (x, y, m))
    got = C.adam(lambda q: tbce(xt @ q["w"] + q["b"], yt, mt).sum(),
                 {k: torch.from_numpy(v) for k, v in p0.items()}, 5e-2, 100)
    for k in p0:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(p[k]),
                                   rtol=1e-5, atol=1e-5)


def test_trajectory_availability_equals_jax(tmp_path):
    argv = flags(None, tmp_path / "j", ["--max_samples", "200"])
    want = JTA.main(argv)
    got = trajectory_availability.main(
        flags(None, tmp_path / "p", ["--max_samples", "200", "--device",
                                     "cpu"]))
    assert got == want
    assert os.listdir(tmp_path / "p") == ["trajectory_availability.json"]


def _structure(r):
    """A report's keys and list lengths, and its counts ``n``."""
    if isinstance(r, dict):
        return {k: (v if k in ("n", "samples", "total") else _structure(v))
                for k, v in r.items()}
    if isinstance(r, (list, tuple)):
        return [len(r)] + [_structure(v) for v in r[:1]]
    return type(r).__name__ if isinstance(r, str) else "x"


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_report_matches_jax(name, ckpt, tmp_path, monkeypatch):
    """At float32: the port's report equals JAX's within the script's
    tolerance, and both write the same files. At the default bf16 the
    port's report has the same structure."""
    jax_mod, mod, extra, tol = SCRIPTS[name]
    with monkeypatch.context() as mp:
        jax_at_float32(mp)
        want = jax_mod.main(flags(ckpt, tmp_path / "jax", extra))
    got = mod.main(flags(ckpt, tmp_path / "port", extra + ["--device",
                                                           "cpu"]),
                   dtype=torch.float32)
    assert_report_close(got, want, tol)
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    bf16 = mod.main(flags(ckpt, tmp_path / "bf16", extra + ["--device",
                                                            "cpu"]))
    assert _structure(bf16) == _structure(got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_complementarity_feature_cache_parity(dtype, ckpt, tmp_path):
    """``--cxr_feature_cache hbm`` does not change the analysis: the
    tokens of the bank are the frozen ViT's. At float32 the two tiers'
    reports agree (counts equal, floats within 1e-5); at bf16 the per-label counts agree and each
    accuracy is within one sample's flip (1/n: the bank's chunks and the
    eval's batches round apart near a threshold; JAX's own test bounds the
    same difference by 0.02 on a cohort of 400 stays), the time-series
    branch's equal."""
    px = complementarity.main(flags(ckpt, tmp_path / "px", ["--device",
                                                            "cpu"]),
                              dtype=dtype)
    ft = complementarity.main(flags(ckpt, tmp_path / "ft", [
        "--device", "cpu", "--cxr_feature_cache", "hbm"]), dtype=dtype)
    assert any(r["n"] for r in px["per_label"])
    if dtype == torch.float32:
        assert_report_close(ft, px, 1e-5)
        return
    for r_px, r_ft in zip(px["per_label"], ft["per_label"]):
        assert r_px["n"] == r_ft["n"]
        if r_px["n"]:
            for k in ("img_acc", "fus_acc"):
                assert abs(r_px[k] - r_ft[k]) <= 1 / r_px["n"] + 1e-12, \
                    (r_px["label"], k)
            assert r_px["ts_acc"] == r_ft["ts_acc"]


def test_scripts_refuse_to_fall_back_to_the_cpu(ckpt, tmp_path):
    """Every script defaults to the card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mod in [trajectory_availability] + [v[1] for v in SCRIPTS.values()]:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(flags(ckpt if mod is not trajectory_availability
                           else None, tmp_path))
