"""The figure suite in the port (``analysis/visualize_pathology.py``)
against the JAX package's, on the CPU, on the tiny teacher of
``analysis_port_util``.

At float32 (JAX's eval steps patched from the test; on the encode-once
tier its ViT encode and bank too, whose defaults are bf16): ``_collect``
on the pixel and ``hbm`` tiers within 1e-5 (ids and the attention axis
equal), ``query_cosine.csv`` and ``gap_summary.csv`` within 1e-5, and, with
matplotlib, the same files as JAX for ``--dim_reduce auto`` and ``tsne``
(the port's UMAP and exact t-SNE in place of umap-learn and sklearn's
Barnes-Hut t-SNE: the embeddings are held in tests/test_torch_umap_tsne.py;
here finite, of shape [N·K, 2]). Where matplotlib cannot be imported, the
CSVs are still written and one line names the figures not drawn.
"""
import argparse
import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analysis_port_util import _one_thread  # noqa: F401
from analysis_port_util import (assert_report_close, flags, jax_at_float32,
                                write_teacher)
from multimodal_edema_prediction_tpu.analysis import common as JCm
from multimodal_edema_prediction_tpu.analysis import visualize_pathology as JV
from multimodal_edema_prediction_tpu.data import features as JF
from multimodal_edema_prediction_tpu_torch.analysis import common as Cm
from multimodal_edema_prediction_tpu_torch.analysis import \
    visualize_pathology as V

EXTRA = ["--split", "train", "--max_batches", "2"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_teacher(str(tmp_path_factory.mktemp("teacher")
                             / "teacher.msgpack"))


def _jax_at_float32(mp):
    """JAX's evals, and its encode-once build, at float32."""
    jax_at_float32(mp)
    mp.setattr(JF, "encode_fn_for_teacher", functools.partial(
        JF.encode_fn_for_teacher, dtype=jnp.float32))
    build = JF.build_feature_arrays
    mp.setattr(JF, "build_feature_arrays",
               lambda *a: build(*a[:5], out_dtype=np.float32))


@pytest.mark.parametrize("tier", ["none", "hbm"])
def test_collect_matches_jax(tier, ckpt, monkeypatch):
    argv = flags(ckpt, "-", EXTRA + ["--cxr_feature_cache", tier])
    _jax_at_float32(monkeypatch)
    p = argparse.ArgumentParser()
    JCm.add_analysis_flags(p)
    args = p.parse_args(argv)
    model, cfg, params, stats, _ = JCm.load_teacher(args.ckpt)
    _, _, ds, _ = JCm.load_analysis_data(args,
                                         n_variables=cfg.duett.n_variables)
    src, fsrc = JCm.make_sources(args, ds, model, params, cfg)
    want = JV._collect(model, params, stats, ds, "train", 16, src, 2,
                       feature_source=fsrc)
    p = argparse.ArgumentParser()
    Cm.add_analysis_flags(p)
    pm, _, pds, _, psrc, pfsrc = Cm.load_for_analysis(
        p.parse_args(argv + ["--device", "cpu"]), torch.float32,
        grid_on_device=False)
    assert (pfsrc is None) == (tier == "none")
    got = V._collect(pm, pds, "train", 16, psrc, 2, feature_source=pfsrc,
                     dtype=torch.float32)
    assert set(got) == set(want) and got["attn_axis"] == want["attn_axis"]
    for k in ("y", "mask", "image_ids"):
        np.testing.assert_array_equal(got[k], want[k])
    for k in ("img_attn", "ts_attn", "fus_tok", "img", "ts", "fus"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                   atol=1e-5, err_msg=k)


def _csv(path):
    return np.genfromtxt(path, delimiter=",", names=None, dtype=None,
                         encoding=None)


@pytest.mark.parametrize("dim_reduce", ["auto", "tsne"])
def test_main_matches_jax(dim_reduce, ckpt, tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    extra = EXTRA + ["--dim_reduce", dim_reduce]
    with monkeypatch.context() as mp:
        jax_at_float32(mp)
        want = JV.main(flags(ckpt, tmp_path / "jax", extra))
    got = V.main(flags(ckpt, tmp_path / "port", extra + ["--device", "cpu"]),
                 dtype=torch.float32)
    assert_report_close(got["gap_summary"], want, 1e-5)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == files
    assert "fusion_tokens_raw.png" in files and "query_cosine.csv" in files
    a = np.loadtxt(tmp_path / "port" / "query_cosine.csv", delimiter=",")
    b = np.loadtxt(tmp_path / "jax" / "query_cosine.csv", delimiter=",")
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    a, b = (_csv(tmp_path / d / "gap_summary.csv") for d in ("port", "jax"))
    assert a.shape == b.shape
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            try:
                assert abs(float(x) - float(y)) <= 1e-5, (x, y)
            except ValueError:
                assert x == y
    N, K = 32, 7
    proj = got["projection"]
    assert proj["reducer"] == ("tsne" if dim_reduce == "tsne" else "umap")
    for tag in ("raw", "centered"):
        assert proj[tag].shape == (N * K, 2) and np.isfinite(proj[tag]).all()
        assert got["token_embedding"][tag].shape == (N, 2)
    assert got["query_cosine"][""].shape == (K, K)
    np.testing.assert_allclose(np.diag(got["query_cosine"][""]), 1.0,
                               atol=1e-6)


def test_without_matplotlib_the_csvs_are_written(ckpt, tmp_path,
                                                 monkeypatch, capsys):
    for name in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    got = V.main(flags(ckpt, tmp_path, EXTRA + ["--device", "cpu"]))
    assert sorted(os.listdir(tmp_path)) == ["gap_summary.csv",
                                            "query_cosine.csv"]
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if "figures not drawn" in ln]
    assert len(line) == 1
    for png in ("patch_attention_overlays.png", "ts_attention_heatmap.png",
                "query_cosine.png", "fusion_tokens_raw.png",
                "fusion_token_umap.png", "stage4_projection.png",
                "gap_summary.png"):
        assert png in line[0], png
    assert np.isfinite(got["projection"]["raw"]).all()


def test_refuses_to_fall_back_to_the_cpu(ckpt, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.main(flags(ckpt, tmp_path))
