"""The port's inference CLI (``cli/predict.py``, ROADMAP P17) against the
JAX package's, on one tiny-ViT teacher checkpoint the JAX package wrote:
on procedural pixels (JAX's own, drawn from ``jax.random`` by the port's
threefry) and on the encode-once tier (``--cxr_feature_cache hbm``).
Through the eval at float32 the logits agree within 1e-5; through both
CLIs at their defaults (bf16) the NPZs have the same keys, labels and
masks, and logits within PREDICT_BF16_TOL. The float32 serving-side
check of the procedural images is ``tests/test_torch_synthetic_serve.py``.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.analysis import common as JA
from multimodal_edema_prediction_tpu.cli import predict as jax_predict
from multimodal_edema_prediction_tpu.data import features as JF
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.parallel import mesh as meshlib
from multimodal_edema_prediction_tpu.train import engine as JE
from multimodal_edema_prediction_tpu.train import teacher_loop as JTL
from multimodal_edema_prediction_tpu.train.checkpoint import save_checkpoint
from multimodal_edema_prediction_tpu.train.evaluator import \
    collect_dual_outputs
from multimodal_edema_prediction_tpu_torch.cli import predict
from torch_port_util import perturb, tiny_teacher_cfg

STAYS = "60"
KEYS = ("img_logits", "ts_logits", "fusion_logits", "scaled_correction",
        "main_logit")
# both CLIs at their default bf16 on the CPU, each logit against the
# array's max abs: bf16 keeps 8 bits (2^-8 relative), and the two packages
# round at other places through the ViT, DuETT and the perceiver (measured:
# ts_logits 3.3e-2, the others 0.9e-2 to 2.0e-2; at float32 the same
# outputs agree within 1e-5, below)
PREDICT_BF16_TOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = tiny_teacher_cfg()
    variables = JTL.init_teacher(JT(cfg), cfg, 2, cfg.duett.n_timesteps,
                                 jax.random.key(0))
    path = str(tmp_path_factory.mktemp("teacher") / "teacher.msgpack")
    save_checkpoint(path, perturb(variables["params"]),
                    perturb(variables["batch_stats"], 1), step=1, metric=0.5,
                    config={"model": cfg.to_dict()})
    return path


def _argv(ckpt, out, tier):
    extra = ["--cxr_feature_cache", "hbm"] if tier == "hbm" else []
    return ["--ckpt", ckpt, "--synthetic_stays", STAYS, "--out", out] + extra


@pytest.mark.parametrize("tier", ["pixels", "hbm"])
def test_cli_npz_matches_jax(ckpt, tmp_path, tier):
    jout, out = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_predict.main(_argv(ckpt, jout, tier))
    res = predict.main(_argv(ckpt, out, tier) + ["--device", "cpu"])
    with np.load(jout) as j, np.load(out) as p:
        assert sorted(p.files) == sorted(j.files)
        assert "beta" in p.files
        for k in ("labels", "y_multi", "y_multi_mask", "beta"):
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
        for k in KEYS:
            scale = float(np.abs(j[k]).max())
            assert p[k].shape == j[k].shape and p[k].dtype == np.float32
            assert np.abs(p[k] - j[k]).max() <= PREDICT_BF16_TOL * scale, k
    assert res["n"] == len(res["outputs"]["main"]) > 0


def _jax_outputs(ckpt, tier):
    """JAX's predict at float32: its analysis helpers, with the encode-once
    bank built as ``make_sources`` builds it but at float32."""
    p = argparse.ArgumentParser()
    JA.add_analysis_flags(p)
    args = p.parse_args(_argv(ckpt, "-", tier))
    model, cfg, params, stats, _ = JA.load_teacher(ckpt)
    _, _, data, _ = JA.load_analysis_data(args,
                                          n_variables=cfg.duett.n_variables)
    source = JA.make_image_source(args, data, cfg.vit)
    feature_source = None
    if tier == "hbm":
        a = data.anchor
        ids = np.unique(a["image_ids"]).astype(np.int64)
        order = np.argsort(a["image_ids"], kind="stable")
        first = order[np.searchsorted(a["image_ids"][order], ids)]
        y_rep = np.asarray(a["y_multi"][first], np.float32)

        def pixels_for_ids(b):
            return np.asarray(source({
                "image_ids": np.asarray(b, np.int32),
                "y_multi": y_rep[np.searchsorted(ids, b)]}), np.float32)

        bank = JF.CXRFeatureBank.build(
            JF.encode_fn_for_teacher(model, params, jnp.float32),
            pixels_for_ids, ids, out_dtype=np.float32)
        feature_source = bank.feature_source(keyed_by_row=False)
    step = JE.make_teacher_eval(model, data.n_timesteps, jnp.float32,
                                image_source=source,
                                feature_source=feature_source)
    mesh = meshlib.create_mesh()
    with mesh:
        data.grid = jax.device_put(data.grid, meshlib.replicated(mesh))
        return collect_dual_outputs(step, params, stats, data, "test", 64,
                                    mesh)


@pytest.mark.parametrize("tier", ["pixels", "hbm"])
def test_eval_at_float32_matches_jax(ckpt, tier):
    want = _jax_outputs(ckpt, tier)
    args = predict.build_parser().parse_args(
        _argv(ckpt, "-", tier) + ["--device", "cpu"])
    got = predict.predict(args, dtype=torch.float32)["outputs"]
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def test_predict_refuses_a_teacher_without_fusion(tmp_path):
    from multimodal_edema_prediction_tpu.config import TeacherConfig
    cfg = tiny_teacher_cfg()
    cfg = TeacherConfig.from_dict({**cfg.to_dict(),
                                   "perceiver_type": "single"})
    variables = JTL.init_teacher(JT(cfg), cfg, 2, cfg.duett.n_timesteps,
                                 jax.random.key(0))
    path = str(tmp_path / "single.msgpack")
    save_checkpoint(path, variables["params"], variables["batch_stats"],
                    step=1, metric=0.5, config={"model": cfg.to_dict()})
    with pytest.raises(ValueError, match="residual-fusion"):
        predict.main(["--ckpt", path, "--device", "cpu", "--out",
                      str(tmp_path / "x.npz")])


def test_cli_defaults_to_the_card():
    args = predict.build_parser().parse_args(["--ckpt", "x.msgpack"])
    assert (args.device, args.batch_size, args.split,
            args.cxr_feature_cache) == ("cuda", 64, "test", "none")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main(["--ckpt", "x.msgpack"])
