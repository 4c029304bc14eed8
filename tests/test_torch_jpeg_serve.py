"""Real JPEGs beyond the teacher's pixel tiers, against the JAX package on
the CPU in float32: the encode-once tier's token bank built from JPEGs
(``teacher_loop.build_image_tier`` → ``build_feature_tier``); the CXR
head's CLS sweep from JPEGs (``extract_cls_features`` with ``jpeg_store``,
with and without the disk u8 store); serving by image id (``cli/serve.py
--image_mode jpeg_root``'s startup encode and ``BatchingPredictor`` with
a ``feature_source``), an unknown id answering NaN. Tolerance 1e-5."""
import json
import os
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.analysis.common import load_teacher
from multimodal_edema_prediction_tpu.config import ViTConfig as JViT
from multimodal_edema_prediction_tpu.data import features as JF
from multimodal_edema_prediction_tpu.data.images import JpegStore as JStore
from multimodal_edema_prediction_tpu.data.images import decode_batch as jdec
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.models.vit import DinoViT as JViTModel
from multimodal_edema_prediction_tpu.serve import \
    BatchingPredictor as JPredictor
from multimodal_edema_prediction_tpu.train import cxr_head_loop as JH
from multimodal_edema_prediction_tpu.train import teacher_loop as JL
from multimodal_edema_prediction_tpu.train.checkpoint import save_checkpoint
from multimodal_edema_prediction_tpu_torch.cli import serve as cli_serve
from multimodal_edema_prediction_tpu_torch.cli import train_cxr_head as cli
from multimodal_edema_prediction_tpu_torch.config import (DataConfig,
                                                          TeacherConfig,
                                                          TrainConfig,
                                                          ViTConfig)
from multimodal_edema_prediction_tpu_torch.convert import load_flax
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.data.images import JpegStore
from multimodal_edema_prediction_tpu_torch.models.teacher import TeacherModel
from multimodal_edema_prediction_tpu_torch.models.vit import DinoViT
from multimodal_edema_prediction_tpu_torch.serve import (BatchingPredictor,
                                                         make_server,
                                                         serve_forever)
from multimodal_edema_prediction_tpu_torch.train import cxr_head_loop as H
from multimodal_edema_prediction_tpu_torch.train import teacher_loop as L
from multimodal_edema_prediction_tpu_torch.train.checkpoint import \
    load_teacher_from_ckpt
from test_torch_jpeg_loop import JCFG, TRAIN, jpeg_cohort
from torch_port_util import (init_perturbed, perturb, tiny_teacher_cfg,
                             window_inputs)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import jpeg_fixtures as J  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_dir(root, ids, h=48, w=40):
    """``{id}.jpg`` for each id: the fixture writer's grayscale files."""
    J.write_jpegs(str(root), ids, h, w)
    return str(root)


def test_feature_tier_tokens_from_jpegs_match_jax(tmp_path):
    """With an encode-once tier, the JPEG hook's float32 pixels feed the
    feature build (``build_image_tier``): the port's token bank equals the
    JAX package's bank over the same decoded pixels (≤1e-5, float32), and
    the loop trains on it."""
    import jax.numpy as jnp
    from multimodal_edema_prediction_tpu.data import features as JF
    from multimodal_edema_prediction_tpu.data.images import \
        make_jpeg_host_fn as j_jpeg_hook
    jad, ad, blobs = jpeg_cohort()
    variables = jax.tree.map(np.asarray, JL.init_teacher(
        JT(JCFG), JCFG, 16, 24, jax.random.key(1)))
    cfg = TeacherConfig.from_dict(JCFG.to_dict())
    model = load_flax(TeacherModel(cfg), variables["params"],
                      variables["batch_stats"])
    hook, source, tier = L.build_image_tier(
        ad, JpegStore(blobs=blobs), 28, "hbm", "auto", None, 8.0,
        torch.device("cpu"), lambda s: None)
    assert tier == {"tier": "jpeg_for_features"}
    fsource, info = L.build_feature_tier(
        model, ad, hook, torch.float32, "hbm", 8.0, None,
        torch.device("cpu"), lambda s: None)
    n = info["n_images"]
    cls, patches = fsource({"image_ids": torch.arange(n, dtype=torch.int32)})

    ids = np.unique(jad.anchor["image_ids"]).astype(np.int64)
    jhook = j_jpeg_hook(JStore(blobs=blobs), 28)
    bank = JF.CXRFeatureBank.build(
        JF.encode_fn_for_teacher(JT(JCFG), variables["params"], jnp.float32),
        lambda b: jhook({"image_ids": np.asarray(b)})["pixel_values"], ids,
        out_dtype=np.float32)
    np.testing.assert_allclose(cls.numpy(), np.asarray(bank.cls)[:n],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(patches.numpy(), np.asarray(bank.patches)[:n],
                               rtol=1e-5, atol=1e-5)
    res = L.train_teacher(ad, cfg, TrainConfig.from_dict(TRAIN),
                          str(tmp_path), DataConfig().pathology_labels,
                          model=model, device="cpu", feature_cache="hbm",
                          jpeg_store=JpegStore(blobs=blobs),
                          log=lambda s: None)
    assert res.extras["feature_tier"]["tier"] == "hbm"
    assert res.extras["image_tier"]["tier"] == "jpeg_for_features"
    assert all(np.isfinite(h["train_total"]) for h in res.history)


@pytest.fixture(scope="module")
def catalog_jpegs(tmp_path_factory):
    cat = S.make_synthetic(seed=0, n_stays=40, n_subjects=13).cxr_catalog
    ids, labels = cat.image_ids[:24], cat.labels[:24]
    root = _write_dir(tmp_path_factory.mktemp("catalog"), ids, 60, 50)
    jvit = JViT(image_size=28, patch_size=14, d_model=16, n_layers=1,
                n_heads=2, d_feedforward=32)
    params, _ = init_perturbed(JViTModel(jvit),
                               np.zeros((1, 28, 28, 3), np.float32))
    vit = load_flax(DinoViT(ViTConfig.from_dict(jvit.to_dict())), params)
    return ids, labels, root, jvit, params, vit


@pytest.mark.parametrize("u8", [False, True])
def test_cls_features_from_jpegs_match_jax(catalog_jpegs, tmp_path, u8):
    """The CXR head's sweep over real JPEGs: decoded per chunk
    (``pixel_values``), or decoded once into the disk u8 store whose rows
    are normalized on the device; against JAX's ≤1e-5."""
    ids, labels, root, jvit, params, vit = catalog_jpegs
    kw = {"u8_store_path": str(tmp_path / ("jax" if u8 else "x"))} \
        if u8 else {}
    want = JH.extract_cls_features(params, jvit, None, ids, labels,
                                   batch_size=8, jpeg_store=JStore(root=root),
                                   **kw)
    kw = {"u8_store_path": str(tmp_path / "port")} if u8 else {}
    got = H.extract_cls_features(vit, None, ids, labels, batch_size=8,
                                 jpeg_store=JpegStore(root=root), **kw)
    assert got.shape == (24, 16)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if u8:      # the port's store files are the JAX package's
        for suffix in (".meta.json", ".ids.npy", ".u8"):
            with open(str(tmp_path / "port") + suffix, "rb") as a, \
                    open(str(tmp_path / "jax") + suffix, "rb") as b:
                assert a.read() == b.read(), suffix


def test_cxr_head_cli_takes_a_jpeg_root(tmp_path):
    """``--cxr_jpeg_root`` trains the head from the catalog's JPEGs."""
    cat = S.make_synthetic(seed=0, n_stays=40, n_subjects=13).cxr_catalog
    root = _write_dir(tmp_path / "jpegs", cat.image_ids, 30, 30)
    res = cli.main(["--device", "cpu", "--vit_size", "tiny",
                    "--synthetic_stays", "40", "--batch_size", "64",
                    "--epochs", "2", "--ckpt_dir", str(tmp_path / "run"),
                    "--cxr_jpeg_root", root])
    assert res["n_images"] == len(cat.image_ids)
    assert np.isfinite(res["best_val_macro_auroc"])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One float32 teacher checkpoint read by both packages, a JPEG
    directory, and both predictors serving it by image id."""
    cfg = tiny_teacher_cfg()
    variables = JL.init_teacher(JT(cfg), cfg, 2, cfg.duett.n_timesteps,
                                jax.random.key(0))
    tmp = tmp_path_factory.mktemp("serve")
    path = str(tmp / "teacher.msgpack")
    save_checkpoint(path, perturb(variables["params"]),
                    perturb(variables["batch_stats"], 1), step=1, metric=0.5,
                    config={"model": cfg.to_dict()})
    ids = [11, 3, 42, 7, 19]
    root = _write_dir(tmp / "jpegs", ids)

    jm, _, params, stats, _ = load_teacher(path)
    store = JStore(root=root)
    jbank = JF.CXRFeatureBank.build(
        JF.encode_fn_for_teacher(jm, params, jnp.float32),
        lambda b: jdec([store.get(i) for i in np.asarray(b)],
                       cfg.vit.image_size),
        np.asarray(sorted(ids), np.int64), out_dtype=np.float32)
    jpred = JPredictor(jm, params, stats, max_batch=8, dtype=jnp.float32,
                       feature_source=jbank.feature_source(
                           keyed_by_row=False)).start()
    model, _, _ = load_teacher_from_ckpt(path, device="cpu")
    source, info = cli_serve.jpeg_feature_source(model, root, torch.float32)
    pred = BatchingPredictor(model, feature_source=source, max_batch=8,
                             max_wait_ms=20.0, dtype=torch.float32,
                             device="cpu").start()
    yield cfg, ids, info, jpred, pred, path, root
    jpred.close()
    pred.close()


def _requests(cfg, ids, seed=2):
    x_ts, static, _, _ = window_inputs(cfg, len(ids), seed)
    return [{"x_ts": x_ts[i], "static": static[i], "image_id": int(k)}
            for i, k in enumerate(ids)]


def test_serving_by_image_id_matches_jax(served):
    cfg, ids, info, jpred, pred, _, _ = served
    assert info["n_images"] == len(ids)
    for r in _requests(cfg, ids + [ids[0]]):
        got, want = pred.predict(r), jpred.predict(r)
        for k in ("fusion_logits", "img_logits", "ts_logits",
                  "probabilities"):
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                       err_msg=k)


def test_an_unknown_image_id_answers_nan(served):
    cfg, ids, _, jpred, pred, _, _ = served
    (r,) = _requests(cfg, [999])
    for p in (pred, jpred):
        out = p.predict(r)
        assert np.isnan(out["img_logits"]).all()
        assert np.isnan(out["fusion_logits"]).all()
    assert np.isfinite(pred.predict(_requests(cfg, [ids[1]])[0])
                       ["fusion_logits"]).all()


def test_image_id_requests_over_http(served):
    """The server passes ``image_id`` through; no pixels are sent."""
    cfg, ids, _, _, pred, _, _ = served
    server = make_server(pred, "127.0.0.1", 0, meta={})
    serve_forever(server, background=True)
    try:
        reqs = _requests(cfg, ids[:3], seed=5)
        body = {"instances": [{"x_ts": r["x_ts"].tolist(),
                               "static": r["static"].tolist(),
                               "image_id": r["image_id"]} for r in reqs]}
        url = f"http://127.0.0.1:{server.server_address[1]}/v1/predict"
        req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                     headers={"Content-Type":
                                              "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            preds = json.loads(resp.read())["predictions"]
    finally:
        server.shutdown()
        server.server_close()
    for r, p in zip(reqs, preds):
        np.testing.assert_allclose(p["fusion_logits"],
                                   pred.predict(r)["fusion_logits"],
                                   rtol=TOL, atol=TOL)


def test_serve_cli_needs_a_jpeg_root_for_jpeg_root_mode(served):
    path = served[5]
    with pytest.raises(SystemExit):
        cli_serve.main(["--ckpt", path, "--image_mode", "jpeg_root",
                        "--device", "cpu"])
    with pytest.raises(ValueError, match="no {id}.jpg files"):
        cli_serve.jpeg_feature_source(
            load_teacher_from_ckpt(path, device="cpu")[0],
            os.path.dirname(path))
