"""Serving's ``--image_mode synthetic`` (ROADMAP P17) against the JAX
package's: the port draws JAX's procedural images (``data/pipeline.
synthetic_image_device``: threefry bits equal to ``jax.random``'s, the
normals within ~1e-6), and a predictor on that source answers requests by
``image_id`` as the JAX predictor on its own source does, on one float32
checkpoint (within 1e-5); the CLI serves by image id over HTTP."""
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.analysis.common import load_teacher
from multimodal_edema_prediction_tpu.data import pipeline as JP
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.serve import \
    BatchingPredictor as JPredictor
from multimodal_edema_prediction_tpu.train import teacher_loop as JTL
from multimodal_edema_prediction_tpu.train.checkpoint import save_checkpoint
from multimodal_edema_prediction_tpu_torch import serve as port_serve
from multimodal_edema_prediction_tpu_torch.cli import serve as cli_serve
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.serve import BatchingPredictor
from multimodal_edema_prediction_tpu_torch.train.checkpoint import \
    load_teacher_from_ckpt
from torch_port_util import perturb, tiny_teacher_cfg, window_inputs

TOL = 1e-5
IDS = np.array([0, 1, 7, 40123, 2 ** 31 - 1], np.int32)


def test_threefry_bits_are_jax_random_bits():
    k0, k1 = P.threefry2x32(*(torch.zeros(len(IDS), dtype=torch.int64),) * 3,
                            torch.tensor(IDS.astype(np.int64)))
    counter = torch.arange(35, dtype=torch.int64)
    b0, b1 = P.threefry2x32(k0[:, None], k1[:, None],
                            torch.zeros_like(counter), counter)
    for i, id_ in enumerate(IDS):
        key = jax.random.fold_in(jax.random.key(0), jnp.int32(id_))
        np.testing.assert_array_equal(
            [int(k0[i]), int(k1[i])], np.asarray(jax.random.key_data(key)))
        want = np.asarray(jax.random.bits(key, (5, 7), jnp.uint32))
        np.testing.assert_array_equal((b0[i] ^ b1[i]).numpy(),
                                      want.astype(np.int64).ravel())


@pytest.mark.parametrize("size", [28, 518])
def test_procedural_images_match_jax(size):
    """Per-id noise and a blob per positive label (NaN labels none)."""
    labels = np.random.default_rng(0).random((len(IDS), 7)).astype(
        np.float32)
    labels[0, 3] = np.nan
    want = np.asarray(JP.synthetic_image_device(
        jnp.asarray(IDS), jnp.asarray(labels), size))
    got = P.synthetic_image_device(torch.tensor(IDS), torch.tensor(labels),
                                   size)
    assert got.shape == want.shape == (len(IDS), size, size, 3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cfg = tiny_teacher_cfg()
    variables = JTL.init_teacher(JT(cfg), cfg, 2, cfg.duett.n_timesteps,
                                 jax.random.key(0))
    path = str(tmp_path_factory.mktemp("synthetic") / "teacher.msgpack")
    save_checkpoint(path, perturb(variables["params"]),
                    perturb(variables["batch_stats"], 1), step=1, metric=0.5,
                    config={"model": cfg.to_dict()})
    jm, _, params, stats, _ = load_teacher(path)
    base = JTL.make_synthetic_image_source(cfg.vit.image_size)
    K = cfg.perceiver.n_pathologies

    def jax_source(batch):       # JAX cli/serve.py:83-89
        return base({**batch, "y_multi": jnp.zeros(
            (batch["image_ids"].shape[0], K), jnp.float32)})

    jpred = JPredictor(jm, params, stats, image_source=jax_source,
                       max_batch=4, dtype=jnp.float32).start()
    model, tcfg, _ = load_teacher_from_ckpt(path, device="cpu")
    source = cli_serve.synthetic_image_source(tcfg)
    pred = BatchingPredictor(model, image_source=source, max_batch=4,
                             max_wait_ms=20.0, dtype=torch.float32,
                             device="cpu").start()
    yield cfg, path, jax_source, source, jpred, pred
    jpred.close()
    pred.close()


def test_serving_source_matches_jax(served):
    cfg, _, jax_source, source, _, _ = served
    want = np.asarray(jax_source({"image_ids": jnp.asarray(IDS)}))
    got = source({"image_ids": torch.tensor(IDS)})
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def _requests(cfg, ids, seed=3):
    x_ts, static, _, _ = window_inputs(cfg, len(ids), seed)
    return [{"x_ts": x_ts[i], "static": static[i], "image_id": int(k)}
            for i, k in enumerate(ids)]


def test_served_by_image_id_matches_jax(served):
    cfg, _, _, _, jpred, pred = served
    for r in _requests(cfg, [5, 17, 5, 90210]):
        got, want = pred.predict(r), jpred.predict(r)
        for k in ("fusion_logits", "img_logits", "ts_logits",
                  "probabilities"):
            np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL,
                                       err_msg=k)


def test_cli_serves_synthetic_images_by_id(served, monkeypatch):
    """``cli.serve --image_mode synthetic``: the server answers a request
    that names an image id and carries no pixels, as the predictor does."""
    cfg, path, _, _, _, pred = served
    (r,) = _requests(cfg, [42])
    answers = []
    serve_forever = port_serve.serve_forever

    def serve_once(server, background=False):
        serve_forever(server, background=True)
        url = f"http://127.0.0.1:{server.server_address[1]}/v1/predict"
        body = {"instances": [{"x_ts": r["x_ts"].tolist(),
                               "static": r["static"].tolist(),
                               "image_id": r["image_id"]}]}
        req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                     headers={"Content-Type":
                                              "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                answers.append(json.loads(resp.read())["predictions"][0])
        finally:
            server.shutdown()
        raise KeyboardInterrupt

    monkeypatch.setattr(port_serve, "serve_forever", serve_once)
    cli_serve.main(["--ckpt", path, "--image_mode", "synthetic", "--device",
                    "cpu", "--port", "0", "--max_batch", "2"])
    (got,) = answers
    # the CLI serves in bf16; the float32 predictor's answer within bf16
    np.testing.assert_allclose(got["fusion_logits"],
                               pred.predict(r)["fusion_logits"], atol=5e-2)
    assert np.isfinite(got["probabilities"]).all()
