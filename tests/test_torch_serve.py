"""The slice as a whole: the JAX ``BatchingPredictor`` and the port's, both
built from the same JAX checkpoint at float32, answer the same requests over
HTTP with equal outputs (≤1e-4, the whole-teacher float32 bound). Also bucket
padding and coalescing, a 503 on a full queue, and 400s on bad shapes."""
import base64
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.analysis.common import load_teacher
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.serve import \
    BatchingPredictor as JPredictor
from multimodal_edema_prediction_tpu.serve import make_server as j_make_server
from multimodal_edema_prediction_tpu.train.checkpoint import save_checkpoint
from multimodal_edema_prediction_tpu.train.teacher_loop import init_teacher
from multimodal_edema_prediction_tpu_torch.serve import (BatchingPredictor,
                                                         QueueFullError,
                                                         make_server,
                                                         serve_forever)
from multimodal_edema_prediction_tpu_torch.train import engine
from multimodal_edema_prediction_tpu_torch.train.checkpoint import \
    load_teacher_from_ckpt
from torch_port_util import perturb, tiny_teacher_cfg, window_inputs

LABELS = [f"label_{i}" for i in range(7)]
TOL = 1e-4


def _start(server):
    serve_forever(server, background=True)
    return f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    cfg = tiny_teacher_cfg()
    jmodel = JT(cfg)
    variables = init_teacher(jmodel, cfg, 2, cfg.duett.n_timesteps,
                             jax.random.key(0))
    path = str(tmp_path_factory.mktemp("ckpt") / "teacher.msgpack")
    save_checkpoint(path, perturb(variables["params"]),
                    perturb(variables["batch_stats"], 1), step=1, metric=0.5,
                    config={"model": cfg.to_dict()})

    jm, _, params, stats, _ = load_teacher(path)
    # one bucket on the JAX side keeps its compile count (and the test's
    # time) down; batch composition does not change f32 outputs beyond TOL
    jpred = JPredictor(jm, params, stats, max_batch=1, dtype=jnp.float32,
                       labels=LABELS).start()
    model, tcfg, _ = load_teacher_from_ckpt(path, device="cpu")
    pred = BatchingPredictor(model, max_batch=4, max_wait_ms=20.0,
                             max_queue=64, dtype=torch.float32,
                             labels=LABELS, device="cpu").start()
    S = cfg.vit.image_size
    example = {"x_ts": np.zeros((24, 12), np.float32),
               "static": np.zeros(18, np.float32),
               "pixel_u8": np.zeros((S, S, 3), np.uint8)}
    jpred.warmup(example)
    pred.warmup(example)
    meta = {"image_size": S, "n_timesteps": 24}
    jserver = j_make_server(jpred, "127.0.0.1", 0, meta=meta)
    server = make_server(pred, "127.0.0.1", 0, meta=meta)
    urls = (_start(jserver), _start(server))
    yield tcfg, model, pred, urls
    for s in (jserver, server):
        s.shutdown()
        s.server_close()
    jpred.close()
    pred.close()


def _requests(cfg, n, seed):
    x_ts, static, _, pixel_u8 = window_inputs(cfg, n, seed)
    return [{"x_ts": x_ts[i], "static": static[i], "pixel_u8": pixel_u8[i]}
            for i in range(n)]


def _instance(r):
    return {"x_ts": r["x_ts"].tolist(), "static": r["static"].tolist(),
            "pixel_u8_b64": base64.b64encode(r["pixel_u8"].tobytes()).decode()}


def _post(url, payload):
    req = urllib.request.Request(
        f"{url}/v1/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_answers_equal_jax(servers):
    cfg, _, pred, (jurl, url) = servers
    reqs = _requests(cfg, 5, seed=2)
    body = {"instances": [_instance(r) for r in reqs]}
    (jcode, jresp), (code, resp) = _post(jurl, body), _post(url, body)
    assert jcode == code == 200
    assert len(resp["predictions"]) == 5
    for jp, p in zip(jresp["predictions"], resp["predictions"]):
        assert p["labels"] == jp["labels"] == LABELS
        for k in ("fusion_logits", "img_logits", "ts_logits",
                  "probabilities"):
            np.testing.assert_allclose(p[k], jp[k], atol=TOL, rtol=TOL,
                                       err_msg=k)
        assert p["main_probability"] == pytest.approx(jp["main_probability"],
                                                      abs=TOL)


def test_concurrent_requests_pad_and_coalesce(servers):
    """Concurrent clients coalesce into batches larger than one, padded to
    the bucket ladder by repeating row 0; every answer equals the direct
    eval of that request alone."""
    cfg, model, pred, (_, url) = servers
    reqs = _requests(cfg, 7, seed=3)
    results = {}

    def client(i):
        results[i] = _post(url, {"instances": [_instance(reqs[i])]})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(7)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    step = engine.make_teacher_eval_from_windows(model, torch.float32)
    T = cfg.duett.n_timesteps
    for i, r in enumerate(reqs):
        code, resp = results[i]
        assert code == 200
        want = step(r["x_ts"][None], r["static"][None],
                    {"bin_ends": (np.arange(1, T + 1, dtype=np.float32)
                                  / 24.0)[None],
                     "pixel_u8": r["pixel_u8"][None]})["fusion_logits"][0]
        np.testing.assert_allclose(resp["predictions"][0]["fusion_logits"],
                                   want.numpy(), atol=TOL, rtol=TOL)
    hist = pred.stats()["batch_size_hist"]
    assert max(int(b) for b in hist) > 1
    assert pred.buckets == (1, 2, 4)


def test_padding_repeats_row_zero(servers):
    cfg, _, pred, _ = servers
    items = [pred._parse(r) for r in _requests(cfg, 3, seed=4)]
    x_ts, static, batch = pred._assemble(items, 4)
    assert x_ts.shape == (4, 24, 12) and batch["pixel_u8"].shape[0] == 4
    np.testing.assert_array_equal(x_ts[3], x_ts[0])
    np.testing.assert_array_equal(batch["pixel_u8"][3],
                                  batch["pixel_u8"][0])


def test_full_queue_is_503(servers):
    cfg, model, _, _ = servers
    pred = BatchingPredictor(model, max_batch=2, max_queue=2,
                             dtype=torch.float32, device="cpu")
    req = _requests(cfg, 1, seed=5)[0]
    with pytest.raises(RuntimeError):
        pred.submit(req)                 # not started
    pred._running = True                 # the batcher never drains
    server = make_server(pred, "127.0.0.1", 0)
    url = _start(server)
    try:
        pred.submit(req)
        pred.submit(req)
        code, resp = _post(url, {"instances": [_instance(req)]})
        assert code == 503 and "capacity" in resp["error"]
        with pytest.raises(QueueFullError):
            pred.submit(req)
        assert pred.stats()["n_rejected"] == 2
    finally:
        pred._running = False
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("mutate", [
    lambda i: i.update(x_ts=[[0.0] * 12] * 5),               # wrong T
    lambda i: i.update(static=[0.0] * 3),                    # wrong D
    lambda i: i.pop("pixel_u8_b64"),                         # no pixels
    lambda i: i.update(pixel_u8_b64=base64.b64encode(
        bytes(27)).decode()),                                # wrong S
    lambda i: i.update(bin_ends=[0.1] * 5),                  # wrong T
])
def test_bad_shapes_are_400(servers, mutate):
    cfg, _, _, (_, url) = servers
    inst = _instance(_requests(cfg, 1, seed=6)[0])
    mutate(inst)
    code, resp = _post(url, {"instances": [inst]})
    assert code == 400, resp
    assert _post(url, {"instances": []})[0] == 400


def test_default_device_is_the_card(servers):
    _, model, _, _ = servers
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchingPredictor(model)
