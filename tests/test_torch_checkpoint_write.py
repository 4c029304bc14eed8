"""Checkpoints written by the port (``train/checkpoint.py::save_checkpoint``,
``convert.to_flax``) load in the JAX package's ``load_checkpoint`` and in
the port's own ``load_teacher_from_ckpt`` (what ``cli/serve.py`` calls).

Tolerances: the arrays round-trip bit-identically, and the port's file is
byte for byte the JAX package's ``save_checkpoint`` of the same trees
(flax's writer sorts each map's keys, and so does the port's); the JAX
``TeacherModel.apply`` on the loaded trees equals the port's eval of the
model that was saved within 1e-4 at float32 (the whole teacher, as in
``tests/test_torch_teacher.py``).
"""
import json
import os

import jax
import msgpack
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.train.checkpoint import \
    load_checkpoint as jload
from multimodal_edema_prediction_tpu.train.checkpoint import \
    save_checkpoint as jsave
from multimodal_edema_prediction_tpu.train.teacher_loop import init_teacher
from multimodal_edema_prediction_tpu_torch.config import TeacherConfig
from multimodal_edema_prediction_tpu_torch.convert import load_flax, to_flax
from multimodal_edema_prediction_tpu_torch.models.teacher import TeacherModel
from multimodal_edema_prediction_tpu_torch.train import checkpoint as P
from torch_port_util import perturb, t, tiny_teacher_cfg, window_inputs


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    jcfg = tiny_teacher_cfg()
    v = init_teacher(JT(jcfg), jcfg, 2, 24, jax.random.key(0))
    params, stats = perturb(v["params"]), perturb(v["batch_stats"], 1)
    cfg = TeacherConfig.from_dict(jcfg.to_dict())
    model = load_flax(TeacherModel(cfg), params, stats).eval()
    path = str(tmp_path_factory.mktemp("ckpt") / "best.msgpack")
    config = {"model": cfg.to_dict(), "train": {"seed": 3}}
    P.save_checkpoint(path, model, step=17, metric=0.625, config=config,
                      extra={"epoch": 4})
    return jcfg, model, params, stats, path, config


def test_jax_loader_reads_port_checkpoint(saved):
    _, _, params, stats, path, config = saved
    ck = jload(path)
    assert ck["step"] == 17 and ck["metric"] == 0.625
    assert ck["extra"] == {"epoch": 4}
    assert ck["config"] == json.loads(json.dumps(config))
    for tree, got in ((params, ck["params"]), (stats, ck["batch_stats"])):
        want, have = _flat(tree), _flat(got)
        assert sorted(want) == sorted(have)
        for k in want:
            assert have[k].dtype == want[k].dtype, k
            assert have[k].tobytes() == want[k].tobytes(), k


def test_jax_apply_on_port_checkpoint_matches_port_eval(saved):
    jcfg, model, _, _, path, _ = saved
    ck = jload(path)
    x_ts, static, bin_ends, pixel_u8 = window_inputs(jcfg, 2)
    x_in = np.concatenate([x_ts, np.zeros((2, 24, 1), np.float32)], -1)
    px = (pixel_u8.astype(np.float32) / 255.0 - 0.5307) / 0.2583
    want = jax.jit(JT(jcfg).apply)(
        {"params": ck["params"], "batch_stats": ck["batch_stats"]},
        x_in, static, bin_ends, px)
    reloaded, cfg, _ = P.load_teacher_from_ckpt(path, device="cpu")
    assert cfg == model.cfg
    with torch.inference_mode():
        for m in (model, reloaded):
            got = m(t(x_in), t(static), t(bin_ends), t(px))
            for k in ("fusion_logits", "img_logits", "ts_logits"):
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), atol=1e-4,
                                           rtol=1e-4, err_msg=k)
    for k, v in model.state_dict().items():
        assert torch.equal(reloaded.state_dict()[k], v), k


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_port_checkpoint_is_byte_equal_to_jax(saved, tmp_path):
    """The same teacher tree saved by each package: the same bytes, the
    sidecar too (a tree whose insertion order is not flax's sorted one)."""
    _, model, params, stats, path, config = saved
    jpath = str(tmp_path / "jax.msgpack")
    jsave(jpath, params, stats, step=17, metric=0.625, config=config,
          extra={"epoch": 4})
    assert _read(path) == _read(jpath)
    assert _read(path + ".config.json") == _read(jpath + ".config.json")


def test_batch_stats_none_is_byte_equal_to_jax(tmp_path):
    """A ViT tree with ``batch_stats`` None, as the RAD-DINO converters
    write it, through ``save_flax_checkpoint``: the same bytes as JAX's."""
    from multimodal_edema_prediction_tpu.models.vit import DinoViT as JV
    jcfg = tiny_teacher_cfg().vit
    params = perturb(JV(jcfg).init(
        jax.random.key(1), np.zeros((1, jcfg.image_size, jcfg.image_size, 3),
                                    np.float32), train=False)["params"])
    config = {"vit": jcfg.to_dict(), "source": "hf_dir",
              "image_mean": [0.5], "image_std": [0.25]}
    ppath, jpath = str(tmp_path / "port.msgpack"), str(tmp_path / "jax.msgpack")
    P.save_flax_checkpoint(ppath, params, None, step=0, metric=0.0,
                           config=config)
    jsave(jpath, params, None, step=0, metric=0.0, config=config)
    assert _read(ppath) == _read(jpath)
    assert _read(ppath + ".config.json") == _read(jpath + ".config.json")
    assert P.load_checkpoint(ppath)["batch_stats"] is None


def test_writer_sorts_map_keys_as_flax():
    """Flax maps a tree through ``jax.tree_util`` before packing, which
    sorts dict keys at every level; scalars, strings and lists pack as
    msgpack packs them, each int in its smallest form."""
    from flax import serialization
    for value in ({"b": 1, "a": 2}, {"z": {"y": [1, {"d": 0, "c": 1}]},
                                     "a": np.arange(3, dtype=np.float32)},
                  np.ones(2, np.int32), 2.5, "s", [3, 1],
                  [0, 127, 128, 255, 256, 65536, 2 ** 40, -1, -32, -33, -129,
                   -2 ** 40]):
        assert P.msgpack_serialize(value) == \
            serialization.msgpack_serialize(value)
    assert P.msgpack_serialize({"b": 1, "a": 2}).hex() == "82a16102a16201"


def test_to_flax_round_trip(saved):
    _, model, params, stats, _, _ = saved
    p2, s2 = to_flax(model)
    for a, b in ((params, p2), (stats, s2)):
        fa, fb = _flat(a), _flat(b)
        assert sorted(fa) == sorted(fb)
        assert all(np.array_equal(fa[k], fb[k]) for k in fa)


def test_writer_matches_msgpack_on_every_type():
    value = {"ints": [0, 1, 127, 128, 255, 65536, 2 ** 40, -1, -32, -33,
                      -2 ** 40],
             "floats": [0.5, -1.25e300, float("inf")], "none": None,
             "bools": [True, False], "s": "x" * 40, "long": "y" * 70000,
             "bin": b"\x00\x01" * 200, "nested": {"a": {"b": [1, [2, {}]]}},
             "many": list(range(20)), "map": {str(i): i for i in range(20)}}
    data = P.msgpack_serialize(value)
    assert msgpack.unpackb(data, raw=False) == value
    assert P.msgpack_restore(data) == value
    arrs = {"a": np.arange(6, dtype=np.int64).reshape(2, 3),
            "e": np.zeros((0, 4), np.float32), "s": np.float32(2.5)}
    back = P.msgpack_restore(P.msgpack_serialize(arrs))
    for k, v in arrs.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v)
    with pytest.raises(TypeError):
        P.msgpack_serialize({"x": object()})


def test_best_k_tracker_keeps_the_best(saved, tmp_path):
    _, model, _, _, _, _ = saved
    tr = P.BestKTracker(str(tmp_path), k=1, mode="max", prefix="best")
    assert tr.offer(0.5, model, 1)
    assert not tr.offer(0.4, model, 2)
    assert tr.offer(0.7, model, 3)
    metric, path = tr.best
    assert metric == 0.7 and os.path.exists(path)
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(path)]
    empty = P.BestKTracker(str(tmp_path / "e"), k=1, mode="max")
    empty.ensure_saved(model, 5)
    assert empty.best[0] == float("-inf")
    assert jload(empty.best[1])["step"] == 5
