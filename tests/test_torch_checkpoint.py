"""The port reads the JAX package's checkpoints without JAX or msgpack: a
checkpoint written by the JAX ``save_checkpoint`` decodes to bit-identical
arrays and the same config, and ``load_teacher_from_ckpt`` rebuilds the
same model."""
import json

import jax
import msgpack
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.train.checkpoint import save_checkpoint
from multimodal_edema_prediction_tpu.train.teacher_loop import init_teacher
from multimodal_edema_prediction_tpu_torch.convert import flax_to_state_dict
from multimodal_edema_prediction_tpu_torch.train import checkpoint as P
from torch_port_util import perturb, t, tiny_teacher_cfg, window_inputs


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    cfg = tiny_teacher_cfg()
    jmodel = JT(cfg)
    variables = init_teacher(jmodel, cfg, 2, cfg.duett.n_timesteps,
                             jax.random.key(0))
    params = perturb(variables["params"])
    stats = perturb(variables["batch_stats"], 1)
    path = str(tmp_path_factory.mktemp("ckpt") / "best.msgpack")
    config = {"model": cfg.to_dict(), "train": {"seed": 3}}
    save_checkpoint(path, params, stats, step=17, metric=0.625,
                    config=config, extra={"epoch": 4, "name": "best"})
    return cfg, jmodel, params, stats, path, config


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_decoder_is_bit_identical(saved):
    _, _, params, stats, path, config = saved
    ck = P.load_checkpoint(path)
    assert ck["step"] == 17 and ck["metric"] == 0.625
    assert ck["extra"] == {"epoch": 4, "name": "best"}
    assert ck["config"] == json.loads(json.dumps(config))
    for tree, got in ((params, ck["params"]), (stats, ck["batch_stats"])):
        want, have = _flat(tree), _flat(got)
        assert sorted(want) == sorted(have)
        for k, v in want.items():
            assert have[k].dtype == np.asarray(v).dtype, k
            assert have[k].tobytes() == np.asarray(v).tobytes(), k


def test_decoder_matches_msgpack_on_every_type():
    value = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63,
                      -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1,
                      -2**63],
             "floats": [0.5, -1.25e300, float("inf")], "none": None,
             "bools": [True, False], "s": "x" * 40, "long": "y" * 70000,
             "bin": b"\x00\x01" * 200, "nested": {"a": {"b": [1, [2, {}]]}},
             "many": list(range(20)), "map": {str(i): i for i in range(20)}}
    data = msgpack.packb(value, use_bin_type=True)
    assert P.msgpack_restore(data) == msgpack.unpackb(data, raw=False)


def test_load_teacher_rebuilds_the_same_model(saved):
    cfg, jmodel, params, stats, path, _ = saved
    model, tcfg, _ = P.load_teacher_from_ckpt(path, device="cpu")
    assert tcfg.to_dict() == cfg.to_dict()
    want_sd = flax_to_state_dict(params, stats)
    got_sd = model.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
    x_ts, static, bin_ends, pixel_u8 = window_inputs(cfg, 2)
    x_in = np.concatenate([x_ts, np.zeros((2, 24, 1), np.float32)], -1)
    px = (pixel_u8.astype(np.float32) / 255.0 - 0.5307) / 0.2583
    want = jax.jit(jmodel.apply)({"params": params, "batch_stats": stats},
                                 x_in, static, bin_ends, px)
    with torch.inference_mode():
        got = model(t(x_in), t(static), t(bin_ends), t(px))
    np.testing.assert_allclose(got["fusion_logits"].numpy(),
                               np.asarray(want["fusion_logits"]),
                               atol=1e-4, rtol=1e-4)


def test_default_device_is_the_card(saved):
    path = saved[4]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.load_teacher_from_ckpt(path)
