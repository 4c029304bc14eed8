"""The port's ``TeacherModel`` (``dual_patch``) and its eval step against the
JAX package, at a small geometry whose ViT opens the flash gate (224² →
257 tokens, 2 heads of 64).

Tolerances: ≤1e-4 at float32 for the whole teacher (a deeper stack than one
module). At bfloat16 both packages round at different places (the JAX
attention path rounds logits and softmax to bf16, the port keeps them in
float32; XLA and torch fuse elementwise work differently); the measured max
abs difference on the outputs is 2.9e-2 with logits of magnitude ≤1.3, and
the bound is 0.1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.config import (
    DuettConfig as JDuett, PerceiverConfig as JPerc, TeacherConfig as JTeacher,
    ViTConfig as JViT)
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.train import engine as jengine
from multimodal_edema_prediction_tpu_torch.config import TeacherConfig
from multimodal_edema_prediction_tpu_torch.convert import load_flax
from multimodal_edema_prediction_tpu_torch.models.duett import feats_to_input
from multimodal_edema_prediction_tpu_torch.models.teacher import TeacherModel
from multimodal_edema_prediction_tpu_torch.train import engine
from torch_port_util import init_perturbed, t, window_inputs

KEYS = ("main_logit", "img_logits", "ts_logits", "fusion_logits",
        "scaled_correction")


def _jcfg():
    return JTeacher(
        duett=JDuett(n_variables=5, n_timesteps=8, d_embedding=8, n_layers=1,
                     d_feedforward=16, d_hidden_mlp_embedding=8,
                     d_hidden_tab_encoder=8),
        vit=JViT(image_size=224, patch_size=14, d_model=128, n_layers=1,
                 n_heads=2, d_feedforward=128),
        perceiver=JPerc(d_latent=32, n_heads=2, head_hidden=8))


@pytest.fixture(scope="module")
def pair():
    jcfg = _jcfg()
    cfg = TeacherConfig.from_dict(jcfg.to_dict())
    x_ts, static, bin_ends, pixel_u8 = window_inputs(cfg, 2)
    x_in = np.concatenate([x_ts, np.zeros((2, 8, 1), np.float32)], -1)
    px = np.asarray(jengine.default_image_source(
        {"pixel_u8": pixel_u8}), np.float32)
    jmodel = JT(jcfg)
    params, stats = init_perturbed(jmodel, x_in, static, bin_ends, px)
    model = load_flax(TeacherModel(cfg), params, stats).eval()
    return dict(jmodel=jmodel, params=params, stats=stats, model=model,
                x_ts=x_ts, x_in=x_in, static=static, bin_ends=bin_ends,
                px=px, pixel_u8=pixel_u8)


def test_teacher_forward_f32(pair):
    p = pair
    want = jax.jit(p["jmodel"].apply)(
        {"params": p["params"], "batch_stats": p["stats"]},
        p["x_in"], p["static"], p["bin_ends"], p["px"])
    with torch.inference_mode():
        got = p["model"](t(p["x_in"]), t(p["static"]), t(p["bin_ends"]),
                         t(p["px"]))
    assert set(got) == set(KEYS) | {"ts_correction"}
    assert np.abs(np.asarray(want["scaled_correction"])).max() > 1e-2
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)


def _eval_both(p, jdtype, dtype):
    batch = {"bin_ends": p["bin_ends"], "pixel_u8": p["pixel_u8"]}
    want = jengine.make_teacher_eval_from_windows(p["jmodel"], jdtype)(
        p["params"], p["stats"], p["x_ts"], p["static"], batch)
    got = engine.make_teacher_eval_from_windows(p["model"], dtype)(
        p["x_ts"], p["static"], batch)
    assert sorted(got) == sorted(want) == sorted(KEYS)
    return want, got


def test_eval_from_windows_pixel_u8_f32(pair):
    want, got = _eval_both(pair, jnp.float32, torch.float32)
    for k in KEYS:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)


def test_eval_from_windows_bf16(pair):
    want, got = _eval_both(pair, jnp.bfloat16, torch.bfloat16)
    for k in KEYS:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=0.1, err_msg=k)


def test_feats_to_input_used_by_eval(pair):
    x_in, _ = feats_to_input(t(pair["x_ts"]), t(pair["static"]))
    np.testing.assert_array_equal(x_in.numpy(), pair["x_in"])


@pytest.mark.parametrize("mode", ["single", "legacy", "dual_patch_event"])
def test_other_modes_are_queued(mode):
    cfg = TeacherConfig.from_dict({**_jcfg().to_dict(),
                                   "perceiver_type": mode})
    with pytest.raises(NotImplementedError, match="ROADMAP P13"):
        TeacherModel(cfg)
