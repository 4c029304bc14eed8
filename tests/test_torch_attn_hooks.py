"""The attention and token hooks of the analysis suite in the port against
the JAX package: ``MultiHeadAttention(return_weights=True)`` (its weights
averaged over heads, and the flash gate it closes), ``return_attn`` through
the teacher in every mode (each perceiver's attentions and tokens),
``token_eps`` in the two patch modes (and its refusal elsewhere), and the
window eval step's ``return_attn`` keys.

The teacher geometry is ``tests/test_torch_modes.py``'s; weights are
flax's, perturbed and carried into the port by ``convert.py``. Everything
runs in float32 on the CPU with dropout off. Tolerance: every output
≤1e-5 (relative and absolute).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.config import (
    DuettConfig as JDuett, PerceiverConfig as JPerc, TeacherConfig as JTeacher,
    ViTConfig as JViT)
from multimodal_edema_prediction_tpu.models.layers import \
    MultiHeadAttention as JMHA
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.train import engine as JE
from multimodal_edema_prediction_tpu_torch.config import TeacherConfig
from multimodal_edema_prediction_tpu_torch.convert import load_flax
from multimodal_edema_prediction_tpu_torch.models import layers
from multimodal_edema_prediction_tpu_torch.models.layers import \
    MultiHeadAttention
from multimodal_edema_prediction_tpu_torch.models.teacher import (
    ATTN_KEYS, TeacherModel)
from multimodal_edema_prediction_tpu_torch.train import engine
from torch_port_util import init_perturbed, t

B, T, V = 3, 24, 5
JCFG = JTeacher(
    duett=JDuett(n_variables=V, n_timesteps=T, d_embedding=8, n_layers=1,
                 d_feedforward=16, d_hidden_mlp_embedding=8,
                 d_hidden_tab_encoder=8),
    vit=JViT(image_size=56, patch_size=14, d_model=32, n_layers=1, n_heads=2,
             d_feedforward=64),
    perceiver=JPerc(n_pathologies=7, d_latent=32, n_heads=2, dropout=0.0,
                    head_dropout=0.0, head_hidden=16, n_latents=4,
                    n_layers=2))
MODES = ("dual_patch", "dual_patch_event", "single", "legacy", "dual")
PATCH_MODES = ("dual_patch", "dual_patch_event")
# what return_attn adds in each mode (JAX teacher.py:135-140, :140-143)
ATTN = {"dual_patch": ("img_tokens", "ts_tokens", "fusion_tokens",
                       "img_attn", "ts_attn"),
        "dual_patch_event": ("img_tokens", "ts_tokens", "fusion_tokens",
                             "img_attn", "event_attn"),
        "single": ("stage2_tokens", "stage4_tokens", "img_attn", "ts_attn"),
        "legacy": (),
        "dual": ("ts_tokens", "fusion_tokens", "ts_attn")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, err=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-5,
                               atol=1e-5, err_msg=err)


@pytest.mark.parametrize("masked", [False, True])
def test_return_weights_matches_jax_and_closes_the_flash_gate(
        masked, monkeypatch):
    """At a shape that opens the flash gate (1 × 300 keys, d_head 64),
    ``return_weights`` keeps the call on the plain route (as JAX's gate at
    ``layers.py:292``) and returns the head-averaged probabilities
    [B, Nq, Nk], rows summing to 1."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(3, 4, 128)).astype(np.float32)
    kv = rng.normal(size=(3, 300, 128)).astype(np.float32)
    mask = (rng.random((3, 300)) < 0.3) if masked else None
    jmod = JMHA(2, 64, use_flash=True)
    params, _ = init_perturbed(jmod, q, kv)
    model = load_flax(MultiHeadAttention(128, 2, 64, use_flash=True), params)
    monkeypatch.setattr(layers, "flash_mha", lambda *a, **k: pytest.fail(
        "return_weights must close the flash gate"))
    want_out, want_w = jmod.apply({"params": params}, q, kv,
                                  return_weights=True, key_padding_mask=mask)
    out, w = model(t(q), t(kv), return_weights=True,
                   key_padding_mask=None if mask is None else t(mask))
    assert w.shape == (3, 4, 300)
    _close(out, want_out)
    _close(w, want_w)
    np.testing.assert_allclose(w.sum(-1).detach().numpy(), 1.0, rtol=1e-5)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 3, size=(B, T, V)).astype(np.float32)
    counts[0, :, [1, 4]] = 0.0       # two variables never observed
    x_in = np.concatenate([rng.normal(size=(B, T, V)), counts,
                           np.zeros((B, T, 1))], -1).astype(np.float32)
    return (x_in, rng.normal(size=(B, 18)).astype(np.float32),
            np.tile(np.arange(1, T + 1, dtype=np.float32) / 24, (B, 1)),
            rng.normal(size=(B, 56, 56, 3)).astype(np.float32))


_PAIRS = {}


def _pair(mode, inputs):
    """(flax teacher, its variables, the port's teacher with them), one
    per mode for the module."""
    if mode not in _PAIRS:
        jcfg = JCFG.replace(perceiver_type=mode)
        jmodel = JT(jcfg)
        params, stats = init_perturbed(jmodel, *inputs)
        model = load_flax(TeacherModel(TeacherConfig.from_dict(
            jcfg.to_dict())), params, stats).eval()
        _PAIRS[mode] = (jmodel, {"params": params, "batch_stats": stats},
                        model)
    return _PAIRS[mode]


@pytest.mark.parametrize("mode", MODES)
def test_return_attn_matches_jax(mode, inputs):
    """Every output of ``return_attn=True`` in every mode: the logits as
    before, and the attentions and tokens of the mode (``legacy`` has
    none, as in JAX); the attention rows sum to 1."""
    jmodel, variables, model = _pair(mode, inputs)
    want = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, train=False, return_attn=True))(variables, *inputs)
    with torch.no_grad():
        got = model(*[t(x) for x in inputs], return_attn=True)
        plain = model(*[t(x) for x in inputs])
    assert set(got) == set(want) == set(plain) | set(ATTN[mode])
    for k in want:
        _close(got[k], want[k], k)
    for k in ATTN[mode]:
        if k.endswith("_attn"):
            np.testing.assert_allclose(got[k].sum(-1).numpy(), 1.0,
                                       rtol=1e-5)


@pytest.mark.parametrize("mode", PATCH_MODES)
def test_token_eps_matches_jax(mode, inputs):
    """``token_eps=(eps_img, eps_ts)`` added to the fusion tokens before
    the heads: non-zero perturbations move the logits exactly as in JAX;
    zeros leave every output as it was."""
    jmodel, variables, model = _pair(mode, inputs)
    rng = np.random.default_rng(5)
    K, D = 7, 32
    eps = tuple(0.3 * rng.normal(size=(B, K, D)).astype(np.float32)
                for _ in range(2))
    want = jax.jit(lambda v, e, *a: jmodel.apply(
        v, *a, train=False, return_attn=True, token_eps=e))(
            variables, eps, *inputs)
    with torch.no_grad():
        got = model(*[t(x) for x in inputs], return_attn=True,
                    token_eps=tuple(t(e) for e in eps))
        zero = model(*[t(x) for x in inputs], return_attn=True,
                     token_eps=tuple(torch.zeros(B, K, D) for _ in eps))
        plain = model(*[t(x) for x in inputs], return_attn=True)
    for k in want:
        _close(got[k], want[k], k)
    for k in plain:
        assert torch.equal(zero[k], plain[k]), k
    assert not torch.equal(got["img_logits"], plain["img_logits"])


@pytest.mark.parametrize("mode", ("single", "legacy", "dual"))
def test_token_eps_refused_outside_the_patch_modes(mode, inputs):
    _, _, model = _pair(mode, inputs)
    eps = (torch.zeros(B, 7, 32), torch.zeros(B, 7, 32))
    with pytest.raises(ValueError, match="patch perceiver modes"):
        model(*[t(x) for x in inputs], token_eps=eps)


@pytest.mark.parametrize("mode", PATCH_MODES + ("dual",))
def test_window_eval_return_attn_matches_jax(mode, inputs):
    """``make_teacher_eval_from_windows(return_attn=True)`` at float32:
    the five eval outputs and the six attention and token keys the mode
    has (JAX ``engine.py:403-427``); without it the five alone."""
    jmodel, variables, model = _pair(mode, inputs)
    rng = np.random.default_rng(7)
    x_ts = inputs[0][..., :2 * V]
    x_static = inputs[1]
    batch = {"bin_ends": inputs[2], "pixel_values": inputs[3],
             "image_ids": rng.integers(0, 9, B).astype(np.int32)}
    jstep = JE.make_teacher_eval_from_windows(jmodel, dtype=jnp.float32,
                                              return_attn=True)
    want = jstep(variables["params"], variables["batch_stats"], x_ts,
                 x_static, batch)
    got = engine.make_teacher_eval_from_windows(
        model, torch.float32, return_attn=True)(x_ts, x_static, batch)
    assert set(got) == set(want)
    assert set(got) - set(engine.EVAL_KEYS) == \
        set(ATTN[mode]) & set(ATTN_KEYS)
    for k in want:
        _close(got[k], want[k], k)
    plain = engine.make_teacher_eval_from_windows(model, torch.float32)(
        x_ts, x_static, batch)
    assert set(plain) == set(engine.EVAL_KEYS)
