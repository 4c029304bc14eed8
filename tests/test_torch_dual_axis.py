"""K3, the fused DuETT dual-axis encoder block
(``ops/dual_axis.py::fused_encoder_block``), against the JAX package's
``ops/pallas_dual_axis.py`` on the CPU, where the port runs its plain
version and the JAX op runs its Pallas kernel in interpret mode.

The cases are the JAX test's own (``tests/test_pallas_dual_axis.py``):
float32, 2 heads x 12, F 512, weights N(0, 0.1²), unit gains. Tolerances:
≤1e-5 of the output's largest magnitude against ``encoder_block_reference``
(the same float32 math in another summation order: 840- and 512-term dot
products reach 1.8e-5 absolute on outputs up to ~4.5); rtol 2e-4, atol 2e-5
against the
interpret-mode kernel (the JAX test's bounds); the backward rtol 2e-3, atol
1e-5 (``test_pallas_dual_axis.py:45-49``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.ops.pallas_dual_axis import (
    encoder_block_reference as j_reference, fused_encoder_block as j_fused)
from multimodal_edema_prediction_tpu_torch.ops import dual_axis as DA


def _params(rng, D, inner, F_, gains=(1.0, 1.0, 1.0), scale=0.1):
    def r(*s):
        return (rng.normal(size=s) * scale).astype(np.float32)
    g = {k: np.full(1, v, np.float32) for k, v in zip(DA.GAINS, gains)}
    return {**g, "wq": r(D, inner), "wk": r(D, inner), "wv": r(D, inner),
            "wo": r(inner, D), "bo": r(D), "w1": r(D, F_), "b1": r(F_),
            "w2": r(F_, D), "b2": r(D)}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("B,L,D", [(8, 35, 600), (4, 25, 840), (6, 7, 96)])
def test_plain_block_matches_jax(B, L, D):
    rng = np.random.default_rng(0)
    jp, tp = _both(_params(rng, D, 24, 512))
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    got = DA.fused_encoder_block(torch.from_numpy(x), tp, 2, 12).numpy()
    want = np.asarray(j_reference(jnp.asarray(x), jp, 2, 12))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(
        got, np.asarray(j_fused(jnp.asarray(x), jp, 2, 12)),
        rtol=2e-4, atol=2e-5)


def test_backward_matches_jax_grad():
    """The autograd Function's backward (a recompute of the plain version)
    against ``jax.grad`` of the JAX fused op (its custom VJP)."""
    rng = np.random.default_rng(1)
    B, L, D, F_ = 4, 25, 96, 64
    params = _params(rng, D, 24, F_, gains=(1.1, 0.9, 1.2))
    jp, _ = _both(params)
    x = rng.normal(size=(B, L, D)).astype(np.float32)

    def loss(x_, p_):
        return (j_fused(x_, p_, 2, 12) ** 2).mean()

    jgx, jgp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jp)
    tx = torch.from_numpy(x).requires_grad_()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    (DA.fused_encoder_block(tx, tp, 2, 12) ** 2).mean().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=2e-3,
                               atol=1e-5)
    for k in DA.PARAM_KEYS:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]),
                                   rtol=2e-3, atol=1e-5, err_msg=k)


def test_block_gelu_is_the_tanh_form(monkeypatch):
    """Both JAX functions call ``jax.nn.gelu(x)``, whose default is the tanh
    form. At float32, with the FF pre-activations of size ~1, the erf form
    moves the block's output by well over 1e-5 (3.7e-4 here): the port
    agrees with JAX within 1e-6 of the output's largest magnitude, and an
    erf variant of it does not."""
    rng = np.random.default_rng(2)
    jp, tp = _both(_params(rng, 96, 24, 64))
    x = rng.normal(size=(3, 7, 96)).astype(np.float32)
    want = np.asarray(j_reference(jnp.asarray(x), jp, 2, 12))
    got = DA.encoder_block_reference(torch.from_numpy(x), tp, 2, 12).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()

    gelu = DA.F.gelu
    monkeypatch.setattr(DA.F, "gelu",
                        lambda t, approximate: gelu(t, approximate="none"))
    erf_out = DA.encoder_block_reference(torch.from_numpy(x), tp, 2,
                                         12).numpy()
    assert np.abs(erf_out - want).max() > 1e-4


@pytest.mark.parametrize("axis", ["event", "time"])
def test_block_computes_a_duett_axis_layer(axis):
    """``params_from_encoder`` maps a DuETT axis (a one-layer
    ``TransformerEncoder``, its weights and gains moved off their init) onto
    K3's dict: at bfloat16, where both take GELU's tanh form, the block gives
    the encoder's own output within 2e-2 of its largest magnitude (0.009
    here: the encoder rounds each product to bfloat16, the block sums in
    float32). Swapping two gains, wq and wk, or bo and b2, or zeroing b1
    moves it by 0.028 or more."""
    from multimodal_edema_prediction_tpu_torch.config import DuettConfig
    from multimodal_edema_prediction_tpu_torch.models.duett import \
        DuettEncoder
    from multimodal_edema_prediction_tpu_torch.models.layers import \
        init_like_flax
    cfg = DuettConfig(n_variables=6, n_timesteps=8, d_embedding=8,
                      n_layers=1, d_feedforward=32)
    enc = getattr(init_like_flax(DuettEncoder(cfg), 0),
                  f"{axis}_transformer_0")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in enc.parameters():
            p.add_((0.3 if p.numel() == 1 else 0.05)
                   * torch.randn(p.shape, generator=g))
    D = cfg.et_dim if axis == "event" else cfg.tt_dim
    L = cfg.n_variables + 1 if axis == "event" else cfg.n_timesteps + 1
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, L, D)).astype(np.float32)).to(torch.bfloat16)
    params = DA.params_from_encoder(enc)
    heads = (cfg.n_heads, cfg.d_embedding // cfg.n_heads)
    with torch.no_grad():
        want = enc(x).float()
        got = DA.fused_encoder_block(x, params, *heads).float()
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()
    with pytest.raises(ValueError, match="one layer"):
        enc.n_layers = 2
        DA.params_from_encoder(enc)


def test_rejects_params_of_the_wrong_shape():
    rng = np.random.default_rng(3)
    _, tp = _both(_params(rng, 96, 24, 64))
    with pytest.raises(ValueError, match="wrong shape"):
        DA.fused_encoder_block(torch.zeros(2, 7, 80), tp, 2, 12)
    with pytest.raises(ValueError, match="missing"):
        DA.fused_encoder_block(torch.zeros(2, 7, 96),
                               {k: v for k, v in tp.items() if k != "gf"},
                               2, 12)


@pytest.mark.parametrize("L,D,fits", [(35, 600, True), (25, 840, True),
                                      (64, 840, False)])
def test_shared_memory_budget(L, D, fits):
    """DuETT's two axes fit one block's 227 KB; a longer axis is refused
    by the kernel wrapper (the check runs before any launch)."""
    assert (DA.smem_bytes(L, D, 2, 12) <= DA.SMEM_LIMIT) == fits
