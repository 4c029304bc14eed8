"""Port building blocks (``models/layers.py``) against the flax modules.

Tolerance: ≤1e-5 at float32 per module, the repo's precedent for module
outputs (``models/layers.py:33-43``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.models import layers as J
from multimodal_edema_prediction_tpu_torch.convert import load_flax
from multimodal_edema_prediction_tpu_torch.models import layers as P
from multimodal_edema_prediction_tpu_torch.ops.attention import LAUNCHES
from torch_port_util import init_perturbed, t

TOL = 1e-5


def _check(jmod, pmod, inputs, jkw=None, pkw=None, rows=None):
    params, stats = init_perturbed(jmod, *inputs, **(jkw or {}))
    want = np.asarray(jax.jit(lambda v, *a: jmod.apply(v, *a, **(jkw or {})))(
        {"params": params, "batch_stats": stats}, *inputs))
    load_flax(pmod, params, stats)
    with torch.inference_mode():
        got = pmod(*[t(x) for x in inputs], **(pkw or {})).numpy()
    if rows is not None:
        want, got = want[:, :rows], got[:, :rows]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_scalenorm():
    _check(J.ScaleNorm(), P.ScaleNorm(), [_x(3, 5, 40) * 3.0])


def test_batchnorm_eval():
    _check(J.BatchNormLastDim(), P.BatchNormLastDim(12), [_x(4, 7, 12)],
           jkw={"use_running_average": True})


@pytest.mark.parametrize("n_hidden", [0, 1, 2])
def test_simple_mlp(n_hidden):
    _check(J.SimpleMLP(5, n_hidden=n_hidden, d_hidden=16,
                       hidden_batch_norm=True),
           P.SimpleMLP(18, 5, n_hidden, 16, hidden_batch_norm=True),
           [_x(6, 18)])


def test_cve():
    _check(J.CVE(40, batch_norm=True), P.CVE(40, batch_norm=True),
           [_x(2, 24, 1)])


def test_per_variable_mlp():
    _check(J.PerVariableMLP(6, 8, 16), P.PerVariableMLP(6, 8, 16),
           [_x(2, 24, 6, 2)])


@pytest.mark.parametrize("scalenorm", [True, False])
def test_transformer_encoder(scalenorm):
    # DuETT's event-axis geometry, cut down: 2 heads × d_head 12 on 200-dim
    # tokens, no qkv bias
    _check(J.TransformerEncoder(2, 2, 12, 32, scalenorm=scalenorm),
           P.TransformerEncoder(200, 2, 2, 12, 32, scalenorm=scalenorm),
           [_x(2, 7, 200)])


@pytest.mark.parametrize("valid_len", [None, 20])
def test_mha_plain_path(valid_len):
    """Cross-attention below the flash gate (24 keys), with and without
    pad masking of the keys."""
    q, kv = _x(2, 7, 32), _x(2, 24, 32, seed=1)
    _check(J.MultiHeadAttention(4, 8), P.MultiHeadAttention(32, 4, 8),
           [q, kv], jkw={"valid_len": valid_len},
           pkw={"valid_len": valid_len})


@pytest.mark.parametrize("n_q,valid_len", [(300, None), (300, 270),
                                            (7, None)])
def test_mha_flash_path(n_q, valid_len):
    """KV ≥ 256 and d_head 64 open the flash gate in both packages, for
    the ViT's self-attention and the perceiver's 7-query cross-attention;
    on the CPU both run their plain attention op. Rows past valid_len are
    garbage by contract and not compared."""
    x = _x(2, 300, 128) * 0.5
    q = x if n_q == 300 else _x(2, n_q, 128, seed=1)
    before = LAUNCHES["flash_attention"]
    _check(J.MultiHeadAttention(2, 64, use_flash=True),
           P.MultiHeadAttention(128, 2, 64, use_flash=True), [q, x],
           jkw={"valid_len": valid_len}, pkw={"valid_len": valid_len},
           rows=valid_len)
    assert LAUNCHES["flash_attention"] == before   # no kernel on the CPU


def test_gelu_rule():
    x = torch.linspace(-4, 4, 101)
    want32 = np.asarray(J.gelu_exact(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(P.gelu_exact(x).numpy(), want32, atol=TOL)
    xb = x.to(torch.bfloat16)
    want16 = np.asarray(J.gelu_exact(jnp.asarray(x.numpy(), jnp.bfloat16)),
                        np.float32)
    # tanh form at bf16 in both; one bf16 ulp (2^-8 relative) apart at most
    np.testing.assert_allclose(P.gelu_exact(xb).float().numpy(), want16,
                               atol=2e-2, rtol=1e-2)
