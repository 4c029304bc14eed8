"""K4, the fused LayerNorm → QKV projection (``ops/ln_qkv.py::fused_ln_qkv``),
against the JAX package's ``ops/pallas_ln_qkv.py`` on the CPU, where the
port runs its plain version and the JAX op runs its Pallas kernel in
interpret mode.

The cases are the JAX test's own (``tests/test_pallas_ln_qkv.py:19-21``),
float32. Tolerances: ≤1e-5 (rtol and atol) against ``ln_qkv_reference``;
rtol 2e-4, atol 2e-5 against the interpret-mode kernel (the JAX test's
bounds); the backward rtol 2e-3, atol 1e-6 (``test_pallas_ln_qkv.py:48-53``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.ops.pallas_ln_qkv import (
    fused_ln_qkv as j_fused, ln_qkv_reference as j_reference)
from multimodal_edema_prediction_tpu_torch.ops import ln_qkv as LQ


def _params(rng, D, H, dh):
    def r(*s):
        return (rng.normal(size=s) * 0.05).astype(np.float32)
    return {"ln_scale": (1.0 + r(D)).astype(np.float32),
            "ln_bias": (0.1 + r(D)).astype(np.float32),
            "wq": r(D, H * dh), "wk": r(D, H * dh), "wv": r(D, H * dh),
            "bq": r(H * dh), "bk": r(H * dh), "bv": r(H * dh)}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("B,N,D,H,dh", [(2, 512, 256, 4, 64),
                                        (3, 1024, 128, 2, 64),
                                        (2, 128, 256, 4, 64)])
def test_plain_ln_qkv_matches_jax(B, N, D, H, dh):
    rng = np.random.default_rng(0)
    jp, tp = _both(_params(rng, D, H, dh))
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    got = LQ.fused_ln_qkv(torch.from_numpy(x), tp, H, dh)
    ref = j_reference(jnp.asarray(x), jp, H, dh)
    fused = j_fused(jnp.asarray(x), jp, H, dh)
    for name, a, r, f in zip("qkv", got, ref, fused):
        assert a.shape == (B, H, N, dh)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(f), rtol=2e-4,
                                   atol=2e-5, err_msg=name)


def test_backward_matches_jax_grad():
    """The autograd Function's backward (a recompute of the plain version)
    against ``jax.grad`` of the JAX fused op (its custom VJP)."""
    rng = np.random.default_rng(1)
    B, N, D, H, dh = 2, 256, 128, 2, 64
    params = _params(rng, D, H, dh)
    jp, _ = _both(params)
    x = rng.normal(size=(B, N, D)).astype(np.float32)

    def loss(x_, p_):
        q, k, v = j_fused(x_, p_, H, dh)
        return (q ** 2).mean() + (k * v).mean()

    jgx, jgp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jp)
    tx = torch.from_numpy(x).requires_grad_()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    q, k, v = LQ.fused_ln_qkv(tx, tp, H, dh)
    ((q ** 2).mean() + (k * v).mean()).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=2e-3,
                               atol=1e-6)
    for key in LQ.PARAM_KEYS:
        np.testing.assert_allclose(tp[key].grad.numpy(), np.asarray(jgp[key]),
                                   rtol=2e-3, atol=1e-6, err_msg=key)


def test_token_count_contract_matches_jax():
    """N must be below 512 or a multiple of it, in both packages: the ViT's
    1370 tokens are refused (the JAX model pads them to 3·512 once)."""
    rng = np.random.default_rng(2)
    jp, tp = _both(_params(rng, 64, 1, 64))
    x = rng.normal(size=(1, 1370, 64)).astype(np.float32)
    with pytest.raises(AssertionError, match="multiple of block_n"):
        j_fused(jnp.asarray(x), jp, 1, 64)
    with pytest.raises(ValueError, match="multiple of block_n"):
        LQ.fused_ln_qkv(torch.from_numpy(x), tp, 1, 64)
    q, _, _ = LQ.fused_ln_qkv(torch.from_numpy(x[:, :1024]), tp, 1, 64)
    assert q.shape == (1, 1, 1024, 64)
