"""The port's teacher losses (``ops/losses.py``) against the JAX package's.

Tolerance: ≤1e-6 (relative and absolute) at float32: the same formulas,
summed in another order. Inputs include bf16 logits (both compute in f32),
masked labels, large logits (the stable softplus form) and a pos_weight.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.ops import losses as J
from multimodal_edema_prediction_tpu_torch.ops import losses as P

TOL = 1e-6


def _inputs(seed=0, B=12, K=7):
    rng = np.random.default_rng(seed)
    logits = [(rng.normal(size=(B, K)) * 4).astype(np.float32)
              for _ in range(3)]
    logits[0][0, 0] = 60.0                       # far into the tails
    logits[1][1, 1] = -60.0
    y = (rng.random((B, K)) < 0.4).astype(np.float32)
    mask = (rng.random((B, K)) < 0.8).astype(np.float32)
    mask[:, 3] = 0.0                             # a label with no targets
    lw = rng.uniform(0.5, 1.5, K).astype(np.float32)
    return logits, y, mask, lw


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("pos_weight", [None, 2.5])
def test_bce_and_masked_per_label(pos_weight):
    (x, _, _), y, mask, _ = _inputs()
    pw = None if pos_weight is None else np.float32(pos_weight)
    _close(P.bce_with_logits(torch.tensor(x), torch.tensor(y),
                             None if pw is None else torch.tensor(pw)),
           J.bce_with_logits(jnp.asarray(x), jnp.asarray(y), pw))
    _close(P.masked_per_label_bce(torch.tensor(x), torch.tensor(y),
                                  torch.tensor(mask),
                                  None if pw is None else torch.tensor(pw)),
           J.masked_per_label_bce(jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(mask), pw))


@pytest.mark.parametrize("bf16", [False, True])
def test_dual_pathology_loss(bf16):
    logits, y, mask, lw = _inputs(1)
    tl = [torch.tensor(x) for x in logits]
    jl = [jnp.asarray(x) for x in logits]
    if bf16:
        tl = [x.to(torch.bfloat16) for x in tl]
        jl = [x.astype(jnp.bfloat16) for x in jl]
    got = P.dual_pathology_loss(*tl, torch.tensor(y), torch.tensor(mask),
                                torch.tensor(lw), None, 0.3, 0.7, 1.1)
    want = J.dual_pathology_loss(*jl, jnp.asarray(y), jnp.asarray(mask),
                                 jnp.asarray(lw), None, 0.3, 0.7, 1.1)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == torch.float32
        _close(got[k], want[k])


def test_aux_residual_kl_value_and_gradient():
    (img, corr, _), y, mask, _ = _inputs(2)
    ti = torch.tensor(img, requires_grad=True)
    tc = torch.tensor(corr, requires_grad=True)
    got = P.aux_residual_kl(ti, tc, torch.tensor(y), torch.tensor(mask))
    got.backward()
    want = J.aux_residual_kl(jnp.asarray(img), jnp.asarray(corr),
                             jnp.asarray(y), jnp.asarray(mask))
    _close(got, want)
    # the gradient reaches only the correction (stop-gradient on img)
    assert ti.grad is None or not ti.grad.any()
    import jax
    g = jax.grad(lambda c: J.aux_residual_kl(
        jnp.asarray(img), c, jnp.asarray(y), jnp.asarray(mask)))(
        jnp.asarray(corr))
    _close(tc.grad, g)
