"""The gradient of the port's ``flash_mha`` (its ``torch.autograd.Function``)
against the JAX package's, on the CPU.

On a CPU tensor the Function runs the plain forward and the plain backward
(``flash_mha_reference``, ``flash_mha_lse_reference``,
``flash_mha_backward_reference``), so these tests exercise the wiring the
card's kernels sit in: the saved log-sum-exp, D = rowsum(dO∘O), and the
gradients' layouts. The kernels themselves are held against the plain
backward on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

The JAX oracle is ``jax.vjp`` of ``multimodal_edema_prediction_tpu.ops.
attention.flash_mha``, whose off-TPU route is ``mha_reference``; JAX
0.9.0's ``mha_reference_bwd`` raises for ``sm_scale != 1``
(``flash_attention.py:1629-1630``), so the JAX side runs at ``sm_scale=1``
on a pre-scaled q, which is the same function (its vjp carries the scale
back to q through the chain rule).

Tolerances: 1e-5 at float32 (the same algorithm in another summation
order), on gradients of magnitude ≤ ~10; the plain log-sum-exp against
JAX's m + log(l) within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import \
    mha_reference_no_custom_vjp

from multimodal_edema_prediction_tpu.ops.attention import flash_mha as jax_flash
from multimodal_edema_prediction_tpu_torch.ops import attention as A

SCALE = 64 ** -0.5
TOL = 1e-5


def _inputs(B=2, H=2, N=300, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, N, 64)).astype(np.float32)
            for _ in range(4)]                          # q, k, v, do


def _port_grads(q, k, v, do, sm_scale, kv_valid):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = A.flash_mha(q, k, v, sm_scale, q_valid=kv_valid, kv_valid=kv_valid)
    o.backward(torch.from_numpy(do))
    return o.detach().numpy(), [x.grad.numpy() for x in (q, k, v)]


@pytest.mark.parametrize("kv_valid", [None, 257])
def test_function_grads_match_jax_vjp(kv_valid):
    """The port at the ViT's scale against ``jax.vjp`` of the JAX op at
    ``sm_scale=1`` on q·scale."""
    q, k, v, do = _inputs()

    def f(q, k, v):
        return jax_flash(q * SCALE, k, v, sm_scale=1.0, q_valid=kv_valid,
                         kv_valid=kv_valid)

    want_o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got_o, got = _port_grads(q, k, v, do, SCALE, kv_valid)
    np.testing.assert_allclose(got_o, np.asarray(want_o), atol=TOL,
                               rtol=TOL)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=TOL,
                                   err_msg=f"d{name}")
    if kv_valid is not None:
        # masked keys: exactly zero gradients, in both packages
        assert not got[1][:, :, kv_valid:].any()
        assert not got[2][:, :, kv_valid:].any()


def test_function_grads_at_unit_scale_match_jax():
    """Both packages at ``sm_scale=1`` on the same (pre-scaled) q."""
    q, k, v, do = _inputs(seed=1)
    q = (q * SCALE).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_flash(*a, sm_scale=1.0),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    _, got = _port_grads(q, k, v, do, 1.0, None)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("kv_valid", [None, 290])
def test_function_grads_match_autograd_of_the_reference(kv_valid):
    """The Function's plain backward against torch autograd through
    ``flash_mha_reference``, at the real scale, on strided [B, N, H, D]
    views as the ViT passes them."""
    q, k, v, do = _inputs(seed=2)
    _, got = _port_grads(q, k, v, do, SCALE, kv_valid)
    ts = [torch.from_numpy(x).transpose(1, 2).contiguous().transpose(1, 2)
          .requires_grad_() for x in (q, k, v)]
    o = A.flash_mha_reference(*ts, SCALE, kv_valid=kv_valid)
    o.backward(torch.from_numpy(do))
    for name, g, t in zip("qkv", got, ts):
        np.testing.assert_allclose(g, t.grad.numpy(), atol=TOL, rtol=TOL,
                                   err_msg=f"d{name}")


def test_plain_lse_matches_jax_residuals():
    """``flash_mha_lse_reference`` (the forward kernel's second output,
    plainly) equals JAX's m + log(l) from ``mha_reference_no_custom_vjp(...,
    save_residuals=True)``, masked keys included."""
    q, k, v, _ = _inputs(seed=3)
    N = q.shape[2]
    ab = np.broadcast_to(((np.arange(N) < 280) - 1.0) * 1e30,
                         (2, 2, N, N)).astype(np.float32)
    _, l, m = mha_reference_no_custom_vjp(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(ab),
        sm_scale=SCALE, save_residuals=True)
    want = np.asarray(m) + np.log(np.asarray(l))
    got = A.flash_mha_lse_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    SCALE, kv_valid=280).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_no_gradient_no_function():
    """Without a gradient to keep (eval, frozen branch) the CPU wrapper is
    the plain forward, with no graph; with one, the output carries the
    Function's backward."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(B=1, N=260, seed=4))
    assert A.flash_mha(q, k, v, SCALE).grad_fn is None
    qg = q.clone().requires_grad_()
    assert type(A.flash_mha(qg, k, v, SCALE).grad_fn).__name__ == \
        "_FlashMHABackward"
    with torch.no_grad():
        assert A.flash_mha(qg, k, v, SCALE).grad_fn is None
