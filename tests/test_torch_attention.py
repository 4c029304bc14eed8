"""The port's attention op against the JAX ``flash_mha``.

On the CPU the JAX op runs its plain ``mha_reference`` path
(``ops/attention.py:93-99``) and the port's wrapper runs
``flash_mha_reference``; the CUDA kernel itself is held against
``flash_mha_reference`` on the card by ``chip_smoke.py``.

Tolerances: 1e-5 at float32 (same algorithm, other summation order). At
bfloat16 the JAX op rounds the logits and the softmax to bf16 while the port
keeps them in float32 (the kernel's accumulation type): the measured max
abs difference is 7.8e-3 on outputs of magnitude ≤0.6; the bound is 3e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.ops.attention import flash_mha as jax_flash
from multimodal_edema_prediction_tpu_torch.ops.attention import (
    LAUNCHES, flash_mha, flash_mha_reference)


def _qkv(B, H, Nq, Nk, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, H, Nq, D), (B, H, Nk, D), (B, H, Nk, D))]


@pytest.mark.parametrize("Nq,Nk,kv_valid", [
    (300, 300, None),      # ViT-like self-attention
    (300, 300, 257),       # pre-padded: keys ≥ 257 masked
    (7, 281, 260),         # perceiver-like cross-attention, ragged keys
])
def test_reference_matches_jax_f32(Nq, Nk, kv_valid):
    q, k, v = _qkv(2, 3, Nq, Nk, 64)
    scale = 64 ** -0.5
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), sm_scale=scale,
                                q_valid=kv_valid if Nq == Nk else None,
                                kv_valid=kv_valid))
    got = flash_mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale,
                              kv_valid=kv_valid).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_reference_matches_jax_bf16():
    q, k, v = _qkv(2, 2, 300, 300, 64, seed=1)
    scale = 64 ** -0.5
    want = np.asarray(jax_flash(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)),
                                sm_scale=scale, kv_valid=290), np.float32)
    got = flash_mha_reference(*(torch.from_numpy(a).to(torch.bfloat16)
                                for a in (q, k, v)), scale,
                              kv_valid=290)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


def test_wrapper_on_cpu_is_the_reference():
    """A CPU tensor takes the plain version (strided views included) and
    launches nothing."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 280, 280, 64, 2))
    # [B, N, H, D] storage viewed as [B, H, N, D], as the ViT passes it
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)
    before = LAUNCHES["flash_attention"]
    got = flash_mha(qs, k, v, 0.125, kv_valid=270)
    want = flash_mha_reference(q, k, v, 0.125, kv_valid=270)
    assert torch.equal(got, want)
    assert LAUNCHES["flash_attention"] == before
