"""Train-mode building blocks, DuETT and the perceiver against the flax
modules (``train=True``, float32).

Tolerances:
- BatchNorm outputs and running statistics after one training forward:
  ≤1e-5 (module outputs at float32, ``models/layers.py:33-43``), for
  ``BatchNormLastDim``, ``PerVariableMLP``, ``SimpleMLP``, ``CVE``, the
  whole ``DuettEncoder`` and the perceiver with dropout 0 (whose stop-
  gradient fusion is checked by its gradients, ≤1e-5 relative to each
  leaf's largest magnitude, floored at 1e-3 of the largest gradient of any
  leaf: the key biases' gradient is zero in exact arithmetic, since softmax
  ignores a per-query constant, and both packages leave rounding noise).
- Dropout and augmentation draw from a ``torch.Generator`` where JAX draws
  from ``jax.random``, so they are compared in distribution: on 200,000
  draws the zero fraction is within 0.006 of p (over 10 standard errors of
  a binomial at p ≤ 0.5) and every kept value is exactly x/(1 − p); the
  augmentation noise's standard deviation is within 2% of aug_noise·count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.config import DuettConfig as JDuett
from multimodal_edema_prediction_tpu.config import PerceiverConfig as JPerc
from multimodal_edema_prediction_tpu.models import duett as JD
from multimodal_edema_prediction_tpu.models import layers as J
from multimodal_edema_prediction_tpu.models import perceiver as JP
from multimodal_edema_prediction_tpu_torch.config import (DuettConfig,
                                                          PerceiverConfig)
from multimodal_edema_prediction_tpu_torch.convert import (flax_to_state_dict,
                                                           load_flax)
from multimodal_edema_prediction_tpu_torch.models import duett as PD
from multimodal_edema_prediction_tpu_torch.models import layers as P
from multimodal_edema_prediction_tpu_torch.models import perceiver as PP
from torch_port_util import init_perturbed, t

TOL = 1e-5


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _train_both(jmod, pmod, inputs, jkw, pkw):
    """One training forward in each package: (jax out, new batch_stats),
    (port out, port module)."""
    params, stats = init_perturbed(jmod, *inputs, **jkw)
    want, mut = jmod.apply({"params": params, "batch_stats": stats},
                           *inputs, mutable=["batch_stats"], **jkw)
    load_flax(pmod, params, stats)
    got = pmod(*[t(x) for x in inputs], **pkw)
    return (want, mut["batch_stats"]), got


def _check_stats(pmod, new_stats):
    sd = pmod.state_dict()
    for k, v in flax_to_state_dict({}, new_stats).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=k)


@pytest.mark.parametrize("jmod,pmod,shape", [
    (J.BatchNormLastDim(), P.BatchNormLastDim(12), (4, 7, 12)),
    (J.PerVariableMLP(6, 8, 16), P.PerVariableMLP(6, 8, 16), (3, 24, 6, 2)),
    (J.SimpleMLP(5, n_hidden=2, d_hidden=16, hidden_batch_norm=True),
     P.SimpleMLP(18, 5, 2, 16, hidden_batch_norm=True), (6, 18)),
    (J.CVE(40, batch_norm=True), P.CVE(40, batch_norm=True), (2, 24, 1)),
], ids=["bn", "per_variable_mlp", "simple_mlp", "cve"])
def test_batchnorm_train_outputs_and_running_stats(jmod, pmod, shape):
    x = _x(*shape) * 2.0 + 0.5
    jkw = {"use_running_average": False} if isinstance(
        jmod, J.BatchNormLastDim) else {"train": True}
    (want, new_stats), got = _train_both(jmod, pmod, [x], jkw,
                                         {"train": True})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)
    _check_stats(pmod, new_stats)


def test_duett_encoder_train():
    jcfg = JDuett(n_variables=5, n_timesteps=8, d_embedding=8, n_layers=1,
                  d_feedforward=16, d_hidden_mlp_embedding=8,
                  d_hidden_tab_encoder=8)
    cfg = DuettConfig.from_dict(jcfg.to_dict())
    rng = np.random.default_rng(1)
    x_in = np.concatenate([rng.normal(size=(3, 8, 5)),
                           rng.integers(-1, 4, size=(3, 8, 5)),
                           np.zeros((3, 8, 1))], -1).astype(np.float32)
    static = rng.normal(size=(3, 18)).astype(np.float32)
    times = np.broadcast_to(np.arange(1, 9) / 24.0, (3, 8)).astype(
        np.float32)
    pmod = PD.DuettEncoder(cfg)
    (want, new_stats), got = _train_both(
        JD.DuettEncoder(jcfg), pmod, [x_in, static, times], {"train": True},
        {"train": True})
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=TOL, rtol=TOL)
    _check_stats(pmod, new_stats)


def test_perceiver_train_and_stop_gradient_fusion():
    jcfg = JPerc(d_latent=32, n_heads=2, head_hidden=8, dropout=0.0,
                 head_dropout=0.0)
    cfg = PerceiverConfig.from_dict(jcfg.to_dict())
    ts, img = _x(2, 9, 40), _x(2, 20, 32, seed=1)
    jmod = JP.PatchDualPathologyPerceiver(jcfg, 40)
    params, _ = init_perturbed(jmod, ts, img, train=True)
    pmod = load_flax(PP.PatchDualPathologyPerceiver(cfg, 40), params)

    def jloss(p):
        out = jmod.apply({"params": p}, ts, img, train=True)
        return out["fusion_logits"].sum() + 0.3 * out["img_logits"].sum()

    jgrads = flax_to_state_dict(jax.grad(jloss)(params))
    out = pmod(t(ts), t(img), train=True)
    want = jmod.apply({"params": params}, ts, img, train=True)
    for k in ("img_logits", "ts_logits", "fusion_logits",
              "scaled_correction"):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(want[k]), atol=TOL, rtol=TOL)
    (out["fusion_logits"].sum() + 0.3 * out["img_logits"].sum()).backward()
    floor = 1e-3 * max(np.abs(g.numpy()).max() for g in jgrads.values())
    for name, p in pmod.named_parameters():
        g = jgrads[name].numpy()
        scale = max(np.abs(g).max(), floor)
        got = np.zeros_like(g) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got / scale, g / scale, atol=TOL,
                                   err_msg=name)
    # the fusion loss reaches the image head only through its own term
    assert np.abs(jgrads["image_head.out.weight"].numpy()).max() > 0


@pytest.mark.parametrize("p", [0.1, 0.2, 0.5])
def test_dropout_distribution(p):
    x = torch.full((200_000,), 3.0)
    g = torch.Generator().manual_seed(0)
    y = P.dropout(x, p, True, g)
    kept = y != 0
    assert abs(1.0 - kept.float().mean().item() - p) < 0.006
    assert torch.equal(y[kept], x[kept] / (1.0 - p))
    assert P.dropout(x, p, False, g) is x
    with pytest.raises(ValueError, match="Generator"):
        P.dropout(x, p, True, None)


def test_feats_to_input_augmentation():
    B, T, V = 400, 24, 10
    rng = np.random.default_rng(2)
    counts = rng.integers(1, 4, size=(B, T, V)).astype(np.float32)
    x_ts = np.concatenate([np.zeros((B, T, V), np.float32), counts], -1)
    static = np.zeros((B, 18), np.float32)
    g = torch.Generator().manual_seed(0)
    x_in, xs = PD.feats_to_input(t(x_ts), t(static), aug_noise=0.1,
                                 aug_mask=0.25, train=True, gen=g)
    jx, _ = JD.feats_to_input(jax.random.key(0), jnp.asarray(x_ts),
                              jnp.asarray(static), 0.1, 0.25, train=True)
    assert x_in.shape == jx.shape == (B, T, 2 * V + 1)
    mask = x_in[..., -1] == 1
    assert abs(mask.float().mean().item() - 0.25) < 0.01
    assert (x_in[mask][:, :2 * V] == 0).all()         # masked steps zeroed
    kept = x_in[~mask]
    noise_per_count = kept[:, :V] / kept[:, V:2 * V]
    assert abs(noise_per_count.std().item() - 0.1) < 0.002
    assert abs(xs.std().item() - 0.1) < 0.002
    # eval mode and no augmentation: the mask column only, as in JAX
    x_eval, _ = PD.feats_to_input(t(x_ts), t(static), 0.1, 0.25)
    np.testing.assert_array_equal(
        x_eval.numpy(), np.asarray(JD.feats_to_input(
            None, jnp.asarray(x_ts), jnp.asarray(static), 0.1, 0.25)[0]))
