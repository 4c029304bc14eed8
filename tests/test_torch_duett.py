"""The port's ``DuettEncoder`` against flax: count == -1 event-mask cells,
a masked row (mask column 1), integer counts through the n_obs embedding,
and the axis-fold transposes over two layer pairs. Tolerance ≤1e-5 at
float32."""
import jax
import numpy as np
import torch

from multimodal_edema_prediction_tpu.config import DuettConfig as JDuett
from multimodal_edema_prediction_tpu.models.duett import DuettEncoder as JEnc
from multimodal_edema_prediction_tpu.models.duett import \
    feats_to_input as j_feats
from multimodal_edema_prediction_tpu_torch.config import DuettConfig
from multimodal_edema_prediction_tpu_torch.convert import load_flax
from multimodal_edema_prediction_tpu_torch.models.duett import (
    DuettEncoder, feats_to_input)
from torch_port_util import init_perturbed, t

GEOM = dict(n_variables=6, n_timesteps=12, d_embedding=8, n_layers=2,
            d_feedforward=16, d_hidden_mlp_embedding=8,
            d_hidden_tab_encoder=8, n_obs_bins=4)
TOL = 1e-5


def _inputs(B=3, seed=0):
    rng = np.random.default_rng(seed)
    V, T = GEOM["n_variables"], GEOM["n_timesteps"]
    values = rng.normal(size=(B, T, V)).astype(np.float32)
    counts = rng.integers(-1, 7, size=(B, T, V)).astype(np.float32)  # > bins
    x_ts = np.concatenate([values, counts], -1)
    x_in = np.array(j_feats(None, x_ts, np.zeros((B, 18), np.float32))[0])
    x_in[1, 5, -1] = 1.0                                   # a masked row
    static = rng.normal(size=(B, 18)).astype(np.float32)
    times = np.sort(rng.random((B, T)).astype(np.float32), axis=1)
    return x_ts, x_in, static, times


def test_feats_to_input_eval():
    x_ts, _, static, _ = _inputs()
    want, _ = j_feats(None, x_ts, static)
    got, s2 = feats_to_input(t(x_ts), t(static))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(s2, t(static))


def test_duett_encoder_matches_flax():
    _, x_in, static, times = _inputs()
    assert (x_in[..., 6:12] == -1).any()
    module = JEnc(JDuett(**GEOM))
    params, stats = init_perturbed(module, x_in, static, times)
    j_tokens, j_psi = jax.jit(module.apply)(
        {"params": params, "batch_stats": stats}, x_in, static, times)
    model = load_flax(DuettEncoder(DuettConfig(**GEOM)), params, stats).eval()
    with torch.inference_mode():
        tokens, psi = model(t(x_in), t(static), t(times))
    assert tokens.shape == (3, 13, 8 * 7) and psi.shape == (3, 13, 7, 8)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(j_tokens),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(psi.numpy(), np.asarray(j_psi), atol=TOL,
                               rtol=TOL)
