"""One teacher train step of the port (``train/engine.py::make_teacher_step``)
against the JAX package's, in both image tiers, at float32 with dropout and
augmentation off, from the same weights and batch.

The geometry opens K1's gate (224² → 257 tokens, 2 heads of 64), so the
pixel tier runs the frozen ViT through ``flash_mha`` (its plain version on
the CPU, as the JAX package's own CPU path runs its reference); the
encode-once tier gathers a float32 feature bank through K2's plain version.

Tolerances: losses ≤1e-5 (relative and absolute); gradients ≤1e-4 per
leaf, relative to the leaf's largest magnitude floored at 1e-3 of the
largest gradient of any leaf (leaves whose exact gradient is zero, such as
attention key biases, keep only rounding noise in both packages); BatchNorm
running statistics after the step ≤1e-5. The optimizer is replaced by a
probe that records the gradients on both sides (the update itself is
``tests/test_torch_optim.py``'s). DuETT runs at T = 24, the real window:
its time embedding's BatchNorm sees the bin ends 1/24 … 1, and a shorter
window's narrower spread makes that BatchNorm's gradient ill-conditioned
in float32 in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_edema_prediction_tpu.config import (
    DuettConfig as JDuett, PerceiverConfig as JPerc, TeacherConfig as JTeacher,
    TrainConfig as JTrain, ViTConfig as JViT)
from multimodal_edema_prediction_tpu.data import features as JF
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.train import engine as jengine
from multimodal_edema_prediction_tpu.train.state import TrainState as JState
from multimodal_edema_prediction_tpu_torch.config import (TeacherConfig,
                                                          TrainConfig)
from multimodal_edema_prediction_tpu_torch.convert import (flax_to_state_dict,
                                                           load_flax)
from multimodal_edema_prediction_tpu_torch.data import features as F
from multimodal_edema_prediction_tpu_torch.models.teacher import TeacherModel
from multimodal_edema_prediction_tpu_torch.train import engine
from multimodal_edema_prediction_tpu_torch.train.state import TrainState
from torch_port_util import init_perturbed

B, T, V, N_STAYS, L, N_IMG = 4, 24, 5, 6, 30, 3
TCFG = dict(dtype="float32", aux_residual_alpha=0.3)


class _Probe:
    """Stands in for the port's optimizer: keeps the gradients."""

    def __init__(self, model):
        self.model = model

    def zero_grad(self):
        self.model.zero_grad(set_to_none=True)

    def step(self, count, count_t=None):
        del count, count_t


def _jax_probe():
    """An optax transformation whose state after an update is the
    gradient it was given, and whose update is zero."""
    def update(updates, state, params=None):
        return jax.tree.map(jnp.zeros_like, updates), updates
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), update)


@pytest.fixture(scope="module")
def setup():
    jcfg = JTeacher(
        duett=JDuett(n_variables=V, n_timesteps=T, d_embedding=8, n_layers=1,
                     d_feedforward=16, d_hidden_mlp_embedding=8,
                     d_hidden_tab_encoder=8),
        vit=JViT(image_size=224, patch_size=14, d_model=128, n_layers=1,
                 n_heads=2, d_feedforward=128),
        perceiver=JPerc(d_latent=32, n_heads=2, head_hidden=8, dropout=0.0,
                        head_dropout=0.0))
    rng = np.random.default_rng(0)
    pixels = rng.normal(size=(N_IMG, 224, 224, 3)).astype(np.float32)
    grid = np.concatenate([rng.normal(size=(N_STAYS, L, V)),
                           rng.integers(0, 4, size=(N_STAYS, L, V))],
                          -1).astype(np.float32)
    static = rng.normal(size=(N_STAYS, 18)).astype(np.float32)
    rows = np.array([2, 0, 2, 1], np.int32)
    batch = {"stay_rows": np.array([0, 3, 5, 3], np.int32),
             "slot_idx": np.array([24, 30, 27, 25], np.int32),
             "image_ids": rows,
             "y_multi": (rng.random((B, 7)) < 0.5).astype(np.float32),
             "y_multi_mask": (rng.random((B, 7)) < 0.8).astype(np.float32),
             "bin_ends": np.broadcast_to(np.arange(1, T + 1) / 24.0,
                                         (B, T)).astype(np.float32),
             "pixel_values": pixels[rows]}
    jmodel = JT(jcfg)
    x_in = np.zeros((2, T, 2 * V + 1), np.float32)
    params, stats = init_perturbed(
        jmodel, x_in, static[:2], batch["bin_ends"][:2], pixels[:2])
    return dict(jcfg=jcfg, jmodel=jmodel, params=params, stats=stats,
                pixels=pixels, grid=grid, static=static, batch=batch)


def _jax_step(s, tier):
    state = JState.create(s["params"], s["stats"], _jax_probe())
    fs = None
    if tier == "features":
        bank = JF.CXRFeatureBank.build(
            JF.encode_fn_for_teacher(s["jmodel"], s["params"], jnp.float32),
            lambda ids: s["pixels"][np.asarray(ids)], np.arange(N_IMG),
            out_dtype=np.float32)
        fs = bank.feature_source()
    step = jengine.make_teacher_step(
        s["jmodel"], JTrain(**TCFG), s["jcfg"].duett, T,
        np.ones(7, np.float32), None, jnp.float32, feature_source=fs)
    new_state, metrics = step(state, jnp.asarray(s["grid"]),
                              jnp.asarray(s["static"]),
                              jax.tree.map(jnp.asarray, s["batch"]),
                              jax.random.key(0))
    return metrics, new_state.opt_state, new_state.batch_stats


def _port_step(s, tier):
    cfg = TeacherConfig.from_dict(s["jcfg"].to_dict())
    model = load_flax(TeacherModel(cfg), s["params"], s["stats"])
    fs = None
    if tier == "features":
        bank = F.CXRFeatureBank.build(
            F.encode_fn_for_teacher(model, torch.float32),
            lambda ids: s["pixels"][np.asarray(ids)], np.arange(N_IMG),
            out_dtype=torch.float32)
        fs = bank.feature_source()
    step = engine.make_teacher_step(
        TrainConfig(**TCFG), cfg.duett, T, np.ones(7, np.float32), None,
        torch.float32, feature_source=fs)
    state = TrainState(model, _Probe(model))
    metrics = step(state, torch.from_numpy(s["grid"]),
                   torch.from_numpy(s["static"]),
                   engine.to_device(s["batch"], torch.device("cpu")),
                   torch.Generator().manual_seed(0))
    assert state.step == 1
    return metrics, model


@pytest.mark.parametrize("tier", ["pixels", "features"])
def test_teacher_step_matches_jax(setup, tier):
    want, jgrads, jstats = _jax_step(setup, tier)
    got, model = _port_step(setup, tier)
    for k in ("total", "img_total", "ts_total", "fus_total",
              "aux_residual", "main_logit"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    jg = flax_to_state_dict(jax.tree.map(np.asarray, jgrads))
    floor = 1e-3 * max(np.abs(g.numpy()).max() for g in jg.values())
    named = dict(model.named_parameters())
    for name, g in jg.items():
        g = g.numpy()
        p = named[name]
        port = np.zeros_like(g) if p.grad is None else p.grad.numpy()
        scale = max(np.abs(g).max(), floor)
        np.testing.assert_allclose(port / scale, g / scale, atol=1e-4,
                                   err_msg=name)
        if name.startswith("cxr."):           # frozen: no gradient at all
            assert p.grad is None and not g.any()
    sd = model.state_dict()
    for k, v in flax_to_state_dict({}, jax.tree.map(np.asarray,
                                                    jstats)).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
