"""The ViT's train mode (the repair of fault F2): ``DinoBlock`` passes
``ViTConfig.dropout`` and ``train`` to its attention, as the JAX package's
does (``models/vit.py:51-58``), and the teacher trains the ViT exactly when
the CXR branch is trainable (JAX ``models/teacher.py:64,83-84``).

With attention dropout in force while training, the flash gate closes in
both packages (JAX ``models/layers.py:292-296``); the tests count the calls
that reach each package's ``flash_mha``. The dropout masks come from the
``torch.Generator`` (JAX draws from its own key, so only the gate and the
draw's dependence on the generator are compared, not the masks). At the
flash-gated tiny geometry of ``tests/test_torch_vit.py`` (224² → 257
tokens, 2 heads of 64).
"""
import jax
import numpy as np
import pytest
import torch

import multimodal_edema_prediction_tpu.ops.attention as jax_attention
from multimodal_edema_prediction_tpu.config import ViTConfig as JViTConfig
from multimodal_edema_prediction_tpu.models import vit as JV
from multimodal_edema_prediction_tpu_torch.config import (TeacherConfig,
                                                          ViTConfig)
from multimodal_edema_prediction_tpu_torch.convert import load_flax
from multimodal_edema_prediction_tpu_torch.models import layers
from multimodal_edema_prediction_tpu_torch.models import vit as PV
from multimodal_edema_prediction_tpu_torch.models.teacher import init_teacher
from torch_port_util import init_perturbed, t, tiny_teacher_cfg

GEOM = dict(image_size=224, patch_size=14, d_model=128, n_layers=2,
            n_heads=2, d_feedforward=128)


def _pixels(B=2):
    return np.random.default_rng(0).normal(
        size=(B, 224, 224, 3)).astype(np.float32)


class _Count:
    """Replaces a module's ``flash_mha`` with a counting pass-through."""

    def __init__(self, monkeypatch, module):
        self.n = 0
        inner = module.flash_mha

        def counted(*a, **k):
            self.n += 1
            return inner(*a, **k)

        monkeypatch.setattr(module, "flash_mha", counted)


@pytest.mark.parametrize("dropout,train", [
    (0.0, False), (0.0, True), (0.1, False), (0.1, True)])
def test_flash_gate_follows_jax_in_train_mode(monkeypatch, dropout, train):
    px = _pixels()
    jmod = JV.DinoViT(JViTConfig(**GEOM, dropout=dropout))
    params, _ = init_perturbed(jmod, px)
    jcount = _Count(monkeypatch, jax_attention)
    jmod.apply({"params": params}, px, train=train,
               rngs={"dropout": jax.random.key(0)})
    pcount = _Count(monkeypatch, layers)
    model = load_flax(PV.DinoViT(ViTConfig(**GEOM, dropout=dropout)), params)
    with torch.no_grad():
        model(t(px), train, torch.Generator().manual_seed(0))
    gate_open = not (train and dropout > 0)
    assert jcount.n == (GEOM["n_layers"] if gate_open else 0)
    assert pcount.n == jcount.n


def test_attention_dropout_draws_from_the_generator():
    px = t(_pixels())
    jmod = JV.DinoViT(JViTConfig(**GEOM, dropout=0.3))
    params, _ = init_perturbed(jmod, _pixels())
    model = load_flax(PV.DinoViT(ViTConfig(**GEOM, dropout=0.3)), params)
    with torch.no_grad():
        eval_out = model(px)[1]
        a = model(px, True, torch.Generator().manual_seed(1))[1]
        b = model(px, True, torch.Generator().manual_seed(1))[1]
        c = model(px, True, torch.Generator().manual_seed(2))[1]
        with pytest.raises(ValueError, match="Generator"):
            model(px, True, None)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, eval_out)
    # eval ignores the rate: the same tokens as a ViT without dropout
    plain = load_flax(PV.DinoViT(ViTConfig(**GEOM)), params)
    with torch.no_grad():
        assert torch.equal(plain(px)[1], eval_out)


def test_train_equals_eval_without_dropout():
    px = t(_pixels())
    params, _ = init_perturbed(JV.DinoViT(JViTConfig(**GEOM)), _pixels())
    model = load_flax(PV.DinoViT(ViTConfig(**GEOM)), params)
    with torch.no_grad():
        for got, want in zip(model(px, True, torch.Generator()), model(px)):
            assert torch.equal(got, want)


@pytest.mark.parametrize("freeze_cxr", [True, False])
def test_teacher_trains_the_vit_only_when_unfrozen(monkeypatch, freeze_cxr):
    """In a training forward, a trainable ViT runs in train mode (its
    attention dropout closes the gate: no flash call) and keeps a graph; a
    frozen one runs in eval mode (the gate open) without one."""
    cfg = tiny_teacher_cfg(224).replace(
        vit=JViTConfig(**GEOM, dropout=0.2), freeze_cxr=freeze_cxr)
    model = init_teacher(TeacherConfig.from_dict(cfg.to_dict()), 0)
    count = _Count(monkeypatch, layers)
    d = cfg.duett
    patches = []
    model.img_proj.register_forward_hook(
        lambda m, args, out: patches.append(args[0]))
    model(torch.zeros(2, d.n_timesteps, 2 * d.n_variables + 1),
          torch.zeros(2, d.d_static), torch.ones(2, d.n_timesteps),
          t(_pixels()), train=True, gen=torch.Generator().manual_seed(0))
    assert count.n == (GEOM["n_layers"] if freeze_cxr else 0)
    assert patches[0].requires_grad == (not freeze_cxr)
