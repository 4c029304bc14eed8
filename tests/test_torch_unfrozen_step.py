"""One teacher train step with the CXR branch trainable (``freeze_cxr=False``,
``--unfreeze_cxr``) on the pixel tier: the port's
``train/engine.py::make_teacher_step`` against the JAX package's, at float32
with dropout and augmentation off, from the same weights and batch.

The geometry is ``tests/test_torch_train_step.py``'s (224² → 257 tokens, 2
heads of 64), which opens the port's flash gate, so the ViT's attention runs
through ``flash_mha``'s autograd Function (its plain forward and backward
on the CPU; the kernels on the card). The JAX side runs the same
``TeacherConfig`` with ``ViTConfig(use_flash_attention=False)``: the same
function through the plain ``MultiHeadAttention`` path, because JAX's
off-TPU ``flash_mha`` cannot be differentiated at the ViT's scale (JAX
0.9.0 ``mha_reference_bwd`` raises for ``sm_scale != 1``,
``flash_attention.py:1629-1630``).

Tolerances (``test_torch_train_step.py``'s rules): losses ≤1e-5; every
gradient leaf, ``cxr/*`` included, ≤1e-4 relative to the leaf's largest
magnitude floored at 1e-3 of the largest gradient of any leaf. The update:
the port's real optimizer step against optax's ``make_optimizer`` given the
same gradients and weights, ≤1e-6 relative (1e-7 absolute near zero), as
``tests/test_torch_optim.py`` holds it, with ``cxr/*`` in the backbone
group.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_edema_prediction_tpu.config import (
    DuettConfig as JDuett, OptimConfig as JOptim, PerceiverConfig as JPerc,
    TeacherConfig as JTeacher, TrainConfig as JTrain, ViTConfig as JViT)
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.train import engine as jengine
from multimodal_edema_prediction_tpu.train import optim as JO
from multimodal_edema_prediction_tpu.train.state import TrainState as JState
from multimodal_edema_prediction_tpu_torch.config import (OptimConfig,
                                                          TeacherConfig,
                                                          TrainConfig)
from multimodal_edema_prediction_tpu_torch.convert import (flax_to_state_dict,
                                                           load_flax, to_flax)
from multimodal_edema_prediction_tpu_torch.models import layers
from multimodal_edema_prediction_tpu_torch.models.teacher import TeacherModel
from multimodal_edema_prediction_tpu_torch.train import engine
from multimodal_edema_prediction_tpu_torch.train.optim import MultiGroupAdamW
from multimodal_edema_prediction_tpu_torch.train.state import TrainState
from multimodal_edema_prediction_tpu_torch.train.teacher_loop import \
    teacher_frozen_prefixes
from test_torch_train_step import (B, L, N_IMG, N_STAYS, T, TCFG, V, _Probe,
                                   _jax_probe)
from torch_port_util import init_perturbed

OPTIM = dict(lr=1e-2, backbone_lr_mult=0.2, query_lr_mult=0.5,
             correction_lr_mult=2.0, weight_decay=0.1, warmup_steps=3,
             min_lr_ratio=0.05, grad_clip=0.05)
TOTAL = 9


@pytest.fixture(scope="module")
def setup():
    jcfg = JTeacher(
        duett=JDuett(n_variables=V, n_timesteps=T, d_embedding=8, n_layers=1,
                     d_feedforward=16, d_hidden_mlp_embedding=8,
                     d_hidden_tab_encoder=8),
        vit=JViT(image_size=224, patch_size=14, d_model=128, n_layers=1,
                 n_heads=2, d_feedforward=128, use_flash_attention=False),
        perceiver=JPerc(d_latent=32, n_heads=2, head_hidden=8, dropout=0.0,
                        head_dropout=0.0),
        freeze_cxr=False)
    rng = np.random.default_rng(1)
    pixels = rng.normal(size=(N_IMG, 224, 224, 3)).astype(np.float32)
    grid = np.concatenate([rng.normal(size=(N_STAYS, L, V)),
                           rng.integers(0, 4, size=(N_STAYS, L, V))],
                          -1).astype(np.float32)
    static = rng.normal(size=(N_STAYS, 18)).astype(np.float32)
    rows = np.array([1, 0, 2, 1], np.int32)
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
    # the port's config is the JAX one with the flash gate open
    cfg = TeacherConfig.from_dict(jcfg.to_dict())
    cfg = cfg.replace(vit=cfg.vit.replace(use_flash_attention=True))
    return dict(jcfg=jcfg, jmodel=jmodel, cfg=cfg, params=params,
                stats=stats, grid=grid, static=static, batch=batch)


def _port_step(s, optimizer=None):
    """(metrics, model, flash calls) after one port step; ``optimizer``
    builds the real optimizer for the model (default: a gradient probe)."""
    model = load_flax(TeacherModel(s["cfg"]), s["params"], s["stats"])
    opt = _Probe(model) if optimizer is None else optimizer(model)
    state = TrainState(model, opt)
    step = engine.make_teacher_step(TrainConfig(**TCFG), s["cfg"].duett, T,
                                    np.ones(7, np.float32), None,
                                    torch.float32)
    calls = []

    def counting_flash(*a, **k):
        calls.append(a[0].requires_grad)
        return flash(*a, **k)

    flash = layers.flash_mha
    layers.flash_mha = counting_flash
    try:
        metrics = step(state, torch.from_numpy(s["grid"]),
                       torch.from_numpy(s["static"]),
                       engine.to_device(s["batch"], torch.device("cpu")),
                       torch.Generator().manual_seed(0))
    finally:
        layers.flash_mha = flash
    return metrics, model, calls


def test_unfrozen_step_matches_jax(setup):
    s = setup
    jstep = jengine.make_teacher_step(
        s["jmodel"], JTrain(**TCFG), s["jcfg"].duett, T,
        np.ones(7, np.float32), None, jnp.float32)
    new_state, want = jstep(JState.create(s["params"], s["stats"],
                                          _jax_probe()),
                            jnp.asarray(s["grid"]), jnp.asarray(s["static"]),
                            jax.tree.map(jnp.asarray, s["batch"]),
                            jax.random.key(0))
    jgrads = new_state.opt_state   # the probe's state is the gradient
    got, model, calls = _port_step(s)
    # the ViT's one attention went through flash_mha, with a gradient
    assert calls == [True]
    for k in ("total", "img_total", "ts_total", "fus_total",
              "aux_residual", "main_logit"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    jg = flax_to_state_dict(jax.tree.map(np.asarray, jgrads))
    floor = 1e-3 * max(np.abs(g.numpy()).max() for g in jg.values())
    named = dict(model.named_parameters())
    n_cxr = 0
    for name, g in jg.items():
        g = g.numpy()
        p = named[name]
        assert p.grad is not None, name
        scale = max(np.abs(g).max(), floor)
        np.testing.assert_allclose(p.grad.numpy() / scale, g / scale,
                                   atol=1e-4, err_msg=name)
        n_cxr += name.startswith("cxr.")
    assert n_cxr == sum(n.startswith("cxr.") for n in named) > 0
    # the trainable ViT receives real gradients (not only rounding noise)
    assert max(named[n].grad.abs().max().item() for n in named
               if n.startswith("cxr.block_0.attn.q")) > 10 * floor


def test_unfrozen_update_matches_optax(setup):
    """The port's real optimizer step on the unfrozen model against optax's
    update from the same weights and the port step's gradients."""
    s = setup
    frozen = teacher_frozen_prefixes(s["cfg"])
    assert frozen == ()
    opts = []

    def make_opt(model):
        opts.append(MultiGroupAdamW(model, OptimConfig(**OPTIM), TOTAL,
                                    frozen_prefixes=frozen))
        return opts[-1]

    before = load_flax(TeacherModel(s["cfg"]), s["params"], s["stats"])
    _, model, _ = _port_step(s, make_opt)
    opt = opts[0]
    # cxr/* leaves train, in the backbone group
    backbone = {id(p) for p in opt.params[opt.labels.index("backbone")]}
    cxr = [p for n, p in model.named_parameters() if n.startswith("cxr.")]
    assert cxr and all(id(p) in backbone and p.requires_grad for p in cxr)

    grads = copy.deepcopy(before)
    with torch.no_grad():
        for (n, g), (_, p) in zip(grads.named_parameters(),
                                  model.named_parameters()):
            g.copy_(p.grad)
    jparams = jax.tree.map(jnp.asarray, to_flax(before)[0])
    tx = JO.make_optimizer(JOptim(**OPTIM), TOTAL, frozen_prefixes=frozen)
    updates, _ = tx.update(jax.tree.map(jnp.asarray, to_flax(grads)[0]),
                           tx.init(jparams), jparams)
    want = flax_to_state_dict(jax.tree.map(
        np.asarray, optax.apply_updates(jparams, updates)))
    moved = 0
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        moved += k.startswith("cxr.") and not torch.equal(
            p.detach(), dict(before.named_parameters())[k].detach())
    assert moved == len(cxr)
