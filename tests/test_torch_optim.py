"""The port's multi-group AdamW (``train/optim.py``) against the JAX
package's ``make_optimizer`` (optax).

Both optimizers get the same parameters and the same sequence of gradients
for 7 steps, crossing warmup (3 steps) into the cosine phase, with a frozen
prefix and ``grad_clip > 0`` (so that some groups are clipped and others
are not). Tolerance: ≤1e-6 relative on every parameter after every step,
1e-7 absolute for values near zero (the same float32 arithmetic; the
schedule, norms and the compiled XLA loop round in other places). The third
test pins
each port parameter's group to the group of its flax path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.config import OptimConfig as JOptim
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.train import optim as JO
from multimodal_edema_prediction_tpu.train.teacher_loop import (
    init_teacher, teacher_frozen_prefixes)
from multimodal_edema_prediction_tpu_torch.config import (OptimConfig,
                                                          TeacherConfig)
from multimodal_edema_prediction_tpu_torch.convert import (
    flax_paths, flax_to_state_dict, load_flax)
from multimodal_edema_prediction_tpu_torch.models.teacher import TeacherModel
from multimodal_edema_prediction_tpu_torch.train import optim as PO
from torch_port_util import perturb, tiny_teacher_cfg

STEPS, TOTAL = 7, 9


@pytest.fixture(scope="module")
def teacher():
    cfg = tiny_teacher_cfg()
    v = init_teacher(JT(cfg), cfg, 2, cfg.duett.n_timesteps,
                     jax.random.key(0))
    return cfg, perturb(v["params"]), perturb(v["batch_stats"], 1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_schedule_matches_optax():
    """Within 1e-6 of the group's base lr: optax evaluates the schedule in
    float32, whose rounding at that magnitude (e.g. 1.000008e-7 for a warmup
    start of 1e-7 at base 1e-3) the port's float64 does not repeat."""
    for mult, ratio in ((1.0, 0.01), (0.2, 0.05), (0.004, 0.01)):
        alpha = min(ratio / mult, 1.0)
        base = 1e-3 * mult
        want = JO.warmup_cosine(base, 3, TOTAL, alpha)
        got = PO.warmup_cosine(base, 3, TOTAL, alpha)
        for s in range(TOTAL + 3):
            np.testing.assert_allclose(got(s), float(want(s)), rtol=0,
                                       atol=1e-6 * base)


def test_updates_match_optax(teacher):
    cfg, params, stats = teacher
    ocfg = dict(lr=1e-2, backbone_lr_mult=0.2, query_lr_mult=0.5,
                correction_lr_mult=2.0, weight_decay=0.1, warmup_steps=3,
                min_lr_ratio=0.05, grad_clip=0.05)
    frozen = teacher_frozen_prefixes(cfg)
    assert frozen == ("cxr/",)
    tx = JO.make_optimizer(JOptim(**ocfg), TOTAL, frozen_prefixes=frozen)
    model = load_flax(TeacherModel(TeacherConfig.from_dict(cfg.to_dict())),
                      params, stats)
    opt = PO.MultiGroupAdamW(model, OptimConfig(**ocfg), TOTAL,
                             frozen_prefixes=frozen)
    assert sorted(opt.labels) == ["backbone", "correction", "queries",
                                  "rest"]
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    named = dict(model.named_parameters())
    rng = np.random.default_rng(7)
    for step in range(STEPS):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.01)
                             .astype(np.float32), params)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        opt.zero_grad()
        for k, g in flax_to_state_dict(grads).items():
            if k in named and named[k].requires_grad:
                named[k].grad = g.clone()
        opt.step(step)
        want = flax_to_state_dict(jax.tree.map(np.asarray, jparams))
        for k, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} after step {step}")
    # the frozen ViT neither moved nor decayed, and needs no gradient
    for k, p in named.items():
        if k.startswith("cxr."):
            assert not p.requires_grad
            assert torch.equal(p.detach(), flax_to_state_dict(params)[k])


def test_groups_follow_flax_paths(teacher):
    cfg, params, stats = teacher
    model = TeacherModel(TeacherConfig.from_dict(cfg.to_dict()))
    paths = flax_paths(model)
    port = {path: PO.default_label_fn(path)
            for name, (kind, path) in paths.items() if kind == "params"}
    jax_paths = _flat(params)
    assert sorted(port) == sorted(jax_paths)
    assert port == {p: JO.default_label_fn(p) for p in jax_paths}
    assert {"backbone", "queries", "correction", "rest"} == set(
        port.values())
