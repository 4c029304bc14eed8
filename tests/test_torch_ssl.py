"""The port's DuETT SSL pieces against the JAX package's, at float32 on the
CPU: the masking (``pretrain_prep_batch``), the pretrain model, the loss,
the schedule and one SSL step (``train/engine.py::make_ssl_step``).

The masks are drawn with numpy and handed to both packages
(``mask_idx``/``event_var``, the batch keys ``ssl_mask_idx``/
``ssl_event_var``), with ``pretrain_dropout`` 0: ``jax.random`` and
``torch.Generator`` give different draws, so the port's own draws are
checked by their invariants. Tolerances: the masked batch bit for bit; the
model's outputs ≤1e-5; the loss ≤1e-6; the schedule exactly; one step's
losses ≤1e-5, every gradient leaf ≤1e-4 of its largest magnitude (floored
at 1e-3 of the largest gradient); the update (the loop's optimizer: clip by
the global norm → AdamW with ``invsqrt_warmup``, two updates, the first at
lr 0) against optax's on the same gradients ≤1e-6 relative (1e-7 absolute
near zero), as ``tests/test_torch_unfrozen_step.py`` holds the teacher's.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_edema_prediction_tpu.config import DuettConfig as JDuett
from multimodal_edema_prediction_tpu.models import duett as jduett
from multimodal_edema_prediction_tpu.ops import losses as jlosses
from multimodal_edema_prediction_tpu.train import engine as jengine
from multimodal_edema_prediction_tpu.train.optim import \
    invsqrt_warmup as j_invsqrt
from multimodal_edema_prediction_tpu.train.state import TrainState as JState
from multimodal_edema_prediction_tpu_torch.config import DuettConfig
from multimodal_edema_prediction_tpu_torch.convert import (flax_to_state_dict,
                                                           load_flax, to_flax)
from multimodal_edema_prediction_tpu_torch.models import duett
from multimodal_edema_prediction_tpu_torch.ops import losses
from multimodal_edema_prediction_tpu_torch.train import engine
from multimodal_edema_prediction_tpu_torch.train.optim import (
    MultiGroupAdamW, invsqrt_warmup)
from multimodal_edema_prediction_tpu_torch.train.state import TrainState
from torch_port_util import init_perturbed

B, T, V, S = 6, 24, 5, 2
CFG = dict(n_variables=V, n_timesteps=T, d_embedding=8, n_layers=1,
           d_feedforward=16, d_hidden_mlp_embedding=8,
           d_hidden_tab_encoder=8, pretrain_masked_steps=S,
           pretrain_dropout=0.0, pretrain_n_hidden=2, pretrain_d_hidden=8)


def _windows(seed=0, n=B):
    """Dense windows with integer counts, some −1-free zeros."""
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(n, T, V)).astype(np.float32)
    counts = rng.integers(0, 4, size=(n, T, V)).astype(np.float32)
    return np.concatenate([values * (counts > 0), counts], -1)


def _masks(seed=1, n=B):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, T, size=(n, S)).astype(np.int32),
            rng.integers(0, V, size=(n,)).astype(np.int32))


@pytest.mark.parametrize("predict_events", [True, False])
def test_prep_batch_with_given_masks_is_jax_bit_for_bit(predict_events):
    x = _windows()
    mask_idx, event_var = _masks()
    want = jduett.pretrain_prep_batch(
        jax.random.key(0), jnp.asarray(x), S, 0.0, predict_events,
        mask_idx=mask_idx, event_var=event_var)
    got = duett.pretrain_prep_batch(
        torch.from_numpy(x), S, 0.0, predict_events,
        mask_idx=torch.from_numpy(mask_idx),
        event_var=torch.from_numpy(event_var))
    for name in duett.PretrainBatch._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_prep_batch_draws_keep_their_invariants():
    """The port's own draws: masked steps in range, zeroed and flagged; the
    event variable's counts −1 everywhere; the targets read the unmasked
    window; a variable not observed at a masked step is never dropped, the
    others are dropped at about the dropout rate; a seed gives the same
    batch."""
    n = 400
    x = torch.from_numpy(_windows(seed=3, n=n))
    pb = duett.pretrain_prep_batch(x, S, 0.5, True,
                                   gen=torch.Generator().manual_seed(0))
    again = duett.pretrain_prep_batch(x, S, 0.5, True,
                                      gen=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(pb, again))
    assert pb.mask_idx.min() >= 0 and pb.mask_idx.max() < T
    assert pb.event_var.min() >= 0 and pb.event_var.max() < V
    rows = torch.arange(n)
    mask_col = pb.x_in[..., -1]
    for s in range(S):
        step = pb.mask_idx[:, s]
        assert bool((mask_col[rows, step] == 1.0).all())
        assert not pb.x_in[rows, step, :V].any()
        np.testing.assert_array_equal(pb.y_value[:, s].numpy(),
                                      x[rows, step, :V].numpy())
    assert int(mask_col.sum()) == int(sum(
        len(set(r.tolist())) for r in pb.mask_idx))
    assert bool((pb.x_in[rows, :, V + pb.event_var] == -1.0).all())
    np.testing.assert_array_equal(pb.y_events.numpy(),
                                  x[rows, :, pb.event_var].numpy())
    observed = pb.y_presence_mask.sum(1) > 0                    # [n, V]
    ev = torch.zeros(n, V, dtype=torch.bool)
    ev[rows, pb.event_var] = True
    unmasked = mask_col == 0
    had = (x[..., V:] > 0) & unmasked[..., None]                # [n, T, V]
    kept = ((pb.x_in[..., V:2 * V] != 0) & had).any(1)
    present = had.any(1) & ~ev
    assert bool(kept[~observed & present].all())
    rate = 1.0 - kept[present & observed].float().mean().item()
    assert 0.4 < rate < 0.6


def _models(train_cfg=CFG):
    jcfg = JDuett(**train_cfg)
    jmodel = jduett.DuettPretrainModel(jcfg)
    x = _windows()
    mask_idx, event_var = _masks()
    pb = jduett.pretrain_prep_batch(jax.random.key(0), jnp.asarray(x), S,
                                    0.0, True, mask_idx, event_var)
    static = np.random.default_rng(4).normal(size=(B, 18)).astype(np.float32)
    times = np.broadcast_to(np.arange(1, T + 1) / 24.0, (B, T)).astype(
        np.float32)
    params, stats = init_perturbed(jmodel, pb, static, times)
    model = load_flax(duett.DuettPretrainModel(DuettConfig(**train_cfg)),
                      params, stats)
    return jmodel, params, stats, model, pb, static, times


@pytest.mark.parametrize("train", [False, True])
def test_pretrain_model_matches_jax(train):
    jmodel, params, stats, model, pb, static, times = _models()
    want, mut = jmodel.apply({"params": params, "batch_stats": stats}, pb,
                             static, times, train=train,
                             mutable=["batch_stats"])
    tpb = duett.PretrainBatch(*(torch.from_numpy(np.asarray(a))
                                for a in pb))
    got = model(tpb, torch.from_numpy(static), torch.from_numpy(times),
                train=train)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    sd = model.state_dict()
    for k, v in flax_to_state_dict({}, jax.tree.map(
            np.asarray, mut["batch_stats"])).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_ssl_loss_matches_jax():
    rng = np.random.default_rng(5)
    args = [rng.normal(size=(B, S, V)), rng.normal(size=(B, S, V)),
            rng.normal(size=(B, T)), rng.normal(size=(B, T)),
            rng.normal(size=(B, S, V)),
            (rng.random((B, S, V)) < 0.5), rng.normal(size=(B, T)),
            (rng.random((B, T)) < 0.5)]
    args = [np.asarray(a, np.float32) for a in args]
    for flags in [dict(), dict(pretrain_presence=False),
                  dict(predict_events=False), dict(pretrain_value=False)]:
        want = jlosses.ssl_pretrain_loss(*map(jnp.asarray, args), **flags)
        got = losses.ssl_pretrain_loss(*map(torch.from_numpy, args), **flags)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_invsqrt_schedule_equals_jax():
    for lr, w in [(3e-4, 2000), (1e-3, 7), (5e-4, 1)]:
        j, p = j_invsqrt(lr, w), invsqrt_warmup(lr, w)
        for s in list(range(0, 40)) + [1999, 2000, 2001, 123457]:
            assert p(s) == float(np.asarray(j(jnp.asarray(s, jnp.int32)))), \
                (lr, w, s)
    assert invsqrt_warmup(3e-4, 2000)(0) == 0.0


def _grid_and_batch():
    rng = np.random.default_rng(6)
    n_stays, L = 5, 40
    values = rng.normal(size=(n_stays, L, V))
    counts = rng.integers(0, 4, size=(n_stays, L, V))
    grid = np.concatenate([values * (counts > 0), counts], -1).astype(
        np.float32)
    static = rng.normal(size=(n_stays, 18)).astype(np.float32)
    mask_idx, event_var = _masks(seed=7)
    batch = {"stay_rows": np.array([0, 3, 4, 1, 3, 2], np.int32),
             "slot_idx": np.array([24, 30, 40, 33, 27, 25], np.int32),
             "bin_ends": np.broadcast_to(np.arange(1, T + 1) / 24.0,
                                         (B, T)).astype(np.float32),
             "ssl_mask_idx": mask_idx, "ssl_event_var": event_var}
    return grid, static, batch


class _Probe:
    """Stands in for the optimizer: keeps the gradients."""

    def __init__(self, model):
        self.model = model

    def zero_grad(self):
        self.model.zero_grad(set_to_none=True)

    def step(self, count, count_t=None):
        del count, count_t


def _jax_probe():
    def update(updates, state, params=None):
        return jax.tree.map(jnp.zeros_like, updates), updates
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), update)


LR, WARMUP, WD, CLIP = 1e-4, 1, 0.1, 1.0


def test_ssl_step_matches_jax():
    """One step: losses, every gradient leaf and the BatchNorm statistics;
    then two steps with the SSL optimizer: the parameters' update."""
    jmodel, params, stats, model, _, _, _ = _models()
    grid, static, batch = _grid_and_batch()
    jcfg = JDuett(**CFG)
    jstep = jengine.make_ssl_step(jmodel, jcfg, T, jnp.float32)
    jbatch = jax.tree.map(jnp.asarray, batch)
    new, want = jstep(JState.create(params, stats, _jax_probe()),
                      jnp.asarray(grid), jnp.asarray(static), jbatch,
                      jax.random.key(0))
    step = engine.make_ssl_step(DuettConfig(**CFG), T, torch.float32)
    tbatch = engine.to_device(batch, torch.device("cpu"))
    got = step(TrainState(model, _Probe(model)), torch.from_numpy(grid),
               torch.from_numpy(static), tbatch, torch.Generator())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    jg = flax_to_state_dict(jax.tree.map(np.asarray, new.opt_state))
    floor = 1e-3 * max(np.abs(g.numpy()).max() for g in jg.values())
    named = dict(model.named_parameters())
    assert jg.keys() == named.keys()
    for name, g in jg.items():
        g = g.numpy()
        p = named[name]
        mine = np.zeros_like(g) if p.grad is None else p.grad.numpy()
        scale = max(np.abs(g).max(), floor)
        np.testing.assert_allclose(mine / scale, g / scale, atol=1e-4,
                                   err_msg=name)
    sd = model.state_dict()
    for k, v in flax_to_state_dict({}, jax.tree.map(
            np.asarray, new.batch_stats)).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)

    # the update: the SSL optimizer against optax's chain, from the same
    # weights, applied twice to the step's gradients (the first at lr 0)
    jparams = to_flax(model)[0]
    grads = copy.deepcopy(model)
    with torch.no_grad():
        for (_, g), (_, p) in zip(grads.named_parameters(),
                                  model.named_parameters()):
            g.copy_(p.grad)
    jgrads = jax.tree.map(jnp.asarray, to_flax(grads)[0])
    tx = optax.chain(optax.clip_by_global_norm(CLIP),
                     optax.adamw(j_invsqrt(LR, WARMUP), weight_decay=WD))
    jp = jax.tree.map(jnp.asarray, jparams)
    opt_state = tx.init(jp)
    opt = MultiGroupAdamW.one_group(model, invsqrt_warmup(LR, WARMUP), WD,
                                    CLIP)
    for count in range(2):
        updates, opt_state = tx.update(jgrads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step(count)
    want = flax_to_state_dict(jax.tree.map(np.asarray, jp))
    start = flax_to_state_dict(jparams)
    moved = 0.0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        moved = max(moved, float(np.abs(want[name] - start[name]).max()))
    assert moved > 1e-5                  # the second step did move weights


def test_ssl_eval_total_leaves_out_event_presence():
    """``make_ssl_eval``: the reference's validation total (value, presence
    and event value; not event presence), against the JAX eval."""
    jmodel, params, stats, model, _, _, _ = _models()
    grid, static, batch = _grid_and_batch()
    want = jengine.make_ssl_eval(jmodel, JDuett(**CFG), T, jnp.float32)(
        params, stats, jnp.asarray(grid), jnp.asarray(static),
        jax.tree.map(jnp.asarray, batch), jax.random.key(0))
    got = engine.make_ssl_eval(DuettConfig(**CFG), T, torch.float32)(
        model, torch.from_numpy(grid), torch.from_numpy(static),
        engine.to_device(batch, torch.device("cpu")), torch.Generator())
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(
        got["total"].numpy(),
        (got["value"] + got["presence"] + got["event_value"]).numpy(),
        rtol=1e-6)
    assert float(got["total_all_terms"] - got["total"]) == pytest.approx(
        float(got["event_presence"]), rel=1e-5)
