"""The port's supervised time-series pieces (ROADMAP P14) against the JAX
package on the CPU, at float32 with dropout and augmentation off:
``StayLabelDataset`` (batches, ``y`` and ``pos_frac`` equal), the
``DuettClassifier`` (both poolings, ``return_representation``, within
1e-5), ``simple_adamw`` against ``optax`` over 7 steps (within 1e-6),
``average_params`` (bit-equal), one ``make_supervised_ts_step`` (loss
within 1e-5, every gradient within 1e-4 of the largest gradient's max
abs, the BatchNorm
statistics and the updated parameters within 1e-5). The loop is
``tests/test_torch_supervised_loop.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_edema_prediction_tpu.config import (
    DataConfig as JData, DuettConfig as JDuett, OptimConfig as JOptim,
    StudentConfig as JStudent)
from multimodal_edema_prediction_tpu.data import pipeline as JP
from multimodal_edema_prediction_tpu.data import sliding as JSL
from multimodal_edema_prediction_tpu.data import synthetic as JS
from multimodal_edema_prediction_tpu.models import duett as jduett
from multimodal_edema_prediction_tpu.models.student import \
    StudentModel as JStudentModel
from multimodal_edema_prediction_tpu.train import checkpoint as JC
from multimodal_edema_prediction_tpu.train import engine as JE
from multimodal_edema_prediction_tpu.train import optim as JO
from multimodal_edema_prediction_tpu.train.state import TrainState as JState
from multimodal_edema_prediction_tpu_torch.config import (
    DataConfig, DuettConfig, OptimConfig, StudentConfig)
from multimodal_edema_prediction_tpu_torch.convert import (
    flax_to_state_dict, load_flax, to_flax)
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import sliding as SL
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.models import duett
from multimodal_edema_prediction_tpu_torch.models.student import StudentModel
from multimodal_edema_prediction_tpu_torch.train import checkpoint as C
from multimodal_edema_prediction_tpu_torch.train import engine as E
from multimodal_edema_prediction_tpu_torch.train import optim as O
from multimodal_edema_prediction_tpu_torch.train.state import TrainState
from torch_port_util import init_perturbed, t

T, V = 24, 6
DUETT = dict(n_variables=V, n_timesteps=T, d_static=18, d_embedding=8,
             n_layers=1, d_feedforward=32, d_hidden_mlp_embedding=16,
             d_hidden_tab_encoder=16)
COHORT = dict(seed=0, n_subjects=40, n_stays=120, n_variables=V, min_len=20,
              max_len=50)


def _stay_datasets():
    jds = JS.make_synthetic(**COHORT)
    jsl = JSL.build_stay_label_dataset(jds, JP.meta_from_events(jds, JData()),
                                       T)
    ds = S.make_synthetic(**COHORT)
    sl = SL.build_stay_label_dataset(ds, P.meta_from_events(ds, DataConfig()),
                                     T)
    return jsl, sl


def test_stay_label_dataset_matches_jax():
    """The first window of each stay (stays shorter than T left out), its
    ``death_adm`` label, the seeded batches and ``pos_frac``, exactly."""
    jsl, sl = _stay_datasets()
    np.testing.assert_array_equal(sl.grid.numpy(), np.asarray(jsl.grid))
    np.testing.assert_array_equal(sl.static.numpy(), np.asarray(jsl.static))
    np.testing.assert_array_equal(sl.labels, jsl.labels)
    assert sl.labels.dtype == np.float32
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(sl.samples[split], jsl.samples[split])
        assert (sl.samples[split][:, 1] == 0).all()
        assert sl.pos_frac(split) == jsl.pos_frac(split)
        for shuffle, seed in ((False, 0), (True, 3)):
            got = list(sl.iter_batches(split, 8, shuffle, seed=seed))
            want = list(jsl.iter_batches(split, 8, shuffle, seed=seed))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert g.keys() == w.keys() and "y" in g
                for k in g:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert 0.0 < sl.pos_frac() < 1.0
    assert len(np.unique(sl.samples["train"][:, 0])) == \
        len(sl.samples["train"])


def _classifier_inputs(B=5, seed=0):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(B, T, V)).astype(np.float32)
    counts = rng.integers(-1, 4, size=(B, T, V)).astype(np.float32)
    mask = (rng.random((B, T, 1)) < 0.2).astype(np.float32)
    x_in = np.concatenate([values, counts, mask], -1)
    x_static = rng.normal(size=(B, 18)).astype(np.float32)
    times = np.broadcast_to((np.arange(1, T + 1) / 24.0).astype(np.float32),
                            (B, T)).copy()
    return x_in, x_static, times


@pytest.mark.parametrize("fusion,d_target", [("rep_token", 1),
                                             ("averaging", 1),
                                             ("rep_token", 3)])
def test_classifier_matches_jax(fusion, d_target):
    x_in, x_static, times = _classifier_inputs()
    jm = jduett.DuettClassifier(JDuett(**DUETT), d_target=d_target,
                                fusion_method=fusion)
    params, stats = init_perturbed(jm, x_in, x_static, times)
    model = load_flax(duett.DuettClassifier(DuettConfig(**DUETT), d_target,
                                            fusion), params, stats)
    want, want_z = jm.apply({"params": params, "batch_stats": stats}, x_in,
                            x_static, times, return_representation=True)
    with torch.no_grad():
        got = model(t(x_in), t(x_static), t(times))
        got2, z = model(t(x_in), t(x_static), t(times),
                        return_representation=True)
    assert got.shape == ((5,) if d_target == 1 else (5, d_target))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), atol=1e-5,
                               rtol=1e-5)
    # the flax tree, both ways
    back_params, back_stats = to_flax(model)
    for tree, ref in ((back_params, params), (back_stats, stats)):
        flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        ref_flat = jax.tree_util.tree_flatten_with_path(ref)[0]
        assert len(flat) == len(ref_flat)
        for path, leaf in ref_flat:
            np.testing.assert_array_equal(flat[path], leaf, err_msg=str(path))


def test_classifier_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="fusion_method"):
        duett.DuettClassifier(DuettConfig(**DUETT), fusion_method="max")
    x_in, x_static, times = _classifier_inputs()
    jm = jduett.DuettClassifier(JDuett(**DUETT))
    params, stats = init_perturbed(jm, x_in, x_static, times)
    params = dict(params)
    params["head"] = {**params["head"], "extra": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="left over"):
        load_flax(duett.DuettClassifier(DuettConfig(**DUETT)), params, stats)
    del params["head"]["extra"]
    del params["head"]["out"]
    with pytest.raises(ValueError, match="missing"):
        load_flax(duett.DuettClassifier(DuettConfig(**DUETT)), params, stats)


class _Two(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(w))
        self.b = torch.nn.Parameter(torch.tensor(b))


@pytest.mark.parametrize("warmup,clip", [(0, 0.0), (3, 0.0), (3, 0.05),
                                         (0, 0.05)])
def test_simple_adamw_matches_optax(warmup, clip):
    """7 updates of ``simple_adamw`` against the JAX package's optax chain
    on the same gradients, within 1e-6: the constant rate or
    warmup/cosine, with and without the global-norm clip."""
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    kw = dict(weight_decay=1e-2, warmup_steps=warmup, total_steps=7,
              min_lr_ratio=0.1, grad_clip=clip)
    tx = JO.simple_adamw(3e-2, **kw)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    model = _Two(params["w"], params["b"])
    opt = O.simple_adamw(model, 3e-2, **kw)
    for step in range(7):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        model.w.grad, model.b.grad = t(grads["w"]), t(grads["b"])
        opt.step(step)
        for k in params:
            np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                       np.asarray(jparams[k]), atol=1e-6,
                                       rtol=1e-6, err_msg=f"{k} step {step}")


def test_average_params_is_bit_equal_to_jax():
    """float64 sums in the trees' order, divided by k: the same bits as
    JAX's, before and after the cast to float32."""
    rng = np.random.default_rng(2)
    trees = [{"a": {"k": rng.normal(size=(5, 3)).astype(np.float32)},
              "b": rng.normal(size=(7,)).astype(np.float32) * 1e3}
             for _ in range(5)]
    got, want = C.average_params(trees), JC.average_params(trees)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        mine = got[path[0].key] if len(path) == 1 else \
            got[path[0].key][path[1].key]
        assert mine.dtype == np.float64 == np.asarray(leaf).dtype
        np.testing.assert_array_equal(mine, np.asarray(leaf))
        np.testing.assert_array_equal(mine.astype(np.float32),
                                      np.asarray(leaf, np.float32))


def _student_cfgs():
    return (StudentConfig(duett=DuettConfig(**DUETT), head_hidden=16,
                          head_dropout=0.0),
            JStudent(duett=JDuett(**DUETT), head_hidden=16,
                     head_dropout=0.0))


def _anchor_datasets():
    jds = JS.make_synthetic(**COHORT)
    jdata = JP.build_anchor_dataset(jds, JP.meta_from_events(jds, JData()),
                                    JData())
    ds = S.make_synthetic(**COHORT)
    data = P.build_anchor_dataset(ds, P.meta_from_events(ds, DataConfig()),
                                  DataConfig())
    return jdata, data


def test_supervised_ts_step_matches_jax():
    """One update of the student on the BCE of ``y``: the loss, every
    gradient (against ``jax.grad`` of the JAX step's own loss), the
    BatchNorm running statistics and the updated parameters."""
    pcfg, jcfg = _student_cfgs()
    jdata, data = _anchor_datasets()
    batch = next(data.iter_batches("train", 16, shuffle=True, seed=0))
    batch.pop("valid")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JStudentModel(jcfg)
    x_in, x_static, times = _classifier_inputs(16)
    params, stats = init_perturbed(jm, x_in, x_static, times)
    ocfg = OptimConfig(lr=1e-2, warmup_steps=2)
    tx = JO.make_optimizer(JOptim(lr=1e-2, warmup_steps=2), 10)
    jstate = JState.create(jax.tree.map(jnp.asarray, params),
                           jax.tree.map(jnp.asarray, stats), tx)
    jstep = JE.make_supervised_ts_step(jm, jcfg.duett, T, jnp.float32)
    new, out = jstep(jstate, jnp.asarray(jdata.grid),
                     jnp.asarray(jdata.static), jbatch, jax.random.key(0))

    def loss_fn(p):
        x_in_, xs_, tm_ = JE._prep_inputs(jdata.grid, jdata.static, jbatch, T,
                                          jnp.float32)
        logits, _ = jm.apply({"params": p, "batch_stats": stats},
                             x_in_, xs_, tm_, train=True,
                             rngs={"dropout": jax.random.key(1)},
                             mutable=["batch_stats"])
        from multimodal_edema_prediction_tpu.ops.losses import \
            bce_with_logits
        return bce_with_logits(logits, jbatch["y"])

    jgrads = flax_to_state_dict(jax.jit(jax.grad(loss_fn))(
        jax.tree.map(jnp.asarray, params)))

    model = load_flax(StudentModel(pcfg), params, stats)
    state = TrainState(model, O.MultiGroupAdamW(model, ocfg, 10))
    step = E.make_supervised_ts_step(pcfg.duett, T, torch.float32)
    got = step(state, data.grid, data.static, E.to_device(batch, "cpu"),
               torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(got["loss"]), float(out["loss"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(out["logits"]), atol=1e-5)
    # every leaf within 1e-4 of the largest gradient's max abs: a float32
    # sum keeps ~1e-7 of its terms' scale, and a leaf whose terms cancel
    # (the time embedding's input weight, 2% of the largest) reads that as
    # ~1e-4 of itself
    top = max(float(g.abs().max()) for g in jgrads.values())
    for name, p in model.named_parameters():
        g, want = p.grad.numpy(), jgrads[name].numpy()
        assert np.abs(g - want).max() <= 1e-4 * top, name
    sd = model.state_dict()
    for name, want in flax_to_state_dict(new.params, new.batch_stats).items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    assert state.step == 1
