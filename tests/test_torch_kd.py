"""Student distillation in the port against the JAX package: the KD losses
(``ops/losses.py``), one KD step (``train/engine.py::make_kd_step``), the
2-epoch loop (``train/kd_loop.py::train_student_kd``), its resume and best
checkpoint, and ``cli/train_student.py`` with its refusals.

The teacher is the tiny one of ``tests/test_ssl_and_kd.py:76-81`` with its
dropout off (it runs in eval mode anyway); the student's dropout and the
augmentation are off, and everything runs in float32 on the CPU, where the
port's kernel wrappers take their plain versions as the JAX package's CPU
path takes its references.

Tolerances: ``binary_kl_kd`` and ``student_kd_loss`` values ≤1e-6 and their
d/dz_s ≤1e-5; one KD step's losses and logits ≤1e-5, the student's
gradients ≤1e-4 per leaf (relative to the leaf's largest magnitude floored
at 1e-2 of the largest gradient, as ``chip_smoke.py``'s ``BLOCK_FLOOR``:
a float32 sum carries ~1e-7 of the scale of its terms, so a leaf far below
the largest gradient keeps that noise in both packages; e.g. the time
axis's ScaleNorm gain, -3.2e-4 against a largest gradient of 0.099, reads
4e-8 apart, 1.2e-4 of itself), BatchNorm statistics ≤1e-5, the
parameters after one AdamW update ≤1e-5, the teacher bit-unchanged; the
2-epoch loop's per-epoch ``train_total``/``bce``/``kd`` and val AUROC
within 5e-3 relative (the loop-parity precedent,
``tests/test_student_loop_parity.py``); resume bit-equal; the port's best
checkpoint in JAX's ``StudentModel`` ≤1e-5.
"""
import json
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_edema_prediction_tpu.config import (
    DataConfig as JData, DuettConfig as JDuett, OptimConfig as JOptim,
    PerceiverConfig as JPerc, StudentConfig as JStudent,
    TeacherConfig as JTeacher, TrainConfig as JTrain, ViTConfig as JViT)
from multimodal_edema_prediction_tpu.data import features as JF
from multimodal_edema_prediction_tpu.data import pipeline as JP
from multimodal_edema_prediction_tpu.data import synthetic as JS_
from multimodal_edema_prediction_tpu.models.student import StudentModel as JS
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.ops import losses as JL
from multimodal_edema_prediction_tpu.train import engine as jengine
from multimodal_edema_prediction_tpu.train import kd_loop as JK
from multimodal_edema_prediction_tpu.train import teacher_loop as JTL
from multimodal_edema_prediction_tpu.train.checkpoint import \
    load_checkpoint as jax_load
from multimodal_edema_prediction_tpu.train.checkpoint import \
    save_checkpoint as jax_save
from multimodal_edema_prediction_tpu.train.optim import make_optimizer
from multimodal_edema_prediction_tpu.train.state import TrainState as JState
from multimodal_edema_prediction_tpu_torch.cli import train_ssl as ssl_cli
from multimodal_edema_prediction_tpu_torch.cli import train_student as cli
from multimodal_edema_prediction_tpu_torch.cli import \
    train_teacher as teacher_cli
from multimodal_edema_prediction_tpu_torch.config import (DataConfig,
                                                          StudentConfig,
                                                          TeacherConfig,
                                                          TrainConfig)
from multimodal_edema_prediction_tpu_torch.convert import (flax_to_state_dict,
                                                           load_flax)
from multimodal_edema_prediction_tpu_torch.data import features as F
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.models.student import StudentModel
from multimodal_edema_prediction_tpu_torch.models.teacher import TeacherModel
from multimodal_edema_prediction_tpu_torch.ops import losses as L
from multimodal_edema_prediction_tpu_torch.train import engine
from multimodal_edema_prediction_tpu_torch.train import kd_loop as K
from multimodal_edema_prediction_tpu_torch.train import teacher_loop as TL
from multimodal_edema_prediction_tpu_torch.train.checkpoint import (
    load_checkpoint, load_student_from_ckpt)
from multimodal_edema_prediction_tpu_torch.train.optim import MultiGroupAdamW
from multimodal_edema_prediction_tpu_torch.train.state import TrainState
from torch_port_util import init_perturbed

DUETT = JDuett(n_variables=8, n_timesteps=24, d_static=18, d_embedding=8,
               n_layers=1, d_feedforward=32, d_hidden_mlp_embedding=16,
               d_hidden_tab_encoder=16, pretrain_masked_steps=2)
JTCFG = JTeacher(
    duett=DUETT,
    vit=JViT(image_size=56, patch_size=14, d_model=32, n_layers=1, n_heads=2,
             d_feedforward=64),
    perceiver=JPerc(n_pathologies=7, d_latent=32, n_heads=2, dropout=0.0,
                    head_dropout=0.0, head_hidden=16))
JTCFG_DUAL = JTCFG.replace(perceiver_type="dual")
JSCFG = JStudent(duett=DUETT, head_hidden=32, head_dropout=0.0)
KD = dict(kd_T=3.0, kd_alpha=0.4)
CPU = torch.device("cpu")


# ---- the losses -------------------------------------------------------------
@pytest.mark.parametrize("T", [1.0, 4.0])
def test_binary_kl_kd_matches_jax(T):
    rng = np.random.default_rng(0)
    z_s = rng.normal(scale=3.0, size=64).astype(np.float32)
    z_t = rng.normal(scale=3.0, size=64).astype(np.float32)
    z_t[:4] = [60.0, -60.0, 0.0, 1e-3]        # past the 1e-7 clip, and near 0
    want, jgrad = jax.value_and_grad(
        lambda z: JL.binary_kl_kd(z, jnp.asarray(z_t), T=T))(jnp.asarray(z_s))
    zs = torch.tensor(z_s, requires_grad=True)
    zt = torch.tensor(z_t, requires_grad=True)
    got = L.binary_kl_kd(zs, zt, T=T)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(zs.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-5)
    assert zt.grad is None                     # the teacher is a constant


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_student_kd_loss_matches_jax(alpha):
    rng = np.random.default_rng(1)
    z_s, z_t = (rng.normal(scale=2.0, size=32).astype(np.float32)
                for _ in range(2))
    y = (rng.random(32) < 0.4).astype(np.float32)

    def jtotal(z):
        out = JL.student_kd_loss(z, jnp.asarray(z_t), jnp.asarray(y), 4.0,
                                 alpha)
        return out["total"], out
    (_, want), jgrad = jax.value_and_grad(jtotal, has_aux=True)(
        jnp.asarray(z_s))
    zs = torch.tensor(z_s, requires_grad=True)
    got = L.student_kd_loss(zs, torch.tensor(z_t), torch.tensor(y), 4.0,
                            alpha)
    got["total"].backward()
    for k in ("total", "bce", "kd"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(zs.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-5)


def test_unknown_kd_name_raises_with_the_list():
    with pytest.raises(ValueError, match=r"unknown KD loss.*vanilla_kl"):
        L.resolve_kd_loss("feature_kd")
    with pytest.raises(ValueError, match="unknown KD loss"):
        L.student_kd_loss(torch.zeros(2), torch.zeros(2), torch.zeros(2),
                          kd_name="feature_kd")
    assert set(L.KD_LOSSES) == set(JL.KD_LOSSES)


# ---- one KD step ------------------------------------------------------------
B, T_, N_STAYS, LEN, N_IMG = 6, 24, 7, 32, 4


def _recorder():
    """An optax transformation that keeps the gradients in its state and
    passes them on unchanged."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


@pytest.fixture(scope="module")
def step_setup():
    rng = np.random.default_rng(0)
    S_ = JTCFG.vit.image_size
    pixels = rng.normal(size=(N_IMG, S_, S_, 3)).astype(np.float32)
    V = DUETT.n_variables
    grid = np.concatenate([rng.normal(size=(N_STAYS, LEN, V)),
                           rng.integers(0, 4, size=(N_STAYS, LEN, V))],
                          -1).astype(np.float32)
    static = rng.normal(size=(N_STAYS, 18)).astype(np.float32)
    rows = np.array([2, 0, 3, 1, 2, 0], np.int32)
    batch = {"stay_rows": np.array([0, 3, 5, 6, 3, 1], np.int32),
             "slot_idx": np.array([24, 30, 27, 25, 31, 26], np.int32),
             "image_ids": rows,
             "y": np.array([1, 0, 1, 0, 0, 1], np.float32),
             "y_multi": (rng.random((B, 7)) < 0.5).astype(np.float32),
             "y_multi_mask": np.ones((B, 7), np.float32),
             "bin_ends": np.broadcast_to(np.arange(1, T_ + 1) / 24.0,
                                         (B, T_)).astype(np.float32),
             "pixel_values": pixels[rows]}
    x_in = np.zeros((2, T_, 2 * V + 1), np.float32)
    tparams, tstats = init_perturbed(JT(JTCFG), x_in, static[:2],
                                     batch["bin_ends"][:2], pixels[:2])
    sparams, sstats = init_perturbed(JS(JSCFG), x_in, static[:2],
                                     batch["bin_ends"][:2], seed=3)
    dparams, dstats = init_perturbed(JT(JTCFG_DUAL), x_in, static[:2],
                                     batch["bin_ends"][:2], pixels[:2],
                                     seed=4)
    return dict(pixels=pixels, grid=grid, static=static, batch=batch,
                tparams=tparams, tstats=tstats, sparams=sparams,
                sstats=sstats, dual=dict(tparams=dparams, tstats=dstats))


TRAIN_STEP = dict(dtype="float32", optim=dict(lr=2e-2, warmup_steps=2,
                                              weight_decay=1e-2), **KD)


def _jax_kd_step(s, tier, jtcfg=JTCFG):
    if jtcfg.perceiver_type == "dual":
        s = {**s, **s["dual"]}
    jteacher = JT(jtcfg)
    tx = optax.chain(_recorder(), make_optimizer(
        JOptim(**TRAIN_STEP["optim"]), 10))
    state = JState.create(s["sparams"], s["sstats"], tx)
    fs, src = None, (lambda b: b["pixel_values"])
    if tier == "features":
        fs = JF.CXRFeatureBank.build(
            JF.encode_fn_for_teacher(jteacher, s["tparams"], jnp.float32),
            lambda ids: s["pixels"][np.asarray(ids)], np.arange(N_IMG),
            out_dtype=np.float32).feature_source()
    step = jengine.make_kd_step(
        JS(JSCFG), jteacher,
        JTrain(**{**TRAIN_STEP, "optim": JOptim(**TRAIN_STEP["optim"])}),
        DUETT, T_, jnp.float32, src, feature_source=fs)
    new, out = step(state, s["tparams"], s["tstats"], jnp.asarray(s["grid"]),
                    jnp.asarray(s["static"]),
                    jax.tree.map(jnp.asarray, s["batch"]), jax.random.key(0))
    return jax.tree.map(np.asarray, (out, new.opt_state[0], new.params,
                                     new.batch_stats))


def _port_kd_step(s, tier, jtcfg=JTCFG):
    dual = jtcfg.perceiver_type == "dual"
    if dual:
        s = {**s, **s["dual"]}
    teacher = load_flax(TeacherModel(TeacherConfig.from_dict(
        jtcfg.to_dict())), s["tparams"], s["tstats"]).eval()
    teacher.requires_grad_(False)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    student = load_flax(StudentModel(StudentConfig.from_dict(
        JSCFG.to_dict())), s["sparams"], s["sstats"])
    cfg = TrainConfig.from_dict(TRAIN_STEP)
    state = TrainState(student, MultiGroupAdamW(student, cfg.optim, 10))
    fs = None
    if tier == "features":
        fs = F.CXRFeatureBank.build(
            F.encode_fn_for_teacher(teacher, torch.float32),
            lambda ids: s["pixels"][np.asarray(ids)], np.arange(N_IMG),
            out_dtype=torch.float32).feature_source(cls_only=dual)
    step = engine.make_kd_step(cfg, StudentConfig.from_dict(
        JSCFG.to_dict()).duett, T_, torch.float32,
        image_source=lambda b: b["pixel_values"], feature_source=fs)
    out = step(state, teacher, torch.from_numpy(s["grid"]),
               torch.from_numpy(s["static"]),
               engine.to_device(s["batch"], CPU),
               torch.Generator().manual_seed(0))
    assert state.step == 1
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k
    return out, student


@pytest.mark.parametrize("tier", ["pixels", "features"])
def test_kd_step_matches_jax(step_setup, tier):
    _check_kd_step(step_setup, tier, JTCFG)


@pytest.mark.parametrize("tier", ["pixels", "features"])
def test_kd_step_from_a_dual_teacher_matches_jax(step_setup, tier):
    """The reference distills from a ``dual`` teacher (its CXR head's
    logits as the image branch): the same step, held as the one above; on
    the features tier the teacher reads the CLS bank alone."""
    _check_kd_step(step_setup, tier, JTCFG_DUAL)


def _check_kd_step(step_setup, tier, jtcfg):
    want, jgrads, jparams, jstats = _jax_kd_step(step_setup, tier, jtcfg)
    got, student = _port_kd_step(step_setup, tier, jtcfg)
    for k in ("total", "bce", "kd", "logits"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert float(got["kd"]) > 1e-3            # the teacher's logit matters
    jg = flax_to_state_dict(jgrads)
    floor = 1e-2 * max(np.abs(g.numpy()).max() for g in jg.values())
    named = dict(student.named_parameters())
    assert set(jg) == set(named)
    for name, g in jg.items():
        g = g.numpy()
        scale = max(np.abs(g).max(), floor)
        np.testing.assert_allclose(named[name].grad.numpy() / scale,
                                   g / scale, atol=1e-4, err_msg=name)
    sd = student.state_dict()
    for k, v in flax_to_state_dict(jparams, jstats).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_kd_step_pixel_and_feature_tiers_agree(step_setup):
    """The port's two tiers against each other on the same step: the
    bank's float32 tokens are the in-step ViT's."""
    px, _ = _port_kd_step(step_setup, "pixels")
    ft, _ = _port_kd_step(step_setup, "features")
    for k in ("total", "bce", "kd", "logits"):
        np.testing.assert_allclose(ft[k].numpy(), px[k].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


# ---- the loop ---------------------------------------------------------------
COHORT = dict(seed=0, n_subjects=30, n_stays=60, n_variables=8, min_len=26,
              max_len=40)
TRAIN = dict(batch_size=16, epochs=2, limit_batches=2, patience=3,
             dtype="float32",
             optim=dict(lr=2e-3, warmup_steps=2, weight_decay=1e-4), **KD)


def _jax_train():
    return JTrain(**{**TRAIN, "optim": JOptim(**TRAIN["optim"])})


def _port_data():
    ds = S.make_synthetic(**COHORT)
    return P.build_anchor_dataset(ds, P.meta_from_events(ds, DataConfig()),
                                  DataConfig())


@pytest.fixture(scope="module")
def teacher_ckpt(tmp_path_factory):
    """A teacher checkpoint written by the JAX package (weights from its
    ``init_teacher``, the config sidecar as its teacher loop writes it)."""
    path = str(tmp_path_factory.mktemp("teacher") / "best-step0-0.5.msgpack")
    v = jax.tree.map(np.asarray, JTL.init_teacher(
        JT(JTCFG), JTCFG, 16, 24, jax.random.key(0)))
    jax_save(path, v["params"], v["batch_stats"], 0, 0.5,
             config={"model": JTCFG.to_dict(), "train": _jax_train().to_dict(),
                     "pathology_labels": list(JData().pathology_labels)})
    return path


@pytest.fixture(scope="module")
def student_vars():
    V = DUETT.n_variables
    v = jax.jit(JS(JSCFG).init)(
        {"params": jax.random.key(5)}, np.zeros((2, 24, 2 * V + 1),
                                                np.float32),
        np.zeros((2, 18), np.float32), np.zeros((2, 24), np.float32))
    return jax.tree.map(np.asarray, v)


def _port_student(v):
    return load_flax(StudentModel(StudentConfig.from_dict(JSCFG.to_dict())),
                     v["params"], v["batch_stats"])


def _port_loop(teacher_ckpt, v, ckpt_dir, **kw):
    return K.train_student_kd(
        _port_data(), StudentConfig.from_dict(JSCFG.to_dict()), teacher_ckpt,
        TrainConfig.from_dict(TRAIN), ckpt_dir, model=_port_student(v),
        device="cpu", image_hook=TL.make_synthetic_pixel_hook(56),
        log=lambda s: None, **kw)


@pytest.fixture(scope="module")
def loops(teacher_ckpt, student_vars, tmp_path_factory):
    root = tmp_path_factory.mktemp("kd")
    hook = TL.make_synthetic_pixel_hook(56)
    jds = JS_.make_synthetic(**COHORT)
    jad = JP.build_anchor_dataset(jds, JP.meta_from_events(jds, JData()),
                                  JData())
    jad.batch_hook = hook
    jres = JK.train_student_kd(
        jad, JSCFG, teacher_ckpt, _jax_train(), str(root / "jax"),
        image_source=jengine.default_image_source, feature_cache="hbm",
        init_variables=jax.tree.map(jnp.asarray, student_vars))
    res = _port_loop(teacher_ckpt, student_vars, str(root / "port"),
                     feature_cache="hbm")
    return jres, res


def test_kd_loop_matches_jax_per_epoch(loops):
    jres, res = loops
    assert len(res.history) == len(jres.history) == 2
    for got, want in zip(res.history, jres.history):
        for k in ("train_total", "train_bce", "train_kd", "auroc", "auprc"):
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3,
                                       err_msg=f"epoch {got['epoch']} {k}")
        assert got["n"] == want["n"]
    np.testing.assert_allclose(res.best_metric, jres.best_metric, rtol=5e-3)
    np.testing.assert_allclose(res.test_metrics["auroc"],
                               jres.test_metrics["auroc"], rtol=5e-3)


def test_kd_loop_bookkeeping(loops):
    """Four steps with their per-step losses kept, the bank tier reported,
    the val split once per epoch and the test split once; the best
    checkpoint's config is JAX's layout and its reload evaluates the val
    split as the loop did."""
    _, res = loops
    ex = res.extras
    assert ex["n_train_steps"] == 4 and ex["feature_tier"]["tier"] == "hbm"
    assert all(len(v) == 4 for v in ex["step_losses"].values())
    np.testing.assert_allclose(sum(ex["step_losses"]["total"][:2]) / 2,
                               res.history[0]["train_total"], rtol=1e-12)
    ad = _port_data()
    n_batches = {k: -(-ad.split_size(k) // 16) for k in ("val", "test")}
    assert ex["n_eval_steps"] == 2 * n_batches["val"] + n_batches["test"]
    assert set(ex["phase_seconds"]) == {"feature_build", "train", "eval"}
    ck = load_checkpoint(res.best_path)
    assert set(ck["config"]) == {"model", "train", "teacher_ckpt"}
    model, scfg, _ = load_student_from_ckpt(res.best_path, device="cpu")
    assert scfg.to_dict() == JSCFG.to_dict()
    assert ex["evaluate"](model, "val")["auroc"] == res.best_metric


def test_best_student_checkpoint_loads_in_jax(loops):
    _, res = loops
    ck = jax_load(res.best_path)
    jcfg = JStudent.from_dict(ck["config"]["model"])
    model, _, _ = load_student_from_ckpt(res.best_path, device="cpu")
    rng = np.random.default_rng(2)
    V = DUETT.n_variables
    x_in = np.concatenate([rng.normal(size=(5, 24, V)),
                           rng.integers(0, 4, size=(5, 24, V)),
                           np.zeros((5, 24, 1))], -1).astype(np.float32)
    xs = rng.normal(size=(5, 18)).astype(np.float32)
    t = np.tile(np.arange(1, 25, dtype=np.float32) / 24, (5, 1))
    want = JS(jcfg).apply({"params": ck["params"],
                           "batch_stats": ck["batch_stats"]}, x_in, xs, t)
    got = model(torch.from_numpy(x_in), torch.from_numpy(xs),
                torch.from_numpy(t))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tier", ["none", "host"])
def test_stop_and_resume_is_bit_equal(teacher_ckpt, student_vars, tmp_path,
                                      tier):
    """``stop_after_epochs=1`` then ``auto_resume`` in the same directory:
    the history, the per-step losses of the second epoch, the weights and
    the best checkpoint equal an uninterrupted run's bit for bit."""
    whole = _port_loop(teacher_ckpt, student_vars, str(tmp_path / "a"),
                       save_full_state=True, feature_cache=tier)
    first = _port_loop(teacher_ckpt, student_vars, str(tmp_path / "b"),
                       save_full_state=True, stop_after_epochs=1,
                       feature_cache=tier)
    assert len(first.history) == 1
    second = _port_loop(teacher_ckpt, student_vars, str(tmp_path / "b"),
                        auto_resume=True, feature_cache=tier)
    assert second.history == whole.history
    assert second.extras["step_losses"] == {
        k: v[2:] for k, v in whole.extras["step_losses"].items()}
    assert second.best_metric == whole.best_metric
    assert second.test_metrics == whole.test_metrics
    a, b = (load_checkpoint(r.best_path) for r in (whole, second))
    for want, got in ((a["params"], b["params"]),
                      (a["batch_stats"], b["batch_stats"])):
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        other = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        for path, leaf in flat:
            np.testing.assert_array_equal(other[path], leaf)


@pytest.mark.parametrize("tier", ["none", "host"])
def test_kd_loop_tiers_train_as_hbm(loops, teacher_ckpt, student_vars,
                                    tmp_path, tier):
    """The pixel tier (the ViT in every step) and the host store give the
    bank tier's per-step losses: exactly from the store, within 1e-6 from
    the in-step ViT (float32)."""
    _, hbm = loops
    res = _port_loop(teacher_ckpt, student_vars, str(tmp_path),
                     feature_cache=tier)
    want = hbm.extras["step_losses"]
    for k, got in res.extras["step_losses"].items():
        if tier == "host":
            assert got == want[k], k
        else:
            np.testing.assert_allclose(got, want[k], rtol=1e-6, err_msg=k)


def test_kd_loop_refuses_what_is_not_ported(teacher_ckpt, tmp_path,
                                            monkeypatch):
    cfg = TrainConfig.from_dict(TRAIN)
    scfg = StudentConfig.from_dict(JSCFG.to_dict())
    for run_cfg, backend, match in (
            (cfg.replace(steps_per_call=2), "msgpack", "P10"),
            (cfg, "orbax", "P16")):
        with pytest.raises(NotImplementedError, match=match):
            K.train_student_kd(None, scfg, teacher_ckpt, run_cfg,
                               str(tmp_path), device="cpu",
                               state_backend=backend)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="P18"):
        K.train_student_kd(None, scfg, teacher_ckpt, cfg, str(tmp_path),
                           device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    # every teacher mode distills since P13 was ported (a 'single' one:
    # tests/test_torch_modes_step.py); a sidecar that names another mode
    # than its weights' is refused by the loader, before any work
    single = str(tmp_path / "single.msgpack")
    shutil.copy(teacher_ckpt, single)
    with open(teacher_ckpt + ".config.json") as f:
        sidecar = json.load(f)
    sidecar["model"]["perceiver_type"] = "single"
    with open(single + ".config.json", "w") as f:
        json.dump(sidecar, f)
    with pytest.raises(ValueError, match="do not fit"):
        K.train_student_kd(None, scfg, single, cfg, str(tmp_path),
                           device="cpu")


# ---- the CLI ----------------------------------------------------------------
@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The port's SSL → teacher chain on the CPU at a small DuETT and a
    tiny ViT: the SSL and teacher checkpoints the student needs."""
    root = tmp_path_factory.mktemp("chain")
    common = ["--device", "cpu", "--synthetic_stays", "60", "--n_variables",
              "8", "--d_embedding", "8", "--n_duett_layers", "1",
              "--batch_size", "16", "--epochs", "1", "--limit_batches", "2"]
    ssl = ssl_cli.main(common + ["--ssl_warmup", "2",
                                 "--ckpt_dir", str(root / "ssl")])
    teacher = teacher_cli.main(common + [
        "--vit_size", "tiny", "--warmup_steps", "2", "--cxr_feature_cache",
        "hbm", "--duett_ckpt", ssl.best_path, "--ckpt_dir",
        str(root / "teacher")])
    return ssl.best_path, teacher.best_path, common, root


def test_cli_distills_from_the_chain_on_the_cpu(chain, monkeypatch):
    """``--duett_ckpt`` starts the student's DuETT from the SSL encoder, and
    the student trains from the teacher CLI's checkpoint."""
    ssl_path, teacher_path, common, root = chain
    seen = {}
    transplant = K.transplant_encoder

    def spy(path, model):
        changed = transplant(path, model)
        seen.update({k: v.clone() for k, v in model.duett.state_dict()
                     .items()})
        return changed

    monkeypatch.setattr(K, "transplant_encoder", spy)
    res = cli.main(common + ["--teacher_ckpt", teacher_path,
                             "--duett_ckpt", ssl_path, "--warmup_steps", "2",
                             "--ckpt_dir", str(root / "student")])
    ck = load_checkpoint(ssl_path)
    want = flax_to_state_dict(ck["params"]["encoder"],
                              ck["batch_stats"]["encoder"])
    assert seen.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(seen[k], v.to(seen[k].dtype)), k
    assert np.isfinite(res.history[0]["train_total"])
    assert res.best_path.startswith(str(root / "student"))
    assert load_checkpoint(res.best_path)["config"]["teacher_ckpt"] == \
        teacher_path


@pytest.mark.parametrize("argv,error,match", [
    (["--state_backend", "orbax"], NotImplementedError, "P16"),
    (["--steps_per_call", "2"], NotImplementedError, "P10"),
    (["--kd_name", "feature_kd"], ValueError, "unknown KD loss")])
def test_cli_refuses_what_is_not_ported(argv, error, match, tmp_path):
    with pytest.raises(error, match=match):
        cli.main(["--device", "cpu", "--teacher_ckpt", "x.msgpack",
                  "--ckpt_dir", str(tmp_path)] + argv)
    assert not os.listdir(tmp_path)            # refused before any work


def test_cli_refuses_sigterm_naming_its_item(chain, monkeypatch):
    """SIGTERM during the run no longer raises: the CLI arms the graceful
    handler (``utils/preemption.py``), which turns the signal into the flag
    the loop reads at the epoch boundary, and the run returns normally
    (the loop's save and resume: ``tests/test_torch_resume.py``)."""
    from multimodal_edema_prediction_tpu_torch.utils import preemption
    _, teacher_path, common, root = chain
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    installed = preemption._installed
    seen = []

    def killed(*a, **k):
        os.kill(os.getpid(), signal.SIGTERM)
        seen.append(preemption.requested())
        return K.TrainResult(best_metric=0.5, best_path="x", history=[],
                             test_metrics={}, steps_per_sec=0.0,
                             samples_per_sec=0.0)

    monkeypatch.setattr(cli, "train_student_kd", killed)
    try:
        res = cli.main(common + ["--teacher_ckpt", teacher_path,
                                 "--ckpt_dir", str(root / "killed")])
    finally:
        preemption.clear()
        for s, h in prev.items():
            signal.signal(s, h)
        preemption._installed = installed
    assert seen == [True] and res.best_metric == 0.5


def test_cli_device_default_is_cuda(chain, tmp_path):
    _, teacher_path, _, _ = chain
    assert cli.build_parser().parse_args(
        ["--teacher_ckpt", "x"]).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--teacher_ckpt", teacher_path, "--synthetic_stays", "40",
                  "--ckpt_dir", str(tmp_path)])
