"""One train step of each other teacher mode in the port against the JAX
package's: ``single`` (``engine.make_teacher_pathology_step``), ``legacy``
(``make_teacher_legacy_step``, with and without its auxiliary CXR head)
and ``dual_patch_event`` (``make_teacher_step``), on pixels and, where the
mode takes it, the encode-once tier; one KD step from a ``single``
teacher; and serving's refusal of the modes without fusion logits.

The geometry is ``tests/test_torch_dual.py``'s (DuETT of 5 variables at
T = 24, a 56² ViT); float32 on the CPU, dropout and augmentation off, the
same perturbed weights and batch on both sides. The ``single`` step takes
stage weights other than ``TrainConfig``'s defaults, so that the loop's
wiring of them shows.

Tolerances (``tests/test_torch_dual.py``'s): losses and logits ≤1e-5;
gradients ≤1e-4 per leaf relative to the leaf's largest magnitude floored
at 1e-3 of the largest gradient; BatchNorm statistics and the parameters
after one AdamW update ≤1e-5. One leaf is held to 1e-3 instead: the time
embedding's first layer (``duett.full_time_embedding.in``), whose
gradient reaches it through a BatchNorm over bin ends that every sample
shares, a difference of near-equal float32 sums (at these weights 2.7e-3
against a largest gradient of 0.25); the JAX package alone moves it by
2.0e-4 of itself between the suite's XLA setting and XLA's default
pipeline (PERF.md, §6), and here the packages read up to 1.6e-4 apart.
"""
# the one leaf float32 cannot pin to 1e-4 (see above)
ILL_CONDITIONED = "duett.full_time_embedding.in."
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_edema_prediction_tpu.config import (
    DuettConfig as JDuett, OptimConfig as JOptim, PerceiverConfig as JPerc,
    StudentConfig as JStudent, TeacherConfig as JTeacher,
    TrainConfig as JTrain, ViTConfig as JViT)
from multimodal_edema_prediction_tpu.data import features as JF
from multimodal_edema_prediction_tpu.models.student import StudentModel as JS
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.ops import losses as JLoss
from multimodal_edema_prediction_tpu.train import engine as jengine
from multimodal_edema_prediction_tpu.train import teacher_loop as JL
from multimodal_edema_prediction_tpu.train.optim import make_optimizer
from multimodal_edema_prediction_tpu.train.state import TrainState as JState
from multimodal_edema_prediction_tpu_torch.config import (StudentConfig,
                                                          TeacherConfig,
                                                          TrainConfig)
from multimodal_edema_prediction_tpu_torch.convert import (flax_to_state_dict,
                                                           load_flax)
from multimodal_edema_prediction_tpu_torch.data import features as F
from multimodal_edema_prediction_tpu_torch.models.student import StudentModel
from multimodal_edema_prediction_tpu_torch.models.teacher import TeacherModel
from multimodal_edema_prediction_tpu_torch.ops import losses as L
from multimodal_edema_prediction_tpu_torch.serve import BatchingPredictor
from multimodal_edema_prediction_tpu_torch.train import engine
from multimodal_edema_prediction_tpu_torch.train import teacher_loop as TL
from multimodal_edema_prediction_tpu_torch.train.optim import MultiGroupAdamW
from multimodal_edema_prediction_tpu_torch.train.state import TrainState
from torch_port_util import init_perturbed, t

B, T, V, N_STAYS, LEN, N_IMG = 4, 24, 5, 6, 30, 3
JCFG = JTeacher(
    duett=JDuett(n_variables=V, n_timesteps=T, d_embedding=8, n_layers=1,
                 d_feedforward=16, d_hidden_mlp_embedding=8,
                 d_hidden_tab_encoder=8),
    vit=JViT(image_size=56, patch_size=14, d_model=32, n_layers=1, n_heads=2,
             d_feedforward=64),
    perceiver=JPerc(n_pathologies=7, d_latent=32, n_heads=2, dropout=0.0,
                    head_dropout=0.0, head_hidden=16, n_latents=4))
STEP = dict(dtype="float32", aux_stage2_alpha=0.7, aux_stage4_alpha=0.3,
            optim=dict(lr=2e-2, warmup_steps=2, weight_decay=1e-2))
LOSS_KEYS = {
    "single": ("total", "stage2_total", "stage4_total", "main_logit"),
    "legacy": ("loss", "main_loss", "aux_loss", "logits"),
    "dual_patch_event": ("total", "img_total", "ts_total", "fus_total",
                         "main_logit")}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These small models gain nothing from intra-op threads, and the suite
    runs several test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recorder():
    """An optax transformation that keeps the gradients in its state and
    passes them on unchanged."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, st, p=None: (u, u))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    pixels = rng.normal(size=(N_IMG, 56, 56, 3)).astype(np.float32)
    grid = np.concatenate([rng.normal(size=(N_STAYS, LEN, V)),
                           rng.integers(0, 4, size=(N_STAYS, LEN, V))],
                          -1).astype(np.float32)
    grid[3, :, V + 2] = 0.0          # stay 3 never observes variable 2
    static = rng.normal(size=(N_STAYS, 18)).astype(np.float32)
    rows = np.array([2, 0, 2, 1], np.int32)
    batch = {"stay_rows": np.array([0, 3, 5, 3], np.int32),
             "slot_idx": np.array([24, 30, 27, 25], np.int32),
             "image_ids": rows,
             "y": np.array([1, 0, 0, 1], np.float32),
             "y_multi": (rng.random((B, 7)) < 0.5).astype(np.float32),
             "y_multi_mask": (rng.random((B, 7)) < 0.8).astype(np.float32),
             "bin_ends": np.broadcast_to(np.arange(1, T + 1) / 24.0,
                                         (B, T)).astype(np.float32),
             "pixel_values": pixels[rows]}
    x_in = np.concatenate([grid[:2, :T], np.zeros((2, T, 1), np.float32)],
                          -1)
    weights = {mode: init_perturbed(JT(JCFG.replace(perceiver_type=mode)),
                                    x_in, static[:2], batch["bin_ends"][:2],
                                    pixels[:2])
               for mode in LOSS_KEYS}
    return dict(pixels=pixels, grid=grid, static=static, batch=batch,
                weights=weights)


def _jax_step(s, mode, tier, aux_alpha):
    jcfg = JCFG.replace(perceiver_type=mode)
    jmodel = JT(jcfg)
    params, stats = s["weights"][mode]
    run = JTrain(**{**STEP, "optim": JOptim(**STEP["optim"])})
    tx = optax.chain(_recorder(), make_optimizer(
        run.optim, 10, frozen_prefixes=JL.teacher_frozen_prefixes(jcfg)))
    state = JState.create(params, stats, tx)
    src = lambda b: b["pixel_values"]    # noqa: E731
    fs = None
    if tier == "features":
        fs = JF.CXRFeatureBank.build(
            JF.encode_fn_for_teacher(jmodel, params, jnp.float32),
            lambda ids: s["pixels"][np.asarray(ids)], np.arange(N_IMG),
            out_dtype=np.float32).feature_source()
    lw = np.ones(7, np.float32)
    if mode == "single":
        step = jengine.make_teacher_pathology_step(
            jmodel, run, jcfg.duett, T, lw, None, jnp.float32,
            alpha_stage2=run.aux_stage2_alpha,
            alpha_stage4=run.aux_stage4_alpha, image_source=src,
            feature_source=fs)
    elif mode == "legacy":
        step = jengine.make_teacher_legacy_step(
            jmodel, run, jcfg.duett, T, jnp.float32, aux_alpha=aux_alpha,
            image_source=src)
    else:
        step = jengine.make_teacher_step(
            jmodel, run, jcfg.duett, T, lw, None, jnp.float32,
            image_source=src, feature_source=fs)
    new, out = step(state, jnp.asarray(s["grid"]), jnp.asarray(s["static"]),
                    jax.tree.map(jnp.asarray, s["batch"]), jax.random.key(0))
    return jax.tree.map(np.asarray, (out, new.opt_state[0], new.params,
                                     new.batch_stats))


def _port_model(s, mode):
    cfg = TeacherConfig.from_dict(JCFG.replace(perceiver_type=mode)
                                  .to_dict())
    return load_flax(TeacherModel(cfg), *s["weights"][mode])


def _port_step(s, mode, tier, aux_alpha):
    model = _port_model(s, mode)
    cfg = TrainConfig.from_dict(STEP)
    state = TrainState(model, MultiGroupAdamW(
        model, cfg.optim, 10,
        frozen_prefixes=TL.teacher_frozen_prefixes(model.cfg)))
    src = lambda b: b["pixel_values"]    # noqa: E731
    fs = None
    if tier == "features":
        fs = F.CXRFeatureBank.build(
            F.encode_fn_for_teacher(model, torch.float32),
            lambda ids: s["pixels"][np.asarray(ids)], np.arange(N_IMG),
            out_dtype=torch.float32).feature_source()
    lw = np.ones(7, np.float32)
    duett = model.cfg.duett
    if mode == "single":
        step = engine.make_teacher_pathology_step(
            cfg, duett, T, lw, None, torch.float32,
            alpha_stage2=cfg.aux_stage2_alpha,
            alpha_stage4=cfg.aux_stage4_alpha, image_source=src,
            feature_source=fs)
    elif mode == "legacy":
        step = engine.make_teacher_legacy_step(
            cfg, duett, T, torch.float32, aux_alpha=aux_alpha,
            image_source=src)
    else:
        step = engine.make_teacher_step(cfg, duett, T, lw, None,
                                        torch.float32, image_source=src,
                                        feature_source=fs)
    out = step(state, torch.from_numpy(s["grid"]),
               torch.from_numpy(s["static"]),
               engine.to_device(s["batch"], CPU),
               torch.Generator().manual_seed(0))
    assert state.step == 1
    return out, model


@pytest.mark.parametrize("mode,tier,aux_alpha", [
    ("single", "pixels", 0.0), ("single", "features", 0.0),
    ("legacy", "pixels", 0.5), ("legacy", "pixels", 0.0),
    ("dual_patch_event", "pixels", 0.0),
    ("dual_patch_event", "features", 0.0)])
def test_mode_step_matches_jax(setup, mode, tier, aux_alpha):
    want, jgrads, jparams, jstats = _jax_step(setup, mode, tier, aux_alpha)
    got, model = _port_step(setup, mode, tier, aux_alpha)
    for k in LOSS_KEYS[mode]:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    if mode == "legacy" and aux_alpha == 0.0:
        assert float(got["aux_loss"]) == 0.0 == float(want["aux_loss"])
    jg = flax_to_state_dict(jgrads)
    floor = 1e-3 * max(np.abs(g.numpy()).max() for g in jg.values())
    named = dict(model.named_parameters())
    assert set(jg) == set(named)
    for name, g in jg.items():
        g = g.numpy()
        p = named[name]
        port = np.zeros_like(g) if p.grad is None else p.grad.numpy()
        scale = max(np.abs(g).max(), floor)
        np.testing.assert_allclose(
            port / scale, g / scale, err_msg=name,
            atol=1e-3 if name.startswith(ILL_CONDITIONED) else 1e-4)
        if name.startswith("cxr."):           # frozen: no gradient at all
            assert p.grad is None and not g.any(), name
    # the BatchNorm statistics the step updated and one AdamW update
    sd = model.state_dict()
    for k, v in flax_to_state_dict(jparams, jstats).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_event_step_reaches_duett_through_the_grid(setup):
    """``dual_patch_event``'s temporal branch reads DuETT's event grid, not
    its tokens: its loss still trains the DuETT encoder."""
    _, model = _port_step(setup, "dual_patch_event", "features", 0.0)
    grads = [p.grad for n, p in model.named_parameters()
             if n.startswith("duett.")]
    assert any(g is not None and g.abs().sum() > 0 for g in grads)


def test_pathology_loss_defaults_are_the_functions_own():
    """``pathology_multilabel_loss``'s own defaults are α₂ 0.5 and α₄ 1.0,
    as in JAX; the step passes ``TrainConfig``'s 1.0 and 0.5."""
    rng = np.random.default_rng(5)
    s2, s4 = (rng.normal(size=(6, 7)).astype(np.float32) for _ in range(2))
    y = (rng.random((6, 7)) < 0.5).astype(np.float32)
    m = (rng.random((6, 7)) < 0.7).astype(np.float32)
    lw = np.linspace(0.5, 1.5, 7).astype(np.float32)
    for kw in ({}, {"alpha_stage2": 1.0, "alpha_stage4": 0.5}):
        want = JLoss.pathology_multilabel_loss(s2, s4, y, m, jnp.asarray(lw),
                                               **kw)
        got = L.pathology_multilabel_loss(t(s2), t(s4), t(y), t(m), t(lw),
                                          **kw)
        for k in ("total", "stage2_total", "stage4_total", "stage2_per",
                  "stage4_per"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    assert TrainConfig().aux_stage2_alpha == 1.0
    assert TrainConfig().aux_stage4_alpha == 0.5


# ---- KD from a single teacher, and serving ----------------------------------
def test_kd_step_from_a_single_teacher_matches_jax(setup):
    """The student distills ``single``'s ``main_logit`` (stage 4's first
    label), on the encode-once tier: losses, logits ≤1e-5, the student
    after one update ≤1e-5, the teacher unchanged."""
    s = setup
    jcfg = JCFG.replace(perceiver_type="single")
    jscfg = JStudent(duett=JCFG.duett, head_hidden=16, head_dropout=0.0)
    run = dict(dtype="float32", kd_T=3.0, kd_alpha=0.4,
               optim=dict(lr=2e-2, warmup_steps=2, weight_decay=1e-2))
    x_in = np.zeros((2, T, 2 * V + 1), np.float32)
    sparams, sstats = init_perturbed(JS(jscfg), x_in, s["static"][:2],
                                     s["batch"]["bin_ends"][:2], seed=3)
    tparams, tstats = s["weights"]["single"]
    jteacher = JT(jcfg)
    jrun = JTrain(**{**run, "optim": JOptim(**run["optim"])})
    fs = JF.CXRFeatureBank.build(
        JF.encode_fn_for_teacher(jteacher, tparams, jnp.float32),
        lambda ids: s["pixels"][np.asarray(ids)], np.arange(N_IMG),
        out_dtype=np.float32).feature_source()
    jstep = jengine.make_kd_step(JS(jscfg), jteacher, jrun, jcfg.duett, T,
                                 jnp.float32, feature_source=fs)
    new, want = jstep(JState.create(sparams, sstats,
                                    make_optimizer(jrun.optim, 10)),
                      tparams, tstats, jnp.asarray(s["grid"]),
                      jnp.asarray(s["static"]),
                      jax.tree.map(jnp.asarray, s["batch"]),
                      jax.random.key(0))

    teacher = _port_model(s, "single").eval()
    teacher.requires_grad_(False)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    scfg = StudentConfig.from_dict(jscfg.to_dict())
    student = load_flax(StudentModel(scfg), sparams, sstats)
    cfg = TrainConfig.from_dict(run)
    state = TrainState(student, MultiGroupAdamW(student, cfg.optim, 10))
    pfs = F.CXRFeatureBank.build(
        F.encode_fn_for_teacher(teacher, torch.float32),
        lambda ids: s["pixels"][np.asarray(ids)], np.arange(N_IMG),
        out_dtype=torch.float32).feature_source()
    got = engine.make_kd_step(cfg, scfg.duett, T, torch.float32,
                              feature_source=pfs)(
        state, teacher, torch.from_numpy(s["grid"]),
        torch.from_numpy(s["static"]), engine.to_device(s["batch"], CPU),
        torch.Generator().manual_seed(0))
    for k in ("total", "bce", "kd", "logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert float(got["kd"]) > 1e-3
    sd = student.state_dict()
    for k, v in flax_to_state_dict(jax.tree.map(np.asarray, new.params),
                                   jax.tree.map(np.asarray,
                                                new.batch_stats)).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("mode", ["single", "legacy", "dual_patch_event"])
def test_serving_takes_only_the_fusion_modes(setup, mode):
    """A ``dual_patch_event`` teacher serves as its eval step reads the
    batch; ``single`` and ``legacy`` have no fusion logits, and their
    batches fail with the JAX predictor's ``RuntimeError``, in the warmup
    as for a request."""
    model = _port_model(setup, mode).eval()
    rng = np.random.default_rng(7)
    req = {"x_ts": setup["grid"][0, :T],
           "static": setup["static"][0],
           "pixel_u8": rng.integers(0, 256, (56, 56, 3), dtype=np.uint8)}
    pred = BatchingPredictor(model, max_batch=2, max_wait_ms=0.0,
                             dtype=torch.float32, device="cpu")
    if mode != "dual_patch_event":
        with pytest.raises(RuntimeError, match="single/legacy"):
            pred.warmup(req)
    pred.start()
    try:
        if mode != "dual_patch_event":
            with pytest.raises(RuntimeError, match="requires a dual_patch"):
                pred.predict(req)
            return
        got = pred.predict(req)
    finally:
        pred.close()
    want = engine.make_teacher_eval_from_windows(model, torch.float32)(
        req["x_ts"][None], req["static"][None],
        {"bin_ends": np.arange(1, T + 1, dtype=np.float32)[None] / 24,
         "pixel_u8": req["pixel_u8"][None]})
    for k in ("fusion_logits", "img_logits", "ts_logits"):
        np.testing.assert_allclose(got[k], want[k][0].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
