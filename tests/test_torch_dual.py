"""The ``dual`` teacher (``models/perceiver.py::DualPathologyPerceiver``,
``models/teacher.py``'s ``dual`` branch, ``train/teacher_loop.py`` with
``pretrained_head_ckpt``) against the JAX package.

The pretrained CXR head here has nine labels, the seven pathology labels
in a permuted order among them, so that the teacher's ``static_keep_idx``
selects and reorders its outputs (as ``tests/test_dual_head_wiring.py``
permutes them). Everything runs in float32 on the CPU with dropout and
augmentation off.

Tolerances: module and teacher outputs ≤1e-5; one train step's losses
≤1e-5, its gradients ≤1e-4 per leaf relative to the leaf's largest
magnitude floored at 1e-3 of the largest gradient (as
``tests/test_torch_train_step.py``); the ViT after one ``--unfreeze_cxr``
step (no gradient reaches it, weight decay alone moves it) ≤1e-6
relative; the frozen head bit-equal; the 2-epoch loop's per-epoch losses
and val AUROC within 5e-3 relative (``tests/test_torch_teacher_loop.py``);
checkpoints read across the packages ≤1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_edema_prediction_tpu.config import (
    DataConfig as JData, DuettConfig as JDuett, OptimConfig as JOptim,
    PerceiverConfig as JPerc, TeacherConfig as JTeacher, TrainConfig as JTrain,
    ViTConfig as JViT)
from multimodal_edema_prediction_tpu.data import features as JF
from multimodal_edema_prediction_tpu.data import pipeline as JP
from multimodal_edema_prediction_tpu.data import synthetic as JS
from multimodal_edema_prediction_tpu.models.perceiver import \
    DualPathologyPerceiver as JDualPerc
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.train import engine as jengine
from multimodal_edema_prediction_tpu.train import kd_loop as JK
from multimodal_edema_prediction_tpu.train import teacher_loop as JL
from multimodal_edema_prediction_tpu.train.checkpoint import \
    load_checkpoint as jax_load
from multimodal_edema_prediction_tpu.train.checkpoint import \
    save_checkpoint as jax_save
from multimodal_edema_prediction_tpu.train.optim import make_optimizer
from multimodal_edema_prediction_tpu.train.state import TrainState as JState
from multimodal_edema_prediction_tpu_torch.config import (
    DataConfig, PerceiverConfig, TeacherConfig, TrainConfig)
from multimodal_edema_prediction_tpu_torch.convert import (flax_paths,
                                                           flax_to_state_dict,
                                                           load_flax, to_flax)
from multimodal_edema_prediction_tpu_torch.data import features as F
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.models.layers import init_like_flax
from multimodal_edema_prediction_tpu_torch.models.perceiver import \
    DualPathologyPerceiver
from multimodal_edema_prediction_tpu_torch.models.teacher import TeacherModel
from multimodal_edema_prediction_tpu_torch.train import engine
from multimodal_edema_prediction_tpu_torch.train import teacher_loop as L
from multimodal_edema_prediction_tpu_torch.train.optim import MultiGroupAdamW
from multimodal_edema_prediction_tpu_torch.train.state import TrainState
from torch_port_util import init_perturbed, t

LABELS = JData().pathology_labels
# the head's labels: two others, then the pathology labels reversed
HEAD_LABELS = ["label_other_a", "label_other_b"] + list(LABELS[::-1])
KEEP = tuple(HEAD_LABELS.index(lab) for lab in LABELS)
B, T, V, N_STAYS, LEN, N_IMG = 4, 24, 5, 6, 30, 3
# the module and step tests take the DuETT of tests/test_torch_train_step.py;
# the loop takes the synthetic cohort's 8 variables with the DuETT of
# tests/test_torch_teacher_loop.py. At the latter, one step's gradient of
# the time embedding's first bias reads 1.6e-4 of itself apart from JAX's:
# the JAX package alone moves it by 2.0e-4 between the suite's XLA setting
# (--xla_backend_optimization_level=0, tests/conftest.py) and XLA's default
# pipeline, against which the port reads 4.6e-5.
JCFG = JTeacher(
    duett=JDuett(n_variables=V, n_timesteps=T, d_embedding=8, n_layers=1,
                 d_feedforward=16, d_hidden_mlp_embedding=8,
                 d_hidden_tab_encoder=8),
    vit=JViT(image_size=56, patch_size=14, d_model=32, n_layers=1, n_heads=2,
             d_feedforward=64),
    perceiver=JPerc(n_pathologies=7, d_latent=32, n_heads=2, dropout=0.0,
                    head_dropout=0.0, head_hidden=16),
    perceiver_type="dual")
JCFG_LOOP = JCFG.replace(duett=JDuett(
    n_variables=8, n_timesteps=T, d_static=18, d_embedding=8, n_layers=1,
    d_feedforward=32, d_hidden_mlp_embedding=16, d_hidden_tab_encoder=16))
KEYS = ("main_logit", "img_logits", "ts_logits", "fusion_logits",
        "ts_correction", "scaled_correction")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These small models gain nothing from intra-op threads, and the suite
    runs several test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmodel(cfg=JCFG):
    return JT(cfg, n_pretrained_labels=len(HEAD_LABELS), static_keep_idx=KEEP)


def _port(cfg, params, stats):
    model = TeacherModel(TeacherConfig.from_dict(cfg.to_dict()),
                         len(HEAD_LABELS), static_keep_idx=KEEP)
    return load_flax(model, params, stats)


# ---- the perceiver and the teacher's forward -------------------------------
@pytest.mark.parametrize("ablation", ["hourly_only", "full", "rep_only"])
def test_dual_perceiver_matches_jax(ablation):
    jcfg = JPerc(n_pathologies=7, d_latent=16, n_heads=2, head_hidden=8,
                 ts_ablation=ablation)
    rng = np.random.default_rng(0)
    ts = rng.normal(size=(3, 9, 12)).astype(np.float32)
    img = rng.normal(size=(3, 7)).astype(np.float32)
    jmod = JDualPerc(jcfg, 12)
    params, _ = init_perturbed(jmod, ts, img)
    want = jmod.apply({"params": params}, ts, img)
    model = load_flax(DualPathologyPerceiver(
        PerceiverConfig.from_dict(jcfg.to_dict()), 12), params)
    got = model(t(ts), t(img))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    # the image logits are a constant of the fusion
    assert not got["img_logits"].requires_grad


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    S_ = JCFG.vit.image_size
    pixels = rng.normal(size=(N_IMG, S_, S_, 3)).astype(np.float32)
    grid = np.concatenate([rng.normal(size=(N_STAYS, LEN, V)),
                           rng.integers(0, 4, size=(N_STAYS, LEN, V))],
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
    x_in = np.concatenate([grid[:2, :T], np.zeros((2, T, 1), np.float32)],
                          -1)
    params, stats = init_perturbed(_jmodel(), x_in, static[:2],
                                   batch["bin_ends"][:2], pixels[:2])
    return dict(pixels=pixels, grid=grid, static=static, batch=batch,
                params=params, stats=stats, x_in=x_in)


def test_dual_teacher_forward_matches_jax(setup):
    s = setup
    px = s["pixels"][:2]
    want = _jmodel().apply({"params": s["params"],
                            "batch_stats": s["stats"]},
                           s["x_in"], s["static"][:2],
                           s["batch"]["bin_ends"][:2], px)
    model = _port(JCFG, s["params"], s["stats"]).eval()
    assert not hasattr(model, "img_proj")
    with torch.no_grad():
        got = model(t(s["x_in"]), t(s["static"][:2]),
                    t(s["batch"]["bin_ends"][:2]), t(px))
        # the encode-once tiers hand a dual teacher the CLS token alone
        cls, _ = model.cxr(t(px))
        cached = model(t(s["x_in"]), t(s["static"][:2]),
                       t(s["batch"]["bin_ends"][:2]), None,
                       cxr_feats=(cls, None))
    assert set(got) == set(KEYS)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(cached[k].numpy(), got[k].numpy())
    # the image branch is the head's logits at keep_idx, in pathology order
    head = s["params"]["pretrained_cxr_head"]["linear"]
    cls_j = np.asarray(cls)
    np.testing.assert_allclose(
        got["img_logits"].numpy(),
        (cls_j @ head["kernel"] + head["bias"])[:, list(KEEP)], rtol=1e-5,
        atol=1e-5)


def test_dual_tree_converts_both_ways(setup):
    """The stacked heads' raw leaves and ``pretrained_cxr_head/linear`` go
    flax → torch → flax unchanged; their flax paths put the head in the
    frozen group and the stacked heads in the default one; ``keep_idx`` is
    no weight; ``init_like_flax`` gives the stacked kernels flax's fan-in."""
    s = setup
    model = _port(JCFG, s["params"], s["stats"])
    params, _ = to_flax(model)
    flat = jax.tree_util.tree_flatten_with_path(s["params"])[0]
    back = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(back) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back[path], leaf, err_msg=str(path))
    paths = flax_paths(model)
    assert paths["perceiver.temporal_heads.w1"] == (
        "params", "perceiver/temporal_heads/w1")
    assert paths["pretrained_cxr_head.linear.weight"] == (
        "params", "pretrained_cxr_head/linear/kernel")
    assert not any("keep" in k for k in model.state_dict())
    fresh = init_like_flax(_port(JCFG, s["params"], s["stats"]), 0)
    w1 = fresh.perceiver.residual_heads.w1        # [K, d, H]: fan-in d
    np.testing.assert_allclose(float(w1.detach().std()), (1 / 32) ** 0.5,
                               rtol=0.1)
    assert not fresh.perceiver.residual_heads.b1.detach().any()


# ---- one train step -----------------------------------------------------------
STEP = dict(dtype="float32", optim=dict(lr=2e-2, warmup_steps=2,
                                        weight_decay=1e-2))


def _recorder():
    """An optax transformation that keeps the gradients in its state and
    passes them on unchanged."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, st, p=None: (u, u))


def _jax_step(s, tier, jcfg=JCFG, run=STEP):
    jmodel = _jmodel(jcfg)
    tx = optax.chain(_recorder(), make_optimizer(
        JOptim(**run["optim"]), 10,
        frozen_prefixes=JL.teacher_frozen_prefixes(jcfg)))
    state = JState.create(s["params"], s["stats"], tx)
    fs = None
    if tier == "features":
        fs = JF.CXRFeatureBank.build(
            JF.encode_fn_for_teacher(jmodel, s["params"], jnp.float32),
            lambda ids: s["pixels"][np.asarray(ids)], np.arange(N_IMG),
            out_dtype=np.float32).feature_source()
    step = jengine.make_teacher_step(
        jmodel, JTrain(**{**run, "optim": JOptim(**run["optim"])}),
        jcfg.duett, T, np.ones(7, np.float32), None, jnp.float32,
        image_source=lambda b: b["pixel_values"], feature_source=fs)
    new, out = step(state, jnp.asarray(s["grid"]), jnp.asarray(s["static"]),
                    jax.tree.map(jnp.asarray, s["batch"]), jax.random.key(0))
    return jax.tree.map(np.asarray, (out, new.opt_state[0], new.params))


def _port_step(s, tier, jcfg=JCFG, run=STEP):
    model = _port(jcfg, s["params"], s["stats"])
    cfg = TrainConfig.from_dict(run)
    tcfg = TeacherConfig.from_dict(jcfg.to_dict())
    state = TrainState(model, MultiGroupAdamW(
        model, cfg.optim, 10,
        frozen_prefixes=L.teacher_frozen_prefixes(tcfg)))
    fs = None
    if tier == "features":
        fs = F.CXRFeatureBank.build(
            F.encode_fn_for_teacher(model, torch.float32),
            lambda ids: s["pixels"][np.asarray(ids)], np.arange(N_IMG),
            out_dtype=torch.float32).feature_source(cls_only=True)
    step = engine.make_teacher_step(
        cfg, tcfg.duett, T, np.ones(7, np.float32), None, torch.float32,
        image_source=lambda b: b["pixel_values"], feature_source=fs)
    out = step(state, torch.from_numpy(s["grid"]),
               torch.from_numpy(s["static"]),
               engine.to_device(s["batch"], torch.device("cpu")),
               torch.Generator().manual_seed(0))
    return out, model


@pytest.mark.parametrize("tier", ["pixels", "features"])
def test_dual_step_matches_jax(setup, tier, monkeypatch):
    calls = []
    gather = F.gather_rows
    monkeypatch.setattr(F, "gather_rows",
                        lambda bank, rows: calls.append(bank.dim())
                        or gather(bank, rows))
    want, jgrads, jparams = _jax_step(setup, tier)
    got, model = _port_step(setup, tier)
    # one gather a step, of the CLS bank alone
    assert calls == ([2] if tier == "features" else [])
    for k in ("total", "img_total", "ts_total", "fus_total", "main_logit"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    jg = flax_to_state_dict(jgrads)
    floor = 1e-3 * max(np.abs(g.numpy()).max() for g in jg.values())
    named = dict(model.named_parameters())
    assert set(jg) == set(named)
    for name, g in jg.items():
        g = g.numpy()
        p = named[name]
        port = np.zeros_like(g) if p.grad is None else p.grad.numpy()
        scale = max(np.abs(g).max(), floor)
        np.testing.assert_allclose(port / scale, g / scale, atol=1e-4,
                                   err_msg=name)
        if name.startswith(("cxr.", "pretrained_cxr_head.")):
            assert p.grad is None and not g.any(), name
    # the frozen head and ViT are bit-equal after the update, on both sides
    head = setup["params"]["pretrained_cxr_head"]["linear"]
    np.testing.assert_array_equal(
        jparams["pretrained_cxr_head"]["linear"]["kernel"], head["kernel"])
    np.testing.assert_array_equal(model.pretrained_cxr_head.linear.weight
                                  .detach().numpy(), head["kernel"].T)
    fresh = _port(JCFG, setup["params"], setup["stats"])
    for k, v in fresh.cxr.state_dict().items():
        assert torch.equal(model.cxr.state_dict()[k], v), k


def test_dual_unfrozen_vit_decays_as_jax(setup):
    """``--unfreeze_cxr`` with ``dual``: the head's logits are detached, so
    no gradient reaches the ViT (JAX: zero gradients), and weight decay
    alone moves it; its weights after one step equal JAX's (a decay of 1
    at a learning rate of 1, whose first warmup step is 2e-5, so that the
    decay shows in float32)."""
    jcfg = JCFG.replace(freeze_cxr=False)
    run = dict(dtype="float32", optim=dict(lr=1.0, warmup_steps=2,
                                           weight_decay=1.0))
    _, jgrads, jparams = _jax_step(setup, "pixels", jcfg, run)
    assert not any(np.asarray(g).any() for g in
                   jax.tree_util.tree_leaves(jgrads["cxr"]))
    _, model = _port_step(setup, "pixels", jcfg, run)
    assert all(p.grad is None for p in model.cxr.parameters())
    want = flax_to_state_dict({"cxr": jparams["cxr"]})
    sd = model.state_dict()
    before = flax_to_state_dict({"cxr": setup["params"]["cxr"]})
    moved = [k for k in want if not torch.equal(sd[k], before[k])]
    assert "cxr.patch_embed.weight" in moved
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_dual_eval_from_windows_matches_jax(setup):
    """The serving step (``make_teacher_eval_from_windows``) of a ``dual``
    teacher, as ``cli/serve.py`` runs it."""
    s = setup
    rng = np.random.default_rng(3)
    x_ts = s["grid"][:3, :T]
    batch = {"bin_ends": s["batch"]["bin_ends"][:3],
             "pixel_u8": rng.integers(0, 256, (3, 56, 56, 3),
                                      dtype=np.uint8)}
    want = jengine.make_teacher_eval_from_windows(_jmodel(), jnp.float32)(
        s["params"], s["stats"], x_ts, s["static"][:3], batch)
    got = engine.make_teacher_eval_from_windows(
        _port(JCFG, s["params"], s["stats"]).eval(), torch.float32)(
        x_ts, s["static"][:3], batch)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


# ---- the loop -------------------------------------------------------------------
TRAIN = dict(batch_size=16, epochs=2, limit_batches=2, patience=3,
             dtype="float32",
             optim=dict(lr=2e-3, warmup_steps=2, weight_decay=1e-4))
COHORT = dict(seed=0, n_subjects=30, n_stays=60, n_variables=8, min_len=26,
              max_len=40)


@pytest.fixture(scope="module")
def head_ckpt(tmp_path_factory):
    """A nine-label head checkpoint written by the JAX package."""
    path = str(tmp_path_factory.mktemp("head") / "cxr_linear_head.msgpack")
    rng = np.random.default_rng(1)
    jax_save(path, {"linear": {
        "kernel": rng.normal(size=(32, 9)).astype(np.float32),
        "bias": rng.normal(size=9).astype(np.float32)}}, {}, 50, 0.6,
        config={"label_cols": HEAD_LABELS, "num_classes": 9,
                "kind": "cxr_linear_head"})
    return path


@pytest.fixture(scope="module")
def loops(head_ckpt, tmp_path_factory):
    root = tmp_path_factory.mktemp("dual_loops")
    hook = L.make_synthetic_pixel_hook(JCFG.vit.image_size)
    jds = JS.make_synthetic(**COHORT)
    jad = JP.build_anchor_dataset(jds, JP.meta_from_events(jds, JData()),
                                  JData())
    variables = jax.tree.map(np.asarray, JL.init_teacher(
        _jmodel(JCFG_LOOP), JCFG_LOOP, 16, 24, jax.random.key(0)))
    jres = JL.train_teacher(
        jad, JCFG_LOOP,
        JTrain(**{**TRAIN, "optim": JOptim(**TRAIN["optim"])}),
        str(root / "jax"), LABELS,
        init_variables=jax.tree.map(jnp.asarray, variables),
        image_source=lambda b: hook(b)["pixel_values"], feature_cache="hbm",
        pretrained_head_ckpt=head_ckpt)

    ds = S.make_synthetic(**COHORT)
    ad = P.build_anchor_dataset(ds, P.meta_from_events(ds, DataConfig()),
                                DataConfig())
    model = _port(JCFG_LOOP, variables["params"], variables["batch_stats"])
    calls = []
    gather = F.gather_rows

    def counted(bank, rows):
        calls.append(bank.dim())
        return gather(bank, rows)

    F.gather_rows = counted
    try:
        res = L.train_teacher(
            ad, TeacherConfig.from_dict(JCFG_LOOP.to_dict()),
            TrainConfig.from_dict(TRAIN), str(root / "port"), LABELS,
            model=model, device="cpu", image_hook=hook, feature_cache="hbm",
            pretrained_head_ckpt=head_ckpt, log=lambda s: None)
    finally:
        F.gather_rows = gather
    return jres, res, calls


def test_dual_loop_matches_jax_per_epoch(loops):
    jres, res, _ = loops
    assert len(res.history) == len(jres.history) == 2
    for got, want in zip(res.history, jres.history):
        for k in ("train_total", "train_img_total", "train_ts_total",
                  "train_fus_total", "val_main_auroc"):
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3,
                                       err_msg=f"epoch {got['epoch']} {k}")
    np.testing.assert_allclose(res.best_metric, jres.best_metric, rtol=5e-3)
    np.testing.assert_allclose(res.test_metrics["main_auroc"],
                               jres.test_metrics["main_auroc"], rtol=5e-3)


def test_dual_loop_gathers_cls_only_and_keeps_the_head(loops, head_ckpt):
    """K2 once a step (train and eval), on the CLS bank; the head is the
    checkpoint's, bit for bit, after training; the sidecar carries its
    width and index, and no β reaches the evaluator."""
    _, res, calls = loops
    ex = res.extras
    assert calls == [2] * (ex["n_train_steps"] + ex["n_eval_steps"])
    model, tcfg, ck = L.load_teacher_from_ckpt(res.best_path, device="cpu")
    assert tcfg.perceiver_type == "dual"
    assert ck["config"]["n_pretrained_labels"] == 9
    assert tuple(ck["config"]["static_keep_idx"]) == KEEP
    assert model.static_keep_idx == KEEP
    head = jax_load(head_ckpt)["params"]["linear"]
    np.testing.assert_array_equal(ck["params"]["pretrained_cxr_head"]
                                  ["linear"]["kernel"], head["kernel"])
    val = ex["evaluate"](model, "val")
    assert all(np.isnan(r["beta"]) for r in val["per_label"])


def test_dual_checkpoints_read_across_packages(loops):
    """Each package's best ``dual`` checkpoint, rebuilt by the other's
    loader (JAX ``kd_loop.load_teacher_from_ckpt``), gives the same
    outputs ≤1e-5."""
    jres, res, _ = loops
    rng = np.random.default_rng(4)
    x_in = np.concatenate([rng.normal(size=(2, T, 8)),
                           rng.integers(0, 4, size=(2, T, 8)),
                           np.zeros((2, T, 1))], -1).astype(np.float32)
    args = (x_in, rng.normal(size=(2, 18)).astype(np.float32),
            np.tile(np.arange(1, T + 1, dtype=np.float32) / 24, (2, 1)),
            rng.normal(size=(2, 56, 56, 3)).astype(np.float32))
    for path in (jres.best_path, res.best_path):
        jmodel, _, params, stats, _ = JK.load_teacher_from_ckpt(path)
        want = jmodel.apply({"params": params, "batch_stats": stats}, *args)
        model, _, _ = L.load_teacher_from_ckpt(path, device="cpu")
        with torch.no_grad():
            got = model(*map(t, args))
        for k in KEYS:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_a_given_model_must_fit_the_head(head_ckpt, tmp_path):
    cfg = TeacherConfig.from_dict(JCFG_LOOP.to_dict())
    with pytest.raises(ValueError, match="does not fit its head"):
        L.train_teacher(None, cfg,
                        TrainConfig(), str(tmp_path), LABELS,
                        model=TeacherModel(cfg), device="cpu",
                        pretrained_head_ckpt=head_ckpt)


def test_dual_checkpoint_serves(loops):
    """The predictor behind ``cli/serve.py`` answers from the loop's
    ``dual`` checkpoint as its eval step does on the same batch (the
    predictor pads each batch to a bucket)."""
    from multimodal_edema_prediction_tpu_torch.serve import BatchingPredictor
    _, res, _ = loops
    model, _, _ = L.load_teacher_from_ckpt(res.best_path, device="cpu")
    rng = np.random.default_rng(5)
    reqs = [{"x_ts": np.concatenate([rng.normal(size=(T, 8)),
                                     rng.integers(0, 4, size=(T, 8))],
                                    -1).astype(np.float32),
             "static": rng.normal(size=18).astype(np.float32),
             "pixel_u8": rng.integers(0, 256, (56, 56, 3), dtype=np.uint8)}
            for _ in range(3)]
    pred = BatchingPredictor(model, max_batch=4, max_wait_ms=0.0,
                             dtype=torch.float32, device="cpu").start()
    try:
        got = [pred.predict(r) for r in reqs]
    finally:
        pred.close()
    want = engine.make_teacher_eval_from_windows(model, torch.float32)(
        np.stack([r["x_ts"] for r in reqs]),
        np.stack([r["static"] for r in reqs]),
        {"bin_ends": np.tile(np.arange(1, T + 1, dtype=np.float32) / 24,
                             (3, 1)),
         "pixel_u8": np.stack([r["pixel_u8"] for r in reqs])})
    for i, g in enumerate(got):
        for k in ("fusion_logits", "img_logits", "ts_logits"):
            np.testing.assert_allclose(g[k], want[k][i].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_cls_only_sources_read_the_cls_token_alone():
    """A ``dual`` teacher's tiers: the bank's CLS-only source gathers the
    CLS rows alone (one K2 call), the host store's CLS-only hook attaches
    no patch rows, and both give the CLS tokens the full sources give."""
    rng = np.random.default_rng(6)
    ids = np.array([90003, 90001, 90007], np.int64)
    cls = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    patches = torch.from_numpy(rng.normal(size=(3, 5, 8)).astype(np.float32))

    row_of = {int(i): k for k, i in enumerate(ids)}

    def encode(px):      # each "image" is its id, as one pixel value
        rows = [row_of[int(v)] for v in np.asarray(px)[:, 0, 0, 0]]
        return cls[rows], patches[rows]

    def pixels_for_ids(batch_ids):
        return np.asarray(batch_ids, np.float32)[:, None, None, None]

    bank = F.CXRFeatureBank.build(encode, pixels_for_ids, ids, chunk=2,
                                  out_dtype=torch.float32)
    store = F.HostFeatureStore.build(encode, pixels_for_ids, ids, chunk=2,
                                     out_dtype=torch.float32)
    batch = {"image_ids": np.array([90007, 90003], np.int32)}
    dev = engine.to_device(bank.host_fn()(batch), torch.device("cpu"))
    full_cls, full_patches = bank.feature_source()(dev)
    only_cls, none = bank.feature_source(cls_only=True)(dev)
    assert none is None and full_patches.shape == (2, 5, 8)
    assert torch.equal(only_cls, full_cls)
    assert torch.equal(full_cls, cls[[2, 0]])
    hooked = store.host_fn(cls_only=True)(batch)
    assert "cxr_patches" not in hooked
    host_cls, host_none = F.features_from_batch(hooked)
    assert host_none is None and torch.equal(host_cls, full_cls)
