"""Multi-step dispatch in the port (``--steps_per_call K``, ROADMAP P10):
``data/prefetch.py::stack_host_batches`` and ``train/engine.py::scan_steps``
against the JAX package's and against K single steps, and the four loops
that take it.

On the CPU a ``scan_steps`` call is a loop of its K steps (a card replays
one captured CUDA graph instead: ``tests/test_torch_cuda.py``), so K steps
in one call must equal K single steps **bit for bit**: losses, parameters,
BatchNorm statistics, AdamW moments, the step counts (host and device) and
the generator's state. The loops with ``steps_per_call=2`` over 5 batches
an epoch (groups 2, 2, 1: the remainder path) must equal their
``steps_per_call=1`` runs bit for bit as well: the history, the weights
and the saved full state. The port's K = 2 teacher loop is held against
JAX's K = 2 loop at ``tests/test_torch_teacher_loop.py``'s settings and
tolerance (5e-3 relative; JAX's own K = 2 against K = 1 is 1e-4,
``tests/test_scan_step.py:165``).
"""
import copy
import os

import jax
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.config import (
    DataConfig as JData, OptimConfig as JOptim, TeacherConfig as JTeacher,
    TrainConfig as JTrain)
from multimodal_edema_prediction_tpu.data import pipeline as JP
from multimodal_edema_prediction_tpu.data import synthetic as JS
from multimodal_edema_prediction_tpu.data.prefetch import \
    stack_host_batches as jax_stack
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.train import teacher_loop as JL
from multimodal_edema_prediction_tpu_torch.config import (
    DataConfig, DuettConfig, OptimConfig, StudentConfig, TeacherConfig,
    TrainConfig)
from multimodal_edema_prediction_tpu_torch.convert import load_flax
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.data.features import (
    CXRFeatureBank, encode_fn_for_teacher)
from multimodal_edema_prediction_tpu_torch.data.prefetch import \
    stack_host_batches
from multimodal_edema_prediction_tpu_torch.data.sliding import \
    build_sliding_ssl_dataset
from multimodal_edema_prediction_tpu_torch.models.duett import \
    init_pretrain_model
from multimodal_edema_prediction_tpu_torch.models.student import \
    init_student
from multimodal_edema_prediction_tpu_torch.models.teacher import (
    TeacherModel, init_teacher)
from multimodal_edema_prediction_tpu_torch.train import engine
from multimodal_edema_prediction_tpu_torch.train import kd_loop as KL
from multimodal_edema_prediction_tpu_torch.train import loops as LL
from multimodal_edema_prediction_tpu_torch.train import ssl_loop as SL
from multimodal_edema_prediction_tpu_torch.train import teacher_loop as TL
from multimodal_edema_prediction_tpu_torch.train.optim import (
    MultiGroupAdamW, invsqrt_warmup)
from multimodal_edema_prediction_tpu_torch.train.state import TrainState

DUETT = dict(n_variables=8, n_timesteps=24, d_static=18, d_embedding=8,
             n_layers=1, d_feedforward=32, d_hidden_mlp_embedding=16,
             d_hidden_tab_encoder=16)
TCFG = dict(duett=DUETT,
            vit=dict(image_size=56, patch_size=14, d_model=32, n_layers=2,
                     n_heads=2, d_feedforward=64),
            perceiver=dict(n_pathologies=7, d_latent=32, n_heads=2,
                           dropout=0.1, head_hidden=16))
COHORT = dict(seed=0, n_subjects=30, n_stays=60, n_variables=8, min_len=26,
              max_len=40)
# a warm-up of 3 steps and a clip: the schedule's boundary falls inside a
# K-step call
OPTIM = dict(lr=2e-3, warmup_steps=3, weight_decay=1e-4, grad_clip=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These small models gain nothing from intra-op threads, and the suite
    runs several test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cohort():
    ds = S.make_synthetic(**COHORT)
    return P.build_anchor_dataset(ds, P.meta_from_events(ds, DataConfig()),
                                  DataConfig())


def _train_batches(data, batch_size: int, n: int) -> list:
    out = []
    for b in data.iter_batches("train", batch_size, shuffle=True, seed=0,
                               limit=n):
        b.pop("valid")
        out.append(b)
    return out


def test_stack_host_batches_equals_jax():
    """5 batches in groups of 2 → 2, 2, 1 (the remainder last), every field
    stacked on a new leading axis, as JAX's ``data/prefetch.py:73-88``."""
    rng = np.random.default_rng(0)
    batches = [{"a": rng.normal(size=(4, 3)).astype(np.float32),
                "b": rng.integers(0, 9, 4).astype(np.int32)}
               for _ in range(5)]
    got, want = list(stack_host_batches(batches, 2)), \
        list(jax_stack(batches, 2))
    assert [g["a"].shape[0] for g in got] == [2, 2, 1]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert list(stack_host_batches([], 3)) == []


def _teacher_case(tier: str):
    cfg = TeacherConfig.from_dict(TCFG)
    data = _cohort()
    hook = TL.make_synthetic_pixel_hook(cfg.vit.image_size)
    host = [hook(b) for b in _train_batches(data, 8, 5)]
    source = None

    def make():
        model = init_teacher(cfg, 0)
        return model, MultiGroupAdamW(model, TrainConfig(
            optim=OptimConfig(**OPTIM)).optim, 20, frozen_prefixes=("cxr/",))

    if tier == "hbm":
        model, _ = make()
        ids, pixels_for_ids = TL.pixels_for_ids_fn(data, hook)
        bank = CXRFeatureBank.build(
            encode_fn_for_teacher(model, torch.float32), pixels_for_ids, ids)
        host = [bank.host_fn()(b) for b in host]
        source = bank.feature_source()
    step = engine.make_teacher_step(
        TrainConfig(aux_residual_alpha=0.1), cfg.duett, 24,
        np.ones(7, np.float32), None, torch.float32, feature_source=source)
    return make, step, lambda m: (data.grid, data.static), host


def _kd_case():
    cfg = TeacherConfig.from_dict(TCFG)
    data = _cohort()
    hook = TL.make_synthetic_pixel_hook(cfg.vit.image_size)
    teacher = init_teacher(cfg, 1).requires_grad_(False)
    scfg = StudentConfig(duett=DuettConfig(**DUETT))

    def make():
        model = init_student(scfg, 0)
        return model, MultiGroupAdamW(model, TrainConfig(
            optim=OptimConfig(**OPTIM)).optim, 20)

    step = engine.make_kd_step(TrainConfig(), scfg.duett, 24, torch.float32)
    return make, step, lambda m: (teacher, data.grid, data.static), \
        [hook(b) for b in _train_batches(data, 8, 5)]


def _supervised_case():
    data = _cohort()
    scfg = StudentConfig(duett=DuettConfig(**DUETT))

    def make():
        model = init_student(scfg, 0)
        return model, MultiGroupAdamW(model, TrainConfig(
            optim=OptimConfig(**OPTIM)).optim, 20)

    step = engine.make_supervised_ts_step(scfg.duett, 24, torch.float32)
    return make, step, lambda m: (data.grid, data.static), \
        _train_batches(data, 8, 5)


def _ssl_case():
    ds = S.make_synthetic(**COHORT)
    data = build_sliding_ssl_dataset(ds, P.meta_from_events(
        ds, DataConfig()), 24, stride=4)
    duett = DuettConfig(**DUETT)

    def make():
        model = init_pretrain_model(duett, 0)
        # the SSL loop's optimizer: inverse-sqrt warm-up behind a clip
        return model, MultiGroupAdamW.one_group(
            model, invsqrt_warmup(1e-3, 3), 0.1, 1.0)

    step = engine.make_ssl_step(duett, 24, torch.float32)
    return make, step, lambda m: (data.grid, data.static), \
        list(data.iter_batches("train", 16, shuffle=True, seed=0, limit=5))


CASES = {"teacher_pixels": lambda: _teacher_case("pixels"),
         "teacher_hbm": lambda: _teacher_case("hbm"),
         "kd": _kd_case, "ssl": _ssl_case, "supervised": _supervised_case}


def _run(make, step, fixed, host, k: int):
    """The host batches through ``step``: one at a time (``k`` 0) or in
    ``scan_steps`` calls of ``k``; → (the per-step scalars, the state, the
    generator)."""
    model, opt = make()
    state = TrainState(model, opt)
    gen = torch.Generator().manual_seed(7)
    scalars = []
    if k == 0:
        for b in host:
            out = step(state, *fixed(model), engine.to_device(b, "cpu"), gen)
            scalars.append({n: v for n, v in out.items() if v.ndim == 0})
    else:
        multi = engine.scan_steps(step, k)
        for b in stack_host_batches(host, k):
            out = multi(state, *fixed(model), engine.to_device(b, "cpu"),
                        gen)
            per = out["per_step"]
            n = next(iter(per.values())).shape[0]
            for i in range(n):
                scalars.append({key: v[i] for key, v in per.items()})
            for key, v in per.items():
                assert torch.equal(out[key], v.sum(0)), key
    return scalars, state, gen


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_steps_equals_single_steps_bit_for_bit(case):
    """5 batches as 5 single steps and as ``scan_steps`` calls of 2 (2, 2
    and the remainder 1): every loss of every step, every parameter and
    buffer, both moments, the host and device step counts and the
    generator's state are equal, bit for bit; the learning rate crosses
    its warm-up inside a call, with the gradients clipped."""
    make, step, fixed, host = CASES[case]()
    want, s1, g1 = _run(make, step, fixed, host, 0)
    got, s2, g2 = _run(make, step, fixed, host, 2)
    assert len(got) == len(want) == 5
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key], b[key]), (i, key)
    sd1, sd2 = s1.model.state_dict(), s2.model.state_dict()
    assert sd1.keys() == sd2.keys()
    for key in sd1:
        assert torch.equal(sd1[key], sd2[key]), key
    for m in ("mu", "nu"):
        for a, b in zip(getattr(s1.optimizer, m), getattr(s2.optimizer, m)):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), m
    assert s1.step == s2.step == 5
    assert int(s1.step_t) == int(s2.step_t) == 5
    assert torch.equal(g1.get_state(), g2.get_state())


def test_scan_steps_keeps_stacked_metrics_and_checks_its_input():
    """A non-scalar metric (``main_logit``) stays stacked [K, B]; a batch
    whose fields disagree on K, or of more than ``k`` steps, raises."""
    make, step, fixed, host = _teacher_case("pixels")
    model, opt = make()
    state = TrainState(model, opt)
    multi = engine.scan_steps(step, 2)
    batch = engine.to_device(next(stack_host_batches(host, 2)), "cpu")
    out = multi(state, *fixed(model), batch, torch.Generator())
    assert out["main_logit"].shape == (2, 8)
    assert "main_logit" not in out["per_step"]
    with pytest.raises(ValueError, match="1..2 steps"):
        multi(state, *fixed(model), {**batch, "y_multi":
                                     batch["y_multi"][:1]},
              torch.Generator())
    triple = engine.to_device(next(stack_host_batches(host, 3)), "cpu")
    with pytest.raises(ValueError, match="1..2 steps"):
        multi(state, *fixed(model), triple, torch.Generator())
    with pytest.raises(ValueError, match="at least 1"):
        engine.scan_steps(step, 0)


def test_optimizer_table_grows_and_equals_the_schedules():
    """The device table of learning rates and bias corrections holds, for
    each count and group, optax's float32 values of the host schedules; it
    grows past its first size (``version`` counts its tensors)."""
    model = init_student(StudentConfig(duett=DuettConfig(**DUETT)), 0)
    opt = MultiGroupAdamW(model, OptimConfig(**OPTIM), 10)
    opt.reserve(1)
    assert opt.scalars.shape == (64, len(opt.labels), 3)
    assert opt.version == 1
    opt.reserve(100)
    assert opt.scalars.shape[0] == 128 and opt.version == 2
    for count in (0, 2, 3, 9, 99):
        for g, schedule in enumerate(opt.schedules):
            n = np.float32(count + 1)
            want = np.array([1 - np.float32(0.9) ** n,
                             1 - np.float32(0.999) ** n,
                             -np.float32(schedule(count))], np.float32)
            np.testing.assert_array_equal(opt.scalars[count, g].numpy(),
                                          want)


# the loops at a tiny size: 5 batches an epoch (limit_batches), 2 epochs
LOOP_TRAIN = dict(batch_size=8, epochs=2, limit_batches=5, patience=3,
                  dtype="float32", optim=OPTIM)


def _state_files(run_dir: str) -> tuple:
    import json
    with open(os.path.join(run_dir, "train_state.msgpack"), "rb") as f:
        state = f.read()
    with open(os.path.join(run_dir, "train_state.meta.json")) as f:
        meta = json.load(f)
    return state, meta["rng"], meta["n_steps"]


def _teacher_loop(k, d, mode="dual_patch", log=None):
    cfg = TeacherConfig.from_dict({**TCFG, "perceiver_type": mode})
    model = init_teacher(cfg, 0)
    res = TL.train_teacher(
        _cohort(), cfg, TrainConfig.from_dict({**LOOP_TRAIN,
                                               "steps_per_call": k}),
        d, DataConfig().pathology_labels, model=model, device="cpu",
        feature_cache="hbm" if mode != "legacy" else "none",
        save_full_state=True, log=log or (lambda s: None))
    return res, model


def _ssl_loop(k, d):
    ds = S.make_synthetic(**COHORT)
    data = build_sliding_ssl_dataset(ds, P.meta_from_events(
        ds, DataConfig()), 24, stride=4)
    model = init_pretrain_model(DuettConfig(**DUETT), 0)
    res = SL.train_ssl(data, DuettConfig(**DUETT), TrainConfig.from_dict(
        {**LOOP_TRAIN, "batch_size": 16, "steps_per_call": k}), d,
        lr=1e-3, warmup_steps=3, model=model, device="cpu",
        save_full_state=True, log=lambda s: None)
    return res, model


@pytest.fixture(scope="module")
def kd_teacher(tmp_path_factory):
    """A tiny teacher checkpoint for the KD loop."""
    d = str(tmp_path_factory.mktemp("kd_teacher"))
    cfg = TeacherConfig.from_dict(TCFG)
    res = TL.train_teacher(
        _cohort(), cfg, TrainConfig.from_dict({**LOOP_TRAIN, "epochs": 1,
                                               "limit_batches": 1}),
        d, DataConfig().pathology_labels, device="cpu",
        feature_cache="hbm", log=lambda s: None)
    return res.best_path


def _kd_loop(k, d, teacher_ckpt):
    scfg = StudentConfig(duett=DuettConfig(**DUETT))
    model = init_student(scfg, 0)
    res = KL.train_student_kd(
        _cohort(), scfg, teacher_ckpt, TrainConfig.from_dict(
            {**LOOP_TRAIN, "steps_per_call": k}), d, model=model,
        device="cpu", feature_cache="hbm", save_full_state=True,
        log=lambda s: None)
    return res, model


def _supervised_loop(k, d):
    scfg = StudentConfig(duett=DuettConfig(**DUETT))
    model = init_student(scfg, 0)
    res = LL.train_supervised_ts(
        _cohort(), scfg, TrainConfig.from_dict(
            {**LOOP_TRAIN, "steps_per_call": k}), d, model=model,
        device="cpu", log=lambda s: None)
    return res, model


@pytest.mark.parametrize("loop", ["teacher", "ssl", "kd", "supervised"])
def test_loop_with_two_steps_per_call_equals_one(loop, tmp_path,
                                                 kd_teacher):
    """Each loop with ``steps_per_call=2`` over 5 batches an epoch (2, 2
    and the remainder 1) against ``steps_per_call=1``: the history, every
    parameter and buffer, and (where the loop saves it) the full state's
    bytes (weights, BatchNorm statistics, AdamW moments, step count), the
    generator's state and the step count, all equal."""
    def run(k):
        d = str(tmp_path / f"k{k}")
        if loop == "teacher":
            return _teacher_loop(k, d)
        if loop == "ssl":
            return _ssl_loop(k, d)
        if loop == "kd":
            return _kd_loop(k, d, kd_teacher)
        return _supervised_loop(k, d)

    (r1, m1), (r2, m2) = run(1), run(2)
    assert len(r1.history) == 2
    assert r2.history == r1.history
    assert r2.extras["n_train_steps"] == r1.extras["n_train_steps"] == 10
    sd1, sd2 = m1.state_dict(), m2.state_dict()
    for key in sd1:
        assert torch.equal(sd1[key], sd2[key]), key
    if loop != "supervised":
        assert _state_files(os.path.dirname(r2.best_path)) == \
            _state_files(os.path.dirname(r1.best_path))


@pytest.mark.parametrize("mode", ["single", "legacy"])
def test_single_and_legacy_fall_back_to_one_step_per_call(mode, tmp_path):
    """JAX wires multi-step dispatch for the dual modes only: ``single``
    and ``legacy`` log its line (``teacher_loop.py:418-420``) and run as
    K = 1, to the same history and weights."""
    lines = []
    r2, m2 = _teacher_loop(2, str(tmp_path / "k2"), mode, lines.append)
    r1, m1 = _teacher_loop(1, str(tmp_path / "k1"), mode)
    assert "steps_per_call=2 is wired for the dual modes only; falling " \
        "back to single-step dispatch" in lines
    assert r2.history == r1.history
    for key, v in m1.state_dict().items():
        assert torch.equal(v, m2.state_dict()[key]), key


@pytest.mark.parametrize("pid", [0, 1])
@pytest.mark.parametrize("loop", ["ssl", "kd"])
def test_process_slices_stack_step_by_step(loop, pid, monkeypatch):
    """A multi-process run's K-stacked batch (``steps_per_call`` 2 over 5
    batches: 2, 2, 1) is the K process slices of its global batches, and
    its ``_global`` labels stay aligned with each of the K steps; the
    loops run it (``tests/test_torch_multihost_2proc.py``)."""
    from multimodal_edema_prediction_tpu_torch.parallel import \
        multihost as mh
    monkeypatch.setattr(mh, "process_count", lambda: 2)
    monkeypatch.setattr(mh, "process_index", lambda: pid)
    ds = S.make_synthetic(**COHORT)
    if loop == "ssl":
        data = build_sliding_ssl_dataset(ds, P.meta_from_events(
            ds, DataConfig()), 24, stride=4)
    else:
        data = P.build_anchor_dataset(ds, P.meta_from_events(
            ds, DataConfig()), DataConfig())

    def batches():
        return data.iter_batches("train", 8, shuffle=True, seed=3, limit=5)

    singles = list(batches())
    groups = list(stack_host_batches(batches(), 2))
    assert [len(g["stay_rows"]) for g in groups] == [2, 2, 1]
    i = 0
    for g in groups:
        for j in range(len(g["stay_rows"])):
            one = singles[i]
            assert len(one["stay_rows"]) == 4      # this rank's half of 8
            for k, v in one.items():
                if k == "_global":
                    for name, labels in v.items():
                        np.testing.assert_array_equal(g[k][name][j], labels)
                else:
                    np.testing.assert_array_equal(g[k][j], v)
            i += 1
    assert i == 5 and set(singles[0]["_global"]) >= {"stay_rows"}


JCFG = JTeacher.from_dict({**TCFG, "perceiver": {
    **TCFG["perceiver"], "dropout": 0.0, "head_dropout": 0.0}})
JTRAIN = dict(batch_size=16, epochs=2, limit_batches=2, patience=3,
              dtype="float32", steps_per_call=2,
              optim=dict(lr=2e-3, warmup_steps=2, weight_decay=1e-4))


def test_teacher_loop_with_two_steps_per_call_matches_jax(tmp_path):
    """The port's teacher loop and JAX's ``train_teacher``, both with
    ``steps_per_call=2`` (2 batches an epoch: one K-step call; one scan
    shape, so that JAX compiles one program), from the same converted weights on the same cohort on the
    encode-once tier (``tests/test_torch_teacher_loop.py``'s settings:
    float32, dropout and augmentation off): the per-epoch losses and val
    AUROCs within 5e-3 relative, that file's tolerance."""
    hook = TL.make_synthetic_pixel_hook(JCFG.vit.image_size)
    jds = JS.make_synthetic(**COHORT)
    jad = JP.build_anchor_dataset(jds, JP.meta_from_events(jds, JData()),
                                  JData())
    variables = jax.tree.map(np.asarray, JL.init_teacher(
        JT(JCFG), JCFG, 16, 24, jax.random.key(0)))
    jres = JL.train_teacher(
        jad, JCFG, JTrain(**{**JTRAIN, "optim": JOptim(**JTRAIN["optim"])}),
        str(tmp_path / "jax"), JData().pathology_labels,
        init_variables=jax.tree.map(jax.numpy.asarray, variables),
        image_source=lambda b: hook(b)["pixel_values"],
        feature_cache="hbm")
    cfg = TeacherConfig.from_dict(JCFG.to_dict())
    model = load_flax(TeacherModel(cfg), variables["params"],
                      variables["batch_stats"])
    res = TL.train_teacher(_cohort(), cfg, TrainConfig.from_dict(JTRAIN),
                           str(tmp_path / "port"),
                           DataConfig().pathology_labels,
                           model=copy.deepcopy(model), device="cpu",
                           image_hook=hook, feature_cache="hbm",
                           log=lambda s: None)
    assert len(res.history) == len(jres.history) == 2
    for got, want in zip(res.history, jres.history):
        for k in ("train_total", "train_img_total", "train_ts_total",
                  "train_fus_total", "val_main_auroc"):
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3,
                                       err_msg=f"epoch {got['epoch']} {k}")


def test_stack_host_batches_stacks_tensor_fields():
    """A hook's tensors (the host store's bf16 tokens, a card decoder's
    pixels) stack as tensors, numpy fields as arrays, nested dicts key by
    key; numpy has no bf16."""
    rng = np.random.default_rng(0)
    batches = [{"cls": torch.from_numpy(rng.normal(size=(2, 3)).astype(
                    np.float32)).to(torch.bfloat16),
                "y": rng.normal(size=2).astype(np.float32),
                "_global": {"y": rng.normal(size=4).astype(np.float32)}}
               for _ in range(5)]
    groups = list(stack_host_batches(batches, 2))
    assert [g["y"].shape[0] for g in groups] == [2, 2, 1]
    for i, g in enumerate(groups):
        assert g["cls"].dtype == torch.bfloat16 and isinstance(g["y"],
                                                               np.ndarray)
        for j in range(g["y"].shape[0]):
            b = batches[2 * i + j]
            assert torch.equal(g["cls"][j], b["cls"])
            np.testing.assert_array_equal(g["y"][j], b["y"])
            np.testing.assert_array_equal(g["_global"]["y"][j],
                                          b["_global"]["y"])
