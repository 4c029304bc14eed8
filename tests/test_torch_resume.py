"""Full-state resume and graceful preemption in the port (the teacher loop's
``auto_resume`` / ``save_full_state`` / ``stop_after_epochs``,
``utils/preemption.py``, the preemption check of the teacher, SSL and KD
loops, and the three training CLIs' ``--resume_dir`` and SIGTERM).

A paused or preempted run, resumed, equals the uninterrupted one bit for
bit on the CPU: the per-epoch history, the best checkpoint, the final
train state (weights, AdamW moments, step count). The runs keep dropout and
augmentation on, so the step generator's saved state is what makes them
equal. Signals are sent deterministically, from a step (``os.kill`` of the
process itself, or ``preemption.request()``), never from a timer.
"""
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_edema_prediction_tpu.train import checkpoint as jax_ckpt
from multimodal_edema_prediction_tpu.train.loops import \
    EarlyStopper as JStopper
from multimodal_edema_prediction_tpu.train.state import TrainState as JState
from multimodal_edema_prediction_tpu_torch.cli import train_ssl as ssl_cli
from multimodal_edema_prediction_tpu_torch.cli import train_student as kd_cli
from multimodal_edema_prediction_tpu_torch.cli import \
    train_teacher as teacher_cli
from multimodal_edema_prediction_tpu_torch.config import (DataConfig,
                                                          DuettConfig,
                                                          StudentConfig,
                                                          TeacherConfig,
                                                          TrainConfig)
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.data.sliding import \
    build_sliding_ssl_dataset
from multimodal_edema_prediction_tpu_torch.models.teacher import init_teacher
from multimodal_edema_prediction_tpu_torch.train import engine
from multimodal_edema_prediction_tpu_torch.train import kd_loop as K
from multimodal_edema_prediction_tpu_torch.train import ssl_loop as SSL
from multimodal_edema_prediction_tpu_torch.train import teacher_loop as L
from multimodal_edema_prediction_tpu_torch.train.checkpoint import (
    FullStateResumer, load_checkpoint, save_checkpoint)
from multimodal_edema_prediction_tpu_torch.utils import preemption

LABELS = DataConfig().pathology_labels
DUETT = dict(n_variables=8, n_timesteps=24, d_static=18, d_embedding=8,
             n_layers=1, d_feedforward=32, d_hidden_mlp_embedding=16,
             d_hidden_tab_encoder=16, aug_noise=0.1, aug_mask=0.1)
TCFG = TeacherConfig.from_dict({
    "duett": DUETT, "vit": dict(image_size=56, patch_size=14, d_model=32,
                                n_layers=1, n_heads=2, d_feedforward=64),
    "perceiver": dict(d_latent=32, n_heads=2, dropout=0.2, head_dropout=0.2,
                      head_hidden=16)})
TRAIN = dict(batch_size=16, epochs=3, limit_batches=2, patience=5,
             dtype="float32",
             optim=dict(lr=2e-3, warmup_steps=2, weight_decay=1e-4))
COHORT = dict(seed=0, n_subjects=30, n_stays=60, n_variables=8, min_len=26,
              max_len=40)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These small models gain nothing from intra-op threads, and the suite
    runs several test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    ds = S.make_synthetic(**COHORT)
    return P.build_anchor_dataset(ds, P.meta_from_events(ds, DataConfig()),
                                  DataConfig())


@pytest.fixture
def armed():
    """The preemption handler armed as a CLI arms it; afterwards the
    signal handlers, the flag and the module's state as they were."""
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    installed = preemption._installed
    preemption.install_handler()
    yield
    preemption.clear()
    for s, h in prev.items():
        signal.signal(s, h)
    preemption._installed = installed


def _after_first_step(monkeypatch, module, factory, action):
    """Wrap ``module.<factory>``'s steps: ``action()`` after the first
    step of each call of the loop."""
    make = getattr(module, factory)

    def wrapped(*a, **k):
        step, n = make(*a, **k), [0]

        def run(*args):
            out = step(*args)
            n[0] += 1
            if n[0] == 1:
                action()
            return out
        return run

    monkeypatch.setattr(module, factory, wrapped)


def _sigterm():
    os.kill(os.getpid(), signal.SIGTERM)


def _teacher(ckpt_dir, tier, **kw):
    return L.train_teacher(
        _data(), TCFG, TrainConfig.from_dict(TRAIN), ckpt_dir, LABELS,
        model=init_teacher(TCFG, 0), device="cpu", feature_cache=tier,
        log=lambda s: None, **kw)


def _same_state(dir_a, dir_b):
    """The two directories' final train states are equal bit for bit."""
    a, b = (load_checkpoint(os.path.join(d, "train_state.msgpack"))
            for d in (dir_a, dir_b))
    assert a["step"] == b["step"] and a["epoch"] == b["epoch"]
    for tree in ("params", "batch_stats"):
        flat = jax.tree_util.tree_flatten_with_path(a[tree])[0]
        other = dict(jax.tree_util.tree_flatten_with_path(b[tree])[0])
        assert len(flat) == len(other)
        for path, leaf in flat:
            np.testing.assert_array_equal(other[path], leaf,
                                          err_msg=str(path))
    for k in ("mu", "nu"):
        for x, y in zip(a["opt_state"][k], b["opt_state"][k]):
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def whole(tmp_path_factory):
    """The uninterrupted 3-epoch runs of each tier."""
    root = tmp_path_factory.mktemp("whole")
    return {tier: (_teacher(str(root / tier), tier, save_full_state=True),
                   str(root / tier)) for tier in ("none", "hbm")}


@pytest.mark.parametrize("tier", ["none", "hbm"])
def test_teacher_stop_and_resume_is_bit_equal(whole, tmp_path, tier):
    want, want_dir = whole[tier]
    d = str(tmp_path)
    first = _teacher(d, tier, save_full_state=True, stop_after_epochs=1)
    assert len(first.history) == 1
    second = _teacher(d, tier, auto_resume=True)
    assert second.extras["start_epoch"] == 1
    assert second.extras["n_train_steps"] == 4
    assert second.history == want.history
    assert second.best_metric == want.best_metric
    # (NaN-aware: a label without both classes in the split reads NaN)
    assert json.dumps(second.test_metrics) == json.dumps(want.test_metrics)
    a, b = (load_checkpoint(r.best_path) for r in (want, second))
    for x, y in zip(jax.tree_util.tree_leaves(a["params"]),
                    jax.tree_util.tree_leaves(b["params"])):
        np.testing.assert_array_equal(x, y)
    _same_state(want_dir, d)


def test_teacher_sigterm_saves_at_the_boundary_and_resumes(
        whole, tmp_path, monkeypatch, armed):
    """A SIGTERM during epoch 0's first step: the epoch ends, its state is
    saved (with ``save_full_state`` off), the call returns; a resume runs
    the other two epochs and ends where the uninterrupted run ended."""
    want, want_dir = whole["hbm"]
    _after_first_step(monkeypatch, L.engine, "make_teacher_step", _sigterm)
    d = str(tmp_path)
    first = _teacher(d, "hbm")
    assert preemption.requested()
    assert len(first.history) == 1 and first.extras["state_bytes"] > 0
    assert os.path.exists(os.path.join(d, "train_state.meta.json"))
    preemption.clear()
    monkeypatch.undo()
    second = _teacher(d, "hbm", auto_resume=True)
    assert second.history == want.history
    _same_state(want_dir, d)


def test_resume_refuses_a_jax_state_before_loading(tmp_path):
    """A run directory the JAX package wrote (the same two file names, a
    JAX key and an optax tree) is refused naming that package, and the
    model is left as it was."""
    params = {"w": jnp.ones((3,))}
    state = JState.create(params, {}, optax.adamw(1e-3))
    stopper = JStopper(3, mode="max")
    stopper.update(0.5)
    tracker = jax_ckpt.BestKTracker(str(tmp_path), k=1)
    jax_ckpt.FullStateResumer(str(tmp_path)).save(
        state, 0, stopper, tracker, [], 1, jax.random.key(0))
    with open(tmp_path / "train_state.meta.json") as f:
        assert isinstance(json.load(f)["rng"], list)
    model = init_teacher(TCFG, 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    port_state = engine.TrainState(model, L.MultiGroupAdamW(
        model, TrainConfig().optim, 10))
    with pytest.raises(ValueError, match="multimodal_edema_prediction_tpu"):
        FullStateResumer(str(tmp_path)).restore(port_state)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert port_state.step == 0


def test_ssl_loop_stops_on_preemption(tmp_path, monkeypatch):
    """``preemption.request()`` after the first SSL step: the loop saves
    the state at the boundary and stops; the resume ends as the
    uninterrupted run does."""
    ds = S.make_synthetic(**COHORT)
    meta = P.meta_from_events(ds, DataConfig())
    cfg = DuettConfig(**{**DUETT, "pretrain_masked_steps": 2})
    train = TrainConfig(batch_size=32, epochs=2, limit_batches=2,
                        dtype="float32", seed=0)

    def run(d, **kw):
        return SSL.train_ssl(build_sliding_ssl_dataset(ds, meta, 24, 12, 336),
                             cfg, train, d, warmup_steps=3, device="cpu",
                             log=lambda s: None, **kw)

    want = run(str(tmp_path / "whole"), save_full_state=True)
    _after_first_step(monkeypatch, SSL.engine, "make_ssl_step",
                      preemption.request)
    d = str(tmp_path / "cut")
    try:
        first = run(d)
    finally:
        preemption.clear()
    assert len(first.history) == 1
    monkeypatch.undo()
    second = run(d, auto_resume=True)
    assert second.history == want.history
    _same_state(str(tmp_path / "whole"), d)


@pytest.fixture(scope="module")
def teacher_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("kd_teacher") / "best.msgpack")
    cfg = TCFG.replace(perceiver=TCFG.perceiver.replace(dropout=0.0,
                                                        head_dropout=0.0))
    save_checkpoint(path, init_teacher(cfg, 0), 0, 0.5,
                    config={"model": cfg.to_dict(), "train": {},
                            "pathology_labels": list(LABELS)})
    return path


def test_kd_loop_stops_on_preemption(teacher_ckpt, tmp_path, monkeypatch):
    scfg = StudentConfig(duett=DuettConfig(**DUETT), head_hidden=16)
    train = TrainConfig.from_dict({**TRAIN, "epochs": 2})

    def run(d, **kw):
        return K.train_student_kd(
            _data(), scfg, teacher_ckpt, train, d, device="cpu",
            feature_cache="hbm", log=lambda s: None, **kw)

    want = run(str(tmp_path / "whole"), save_full_state=True)
    _after_first_step(monkeypatch, K.engine, "make_kd_step",
                      preemption.request)
    d = str(tmp_path / "cut")
    try:
        first = run(d)
    finally:
        preemption.clear()
    assert len(first.history) == 1
    monkeypatch.undo()
    second = run(d, auto_resume=True)
    assert second.history == want.history
    _same_state(str(tmp_path / "whole"), d)


CLI_COMMON = ["--device", "cpu", "--synthetic_stays", "60", "--n_variables",
              "8", "--d_embedding", "8", "--n_duett_layers", "1",
              "--batch_size", "16", "--epochs", "3", "--limit_batches", "2"]


@pytest.mark.parametrize("which", ["teacher", "ssl", "student"])
def test_cli_sigterm_saves_and_exits_cleanly(which, teacher_ckpt, tmp_path,
                                             monkeypatch, armed):
    """Each training CLI arms the handler: a SIGTERM after the first step
    ends the run at the epoch boundary with the state saved and returns
    (exit 0); ``--resume_dir`` then runs the remaining epochs."""
    mod, argv, (module, factory) = {
        "teacher": (teacher_cli, ["--vit_size", "tiny", "--warmup_steps",
                                  "2", "--cxr_feature_cache", "hbm"],
                    (L.engine, "make_teacher_step")),
        "ssl": (ssl_cli, ["--ssl_warmup", "2"], (SSL.engine,
                                                   "make_ssl_step")),
        "student": (kd_cli, ["--teacher_ckpt", teacher_ckpt,
                             "--cxr_feature_cache", "hbm", "--warmup_steps",
                             "2"], (K.engine, "make_kd_step"))}[which]
    _after_first_step(monkeypatch, module, factory, _sigterm)
    root = tmp_path / "runs"
    first = mod.main(CLI_COMMON + argv + ["--no_save_state",
                                          "--ckpt_dir", str(root)])
    assert preemption.requested() and len(first.history) == 1
    (run_dir,) = [root / d for d in os.listdir(root)]
    assert {"train_state.msgpack", "train_state.meta.json"} <= set(
        os.listdir(run_dir))
    preemption.clear()
    monkeypatch.undo()
    second = mod.main(CLI_COMMON + argv + ["--resume_dir", str(run_dir)])
    assert len(second.history) == 3
    assert second.history[0] == first.history[0]
