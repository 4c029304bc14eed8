"""The port's orbax state backend (``train/orbax_io.py``,
``convert.optax_state``) against the JAX package's ``train/orbax_io.py`` and
this host's orbax, in both directions, and the ``orbax`` backend of the
teacher, SSL and KD loops.

- **JAX → port**: the JAX package takes two optimizer steps of each loop's
  optimizer (the teacher's ``make_optimizer`` with a frozen ``cxr/`` prefix
  and ``grad_clip > 0``, SSL's ``chain(clip, adamw(invsqrt_warmup))``, KD's
  ``make_optimizer``; the teacher's and KD's also with ``grad_clip`` 0, the
  CLIs' default) over a tiny model's weights, carried across by
  ``convert``, and saves through its ``save_state``; the port's
  ``restore_state`` loads it, and every weight, BatchNorm statistic, ``mu``,
  ``nu`` and the step equal JAX's leaves bit for bit.
- **Port → JAX**: the port takes two steps and saves; JAX's own
  ``restore_state(make_manager(dir), template)`` restores leaves bit-equal
  to the port's, tensorstore reads every key of the port's store to the
  same bytes, and the port's ``_METADATA`` tree equals the one JAX writes
  for the same state.
- **Loops**: ``state_backend="orbax"`` stopped after epoch 1 and resumed
  (and a SIGTERM run, for the teacher) equals an uninterrupted run and the
  msgpack resume bit for bit: history, final weights, moments and step.
- **Manager**: retention keeps the last ``max_to_keep`` steps; a temporary
  step directory a killed writer left is never the latest, for the port
  and for orbax.
- **Goldens**: ``tests/goldens/orbax_state`` (``scripts/make_orbax_goldens
  .py``) decodes to its ``expected.npz`` and to what the script writes now.
"""
import json
import os
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import tensorstore as ts
import torch

from multimodal_edema_prediction_tpu.config import OptimConfig as JOptim
from multimodal_edema_prediction_tpu.train import checkpoint as jax_ckpt
from multimodal_edema_prediction_tpu.train import optim as JO
from multimodal_edema_prediction_tpu.train import orbax_io as JX
from multimodal_edema_prediction_tpu.train.loops import \
    EarlyStopper as JStopper
from multimodal_edema_prediction_tpu.train.state import TrainState as JState
from multimodal_edema_prediction_tpu_torch.config import (DataConfig,
                                                          DuettConfig,
                                                          OptimConfig,
                                                          StudentConfig,
                                                          TeacherConfig,
                                                          TrainConfig)
from multimodal_edema_prediction_tpu_torch.convert import (flatten_state,
                                                           optax_state,
                                                           to_flax)
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.data.sliding import \
    build_sliding_ssl_dataset
from multimodal_edema_prediction_tpu_torch.models.duett import \
    init_pretrain_model
from multimodal_edema_prediction_tpu_torch.models.student import init_student
from multimodal_edema_prediction_tpu_torch.models.teacher import init_teacher
from multimodal_edema_prediction_tpu_torch.train import kd_loop as K
from multimodal_edema_prediction_tpu_torch.train import optim as PO
from multimodal_edema_prediction_tpu_torch.train import orbax_io as PX
from multimodal_edema_prediction_tpu_torch.train import ssl_loop as SSL
from multimodal_edema_prediction_tpu_torch.train import teacher_loop as L
from multimodal_edema_prediction_tpu_torch.train.checkpoint import (
    FullStateResumer, save_checkpoint)
from multimodal_edema_prediction_tpu_torch.train.state import TrainState
from multimodal_edema_prediction_tpu_torch.utils import preemption

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "orbax_state")
LABELS = DataConfig().pathology_labels
DUETT = dict(n_variables=8, n_timesteps=24, d_static=18, d_embedding=8,
             n_layers=1, d_feedforward=32, d_hidden_mlp_embedding=16,
             d_hidden_tab_encoder=16, aug_noise=0.1, aug_mask=0.1)
TCFG = TeacherConfig.from_dict({
    "duett": DUETT, "vit": dict(image_size=56, patch_size=14, d_model=32,
                                n_layers=1, n_heads=2, d_feedforward=64),
    "perceiver": dict(d_latent=32, n_heads=2, dropout=0.2, head_dropout=0.2,
                      head_hidden=16)})
SCFG = StudentConfig(duett=DuettConfig(**DUETT), head_hidden=16)
OPTIM = dict(lr=1e-2, backbone_lr_mult=0.2, query_lr_mult=0.5,
             correction_lr_mult=2.0, weight_decay=0.1, warmup_steps=2,
             min_lr_ratio=0.05, grad_clip=0.05)
SSL_OPT = dict(lr=3e-3, warmup=3, weight_decay=0.1, grad_clip=1.0)
TRAIN = dict(batch_size=16, epochs=3, limit_batches=2, patience=5,
             dtype="float32",
             optim=dict(lr=2e-3, warmup_steps=2, weight_decay=1e-4))
COHORT = dict(seed=0, n_subjects=30, n_stays=60, n_variables=8, min_len=26,
              max_len=40)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the two packages' states ------------------------------------------------
def _optim(kind) -> dict:
    """``OPTIM``, without its clip for a ``*_noclip`` kind: the teacher and
    student CLIs' default (``grad_clip`` 0), under which each group's
    optax state is a bare ``adamw``'s."""
    return {**OPTIM, "grad_clip": 0.0} if kind.endswith("_noclip") \
        else OPTIM


def _port_state(kind):
    """A fresh port train state of ``kind``'s model and optimizer."""
    optim, kind = _optim(kind), kind.removesuffix("_noclip")
    if kind == "teacher":
        model = init_teacher(TCFG, 0)
        opt = PO.MultiGroupAdamW(model, OptimConfig(**optim), 9,
                                 frozen_prefixes=L.teacher_frozen_prefixes(
                                     TCFG))
    elif kind == "ssl":
        model = init_pretrain_model(DuettConfig(**DUETT), 0)
        opt = PO.MultiGroupAdamW.one_group(
            model, PO.invsqrt_warmup(SSL_OPT["lr"], SSL_OPT["warmup"]),
            SSL_OPT["weight_decay"], SSL_OPT["grad_clip"])
    else:
        model = init_student(SCFG, 0)
        opt = PO.MultiGroupAdamW(model, OptimConfig(**optim), 9)
    return TrainState(model, opt)


def _jax_tx(kind):
    if kind == "ssl":
        return optax.chain(
            optax.clip_by_global_norm(SSL_OPT["grad_clip"]),
            optax.adamw(JO.invsqrt_warmup(SSL_OPT["lr"], SSL_OPT["warmup"]),
                        weight_decay=SSL_OPT["weight_decay"]))
    frozen = ("cxr/",) if kind.startswith("teacher") else ()
    return JO.make_optimizer(JOptim(**_optim(kind)), 9,
                             frozen_prefixes=frozen)


def _jax_state(kind, state):
    """The JAX state over ``state``'s weights (flax layout)."""
    params, stats = to_flax(state.model)
    return JState.create(jax.tree.map(jnp.asarray, params),
                         jax.tree.map(jnp.asarray, stats), _jax_tx(kind))


def _jax_leaves(js) -> dict:
    """{dotted orbax name: numpy array} of a JAX TrainState."""
    tree = {"params": js.params, "batch_stats": js.batch_stats,
            "opt_state": js.opt_state, "step": js.step}
    return {".".join(str(getattr(k, "key", getattr(k, "name", getattr(
        k, "idx", k)))) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(state) -> dict:
    return {".".join(k for k, _ in path): leaf.detach().cpu().numpy()
            for path, leaf in flatten_state(optax_state(
                state.model, state.optimizer, state.step))
            if isinstance(leaf, torch.Tensor)}


def _assert_leaves_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _port_steps(state, n, seed=3):
    """``n`` updates on gradients drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        for ps in state.optimizer.params:
            for p in ps:
                p.grad = torch.from_numpy(
                    (rng.standard_normal(tuple(p.shape)) * 0.01)
                    .astype(np.float32))
        state.optimizer.step(state.step, state.step_t)
        state.step += 1


def _jax_steps(js, n, seed=3):
    rng = np.random.default_rng(seed)
    step = jax.jit(lambda s, g: s.apply_gradients(g))
    for _ in range(n):
        js = step(js, jax.tree.map(lambda a: jnp.asarray(
            (rng.standard_normal(a.shape) * 0.01).astype(np.float32)),
            js.params))
    return js


def _ts_items(d) -> dict:
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + d}).result()
    return {bytes(k): bytes(kv.read(k).result().value)
            for k in kv.list().result()}


KINDS = ["teacher", "ssl", "kd"]
# the round trips also hold the unclipped layout (``inner_state.0.mu``)
ROUND_TRIPS = KINDS + ["teacher_noclip", "kd_noclip"]


@pytest.mark.parametrize("kind", ROUND_TRIPS)
def test_a_jax_state_restores_in_the_port_bit_for_bit(kind, tmp_path):
    js = _jax_steps(_jax_state(kind, _port_state(kind)), 2)
    mgr = JX.make_manager(str(tmp_path))
    JX.save_state(mgr, 2, js)
    mgr.wait_until_finished()
    # orbax's own layout: a two-level store, zstd nodes and chunks
    assert os.path.isdir(tmp_path / "2" / "default" / "ocdbt.process_0")
    state = _port_state(kind)
    assert PX.restore_state(PX.make_manager(str(tmp_path)), state) == 2
    assert state.step == 2
    # without a clip each group's adamw state is not behind a chain's
    adam = ".inner_state.0.mu." if kind.endswith("_noclip") else \
        ".inner_state.1.0.mu." if kind != "ssl" else "opt_state.1.0.mu."
    assert any(adam in k for k in _jax_leaves(js))
    _assert_leaves_equal(_port_leaves(state), _jax_leaves(js))
    # and the weights through the port's own flax view
    params, stats = to_flax(state.model)
    for tree, name in ((params, "params"), (stats, "batch_stats")):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            np.testing.assert_array_equal(leaf, np.asarray(
                _jax_leaves(js)[name + "." + ".".join(k.key for k in path)]))


@pytest.mark.parametrize("kind", ROUND_TRIPS)
def test_a_port_state_restores_in_jax_bit_for_bit(kind, tmp_path):
    state = _port_state(kind)
    _port_steps(state, 2)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    mgr = PX.make_manager(port_dir)
    PX.save_state(mgr, 2, state)
    mgr.wait_until_finished()
    want = _port_leaves(state)
    template = _jax_state(kind, _port_state(kind))
    restored = JX.restore_state(JX.make_manager(port_dir), template)
    got = _jax_leaves(restored)
    _assert_leaves_equal(got, want)
    assert jax.tree.structure(restored.opt_state) == \
        jax.tree.structure(template.opt_state)
    # the same state saved by JAX names the same tree (on device arrays,
    # as the JAX loops hold them; restore_state hands back numpy leaves)
    jmgr = JX.make_manager(jax_dir)
    JX.save_state(jmgr, 2, jax.tree.map(jnp.asarray, restored))
    jmgr.wait_until_finished()
    trees = []
    for d in (port_dir, jax_dir):
        with open(os.path.join(d, "2", "default", "_METADATA")) as f:
            trees.append(json.load(f)["tree_metadata"])
    assert trees[0] == trees[1]
    # tensorstore reads every key of the port's store to the same bytes
    item = os.path.join(port_dir, "2", "default")
    store = PX.ocdbt.Store(item)
    items = _ts_items(item)
    assert sorted(items) == store.keys()
    for k, v in items.items():
        assert store.read(k) == v


def test_restore_refuses_another_tree_and_disagreeing_counts(tmp_path):
    state = _port_state("teacher")
    _port_steps(state, 1)
    mgr = PX.make_manager(str(tmp_path / "a"))
    PX.save_state(mgr, 1, state)
    mgr.wait_until_finished()
    # the KD optimizer over the same kind of tree: another leaf set
    other = _port_state("kd")
    with pytest.raises(ValueError, match="another tree"):
        PX.restore_state(mgr, other)
    # a teacher optimizer without the frozen prefix: masks elsewhere
    model = init_teacher(TCFG, 0)
    loose = TrainState(model, PO.MultiGroupAdamW(model, OptimConfig(**OPTIM),
                                                 9))
    with pytest.raises(ValueError, match="another tree"):
        PX.restore_state(mgr, loose)
    # one group's count off by one
    leaves = PX.host_leaves(state)
    for i, (path, leaf) in enumerate(leaves):
        if path[-1][0] == "count":
            leaves[i] = (path, (leaf[0] + 1, leaf[1]))
            break
    bad = PX.make_manager(str(tmp_path / "b"))
    bad.save(1, leaves)
    bad.wait_until_finished()
    with pytest.raises(ValueError, match="differ from the step"):
        PX.restore_state(bad, _port_state("teacher"))


def test_retention_and_atomic_commit(tmp_path):
    """After 4 saves with ``max_to_keep=2`` two steps remain (JAX
    ``tests/test_orbax_io.py``); a step directory a killed writer left
    behind is not the latest, for the port's manager and for orbax's; a
    step's commit hook runs after its rename."""
    state = _port_state("kd")
    mgr = PX.make_manager(str(tmp_path), max_to_keep=2)
    seen = []
    for step in range(4):
        _port_steps(state, 1, seed=step)
        PX.save_state(mgr, step, state, on_commit=lambda s=step: seen.append(
            os.path.isdir(mgr.step_dir(s))))
    mgr.wait_until_finished()
    assert seen == [True] * 4
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert all(r["write_s"] > 0 and r["bytes"] > 0 for r in mgr.saves)
    jmgr = JX.make_manager(str(tmp_path), max_to_keep=2)
    assert list(jmgr.all_steps()) == [2, 3]
    jmgr.close()
    # a writer killed after its data and before its rename
    leaves = PX.host_leaves(state)
    half = tmp_path / f"4{PX.TMP_SUFFIX}123"
    PX.write_item(str(half / PX.ITEM), leaves)
    assert mgr.latest_step() == 3
    assert JX.make_manager(str(tmp_path)).latest_step() == 3
    with pytest.raises(ValueError, match="already exists"):
        mgr.save(3, leaves)
    restored = _port_state("kd")
    assert PX.restore_state(mgr, restored) == 3
    _assert_leaves_equal(_port_leaves(restored), _port_leaves(state))


def test_a_jax_run_directory_is_refused_on_orbax(tmp_path):
    """JAX's orbax backend writes the same sidecar with a JAX key: the
    port's resumer refuses it before loading, as on msgpack."""
    state = JState.create({"w": jnp.ones((3,))}, {}, optax.adamw(1e-3))
    stopper = JStopper(3, mode="max")
    stopper.update(0.5)
    resumer = jax_ckpt.FullStateResumer(str(tmp_path), backend="orbax")
    resumer.save(state, 0, stopper, jax_ckpt.BestKTracker(str(tmp_path)),
                 [], 1, jax.random.key(0))
    resumer.finish()
    assert os.path.isdir(tmp_path / "orbax_state" / "0")
    port = _port_state("kd")
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    with pytest.raises(ValueError, match="multimodal_edema_prediction_tpu"):
        FullStateResumer(str(tmp_path), "orbax").restore(port)
    for k, v in port.model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("saved,resumed", [("orbax", "msgpack"),
                                           ("msgpack", "orbax")])
def test_a_sidecar_without_this_backends_state_is_refused(saved, resumed,
                                                          tmp_path):
    """A run directory resumed on the other backend raises, naming the state
    it holds, instead of restarting from epoch 0 over its sidecar."""
    from types import SimpleNamespace
    state = _port_state("kd")
    resumer = FullStateResumer(str(tmp_path), saved)
    resumer.save(state, 0, SimpleNamespace(best=0.5, bad_epochs=0),
                 SimpleNamespace(entries=[]), [], 1, torch.Generator())
    resumer.finish()
    held = "orbax_state/" if saved == "orbax" else "train_state.msgpack"
    with pytest.raises(ValueError, match=f"epoch 0.*{held}"):
        FullStateResumer(str(tmp_path), resumed).restore(_port_state("kd"))
    assert FullStateResumer(str(tmp_path), saved).restore(
        _port_state("kd"))["epoch"] == 0


# -- goldens -----------------------------------------------------------------
def _golden_expected(directory):
    z = np.load(os.path.join(directory, "expected.npz"))
    dtypes = json.loads(str(z["__dtypes__"]))
    return {k: (z[k], dt) for k, dt in dtypes.items()}


def test_golden_store_decodes_to_its_arrays_and_to_the_script(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import make_orbax_goldens
    step = os.path.join("1", "default")
    got = PX.read_arrays(os.path.join(GOLDEN, step))
    want = _golden_expected(GOLDEN)
    assert {dt for _, dt in want.values()} == {"<f4", "<i4", "bfloat16"}
    for d in (GOLDEN, str(tmp_path)):
        if d != GOLDEN:
            make_orbax_goldens.make_goldens(d)
            assert os.path.isdir(os.path.join(d, step, "ocdbt.process_0"))
            now = PX.read_arrays(os.path.join(d, step))
            assert now.keys() == got.keys()
            for k, (a, dt) in now.items():
                assert dt == got[k][1]
                np.testing.assert_array_equal(a, got[k][0], err_msg=k)
            for k, (a, dt) in _golden_expected(d).items():
                np.testing.assert_array_equal(a, want[k][0], err_msg=k)
        assert got.keys() == want.keys()
        for k, (a, dt) in got.items():
            assert dt == want[k][1] and a.dtype == want[k][0].dtype, k
            np.testing.assert_array_equal(a, want[k][0], err_msg=k)


# -- the loops ---------------------------------------------------------------
def _data():
    ds = S.make_synthetic(**COHORT)
    return P.build_anchor_dataset(ds, P.meta_from_events(ds, DataConfig()),
                                  DataConfig())


def _teacher(ckpt_dir, **kw):
    return L.train_teacher(
        _data(), TCFG, TrainConfig.from_dict(TRAIN), ckpt_dir, LABELS,
        model=init_teacher(TCFG, 0), device="cpu", feature_cache="hbm",
        log=lambda s: None, **kw)


def _ssl(ckpt_dir, **kw):
    ds = S.make_synthetic(**COHORT)
    meta = P.meta_from_events(ds, DataConfig())
    return SSL.train_ssl(
        build_sliding_ssl_dataset(ds, meta, 24, 12, 336),
        DuettConfig(**{**DUETT, "pretrain_masked_steps": 2}),
        TrainConfig(batch_size=32, epochs=3, limit_batches=2,
                    dtype="float32", seed=0), ckpt_dir, warmup_steps=3,
        device="cpu", log=lambda s: None, **kw)


@pytest.fixture(scope="module")
def kd_teacher(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("kd_teacher") / "best.msgpack")
    cfg = TCFG.replace(perceiver=TCFG.perceiver.replace(dropout=0.0,
                                                        head_dropout=0.0))
    save_checkpoint(path, init_teacher(cfg, 0), 0, 0.5,
                    config={"model": cfg.to_dict(), "train": {},
                            "pathology_labels": list(LABELS)})
    return path


def _run(kind, ckpt_dir, kd_teacher, **kw):
    if kind == "teacher":
        return _teacher(ckpt_dir, **kw)
    if kind == "ssl":
        return _ssl(ckpt_dir, **kw)
    return K.train_student_kd(
        _data(), SCFG, kd_teacher, TrainConfig.from_dict(TRAIN), ckpt_dir,
        device="cpu", feature_cache="hbm", log=lambda s: None, **kw)


def _committed(run_dir) -> dict:
    """{name: array} of the latest committed orbax step of a run."""
    mgr = PX.make_manager(os.path.join(run_dir, "orbax_state"))
    arrays = PX.read_arrays(os.path.join(mgr.step_dir(mgr.latest_step()),
                                         PX.ITEM))
    return {k: a for k, (a, _) in arrays.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_orbax_stop_and_resume_equals_the_whole_run(kind, kd_teacher,
                                                    tmp_path):
    """Stopped after epoch 1 on orbax and resumed to 3: the history and the
    final state equal an uninterrupted run's and the msgpack resume's bit
    for bit, and the last committed step holds that final state."""
    whole = _run(kind, str(tmp_path / "whole"), kd_teacher,
                 save_full_state=True)
    runs = {}
    for backend in ("orbax", "msgpack"):
        d = str(tmp_path / backend)
        first = _run(kind, d, kd_teacher, save_full_state=True,
                     stop_after_epochs=1, state_backend=backend)
        assert len(first.history) == 1
        runs[backend] = _run(kind, d, kd_teacher, auto_resume=True,
                             state_backend=backend)
        assert runs[backend].history == whole.history
        assert runs[backend].best_metric == whole.best_metric
    final = _port_leaves(whole.extras["state"])
    for res in runs.values():
        _assert_leaves_equal(_port_leaves(res.extras["state"]), final)
    _assert_leaves_equal(_committed(str(tmp_path / "orbax")), final)
    # max_to_keep=2, as JAX's resumer keeps them
    assert PX.make_manager(str(tmp_path / "orbax" / "orbax_state")
                           ).all_steps() == [1, 2]


def test_teacher_sigterm_on_orbax_commits_and_resumes(tmp_path, monkeypatch):
    """A SIGTERM in epoch 0's first step: the epoch ends, its state is
    saved on orbax and committed before the call returns (``finish``), and
    the resume ends where the uninterrupted run ends."""
    whole = _teacher(str(tmp_path / "whole"), save_full_state=True)
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    installed = preemption._installed
    preemption.install_handler()
    make = L.engine.make_teacher_step

    def wrapped(*a, **k):
        step, n = make(*a, **k), [0]

        def run(*args):
            out = step(*args)
            n[0] += 1
            if n[0] == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return run

    monkeypatch.setattr(L.engine, "make_teacher_step", wrapped)
    d = str(tmp_path / "cut")
    try:
        first = _teacher(d, state_backend="orbax")
        assert preemption.requested() and len(first.history) == 1
    finally:
        preemption.clear()
        for s, h in prev.items():
            signal.signal(s, h)
        preemption._installed = installed
    monkeypatch.undo()
    assert PX.make_manager(os.path.join(d, "orbax_state")).all_steps() == [0]
    assert first.extras["state_bytes"] > 0
    assert first.extras["state_write_s"][0] > 0
    with open(os.path.join(d, "train_state.meta.json")) as f:
        assert json.load(f)["epoch"] == 0
    second = _teacher(d, auto_resume=True, state_backend="orbax")
    assert second.extras["start_epoch"] == 1
    assert second.history == whole.history
    _assert_leaves_equal(_port_leaves(second.extras["state"]),
                         _port_leaves(whole.extras["state"]))
