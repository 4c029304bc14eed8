"""The port's SSL pretraining loop (``train/ssl_loop.py::train_ssl``) against
the JAX package's, its bit-exact resume, the encoder transplant across the
two packages, and the SSL and teacher CLIs on the CPU.

Both loops start from the same converted weights on the same synthetic
cohort, float32, 2 epochs x 2 batches of 32, with the SSL masks handed to
both through the batch keys ``ssl_mask_idx``/``ssl_event_var`` (a fixed
function of each window's stay and end slot) and ``pretrain_dropout`` 0:
``jax.random`` and ``torch.Generator`` draw differently. Tolerance: the
per-epoch train and val losses within 5e-3 relative (the precedent of
``tests/test_student_loop_parity.py``).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.config import (
    DataConfig as JData, DuettConfig as JDuett, TrainConfig as JTrain)
from multimodal_edema_prediction_tpu.data import pipeline as JP
from multimodal_edema_prediction_tpu.data import sliding as JSL
from multimodal_edema_prediction_tpu.data import synthetic as JS
from multimodal_edema_prediction_tpu.models import duett as jduett
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.train import ssl_loop as JL
from multimodal_edema_prediction_tpu.train import teacher_loop as JTL
from multimodal_edema_prediction_tpu.train.checkpoint import \
    save_checkpoint as jax_save
from multimodal_edema_prediction_tpu_torch.cli import train_ssl as cli_ssl
from multimodal_edema_prediction_tpu_torch.cli import \
    train_teacher as cli_teacher
from multimodal_edema_prediction_tpu_torch.config import (DataConfig,
                                                          DuettConfig,
                                                          TeacherConfig,
                                                          TrainConfig)
from multimodal_edema_prediction_tpu_torch.convert import (flax_to_state_dict,
                                                           load_flax)
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import sliding as SL
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.data.meta import Meta
from multimodal_edema_prediction_tpu_torch.models import duett
from multimodal_edema_prediction_tpu_torch.models.teacher import init_teacher
from multimodal_edema_prediction_tpu_torch.train import ssl_loop as L
from multimodal_edema_prediction_tpu_torch.train.checkpoint import \
    load_checkpoint
from torch_port_util import init_perturbed

T, V = 24, 6
DUETT = dict(n_variables=V, n_timesteps=T, d_static=18, d_embedding=8,
             n_layers=1, d_feedforward=32, d_hidden_mlp_embedding=16,
             d_hidden_tab_encoder=16, pretrain_masked_steps=2,
             pretrain_dropout=0.0)
TRAIN = dict(batch_size=32, epochs=2, patience=10, dtype="float32", seed=0,
             limit_batches=2)
COHORT = dict(seed=0, n_subjects=50, n_stays=120, n_variables=V, min_len=26,
              max_len=60)
LOOP = dict(lr=1e-3, warmup_steps=3, weight_decay=0.1, grad_clip=1.0)


def _with_masks(batch):
    """The SSL masks as a fixed function of each window (stay, end slot)."""
    rows = np.asarray(batch["stay_rows"]).astype(np.int64)
    end = np.asarray(batch["slot_idx"]).astype(np.int64)
    steps = np.arange(DUETT["pretrain_masked_steps"])
    return {**batch,
            "ssl_mask_idx": ((rows * 7 + end)[:, None] + 5 * steps) % T,
            "ssl_event_var": (rows * 3 + end) % V}


class JMasked(JSL.SlidingSSLDataset):
    def iter_batches(self, *a, **k):
        return map(_with_masks, super().iter_batches(*a, **k))


class Masked(SL.SlidingSSLDataset):
    def iter_batches(self, *a, **k):
        return map(_with_masks, super().iter_batches(*a, **k))


def _port_data(cls=Masked):
    ds = S.make_synthetic(**COHORT)
    meta = P.meta_from_events(ds, DataConfig())
    base = SL.build_sliding_ssl_dataset(ds, meta, T, stride=12)
    return cls(**{f: getattr(base, f) for f in
                  ("grid", "static", "samples", "meta", "n_timesteps")})


def _init_variables():
    jmodel = jduett.DuettPretrainModel(JDuett(**DUETT))
    B, S_ = 4, DUETT["pretrain_masked_steps"]
    pb = jduett.PretrainBatch(
        x_in=np.zeros((B, T, 2 * V + 1), np.float32),
        mask_idx=np.zeros((B, S_), np.int32),
        y_value=np.zeros((B, S_, V), np.float32),
        y_presence_mask=np.zeros((B, S_, V), np.float32),
        event_var=np.zeros((B,), np.int32),
        y_events=np.zeros((B, T), np.float32),
        y_events_mask=np.zeros((B, T), np.float32))
    return init_perturbed(jmodel, pb, np.zeros((B, 18), np.float32),
                          np.zeros((B, T), np.float32), scale=0.02)


def _port_model(params, stats):
    return load_flax(duett.DuettPretrainModel(DuettConfig(**DUETT)), params,
                     stats)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ssl")
    params, stats = _init_variables()
    jds = JS.make_synthetic(**COHORT)
    jmeta = JP.meta_from_events(jds, JData())
    jbase = JSL.build_sliding_ssl_dataset(jds, jmeta, T, stride=12)
    jdata = JMasked(**{f: getattr(jbase, f) for f in
                       ("grid", "static", "samples", "meta", "n_timesteps")})
    jres = JL.train_ssl(jdata, JDuett(**DUETT), JTrain(**TRAIN),
                        str(root / "jax"), init_variables=jax.tree.map(
                            jax.numpy.asarray,
                            {"params": params, "batch_stats": stats}),
                        **LOOP)
    res = L.train_ssl(_port_data(), DuettConfig(**DUETT),
                      TrainConfig(**TRAIN), str(root / "port"),
                      model=_port_model(params, stats), device="cpu",
                      save_full_state=True, log=lambda s: None, **LOOP)
    return jres, res, root, params, stats


def test_ssl_loop_matches_jax_per_epoch(runs):
    jres, res, _, _, _ = runs
    assert len(res.history) == len(jres.history) == 2
    for got, want in zip(res.history, jres.history):
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3,
                                       err_msg=f"epoch {got['epoch']} {k}")
    assert res.history[1]["train_loss"] < res.history[0]["train_loss"]
    np.testing.assert_allclose(res.best_metric, jres.best_metric, rtol=5e-3)


def test_ssl_loop_writes_the_contract(runs):
    """The best checkpoint (JAX format, prefix ``pretrain``, reloadable into
    the pretrain model) and ``meta_with_stats.pkl`` beside it."""
    _, res, root, _, _ = runs
    ck = load_checkpoint(res.best_path)
    assert res.best_path.startswith(str(root / "port" / "pretrain-"))
    assert ck["config"]["duett"]["n_variables"] == V
    model = _port_model(ck["params"], ck["batch_stats"])
    assert set(ck["params"]) == {"encoder", "pretrain_value_proj",
                                 "pretrain_presence_proj",
                                 "predict_events_proj",
                                 "predict_events_presence_proj"}
    meta = Meta.load(str(root / "port" / "meta_with_stats.pkl"))
    assert meta.all_vars == _port_data().meta.all_vars
    assert sum(p.numel() for p in model.parameters()) > 0


def test_ssl_resume_is_bit_exact(runs, tmp_path):
    """1 epoch, a pause (the state saved), a resume for the second: the
    same history and the same weights as the 2 uninterrupted epochs."""
    _, res, root, params, stats = runs
    d = str(tmp_path / "resume")
    kw = dict(device="cpu", log=lambda s: None, **LOOP)
    first = L.train_ssl(_port_data(), DuettConfig(**DUETT),
                        TrainConfig(**TRAIN), d,
                        model=_port_model(params, stats),
                        save_full_state=True, stop_after_epochs=1, **kw)
    assert len(first.history) == 1
    model = _port_model(params, stats)
    second = L.train_ssl(_port_data(), DuettConfig(**DUETT),
                         TrainConfig(**TRAIN), d, model=model,
                         auto_resume=True, **kw)
    assert second.history == res.history
    whole = load_checkpoint(str(root / "port" / "train_state.msgpack"))
    again = load_checkpoint(d + "/train_state.msgpack")
    assert whole["step"] == again["step"] == 4
    flat = jax.tree_util.tree_flatten_with_path(whole["params"])[0]
    other = dict(jax.tree_util.tree_flatten_with_path(again["params"])[0])
    for path, leaf in flat:
        np.testing.assert_array_equal(other[path], leaf, err_msg=str(path))
    for k in ("mu", "nu"):
        for a, b in zip(whole["opt_state"][k], again["opt_state"][k]):
            np.testing.assert_array_equal(a, b)


def test_ssl_loop_refuses_what_is_not_ported(runs, tmp_path):
    """Multi-step dispatch (P10) is done: ``steps_per_call=4`` trains, to
    the K = 1 run's history and full state bit for bit (2 batches an epoch:
    one call of 2, the remainder shape). The orbax backend (P16) is done:
    it trains to the same history and commits the same final state as
    orbax steps."""
    _, res, root, params, stats = runs
    four = L.train_ssl(_port_data(), DuettConfig(**DUETT),
                       TrainConfig(**{**TRAIN, "steps_per_call": 4}),
                       str(tmp_path / "k4"), model=_port_model(params, stats),
                       device="cpu", save_full_state=True,
                       log=lambda s: None, **LOOP)
    assert four.history == res.history
    for name in ("train_state.msgpack", "train_state.meta.json"):
        with open(root / "port" / name, "rb") as f, \
                open(tmp_path / "k4" / name, "rb") as g:
            want, got = f.read(), g.read()
        if name.endswith(".json"):   # the tracker's paths differ
            want, got = (json.loads(x) for x in (want, got))
            want, got = ({k: x[k] for k in ("rng", "history", "n_steps")}
                         for x in (want, got))
        assert got == want, name
    orbax = L.train_ssl(_port_data(), DuettConfig(**DUETT),
                        TrainConfig(**TRAIN), str(tmp_path / "orbax"),
                        model=_port_model(params, stats), device="cpu",
                        save_full_state=True, state_backend="orbax",
                        log=lambda s: None, **LOOP)
    assert orbax.history == res.history
    from multimodal_edema_prediction_tpu_torch.convert import (flatten_state,
                                                               optax_state)
    from multimodal_edema_prediction_tpu_torch.train import orbax_io
    mgr = orbax_io.make_manager(str(tmp_path / "orbax" / "orbax_state"))
    stored = orbax_io.read_arrays(os.path.join(
        mgr.step_dir(mgr.latest_step()), orbax_io.ITEM))
    want = res.extras["state"]
    leaves = {".".join(k for k, _ in p): t for p, t in flatten_state(
        optax_state(want.model, want.optimizer, want.step))
        if isinstance(t, torch.Tensor)}
    assert stored.keys() == leaves.keys()
    for k, t in leaves.items():
        np.testing.assert_array_equal(stored[k][0], t.detach().numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("argv,match", [
    (["--state_backend", "orbax"], "P16"),
    (["--steps_per_call", "4"], "P10")])
def test_ssl_cli_refuses_what_is_not_ported(argv, match, tmp_path):
    """``--state_backend orbax`` (P16, done) trains and commits the epoch's
    state as orbax step 0; ``--steps_per_call 4`` (P10, done) parses and
    trains."""
    base = ["--device", "cpu", "--synthetic_stays", "40", "--n_variables",
            "6", "--ckpt_dir", str(tmp_path)]
    if match == "P10":
        res = cli_ssl.main(base + ["--batch_size", "16", "--epochs", "1",
                                   "--limit_batches", "3", "--no_save_state",
                                   "--d_embedding", "8"] + argv)
        assert res.extras["n_train_steps"] == 3
        assert np.isfinite(res.history[0]["train_loss"])
        return
    from multimodal_edema_prediction_tpu_torch.train.orbax_io import \
        make_manager
    res = cli_ssl.main(base + ["--batch_size", "16", "--epochs", "1",
                               "--limit_batches", "3", "--d_embedding", "8"]
                       + argv)
    assert np.isfinite(res.history[0]["train_loss"])
    run_dir = os.path.dirname(res.best_path)
    assert make_manager(os.path.join(run_dir, "orbax_state")
                        ).all_steps() == [0]


def _teacher_cfg():
    return TeacherConfig.from_dict({"duett": DUETT, "vit": dict(
        image_size=28, patch_size=14, d_model=16, n_layers=1, n_heads=2,
        d_feedforward=32), "perceiver": dict(d_latent=16, n_heads=2,
                                             head_hidden=8)})


def test_jax_transplant_reads_a_port_checkpoint(runs):
    _, res, _, _, _ = runs
    cfg = _teacher_cfg()
    from multimodal_edema_prediction_tpu.config import TeacherConfig as JTC
    jcfg = JTC.from_dict(cfg.to_dict())
    variables = JTL.init_teacher(JT(jcfg), jcfg, 4, T, jax.random.key(0))
    params, stats, changed = JL.transplant_encoder(res.best_path,
                                                   variables["params"])
    assert changed == []
    ck = load_checkpoint(res.best_path)
    for tree, want in ((params["duett"], ck["params"]["encoder"]),
                       (stats, ck["batch_stats"]["encoder"])):
        flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        got = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert len(got) == len(flat) > 0
        for path, leaf in got:
            np.testing.assert_array_equal(np.asarray(leaf), flat[path])


def test_port_transplant_reads_a_jax_checkpoint(tmp_path):
    params, stats = _init_variables()
    path = str(tmp_path / "pretrain-step1-0.5.msgpack")
    jax_save(path, params, stats, 1, 0.5, {"duett": DUETT})
    model = init_teacher(_teacher_cfg(), 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert L.transplant_encoder(path, model) == []
    want = flax_to_state_dict(params["encoder"], stats["encoder"])
    sd = model.state_dict()
    for k, v in want.items():
        assert torch.equal(sd["duett." + k], v), k
    for k, v in before.items():
        if not k.startswith("duett."):
            assert torch.equal(sd[k], v), k


def test_ssl_cli_then_teacher_cli_on_the_cpu(tmp_path, monkeypatch):
    """``cli.train_ssl`` on ``--device cpu``, then ``cli.train_teacher
    --duett_ckpt``: before its first step the teacher's DuETT weights and
    BatchNorm statistics are the SSL encoder's; both runs finish with
    finite losses."""
    ssl = cli_ssl.main(["--device", "cpu", "--synthetic_stays", "80",
                        "--batch_size", "16", "--epochs", "2",
                        "--limit_batches", "2", "--ssl_warmup", "2",
                        "--ckpt_dir", str(tmp_path / "ssl")])
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
               for h in ssl.history)
    enc = load_checkpoint(ssl.best_path)
    want = flax_to_state_dict(enc["params"]["encoder"],
                              enc["batch_stats"]["encoder"])
    seen = {}
    train = cli_teacher.train_teacher

    def spy(dataset, teacher_cfg, cfg, ckpt_dir, labels, model=None, **kw):
        seen.update({k: v.clone() for k, v in
                     model.duett.state_dict().items()})
        return train(dataset, teacher_cfg, cfg, ckpt_dir, labels,
                     model=model, **kw)

    monkeypatch.setattr(cli_teacher, "train_teacher", spy)
    res = cli_teacher.main(["--device", "cpu", "--vit_size", "tiny",
                            "--synthetic_stays", "80", "--batch_size", "16",
                            "--epochs", "1", "--limit_batches", "2",
                            "--warmup_steps", "2", "--cxr_feature_cache",
                            "hbm", "--duett_ckpt", ssl.best_path,
                            "--ckpt_dir", str(tmp_path / "teacher")])
    assert seen.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(seen[k], v), k
    assert np.isfinite(res.history[0]["train_total"])
