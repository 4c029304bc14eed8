"""The port's ``utils/logging.py`` and the teacher loop's telemetry against
the JAX package's, on the CPU.

A stub ``wandb`` module in ``sys.modules`` stands for the real one (absent
here, and on the card's host). Both packages' loggers send it the same
calls (``init``, ``log``, ``alert``, ``finish``); ``run_with_crash_alert``
alerts with the traceback and re-raises. A ``RecordingLogger`` (as in JAX
``tests/test_telemetry.py:27``) on both teacher loops, from the same
weights on the same cohort and pixels at float32, records the same rows:
the same keys at the same steps, values within 5e-3 (absolute, plus 5e-3
relative: the loop-parity tolerance, ``tests/test_torch_teacher_loop.py``).
The per-step ``train_step/*`` rows come only with a live sink (a wandb
project and the module) and ``log_every`` > 0.
"""
import sys
import types

import jax
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.config import (
    DataConfig as JData, DuettConfig as JDuett, OptimConfig as JOptim,
    PerceiverConfig as JPerc, TeacherConfig as JTeacher, TrainConfig as JTrain,
    ViTConfig as JViT)
from multimodal_edema_prediction_tpu.data import pipeline as JP
from multimodal_edema_prediction_tpu.data import synthetic as JS
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.train import teacher_loop as JL
from multimodal_edema_prediction_tpu.utils import logging as jlog
from multimodal_edema_prediction_tpu_torch.config import (DataConfig,
                                                          TeacherConfig,
                                                          TrainConfig)
from multimodal_edema_prediction_tpu_torch.convert import load_flax
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.models.teacher import TeacherModel
from multimodal_edema_prediction_tpu_torch.train import teacher_loop as L
from multimodal_edema_prediction_tpu_torch.utils import logging as plog

LABELS = JData().pathology_labels
JCFG = JTeacher(
    duett=JDuett(n_variables=8, n_timesteps=24, d_static=18, d_embedding=8,
                 n_layers=1, d_feedforward=32, d_hidden_mlp_embedding=16,
                 d_hidden_tab_encoder=16),
    vit=JViT(image_size=56, patch_size=14, d_model=32, n_layers=1, n_heads=2,
             d_feedforward=64),
    perceiver=JPerc(n_pathologies=7, d_latent=32, n_heads=2, dropout=0.0,
                    head_dropout=0.0, head_hidden=16))
TRAIN = dict(batch_size=8, epochs=2, limit_batches=2, patience=3,
             dtype="float32", log_every=1, eval_train_batches=1,
             optim=dict(lr=2e-3, warmup_steps=2, weight_decay=1e-4))
COHORT = dict(seed=0, n_subjects=30, n_stays=60, n_variables=8, min_len=26,
              max_len=40)
TOL = 5e-3


class StubWandb(types.ModuleType):
    """What the loggers call of wandb, recorded."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", kw))

    def log(self, data, step=None):
        self.calls.append(("log", dict(data), step))

    def alert(self, title, text):
        self.calls.append(("alert", title, text))

    def finish(self):
        self.calls.append(("finish",))


def recording(base):
    class RecordingLogger(base):
        def __init__(self, project=None):
            super().__init__("test", project)
            self.rows = []

        def metrics(self, data, step=None):
            self.rows.append((dict(data), step))
            super().metrics(data, step)

    return RecordingLogger


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def stub(monkeypatch):
    wb = StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", wb)
    return wb


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_logger_calls_reach_wandb(pkg, stub, capsys):
    mod = jlog if pkg == "jax" else plog
    log = mod.Logger("run", "proj", "name", {"a": 1})
    log.info("hello")
    log.metrics({"x": 1.5}, step=3)
    log.alert("title", "t" * 2000)
    log.finish()
    assert stub.calls == [
        ("init", {"project": "proj", "name": "name", "config": {"a": 1}}),
        ("log", {"x": 1.5}, 3), ("alert", "title", "t" * 1024), ("finish",)]
    out = capsys.readouterr().out
    assert "] hello" in out and "ALERT: title" in out


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("fails", [False, True])
def test_run_with_crash_alert(pkg, fails, stub):
    """A crash alerts with its traceback and re-raises; the logger finishes
    either way."""
    mod = jlog if pkg == "jax" else plog
    log = mod.Logger("run", "proj")

    def main():
        if fails:
            raise KeyError("boom")
        return 7

    if fails:
        with pytest.raises(KeyError, match="boom"):
            mod.run_with_crash_alert(main, log)
        (_, title, text), end = stub.calls[-2:]
        assert title == "run crashed: KeyError" and "boom" in text
    else:
        assert mod.run_with_crash_alert(main, log) == 7
        end = stub.calls[-1]
    assert end == ("finish",)


def test_without_wandb_the_logger_carries_on(monkeypatch, capsys):
    """wandb that does not import: the console alone, as in JAX."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    log = plog.Logger("run", "proj")
    assert "wandb unavailable" in capsys.readouterr().out
    log.metrics({"x": 1.0}, 1)
    log.finish()
    assert log._wb is None


def test_only_the_main_process_logs(stub, monkeypatch, capsys):
    """Rank 1 of an initialised process group starts no wandb run and
    prints nothing."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    log = plog.Logger("run", "proj")
    log.info("hidden")
    assert stub.calls == [] and log._wb is None
    assert capsys.readouterr().out == ""


def _cohort():
    ds = S.make_synthetic(**COHORT)
    return P.build_anchor_dataset(ds, P.meta_from_events(ds, DataConfig()),
                                  DataConfig())


def _jax_pixels_hook():
    """The port's host hook attaching JAX's own procedural images (the JAX
    loop's default source, drawn by the port's threefry), so that the
    train steps and the gradient-flow diagnostics of both loops read the
    same pixels."""
    source = L.make_synthetic_image_source(JCFG.vit.image_size)

    def hook(b):
        px = source({"image_ids": torch.as_tensor(b["image_ids"]),
                     "y_multi": torch.as_tensor(b["y_multi"])})
        return {**b, "pixel_values": px.numpy()}
    return hook


def _run_both(root, variables, train, **kw):
    """Both loops on pixels, each with a RecordingLogger on a live stub."""
    jds = JS.make_synthetic(**COHORT)
    jad = JP.build_anchor_dataset(jds, JP.meta_from_events(jds, JData()),
                                  JData())
    jlogger = recording(jlog.Logger)("proj")
    JL.train_teacher(
        jad, JCFG, JTrain(**{**train, "optim": JOptim(**train["optim"])}),
        str(root / "jax"), LABELS, logger=jlogger,
        init_variables=jax.tree.map(jax.numpy.asarray, variables), **kw)
    cfg = TeacherConfig.from_dict(JCFG.to_dict())
    model = load_flax(TeacherModel(cfg), variables["params"],
                      variables["batch_stats"])
    plogger = recording(plog.Logger)("proj")
    res = L.train_teacher(_cohort(), cfg, TrainConfig.from_dict(train),
                          str(root / "port"), LABELS, model=model,
                          device="cpu", image_hook=_jax_pixels_hook(),
                          logger=plogger,
                          log=lambda s: None, **kw)
    return jlogger.rows, plogger.rows, res


@pytest.fixture(scope="module")
def telemetry(tmp_path_factory):
    """The rows of both loops: a 2-epoch run with the train-subset gap and
    the gradient-flow diagnostics every epoch, then LP mode from the JAX
    run's checkpoint (1 epoch)."""
    wb = StubWandb()
    saved = sys.modules.get("wandb")
    sys.modules["wandb"] = wb
    try:
        root = tmp_path_factory.mktemp("telemetry")
        variables = jax.tree.map(np.asarray, JL.init_teacher(
            JT(JCFG), JCFG, 16, 24, jax.random.key(0)))
        base = _run_both(root / "base", variables, TRAIN,
                         grad_diag_every=1, grad_diag_batches=1)
        import glob
        (start,) = glob.glob(str(root / "base" / "jax" / "best-*.msgpack"))
        lp = _run_both(root / "lp", variables,
                       {**TRAIN, "epochs": 1, "eval_train_batches": 0},
                       lp_from=start)
    finally:
        if saved is None:
            sys.modules.pop("wandb", None)
        else:
            sys.modules["wandb"] = saved
    return {"base": base, "lp": lp}


@pytest.mark.parametrize("run", ["base", "lp"])
def test_teacher_loop_rows_match_jax(telemetry, run):
    jrows, prows, _ = telemetry[run]
    assert [sorted(r) for r, _ in prows] == [sorted(r) for r, _ in jrows]
    assert [s for _, s in prows] == [s for _, s in jrows]
    for (p, step), (j, _) in zip(prows, jrows):
        for k in j:
            np.testing.assert_allclose(p[k], j[k], rtol=TOL, atol=TOL,
                                       err_msg=f"{k} at step {step}")


def test_teacher_loop_sends_jax_six_kinds_of_rows(telemetry):
    """Per-step losses every ``log_every`` steps, the epoch's train and val
    scalars, the train-subset gap, the gradient-flow diagnostics and the
    test scalars (JAX ``teacher_loop.py:580-744``), and LP's terms."""
    _, rows, _ = telemetry["base"]
    kinds = [min(r).split("/")[0] for r, _ in rows]
    assert kinds == ["train_step"] * 2 + ["train", "train_eval",
                                          "grad_diag"] \
        + ["train_step"] * 2 + ["train", "train_eval", "grad_diag", "test"]
    steps = [s for _, s in rows]
    assert steps == [1, 2, 0, 0, 0, 3, 4, 1, 1, 1, None]
    keys = set().union(*[r for r, _ in rows])
    for nm in LABELS:
        assert {f"val/{nm}/fus_auroc", f"val/{nm}/gap_i2f",
                f"val/{nm}/beta"} <= keys
    assert {"train/loss", "train/img_loss", "train/ts_loss",
            "train/fus_loss", "val/best_auroc", "val/auprc",
            "train_eval/main_gap_over_val", "grad_diag/query_gram_gap",
            "test/auroc", "test/auprc", "train_step/total"} <= keys
    lp_keys = set().union(*[r for r, _ in telemetry["lp"][1]])
    assert {"train/lp_reg_beta_l2", "train/lp_reg_corr_l2",
            "train/lp_beta_mean_abs", "train/lp_beta_max_abs"} <= lp_keys
    # the history keeps its keys beside the rows
    res = telemetry["base"][2]
    assert "train_eval_main_gap_over_val" in res.history[0]
    assert "grad_diag/query_gram_gap" in res.history[0]


def _port_rows(tmp_path, project, log_every):
    cfg = TeacherConfig.from_dict(JCFG.to_dict())
    logger = recording(plog.Logger)(project)
    L.train_teacher(_cohort(), cfg, TrainConfig.from_dict(
        {**TRAIN, "epochs": 1, "log_every": log_every,
         "eval_train_batches": 0}), str(tmp_path), LABELS, device="cpu",
        feature_cache="hbm", logger=logger,
        log=lambda s: None)
    return logger


@pytest.mark.parametrize("case", ["no_project", "log_every_0",
                                  "no_module", "live"])
def test_step_rows_need_a_live_sink(case, tmp_path, monkeypatch):
    """``train_step/*`` rows only with a wandb project, an importable
    wandb and ``log_every`` > 0; the epoch and test rows are recorded in
    every case, and reach the stub only when it is live."""
    wb = StubWandb()
    monkeypatch.setitem(sys.modules, "wandb",
                        None if case == "no_module" else wb)
    logger = _port_rows(tmp_path, None if case == "no_project" else "proj",
                        0 if case == "log_every_0" else 1)
    step_rows = [r for r, _ in logger.rows if "train_step/total" in r]
    assert len(step_rows) == (2 if case == "live" else 0)
    assert any("val/auroc" in r for r, _ in logger.rows)
    logged = [c for c in wb.calls if c[0] == "log"]
    assert len(logged) == (len(logger.rows) if case in ("live",
                                                        "log_every_0")
                           else 0)
