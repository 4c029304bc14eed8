"""The port's ``train_supervised_ts`` (TS-only supervised training of the
student architecture, ROADMAP P14) against the JAX package's on the CPU:
2 epochs of 2 batches of 32 at float32 with dropout and augmentation off,
from the initial weights the JAX loop draws (``model.init`` from
``jax.random.key(seed)``), as ``tests/test_e2e_supervised.py`` drives
JAX's. The per-epoch train loss and val AUROC/AUPRC within 5e-3 relative
(the precedent of ``tests/test_student_loop_parity.py``); the best
checkpoint restores in the JAX package."""
import jax
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.config import (
    DuettConfig as JDuett, OptimConfig as JOptim, StudentConfig as JStudent,
    TrainConfig as JTrain)
from multimodal_edema_prediction_tpu.models.student import \
    StudentModel as JStudentModel
from multimodal_edema_prediction_tpu.train import checkpoint as JC
from multimodal_edema_prediction_tpu.train import loops as JL
from multimodal_edema_prediction_tpu_torch.config import (OptimConfig,
                                                          TrainConfig)
from multimodal_edema_prediction_tpu_torch.convert import load_flax
from multimodal_edema_prediction_tpu_torch.models.student import StudentModel
from multimodal_edema_prediction_tpu_torch.train import checkpoint as C
from multimodal_edema_prediction_tpu_torch.train import loops as L
from test_torch_supervised import (_anchor_datasets, _classifier_inputs,
                                   _student_cfgs)
from torch_port_util import t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The loops here train tiny models, which gain nothing from intra-op
    threads, and the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TRAIN = dict(batch_size=32, epochs=2, patience=5, dtype="float32", seed=3,
             limit_batches=2)


OPTIM = dict(lr=1e-3, warmup_steps=2, weight_decay=1e-4)


def _initial_model(pcfg, jcfg):
    """The JAX loop's own initial weights: model.init from key(seed), whose
    draws depend on the shapes alone."""
    x_in, x_static, times = _classifier_inputs(TRAIN["batch_size"])
    v = JStudentModel(jcfg).init({"params": jax.random.key(TRAIN["seed"])},
                                 x_in, x_static, times)
    return load_flax(StudentModel(pcfg), jax.tree.map(np.asarray,
                                                      v["params"]),
                     jax.tree.map(np.asarray, v["batch_stats"]))


@pytest.fixture(scope="module")
def supervised_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("supervised")
    pcfg, jcfg = _student_cfgs()
    jdata, data = _anchor_datasets()
    jres = JL.train_supervised_ts(
        jdata, jcfg, JTrain(**TRAIN, optim=JOptim(**OPTIM)),
        str(root / "jax"))
    res = L.train_supervised_ts(
        data, pcfg, TrainConfig(**TRAIN, optim=OptimConfig(**OPTIM)),
        str(root / "port"), model=_initial_model(pcfg, jcfg), device="cpu",
        log=lambda s: None)
    return jres, res


def test_supervised_ts_loop_matches_jax_per_epoch(supervised_runs):
    jres, res = supervised_runs
    assert len(res.history) == len(jres.history) == 2
    for got, want in zip(res.history, jres.history):
        for k in ("train_loss", "auroc", "auprc"):
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3,
                                       err_msg=f"epoch {got['epoch']} {k}")
    np.testing.assert_allclose(res.best_metric, jres.best_metric, rtol=5e-3)
    np.testing.assert_allclose(res.test_metrics["auroc"],
                               jres.test_metrics["auroc"], rtol=5e-3)


def test_supervised_best_checkpoint_loads_in_jax(supervised_runs):
    """The port's best checkpoint (JAX format, prefix ``best``, the
    ``{"model", "train"}`` config) restores in the JAX package and
    evaluates as the port's reload did."""
    _, res = supervised_runs
    ck = JC.load_checkpoint(res.best_path)
    assert res.best_path.split("/")[-1].startswith("best-")
    assert set(ck["config"]) == {"model", "train"}
    assert ck["metric"] == pytest.approx(res.best_metric)
    jm = JStudentModel(JStudent.from_dict(ck["config"]["model"]))
    x_in, x_static, times = _classifier_inputs(4)
    want = jm.apply({"params": ck["params"],
                     "batch_stats": ck["batch_stats"]}, x_in, x_static, times)
    model, _, _ = C.load_student_from_ckpt(res.best_path, device="cpu")
    with torch.no_grad():
        got = model(t(x_in), t(x_static), t(times))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_supervised_ts_runs_multistep_dispatch(supervised_runs, tmp_path):
    """Multi-step dispatch (P10) is done: 4 steps a call (2 batches an
    epoch: one call of the remainder's shape) give the K = 1 loop's
    history and test metrics bit for bit."""
    _, res = supervised_runs
    pcfg, jcfg = _student_cfgs()
    _, data = _anchor_datasets()
    four = L.train_supervised_ts(
        data, pcfg, TrainConfig(**TRAIN, steps_per_call=4,
                                optim=OptimConfig(**OPTIM)),
        str(tmp_path), model=_initial_model(pcfg, jcfg), device="cpu",
        log=lambda s: None)
    assert four.history == res.history
    assert four.test_metrics == res.test_metrics
