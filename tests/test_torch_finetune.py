"""The port's multi-seed fine-tuning with top-k weight averaging
(``train/finetune_loop.py::finetune_duett``, ROADMAP P14) against the JAX
package's on the CPU: 2 seeds × 2 epochs, top-k 2, float32, dropout off,
each seed's classifier from the variables the JAX loop draws from
``jax.random.key(seed)`` and both from one SSL checkpoint the JAX package
wrote. Per seed the val AUPRC and the test metrics of the averaged and the
best weights within 5e-3 (the loops' precedent,
``tests/test_student_loop_parity.py``); the ``ft-*.msgpack`` files load
in the other package; the average of the same files is JAX's bit for bit;
and the CLI runs on the CPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.config import (
    DataConfig as JData, DuettConfig as JDuett, OptimConfig as JOptim,
    TrainConfig as JTrain)
from multimodal_edema_prediction_tpu.data import pipeline as JP
from multimodal_edema_prediction_tpu.data import sliding as JSL
from multimodal_edema_prediction_tpu.data import synthetic as JS
from multimodal_edema_prediction_tpu.models import duett as jduett
from multimodal_edema_prediction_tpu.train import checkpoint as JC
from multimodal_edema_prediction_tpu.train import finetune_loop as JF
from multimodal_edema_prediction_tpu_torch.cli import finetune_mimic
from multimodal_edema_prediction_tpu_torch.config import (
    DataConfig, DuettConfig, OptimConfig, TrainConfig)
from multimodal_edema_prediction_tpu_torch.convert import (
    flax_to_state_dict, load_flax)
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import sliding as SL
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.models import duett
from multimodal_edema_prediction_tpu_torch.train import checkpoint as C
from multimodal_edema_prediction_tpu_torch.train import finetune_loop as F
from torch_port_util import init_perturbed

T, V = 24, 6
DUETT = dict(n_variables=V, n_timesteps=T, d_static=18, d_embedding=8,
             n_layers=1, d_feedforward=32, d_hidden_mlp_embedding=16,
             d_hidden_tab_encoder=16)
COHORT = dict(seed=0, n_subjects=60, n_stays=180, n_variables=V, min_len=26,
              max_len=50)
TRAIN = dict(batch_size=32, epochs=2, patience=5, dtype="float32")
OPTIM = dict(lr=2e-3, warmup_steps=2, weight_decay=1e-5)
SEEDS = (0, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The loops here train tiny models, which gain nothing from intra-op
    threads, and the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_init(seed):
    """The classifier's variables as JAX ``finetune_duett`` draws them
    (``finetune_loop.py:108-114``)."""
    model = jduett.DuettClassifier(JDuett(**DUETT), d_target=1,
                                   fusion_method="rep_token")
    v = jax.jit(model.init)({"params": jax.random.key(seed)},
                            jnp.zeros((2, T, 2 * V + 1)),
                            jnp.zeros((2, 18)), jnp.zeros((2, T)))
    return jax.tree.map(np.asarray, v)


def _ssl_ckpt(path):
    """An SSL checkpoint written by the JAX package: its pretrain model's
    variables, perturbed."""
    pm = jduett.DuettPretrainModel(JDuett(**DUETT))
    B = 2
    pb = jduett.PretrainBatch(
        x_in=np.zeros((B, T, 2 * V + 1), np.float32),
        mask_idx=np.zeros((B, 1), np.int32),
        y_value=np.zeros((B, 1, V), np.float32),
        y_presence_mask=np.zeros((B, 1, V), np.float32),
        event_var=np.zeros((B,), np.int32),
        y_events=np.zeros((B, T), np.float32),
        y_events_mask=np.zeros((B, T), np.float32))
    params, stats = init_perturbed(pm, pb, np.zeros((B, 18), np.float32),
                                   np.zeros((B, T), np.float32), seed=4)
    JC.save_checkpoint(path, params, stats, step=7, metric=1.0,
                       config={"duett": JDuett(**DUETT).to_dict()})
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("finetune")
    ssl = _ssl_ckpt(str(root / "pretrain.msgpack"))
    jds = JS.make_synthetic(**COHORT)
    jdata = JSL.build_stay_label_dataset(
        jds, JP.meta_from_events(jds, JData()), T)
    jsum = JF.finetune_duett(jdata, JDuett(**DUETT),
                             JTrain(**TRAIN, optim=JOptim(**OPTIM)),
                             str(root / "jax"), ssl_ckpt=ssl, seeds=SEEDS,
                             top_k=2)
    ds = S.make_synthetic(**COHORT)
    data = SL.build_stay_label_dataset(
        ds, P.meta_from_events(ds, DataConfig()), T)
    extras = {}
    summary = F.finetune_duett(
        data, DuettConfig(**DUETT), TrainConfig(**TRAIN,
                                                optim=OptimConfig(**OPTIM)),
        str(root / "port"), ssl_ckpt=ssl, seeds=SEEDS, top_k=2,
        init_variables=_jax_init, device="cpu", log=lambda s: None,
        extras=extras)
    return jsum, summary, extras, root


def test_finetune_matches_jax_per_seed(runs):
    jsum, summary, _, _ = runs
    assert set(summary) == set(jsum)
    assert [r["seed"] for r in summary["per_seed"]] == list(SEEDS)
    for got, want in zip(summary["per_seed"], jsum["per_seed"]):
        assert set(got) == set(want)
        np.testing.assert_allclose(got["val_auprc"], want["val_auprc"],
                                   rtol=5e-3, atol=5e-3)
        for which in ("test_avg", "test_best"):
            for k in ("auroc", "auprc"):
                np.testing.assert_allclose(
                    got[which][k], want[which][k], rtol=5e-3, atol=5e-3,
                    err_msg=f"seed {got['seed']} {which} {k}")
    for k in ("test_auroc_mean", "test_auroc_std", "test_auprc_mean",
              "test_auprc_std"):
        np.testing.assert_allclose(summary[k], jsum[k], rtol=5e-3,
                                   atol=5e-3, err_msg=k)


def test_finetune_checkpoints_cross_load(runs):
    """The port's ``ft-*.msgpack`` (top-k 2 per seed, under ``seed<s>``)
    restore in JAX's ``load_checkpoint`` and into JAX's classifier; JAX's
    restore in the port's and load into the port's classifier."""
    _, _, extras, root = runs
    for seed in SEEDS:
        names = sorted(os.listdir(root / "port" / f"seed{seed}"))
        assert len(names) == 2 and all(n.startswith("ft-step")
                                       for n in names)
        for _, path in extras[seed]["entries"]:
            ck = JC.load_checkpoint(path)
            x = np.random.default_rng(0).normal(size=(3, T, 2 * V + 1)) \
                .astype(np.float32)
            xs = np.zeros((3, 18), np.float32)
            tm = np.broadcast_to(np.arange(1, T + 1, dtype=np.float32) / 24,
                                 (3, T))
            want = jduett.DuettClassifier(JDuett(**DUETT)).apply(
                {"params": ck["params"], "batch_stats": ck["batch_stats"]},
                x, xs, tm)
            model = load_flax(duett.DuettClassifier(DuettConfig(**DUETT)),
                              ck["params"], ck["batch_stats"])
            with torch.no_grad():
                got = model(torch.tensor(x), torch.tensor(xs),
                            torch.tensor(tm))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5)
        jdir = root / "jax" / f"seed{seed}"
        for name in os.listdir(jdir):
            ck = C.load_checkpoint(str(jdir / name))
            load_flax(duett.DuettClassifier(DuettConfig(**DUETT)),
                      ck["params"], ck["batch_stats"])


def test_average_of_the_same_files_is_jax_bit_for_bit(runs):
    """The port's average of the JAX loop's top-k files is JAX's, cast to
    float32 as both loops do; the averaged model the port evaluated holds
    its own files' average with the best file's statistics."""
    _, _, extras, root = runs
    for seed in SEEDS:
        jdir = root / "jax" / f"seed{seed}"
        paths = sorted(str(jdir / n) for n in os.listdir(jdir))
        want = JC.average_params([JC.load_checkpoint(p)["params"]
                                  for p in paths])
        got = C.average_params([C.load_checkpoint(p)["params"]
                                for p in paths])
        w = flax_to_state_dict(jax.tree.map(
            lambda a: np.asarray(a, np.float32), want))
        g = flax_to_state_dict(C.average_params(
            [C.load_checkpoint(p)["params"] for p in paths], np.float32))
        assert all(np.asarray(leaf).dtype == np.float64
                   for leaf in jax.tree.leaves(got))
        assert w.keys() == g.keys()
        for k in w:
            assert torch.equal(w[k], g[k]), k
        entries = extras[seed]["entries"]
        mine = C.average_params([C.load_checkpoint(p)["params"]
                                 for _, p in entries], np.float32)
        best = C.load_checkpoint(entries[0][1])["batch_stats"]
        sd = flax_to_state_dict(mine, best)
        for k, v in extras[seed]["avg_state"].items():
            assert torch.equal(sd[k], v), k


def test_tracker_averaged_params(tmp_path):
    """``BestKTracker.averaged_params``: the kept checkpoints' average."""
    model = duett.DuettClassifier(DuettConfig(**DUETT))
    tr = C.BestKTracker(str(tmp_path), k=2, mode="max", prefix="ft")
    sds = []
    for step, metric in ((1, 0.5), (2, 0.7), (3, 0.6)):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.1 * step)
        sds.append({k: v.clone() for k, v in model.state_dict().items()})
        tr.offer(metric, model, step)
    avg = flax_to_state_dict(tr.averaged_params(np.float32))
    for k, v in avg.items():
        want = ((sds[1][k].double() + sds[2][k].double()) / 2).float()
        assert torch.equal(v, want), k


def test_evaluation_clamps_the_batch_and_refuses_an_empty_split():
    ds = S.make_synthetic(**COHORT)
    data = SL.build_stay_label_dataset(
        ds, P.meta_from_events(ds, DataConfig()), T)
    model = duett.init_classifier(DuettConfig(**DUETT), 0)
    _, eval_step = F.make_finetune_steps(T, torch.float32, None)
    n = data.split_size("val")
    assert 0 < n < 1000
    r = F.evaluate_split(eval_step, model, data, "val", 1000)
    assert np.isfinite(r["auroc"]) and np.isfinite(r["auprc"])
    data.samples["val"] = data.samples["val"][:0]
    with pytest.raises(ValueError, match="val split is empty"):
        F.evaluate_split(eval_step, model, data, "val", 32)


def test_cli_finetunes_on_the_cpu(tmp_path):
    """``cli.finetune_mimic`` at a tiny size: per seed its top-k files, and
    a finite summary."""
    out = finetune_mimic.main([
        "--device", "cpu", "--synthetic_stays", "90", "--n_variables", "6",
        "--d_embedding", "8", "--n_duett_layers", "1", "--epochs", "2",
        "--batch_size", "16", "--seeds", "3", "--top_k", "2",
        "--mixed_precision", "bf16", "--ckpt_dir", str(tmp_path)])
    assert [r["seed"] for r in out["per_seed"]] == [3]
    assert len(os.listdir(tmp_path / "seed3")) == 2
    assert np.isfinite(out["test_auprc_mean"])
