"""The port's teacher loop (``train/teacher_loop.py::train_teacher``) in the
``single`` and ``legacy`` modes against the JAX package's, 2 epochs end to
end, and every other mode's checkpoints read across the packages
(``checkpoint.load_teacher_from_ckpt``).

The cohort, weights' geometry and schedule are
``tests/test_torch_teacher_loop.py``'s: float32, dropout and augmentation
off, 2 epochs × 2 batches of 16, the same converted weights on both sides.
``single`` trains on the encode-once tier (both banks built from the
port's procedural pixels); ``legacy``, which takes pixels only, reads the
same pixels in both packages through the dataset's batch hook. Tolerances:
per-epoch train losses and val AUROC within 5e-3 relative (the loop-parity
precedent, ``tests/test_student_loop_parity.py``); checkpoints read across
the packages ≤1e-5.
"""
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
from multimodal_edema_prediction_tpu.train import engine as jengine
from multimodal_edema_prediction_tpu.train import kd_loop as JK
from multimodal_edema_prediction_tpu.train import teacher_loop as JL
from multimodal_edema_prediction_tpu.train.checkpoint import \
    save_checkpoint as jax_save
from multimodal_edema_prediction_tpu_torch.config import (DataConfig,
                                                          TeacherConfig,
                                                          TrainConfig)
from multimodal_edema_prediction_tpu_torch.convert import load_flax
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.models.teacher import TeacherModel
from multimodal_edema_prediction_tpu_torch.train import teacher_loop as L
from torch_port_util import init_perturbed, t

LABELS = JData().pathology_labels
JCFG = JTeacher(
    duett=JDuett(n_variables=8, n_timesteps=24, d_static=18, d_embedding=8,
                 n_layers=1, d_feedforward=32, d_hidden_mlp_embedding=16,
                 d_hidden_tab_encoder=16),
    vit=JViT(image_size=56, patch_size=14, d_model=32, n_layers=2, n_heads=2,
             d_feedforward=64),
    perceiver=JPerc(n_pathologies=7, d_latent=32, n_heads=2, dropout=0.0,
                    head_dropout=0.0, head_hidden=16, n_latents=4))
TRAIN = dict(batch_size=16, epochs=2, limit_batches=2, patience=3,
             dtype="float32", aux_stage2_alpha=0.7, aux_stage4_alpha=0.3,
             use_aux_cxr=True, aux_cxr_alpha=0.5,
             optim=dict(lr=2e-3, warmup_steps=2, weight_decay=1e-4))
COHORT = dict(seed=0, n_subjects=30, n_stays=60, n_variables=8, min_len=26,
              max_len=40)
HISTORY_KEYS = {
    "single": ("train_total", "train_stage2_total", "train_stage4_total",
               "val_main_auroc"),
    "legacy": ("train_loss", "train_main_loss", "train_aux_loss",
               "val_main_auroc")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These small models gain nothing from intra-op threads, and the suite
    runs several test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(mode, root):
    jcfg = JCFG.replace(perceiver_type=mode)
    hook = L.make_synthetic_pixel_hook(JCFG.vit.image_size)
    jds = JS.make_synthetic(**COHORT)
    jad = JP.build_anchor_dataset(jds, JP.meta_from_events(jds, JData()),
                                  JData())
    variables = jax.tree.map(np.asarray, JL.init_teacher(
        JT(jcfg), jcfg, 16, 24, jax.random.key(0)))
    cache = "hbm" if mode == "single" else "none"
    if cache == "none":
        # the port's pixels, attached on the host as a JPEG store's would be
        jad.batch_hook = lambda b: {**b,
                                    "pixel_values": hook(b)["pixel_values"]}
        source = jengine.default_image_source
    else:
        source = lambda b: hook(b)["pixel_values"]    # noqa: E731
    jres = JL.train_teacher(
        jad, jcfg, JTrain(**{**TRAIN, "optim": JOptim(**TRAIN["optim"])}),
        str(root / "jax"), LABELS,
        init_variables=jax.tree.map(jax.numpy.asarray, variables),
        image_source=source, feature_cache=cache)

    cfg = TeacherConfig.from_dict(jcfg.to_dict())
    ds = S.make_synthetic(**COHORT)
    ad = P.build_anchor_dataset(ds, P.meta_from_events(ds, DataConfig()),
                                DataConfig())
    model = load_flax(TeacherModel(cfg), variables["params"],
                      variables["batch_stats"])
    res = L.train_teacher(ad, cfg, TrainConfig.from_dict(TRAIN),
                          str(root / "port"), LABELS, model=model,
                          device="cpu", image_hook=hook, feature_cache=cache,
                          log=lambda s: None)
    return jres, res


@pytest.fixture(scope="module", params=["single", "legacy"])
def loops(request, tmp_path_factory):
    mode = request.param
    return (mode,) + _run(mode, tmp_path_factory.mktemp(f"{mode}_loops"))


def test_mode_loop_matches_jax_per_epoch(loops):
    mode, jres, res = loops
    assert len(res.history) == len(jres.history) == 2
    for got, want in zip(res.history, jres.history):
        for k in HISTORY_KEYS[mode]:
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3,
                                       err_msg=f"epoch {got['epoch']} {k}")
    np.testing.assert_allclose(res.best_metric, jres.best_metric, rtol=5e-3)
    np.testing.assert_allclose(res.test_metrics["main_auroc"],
                               jres.test_metrics["main_auroc"], rtol=5e-3)
    if mode == "legacy":        # the auxiliary head's loss is in the total
        assert res.history[0]["train_aux_loss"] > 0.0


def test_mode_loop_bookkeeping(loops):
    """The best checkpoint reloads, and the loop's own evaluation of it
    reads the val split as the loop did at the best epoch; ``single``'s
    table is the stage gap table."""
    mode, _, res = loops
    ex = res.extras
    model, tcfg, ck = L.load_teacher_from_ckpt(res.best_path, device="cpu")
    assert tcfg.perceiver_type == mode
    assert ck["config"]["train"]["aux_stage2_alpha"] == 0.7
    again = ex["evaluate"](model, "val")
    assert again["main_auroc"] == res.best_metric
    for k, v in ex["best_val_outputs"].items():
        np.testing.assert_array_equal(again["outputs"][k], v, err_msg=k)
    if mode == "single":
        assert "s4_auroc" in again["table"]
        assert set(again["per_label"][0]) >= {"stage2_auroc", "gap_auroc"}
    else:
        assert again["table"].startswith("binary:")


def _inputs():
    rng = np.random.default_rng(4)
    x_in = np.concatenate([rng.normal(size=(2, 24, 8)),
                           rng.integers(0, 4, size=(2, 24, 8)),
                           np.zeros((2, 24, 1))], -1).astype(np.float32)
    return (x_in, rng.normal(size=(2, 18)).astype(np.float32),
            np.tile(np.arange(1, 25, dtype=np.float32) / 24, (2, 1)),
            rng.normal(size=(2, 56, 56, 3)).astype(np.float32))


def _check_both_loaders(path):
    args = _inputs()
    jmodel, _, params, stats, _ = JK.load_teacher_from_ckpt(path)
    want = jmodel.apply({"params": params, "batch_stats": stats}, *args)
    model, _, _ = L.load_teacher_from_ckpt(path, device="cpu")
    with torch.no_grad():
        got = model(*map(t, args))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_mode_checkpoints_read_across_packages(loops):
    """Each package's best checkpoint of the mode, rebuilt by both
    loaders, gives the same outputs."""
    _, jres, res = loops
    for path in (jres.best_path, res.best_path):
        _check_both_loaders(path)


def test_a_jax_event_checkpoint_loads(tmp_path):
    """A ``dual_patch_event`` checkpoint as the JAX loop writes it
    (perturbed weights, its config sidecar) in the port's loader."""
    jcfg = JCFG.replace(perceiver_type="dual_patch_event")
    params, stats = init_perturbed(JT(jcfg), *_inputs())
    path = str(tmp_path / "best-step1-0.5.msgpack")
    jax_save(path, params, stats, 1, 0.5,
             config={"model": jcfg.to_dict(), "train": {},
                     "pathology_labels": list(LABELS)})
    _check_both_loaders(path)
