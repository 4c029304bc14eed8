"""The port's teacher loop on real JPEGs against the JAX package's: 2
epochs × 2 batches of 16 from the same converted weights, float32, dropout
off, on the card tier's uint8 bank (``image_bank="hbm"``; a CPU tensor
here) within 5e-3 relative of JAX's per-epoch losses and val AUROCs (the
precedent of ``tests/test_student_loop_parity.py``); in the port, the disk
u8 store's loop (``u8_store_path``) equal to the bank's bit for bit, and
the loop without prefetching equal to the prefetched one. (``stream``:
``tests/test_torch_jpeg_stream.py``.)"""
import io

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_edema_prediction_tpu.config import (
    DataConfig as JData, DuettConfig as JDuett, OptimConfig as JOptim,
    PerceiverConfig as JPerc, TeacherConfig as JTeacher, TrainConfig as JTrain,
    ViTConfig as JViT)
from multimodal_edema_prediction_tpu.data import pipeline as JP
from multimodal_edema_prediction_tpu.data import synthetic as JS
from multimodal_edema_prediction_tpu.data.images import JpegStore as JStore
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.train import teacher_loop as JL
from multimodal_edema_prediction_tpu_torch.config import (DataConfig,
                                                          TeacherConfig,
                                                          TrainConfig)
from multimodal_edema_prediction_tpu_torch.convert import load_flax
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.data.images import JpegStore
from multimodal_edema_prediction_tpu_torch.models.teacher import TeacherModel
from multimodal_edema_prediction_tpu_torch.train import teacher_loop as L

TIER = "hbm"
JCFG = JTeacher(
    duett=JDuett(n_variables=8, n_timesteps=24, d_static=18, d_embedding=8,
                 n_layers=1, d_feedforward=32, d_hidden_mlp_embedding=16,
                 d_hidden_tab_encoder=16),
    vit=JViT(image_size=28, patch_size=14, d_model=16, n_layers=1, n_heads=2,
             d_feedforward=32),
    perceiver=JPerc(n_pathologies=7, d_latent=16, n_heads=2, dropout=0.0,
                    head_dropout=0.0, head_hidden=8))
TRAIN = dict(batch_size=16, epochs=2, limit_batches=2, patience=3,
             dtype="float32",
             optim=dict(lr=2e-3, warmup_steps=2, weight_decay=1e-4))
COHORT = dict(seed=0, n_subjects=30, n_stays=60, n_variables=8, min_len=26,
              max_len=40)
KEYS = ("train_total", "train_img_total", "train_ts_total",
        "train_fus_total", "val_main_auroc")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jpeg_cohort():
    """The JAX and the port's anchor datasets of one cohort, and a JPEG per
    image id (grayscale and RGB, PIL-written, distinct per id)."""
    jds = JS.make_synthetic(**COHORT)
    jad = JP.build_anchor_dataset(jds, JP.meta_from_events(jds, JData()),
                                  JData())
    ds = S.make_synthetic(**COHORT)
    ad = P.build_anchor_dataset(ds, P.meta_from_events(ds, DataConfig()),
                                DataConfig())
    rng = np.random.default_rng(0)
    blobs = {}
    for i in np.unique(jad.anchor["image_ids"]):
        shape = (40, 36) if i % 2 else (30, 44, 3)
        buf = io.BytesIO()
        Image.fromarray((rng.random(shape) * 255).astype(np.uint8)).save(
            buf, format="JPEG")
        blobs[int(i)] = buf.getvalue()
    return jad, ad, blobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpeg_loop")
    jad, ad, blobs = jpeg_cohort()
    variables = jax.tree.map(np.asarray, JL.init_teacher(
        JT(JCFG), JCFG, 16, 24, jax.random.key(0)))
    jres = JL.train_teacher(
        jad, JCFG, JTrain(**{**TRAIN, "optim": JOptim(**TRAIN["optim"])}),
        str(root / "jax"), JData().pathology_labels,
        init_variables=jax.tree.map(jax.numpy.asarray, variables),
        jpeg_store=JStore(blobs=blobs), image_bank=TIER)
    cfg = TeacherConfig.from_dict(JCFG.to_dict())

    def port(name, **kw):
        model = load_flax(TeacherModel(cfg), variables["params"],
                          variables["batch_stats"])
        return L.train_teacher(ad, cfg, TrainConfig.from_dict(TRAIN),
                               str(root / name), DataConfig().pathology_labels,
                               model=model, device="cpu",
                               jpeg_store=JpegStore(blobs=blobs),
                               log=lambda s: None, **kw)

    return jres, {
        "bank": port("bank", image_bank="hbm"),
        "u8_store": port("u8", image_bank="stream",
                         u8_store_path=str(root / "store" / "u8")),
        "bank_inline": port("inline", image_bank="hbm", prefetch_depth=0)}


def test_bank_loop_matches_jax_per_epoch(runs):
    jres, res = runs[0], runs[1]["bank"]
    assert len(res.history) == len(jres.history) == 2
    for got, want in zip(res.history, jres.history):
        for k in KEYS:
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3,
                                       err_msg=f"epoch {got['epoch']} {k}")
    np.testing.assert_allclose(res.test_metrics["main_auroc"],
                               jres.test_metrics["main_auroc"], rtol=5e-3)


@pytest.mark.parametrize("other", ["u8_store", "bank_inline"])
def test_loops_equal_the_bank_loop_bit_for_bit(runs, other):
    """The disk store's rows normalized in the step equal the bank's
    gathered and normalized rows; prefetching changes no step."""
    bank, res = runs[1]["bank"], runs[1][other]
    assert res.history == bank.history
    assert res.test_metrics["main_auroc"] == bank.test_metrics["main_auroc"]


def test_tiers_as_chosen(runs):
    tiers = {k: r.extras["image_tier"] for k, r in runs[1].items()}
    assert tiers["bank"]["tier"] == "hbm" == tiers["bank_inline"]["tier"]
    assert tiers["u8_store"]["tier"] == "u8_store"
    n = tiers["bank"]["n_images"]
    assert tiers["bank"]["bytes"] == n * 3 * 28 * 28
    assert "image_build" in runs[1]["bank"].extras["phase_seconds"]

