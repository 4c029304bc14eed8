"""The port's teacher loop on real JPEGs decoded for every batch
(``image_bank="stream"``: the decode runs in the prefetch worker) against
the JAX package's, as ``tests/test_torch_jpeg_loop.py`` holds the bank's:
the per-epoch losses and val AUROCs within 5e-3 relative; in the port,
the loop with ``prefetch_depth=0`` (the hook and the copy inline) equal
to the prefetched one bit for bit; the CLI's image flags reaching the
loop."""
import jax
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.config import (DataConfig as JData,
                                                    OptimConfig as JOptim,
                                                    TrainConfig as JTrain)
from multimodal_edema_prediction_tpu.data.images import JpegStore as JStore
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.train import teacher_loop as JL
from multimodal_edema_prediction_tpu_torch.config import (DataConfig,
                                                          TeacherConfig,
                                                          TrainConfig)
from multimodal_edema_prediction_tpu_torch.convert import load_flax
from multimodal_edema_prediction_tpu_torch.data.images import JpegStore
from multimodal_edema_prediction_tpu_torch.models.teacher import TeacherModel
from multimodal_edema_prediction_tpu_torch.train import teacher_loop as L
from test_torch_jpeg_loop import JCFG, KEYS, TRAIN, jpeg_cohort


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpeg_stream")
    jad, ad, blobs = jpeg_cohort()
    variables = jax.tree.map(np.asarray, JL.init_teacher(
        JT(JCFG), JCFG, 16, 24, jax.random.key(0)))
    jres = JL.train_teacher(
        jad, JCFG, JTrain(**{**TRAIN, "optim": JOptim(**TRAIN["optim"])}),
        str(root / "jax"), JData().pathology_labels,
        init_variables=jax.tree.map(jax.numpy.asarray, variables),
        jpeg_store=JStore(blobs=blobs), image_bank="stream")
    cfg = TeacherConfig.from_dict(JCFG.to_dict())

    def port(name, **kw):
        model = load_flax(TeacherModel(cfg), variables["params"],
                          variables["batch_stats"])
        return L.train_teacher(ad, cfg, TrainConfig.from_dict(TRAIN),
                               str(root / name), DataConfig().pathology_labels,
                               model=model, device="cpu",
                               jpeg_store=JpegStore(blobs=blobs),
                               image_bank="stream", log=lambda s: None, **kw)

    return jres, port("depth2"), port("depth0", prefetch_depth=0)


def test_stream_loop_matches_jax_per_epoch(runs):
    jres, res, _ = runs
    assert res.extras["image_tier"]["tier"] == "stream"
    for got, want in zip(res.history, jres.history):
        for k in KEYS:
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3,
                                       err_msg=f"epoch {got['epoch']} {k}")


def test_prefetch_changes_no_loss(runs):
    _, fetched, inline = runs
    assert fetched.history == inline.history
    assert fetched.extras["n_train_steps"] == inline.extras[
        "n_train_steps"] == 4


def test_a_bad_jpeg_stops_the_loop_naming_its_items(tmp_path):
    """A file that does not decode, met by the prefetch worker, raises in
    the loop with the JAX decoder's message."""
    _, ad, blobs = jpeg_cohort()
    bad = {k: b"\xff\xd8 broken" for k in blobs}
    cfg = TeacherConfig.from_dict(JCFG.to_dict())
    with pytest.raises(ValueError, match="JPEG decode failed for batch "
                                         "items"):
        L.train_teacher(ad, cfg, TrainConfig.from_dict(TRAIN),
                        str(tmp_path), DataConfig().pathology_labels,
                        device="cpu", jpeg_store=JpegStore(blobs=bad),
                        image_bank="stream", log=lambda s: None)
