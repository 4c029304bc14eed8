"""The port's teacher loop (``train/teacher_loop.py::train_teacher``) against
the JAX package's, end to end on the encode-once tier; what the loop and
the CLI refuse; and the CLI training the ViT (``--unfreeze_cxr``) on the
pixel tier. (The ``dual`` mode's loop is ``tests/test_torch_dual.py``'s,
resume and preemption ``tests/test_torch_resume.py``'s.)

Both loops start from the same converted weights on the same synthetic
cohort, with ``feature_cache="hbm"``, float32, dropout and augmentation off,
2 epochs × 2 batches of 16; the JAX side is driven as
``tests/test_feature_cache.py:207-225`` drives it, and both feature banks
are built from the same procedural pixels (the port's numpy source, handed
to the JAX loop as its image source). Tolerance: the per-epoch train losses
and val AUROCs within 5e-3 relative (the precedent of
``tests/test_student_loop_parity.py``).
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
from multimodal_edema_prediction_tpu.train import teacher_loop as JL
from multimodal_edema_prediction_tpu.train.checkpoint import \
    load_checkpoint as jax_load
from multimodal_edema_prediction_tpu_torch.cli import train_teacher as cli
from multimodal_edema_prediction_tpu_torch.config import (DataConfig,
                                                          TeacherConfig,
                                                          TrainConfig)
from multimodal_edema_prediction_tpu_torch.convert import load_flax, to_flax
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.models.teacher import (
    TeacherModel, init_teacher)
from multimodal_edema_prediction_tpu_torch.train import teacher_loop as L
from multimodal_edema_prediction_tpu_torch.train.checkpoint import \
    load_checkpoint

JCFG = JTeacher(
    duett=JDuett(n_variables=8, n_timesteps=24, d_static=18, d_embedding=8,
                 n_layers=1, d_feedforward=32, d_hidden_mlp_embedding=16,
                 d_hidden_tab_encoder=16),
    vit=JViT(image_size=56, patch_size=14, d_model=32, n_layers=2, n_heads=2,
             d_feedforward=64),
    perceiver=JPerc(n_pathologies=7, d_latent=32, n_heads=2, dropout=0.0,
                    head_dropout=0.0, head_hidden=16))
TRAIN = dict(batch_size=16, epochs=2, limit_batches=2, patience=3,
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("loops")
    hook = L.make_synthetic_pixel_hook(JCFG.vit.image_size)

    jds = JS.make_synthetic(**COHORT)
    jad = JP.build_anchor_dataset(jds, JP.meta_from_events(jds, JData()),
                                  JData())
    # host copies: the JAX loop donates its state's buffers
    variables = jax.tree.map(np.asarray, JL.init_teacher(
        JT(JCFG), JCFG, 16, 24, jax.random.key(0)))
    jres = JL.train_teacher(
        jad, JCFG, JTrain(**{**TRAIN, "optim": JOptim(**TRAIN["optim"])}),
        str(root / "jax"), JData().pathology_labels,
        init_variables=jax.tree.map(jax.numpy.asarray, variables),
        image_source=lambda b: hook(b)["pixel_values"],
        feature_cache="hbm")

    cfg = TeacherConfig.from_dict(JCFG.to_dict())
    ds = S.make_synthetic(**COHORT)
    ad = P.build_anchor_dataset(ds, P.meta_from_events(ds, DataConfig()),
                                DataConfig())
    model = load_flax(TeacherModel(cfg), variables["params"],
                      variables["batch_stats"])
    res = L.train_teacher(ad, cfg, TrainConfig.from_dict(TRAIN),
                          str(root / "port"), DataConfig().pathology_labels,
                          model=model, device="cpu", image_hook=hook,
                          feature_cache="hbm", log=lambda s: None)
    return jres, res, ad


def test_loop_matches_jax_per_epoch(runs):
    jres, res, _ = runs
    assert len(res.history) == len(jres.history) == 2
    for got, want in zip(res.history, jres.history):
        for k in ("train_total", "train_img_total", "train_ts_total",
                  "train_fus_total", "val_main_auroc"):
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3,
                                       err_msg=f"epoch {got['epoch']} {k}")
    np.testing.assert_allclose(res.best_metric, jres.best_metric, rtol=5e-3)
    np.testing.assert_allclose(res.test_metrics["main_auroc"],
                               jres.test_metrics["main_auroc"], rtol=5e-3)


def test_loop_bookkeeping(runs):
    _, res, ad = runs
    ex = res.extras
    assert ex["n_train_steps"] == 4
    # the val split once per epoch, the test split once at the end
    n_batches = {k: -(-ad.split_size(k) // 16) for k in ("val", "test")}
    assert ex["n_eval_steps"] == 2 * n_batches["val"] + n_batches["test"]
    assert set(ex["phase_seconds"]) == {"feature_build", "train", "eval"}
    # the best checkpoint reloads (as the test evaluation did) and its val
    # eval equals the loop's own at the best epoch
    model, _, _ = L.load_teacher_from_ckpt(res.best_path, device="cpu")
    again = ex["evaluate"](model, "val")
    assert again["main_auroc"] == res.best_metric
    np.testing.assert_array_equal(again["outputs"]["fus"],
                                  ex["best_val_outputs"]["fus"])


def _tiny(**kw):
    return TeacherConfig.from_dict({**JCFG.to_dict(), **kw})


# ROADMAP items done since their cases were written: their modes and
# flags now train where they used to raise
DONE = {"P13"}


def _cohort():
    ds = S.make_synthetic(**COHORT)
    return P.build_anchor_dataset(ds, P.meta_from_events(ds, DataConfig()),
                                  DataConfig())


@pytest.mark.parametrize("kw,match", [
    ({"perceiver_type": "single"}, "P13"),
    ({"perceiver_type": "legacy"}, "P13"),
    ({"perceiver_type": "dual_patch_event"}, "P13")])
def test_loop_refuses_what_is_not_ported(kw, match, tmp_path):
    """What the loop does not port raises naming its ROADMAP item; the
    modes of a done item (P13, the other teacher modes) train
    an epoch instead, on pixels, to a checkpoint of their mode."""
    if match not in DONE:
        with pytest.raises(NotImplementedError, match=match):
            L.train_teacher(None, _tiny(**kw), TrainConfig(), str(tmp_path),
                            DataConfig().pathology_labels, device="cpu")
        return
    res = L.train_teacher(
        _cohort(), _tiny(**kw),
        TrainConfig.from_dict({**TRAIN, "epochs": 1, "limit_batches": 1}),
        str(tmp_path), DataConfig().pathology_labels, device="cpu",
        log=lambda s: None)
    assert np.isfinite(list(res.history[0].values())[1])
    _, tcfg, _ = L.load_teacher_from_ckpt(res.best_path, device="cpu")
    assert tcfg.perceiver_type == kw["perceiver_type"]


@pytest.mark.parametrize("feature_cache", ["hbm", "auto"])
def test_loop_refuses_a_feature_cache_for_a_trainable_vit(feature_cache,
                                                          tmp_path):
    """The JAX loop's rule (``teacher_loop.py:204-207``): cached ViT tokens
    are constants, so a trainable CXR branch takes the pixel tier only."""
    with pytest.raises(ValueError, match="freeze_cxr=True"):
        L.train_teacher(None, _tiny(freeze_cxr=False), TrainConfig(),
                        str(tmp_path), DataConfig().pathology_labels,
                        device="cpu", feature_cache=feature_cache)


@pytest.mark.parametrize("argv,match", [
    (["--cxr_jpeg_root", "/x"], "P15"),
    (["--perceiver_type", "dual_patch_event"], "P13"),
    (["--state_backend", "orbax"], "P16"),
    (["--lp_only_correction"], "P13"),
    (["--perceiver_type", "single"], "P13"),
    (["--steps_per_call", "4"], "P10"),
    (["--vit_quant", "int8"], "P20")])
def test_cli_refuses_what_is_not_ported(argv, match, tmp_path):
    """What the CLI does not port raises naming its ROADMAP item; the flags
    of a done item (P13) train an epoch instead: the two modes, and LP mode
    from a checkpoint of the CLI's default mode."""
    base = ["--device", "cpu", "--vit_size", "tiny", "--synthetic_stays",
            "40"]
    if match not in DONE:
        with pytest.raises(NotImplementedError, match=match):
            cli.main(base + ["--ckpt_dir", str(tmp_path)] + argv)
        return
    run = base + ["--batch_size", "16", "--epochs", "1", "--limit_batches",
                  "1", "--warmup_steps", "1", "--cxr_feature_cache", "hbm",
                  "--no_save_state"]
    if argv == ["--lp_only_correction"]:
        start = cli.main(run + ["--ckpt_dir", str(tmp_path / "start")])
        argv = argv + ["--lp_ckpt", start.best_path]
    res = cli.main(run + ["--ckpt_dir", str(tmp_path / "run")] + argv)
    assert np.isfinite(list(res.history[0].values())[1])
    if "--lp_only_correction" in argv:
        assert "lp_beta_mean_abs" in res.history[0]


def test_cli_trains_on_the_cpu_when_asked(tmp_path):
    res = cli.main(["--device", "cpu", "--vit_size", "tiny",
                    "--synthetic_stays", "60", "--batch_size", "16",
                    "--epochs", "1", "--limit_batches", "2",
                    "--warmup_steps", "2", "--cxr_feature_cache", "hbm",
                    "--ckpt_dir", str(tmp_path)])
    assert np.isfinite(res.history[0]["train_total"])
    assert res.best_path.startswith(str(tmp_path))


@pytest.mark.parametrize("argv,error", [
    (["--unfreeze_cxr", "--vit_quant", "int8"], SystemExit),
    (["--unfreeze_cxr", "--cxr_feature_cache", "hbm"], ValueError)])
def test_cli_refuses_an_unfrozen_vit_it_cannot_train(argv, error, tmp_path):
    """As the JAX CLI: int8 matmuls are inference-only (an argument error),
    and the encode-once tier needs a frozen branch."""
    with pytest.raises(error):
        cli.main(["--device", "cpu", "--vit_size", "tiny",
                  "--synthetic_stays", "40", "--ckpt_dir", str(tmp_path)]
                 + argv)


def test_cli_trains_the_vit_when_unfrozen(tmp_path):
    """``--unfreeze_cxr`` on the pixel tier: 2 batches on the CPU move the
    ViT's parameters (and DuETT's and the perceiver's). The checkpoint's
    trained ``cxr`` subtree reads the same in both packages' loaders, and
    round-trips torch → flax msgpack → torch → flax bit for bit."""
    res = cli.main(["--device", "cpu", "--vit_size", "tiny",
                    "--unfreeze_cxr", "--synthetic_stays", "60",
                    "--batch_size", "16", "--epochs", "1",
                    "--limit_batches", "2", "--warmup_steps", "2",
                    "--ckpt_dir", str(tmp_path)])
    assert np.isfinite(res.history[0]["train_total"])
    model, tcfg, ck = L.load_teacher_from_ckpt(res.best_path, device="cpu")
    assert not tcfg.freeze_cxr
    init = dict(init_teacher(tcfg, ck["config"]["train"]["seed"])
                .named_parameters())
    trained = dict(model.named_parameters())
    for prefix in ("cxr.", "duett.", "perceiver."):
        weights = [k for k in trained if k.startswith(prefix)
                   and trained[k].dim() >= 2]
        assert weights and all(not torch.equal(trained[k], init[k])
                               for k in weights), prefix
    ours = load_checkpoint(res.best_path)["params"]["cxr"]
    theirs = jax_load(res.best_path)["params"]["cxr"]
    again = to_flax(model)[0]["cxr"]
    flat = jax.tree_util.tree_flatten_with_path(ours)[0]
    for other in (theirs, again):
        other = dict(jax.tree_util.tree_flatten_with_path(other)[0])
        assert len(other) == len(flat) > 0
        for path, leaf in flat:
            np.testing.assert_array_equal(np.asarray(other[path]), leaf,
                                          err_msg=str(path))
