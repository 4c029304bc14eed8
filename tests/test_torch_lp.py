"""LP mode, the correction-only linear probe, in the port against the JAX
package: the optimizer's groups (``teacher_loop.lp_frozen_label_fn``), one
LP step (``engine.make_teacher_step(lp_mode=True)``) and LP through the
CLI from a ``dual_patch_event`` checkpoint.

The step runs with augmentation, dropout and a correction-head dropout all
set, as an LP run's config has them: JAX's LP step runs the model with
``train=False``, so none of them applies, and BatchNorm keeps its
statistics. The geometry is ``tests/test_torch_dual.py``'s, float32 on the
CPU. Tolerances: losses ≤1e-5; the trained leaves' gradients ≤1e-4 of
their largest magnitude; the parameters after one update ≤1e-5; every
other parameter and every BatchNorm statistic bit-equal to the start.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_edema_prediction_tpu.config import (
    DuettConfig as JDuett, OptimConfig as JOptim, PerceiverConfig as JPerc,
    TeacherConfig as JTeacher, TrainConfig as JTrain, ViTConfig as JViT)
from multimodal_edema_prediction_tpu.data import features as JF
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.train import engine as jengine
from multimodal_edema_prediction_tpu.train import teacher_loop as JL
from multimodal_edema_prediction_tpu.train.optim import make_optimizer
from multimodal_edema_prediction_tpu.train.state import TrainState as JState
from multimodal_edema_prediction_tpu_torch.cli import train_teacher as cli
from multimodal_edema_prediction_tpu_torch.config import (TeacherConfig,
                                                          TrainConfig)
from multimodal_edema_prediction_tpu_torch.convert import (flax_paths,
                                                           flax_to_state_dict,
                                                           load_flax)
from multimodal_edema_prediction_tpu_torch.data import features as F
from multimodal_edema_prediction_tpu_torch.models.teacher import TeacherModel
from multimodal_edema_prediction_tpu_torch.train import engine
from multimodal_edema_prediction_tpu_torch.train import teacher_loop as L
from multimodal_edema_prediction_tpu_torch.train.checkpoint import \
    load_checkpoint
from multimodal_edema_prediction_tpu_torch.train.optim import MultiGroupAdamW
from multimodal_edema_prediction_tpu_torch.train.state import TrainState
from torch_port_util import init_perturbed

B, T, V, N_STAYS, LEN, N_IMG = 4, 24, 5, 6, 30, 3
JCFG = JTeacher(
    duett=JDuett(n_variables=V, n_timesteps=T, d_embedding=8, n_layers=1,
                 d_feedforward=16, d_hidden_mlp_embedding=8,
                 d_hidden_tab_encoder=8, aug_noise=0.3, aug_mask=0.2,
                 transformer_dropout=0.2),
    vit=JViT(image_size=56, patch_size=14, d_model=32, n_layers=1, n_heads=2,
             d_feedforward=64),
    perceiver=JPerc(n_pathologies=7, d_latent=32, n_heads=2, dropout=0.2,
                    head_dropout=0.2, head_hidden=16,
                    correction_dropout=0.3))
LP = dict(lp_beta_l2=0.3, lp_corr_l2=0.5)
STEP = dict(dtype="float32", optim=dict(lr=2e-2, warmup_steps=2,
                                        weight_decay=1e-2))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recorder():
    """An optax transformation that keeps the gradients in its state and
    passes them on unchanged."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, st, p=None: (u, u))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    pixels = rng.normal(size=(N_IMG, 56, 56, 3)).astype(np.float32)
    grid = np.concatenate([rng.normal(size=(N_STAYS, LEN, V)),
                           rng.integers(0, 4, size=(N_STAYS, LEN, V))],
                          -1).astype(np.float32)
    static = rng.normal(size=(N_STAYS, 18)).astype(np.float32)
    rows = np.array([2, 0, 2, 1], np.int32)
    batch = {"stay_rows": np.array([0, 3, 5, 3], np.int32),
             "slot_idx": np.array([24, 30, 27, 25], np.int32),
             "image_ids": rows,
             "y_multi": (rng.random((B, 7)) < 0.5).astype(np.float32),
             "y_multi_mask": (rng.random((B, 7)) < 0.8).astype(np.float32),
             "bin_ends": np.broadcast_to(np.arange(1, T + 1) / 24.0,
                                         (B, T)).astype(np.float32),
             "pixel_values": pixels[rows]}
    x_in = np.concatenate([grid[:2, :T], np.zeros((2, T, 1), np.float32)],
                          -1)
    weights = {mode: init_perturbed(JT(JCFG.replace(perceiver_type=mode)),
                                    x_in, static[:2], batch["bin_ends"][:2],
                                    pixels[:2])
               for mode in L.LP_MODES}
    return dict(pixels=pixels, grid=grid, static=static, batch=batch,
                weights=weights)


def test_lp_groups_match_jax(setup):
    """Every leaf of an LP teacher lands in JAX's group: the correction
    head and β train, everything else, BatchNorm's parameters and the
    frozen ViT included, is frozen."""
    model = load_flax(TeacherModel(TeacherConfig.from_dict(JCFG.replace(
        perceiver_type="dual_patch_event").to_dict())),
        *setup["weights"]["dual_patch_event"])
    paths = [p for kind, p in flax_paths(model).values() if kind == "params"]
    labels = {p: L.lp_frozen_label_fn(p) for p in paths}
    assert labels == {p: JL.lp_frozen_label_fn(p) for p in paths}
    trained = sorted(p for p, lab in labels.items() if lab != "frozen")
    assert trained[0] == "perceiver/beta" and all(
        p.startswith("perceiver/correction_head/") for p in trained[1:])
    assert L.LP_TRAINABLE == JL.LP_TRAINABLE


def _jax_lp_step(s, mode, tier):
    jcfg = JCFG.replace(perceiver_type=mode)
    jmodel = JT(jcfg)
    params, stats = s["weights"][mode]
    run = JTrain(**{**STEP, "optim": JOptim(**STEP["optim"])})
    tx = optax.chain(_recorder(), make_optimizer(
        run.optim, 10, label_fn=JL.lp_frozen_label_fn))
    fs = None
    if tier == "features":
        fs = JF.CXRFeatureBank.build(
            JF.encode_fn_for_teacher(jmodel, params, jnp.float32),
            lambda ids: s["pixels"][np.asarray(ids)], np.arange(N_IMG),
            out_dtype=np.float32).feature_source()
    step = jengine.make_teacher_step(
        jmodel, run, jcfg.duett, T, np.ones(7, np.float32), None,
        jnp.float32, image_source=lambda b: b["pixel_values"], lp_mode=True,
        feature_source=fs, **LP)
    new, out = step(JState.create(params, stats, tx),
                    jnp.asarray(s["grid"]), jnp.asarray(s["static"]),
                    jax.tree.map(jnp.asarray, s["batch"]), jax.random.key(0))
    return jax.tree.map(np.asarray, (out, new.opt_state[0], new.params,
                                     new.batch_stats))


def _port_lp_step(s, mode, tier):
    cfg = TeacherConfig.from_dict(JCFG.replace(perceiver_type=mode)
                                  .to_dict())
    model = load_flax(TeacherModel(cfg), *s["weights"][mode])
    run = TrainConfig.from_dict(STEP)
    state = TrainState(model, MultiGroupAdamW(
        model, run.optim, 10, label_fn=L.lp_frozen_label_fn))
    fs = None
    if tier == "features":
        fs = F.CXRFeatureBank.build(
            F.encode_fn_for_teacher(model, torch.float32),
            lambda ids: s["pixels"][np.asarray(ids)], np.arange(N_IMG),
            out_dtype=torch.float32).feature_source()
    step = engine.make_teacher_step(
        run, cfg.duett, T, np.ones(7, np.float32), None, torch.float32,
        image_source=lambda b: b["pixel_values"], feature_source=fs,
        lp_mode=True, **LP)
    out = step(state, torch.from_numpy(s["grid"]),
               torch.from_numpy(s["static"]),
               engine.to_device(s["batch"], torch.device("cpu")),
               torch.Generator().manual_seed(0))
    return out, model


@pytest.mark.parametrize("mode,tier", [("dual_patch_event", "features"),
                                       ("dual_patch", "pixels")])
def test_lp_step_matches_jax(setup, mode, tier):
    want, jgrads, jparams, jstats = _jax_lp_step(setup, mode, tier)
    got, model = _port_lp_step(setup, mode, tier)
    for k in ("total", "img_total", "ts_total", "fus_total", "reg_beta_l2",
              "reg_corr_l2", "main_logit"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert float(got["reg_beta_l2"]) > 0 and float(got["reg_corr_l2"]) > 0
    start = flax_to_state_dict(*setup["weights"][mode])
    jg = flax_to_state_dict(jgrads)
    after = flax_to_state_dict(jparams, jstats)
    lp = ("perceiver.correction_head.", "perceiver.beta")
    named, sd = dict(model.named_parameters()), model.state_dict()
    for name, v in sd.items():
        if name.startswith(lp):
            g = jg[name].numpy()
            scale = np.abs(g).max()
            np.testing.assert_allclose(named[name].grad.numpy() / scale,
                                       g / scale, atol=1e-4, err_msg=name)
            np.testing.assert_allclose(v.numpy(), after[name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
            assert not torch.equal(v, start[name]), name
        else:
            # frozen leaves, BatchNorm statistics included: untouched, in
            # both packages
            assert torch.equal(v, start[name]), name
            assert torch.equal(after[name], start[name]), name
            if name in named:
                assert named[name].grad is None, name


@pytest.mark.parametrize("mode", ["single", "legacy", "dual"])
def test_lp_needs_a_beta(mode, tmp_path):
    """LP regularizes β and trains the correction head: a teacher of a
    mode without them is refused before any work (JAX fails there too)."""
    cfg = TeacherConfig.from_dict(JCFG.replace(perceiver_type=mode)
                                  .to_dict())
    with pytest.raises(ValueError, match="LP mode trains"):
        L.train_teacher(None, cfg, TrainConfig(), str(tmp_path),
                        ["label_edema"], device="cpu", lp_from="x.msgpack")


def test_lp_through_the_cli(tmp_path):
    """``dual_patch_event`` for 2 epochs through the CLI, then
    ``--lp_only_correction --lp_ckpt`` on its best checkpoint for 2 more:
    the LP checkpoint equals the start in every leaf but the correction
    head's and β, which moved; the sidecar keeps the LP dropout; each
    epoch records |β|."""
    base = ["--device", "cpu", "--vit_size", "tiny", "--synthetic_stays",
            "60", "--batch_size", "16", "--epochs", "2", "--limit_batches",
            "2", "--warmup_steps", "2", "--perceiver_type",
            "dual_patch_event", "--cxr_feature_cache", "hbm",
            "--no_save_state"]
    first = cli.main(base + ["--ckpt_dir", str(tmp_path / "event")])
    res = cli.main(base + ["--lp_only_correction", "--lp_ckpt",
                           first.best_path, "--lp_correction_dropout",
                           "0.25", "--ckpt_dir", str(tmp_path / "lp")])
    assert os.path.dirname(res.best_path).startswith(str(tmp_path / "lp"))
    for h in res.history:
        assert np.isfinite(h["train_total"]) and h["train_reg_beta_l2"] > 0
        assert h["lp_beta_max_abs"] >= h["lp_beta_mean_abs"] > 0
    before, after = (load_checkpoint(p) for p in (first.best_path,
                                                  res.best_path))
    assert after["config"]["model"]["perceiver"]["correction_dropout"] \
        == 0.25
    flat = dict(jax.tree_util.tree_flatten_with_path(before["params"])[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            after["params"])[0]:
        name = "/".join(k.key for k in path)
        if name.startswith(L.LP_TRAINABLE):
            continue
        np.testing.assert_array_equal(leaf, flat[path], err_msg=name)
    assert not np.array_equal(after["params"]["perceiver"]["beta"],
                              before["params"]["perceiver"]["beta"])
    for a, b in zip(jax.tree.leaves(after["batch_stats"]),
                    jax.tree.leaves(before["batch_stats"])):
        np.testing.assert_array_equal(a, b)
