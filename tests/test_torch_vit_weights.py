"""``--vit_weights``: the port's ``models/vit.py::load_vit_params`` on a
converted RAD-DINO checkpoint, and the training CLI that starts the CXR
branch from it.

No network here, so the "real" model is a randomly initialized HF
``Dinov2Model`` saved locally and converted by ``scripts/convert_rad_dino.py``
(as ``tests/test_rad_dino_convert.py`` does), at the CLI's ``--vit_size
tiny`` geometry (56², patch 14, d 64, 2 layers, 2 heads, ff 128).

Tolerances: the port's ViT loaded through ``load_vit_params`` against the
JAX ViT loaded through the JAX package's ``load_vit_params``, ≤1e-5 at
float32; the CLI's checkpoint carries the loaded (frozen) ViT bit for bit
(the fast-tier mirror of the JAX package's slow
``test_teacher_cli_vit_weights``).
"""
import glob
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.config import ViTConfig as JViTConfig
from multimodal_edema_prediction_tpu.models import vit as JV
from multimodal_edema_prediction_tpu.train.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from multimodal_edema_prediction_tpu_torch.cli import train_teacher as cli
from multimodal_edema_prediction_tpu_torch.config import ViTConfig
from multimodal_edema_prediction_tpu_torch.models import vit as PV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(image_size=56, patch_size=14, d_model=64, n_layers=2, n_heads=2,
            d_feedforward=128)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Path of a converted random HF Dinov2 checkpoint at the tiny
    geometry."""
    from transformers import Dinov2Config, Dinov2Model
    root = tmp_path_factory.mktemp("vit_weights")
    torch.manual_seed(0)
    Dinov2Model(Dinov2Config(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        mlp_ratio=2, image_size=56, patch_size=14, layerscale_value=1.0,
        hidden_act="gelu")).eval().save_pretrained(root / "hf")
    spec = importlib.util.spec_from_file_location(
        "convert_rad_dino", os.path.join(REPO, "scripts/convert_rad_dino.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = str(root / "vit.msgpack")
    script.main(["--source", str(root / "hf"), "--out", out,
                 "--image_size", "56", "--d_model", "64", "--n_layers", "2",
                 "--n_heads", "2", "--d_feedforward", "128", "--skip_verify"])
    return out


def test_loaded_vit_matches_jax(converted):
    px = np.random.default_rng(0).normal(size=(2, 56, 56, 3)).astype(
        np.float32)
    jcfg = JViTConfig(**TINY)
    jparams = JV.load_vit_params(converted, jcfg)
    jcls, jpatch = JV.DinoViT(jcfg).apply({"params": jparams}, px)
    model = PV.DinoViT(ViTConfig(**TINY))
    model.load_state_dict(PV.load_vit_params(converted, ViTConfig(**TINY)))
    with torch.no_grad():
        cls, patch = model(torch.from_numpy(px))
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(patch.numpy(), np.asarray(jpatch), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("bad", [dict(n_layers=3), dict(d_feedforward=64),
                                 dict(image_size=70)])
def test_wrong_geometry_raises(converted, bad):
    """A missing block, a misshapen MLP, another position-embedding length:
    each raises ``ValueError`` naming the checkpoint."""
    with pytest.raises(ValueError, match="vit.msgpack"):
        PV.load_vit_params(converted, ViTConfig(**{**TINY, **bad}))


def test_cli_trains_from_loaded_vit_weights(converted, tmp_path):
    """Two batches of the frozen-branch teacher on the CPU from the loaded
    ViT; the checkpoint carries the loaded ViT bit for bit, read by both
    packages' loaders."""
    res = cli.main(["--device", "cpu", "--vit_size", "tiny",
                    "--vit_weights", converted, "--synthetic_stays", "40",
                    "--batch_size", "8", "--epochs", "1",
                    "--limit_batches", "2", "--warmup_steps", "2",
                    "--ckpt_dir", str(tmp_path)])
    assert np.isfinite(res.history[0]["train_total"])
    ck = glob.glob(os.path.join(str(tmp_path), "*", "best-*.msgpack"))
    assert ck == [res.best_path]
    trained = jax_load_checkpoint(ck[0])["params"]["cxr"]
    loaded = jax_load_checkpoint(converted)["params"]
    flat_t = jax.tree_util.tree_flatten_with_path(trained)[0]
    flat_l = dict(jax.tree_util.tree_flatten_with_path(loaded)[0])
    assert len(flat_t) == len(flat_l) > 0
    for path, leaf in flat_t:
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(flat_l[path]),
                                      err_msg=str(path))
