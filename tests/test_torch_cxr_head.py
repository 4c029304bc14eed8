"""The CXR linear-head stage of the port (``models/cxr_head.py``,
``train/cxr_head_loop.py``, ``cli/train_cxr_head.py``) against the JAX
package: the uncertain-label policy and the subject split exactly, the
frozen ViT's CLS features, the head's training, and its checkpoint read
across both packages.

Both packages see the same procedural pixels (the port's numpy source,
handed to the JAX function as its image source) and train from the same
initial head weights with dropout off, in float32 on the CPU.

Tolerances: CLS features ≤1e-5; the trained head's weights ≤1e-4 (50
full-batch AdamW updates, or mini-batch ones over the same permutation);
the best val macro AUROC equal (it is a function of the ranks of the val
logits); a checkpoint's head applied by the other package ≤1e-6.
"""
import jax
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.config import ViTConfig as JViT
from multimodal_edema_prediction_tpu.data import cxr_catalog as JC
from multimodal_edema_prediction_tpu.data import synthetic as JS
from multimodal_edema_prediction_tpu.models.cxr_head import \
    CXRLinearHead as JHead
from multimodal_edema_prediction_tpu.models.vit import DinoViT as JViTModel
from multimodal_edema_prediction_tpu.train import cxr_head_loop as JH
from multimodal_edema_prediction_tpu.train.checkpoint import \
    load_checkpoint as jax_load
from multimodal_edema_prediction_tpu_torch.cli import train_cxr_head as cli
from multimodal_edema_prediction_tpu_torch.config import (
    DEFAULT_PATHOLOGY_LABELS, ViTConfig)
from multimodal_edema_prediction_tpu_torch.convert import load_flax
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.models.cxr_head import \
    CXRLinearHead
from multimodal_edema_prediction_tpu_torch.models.vit import DinoViT
from multimodal_edema_prediction_tpu_torch.train import cxr_head_loop as H
from multimodal_edema_prediction_tpu_torch.train.checkpoint import \
    load_checkpoint
from multimodal_edema_prediction_tpu_torch.train.teacher_loop import \
    make_synthetic_pixel_hook
from torch_port_util import init_perturbed

LABELS = list(DEFAULT_PATHOLOGY_LABELS)
JVIT = JViT(image_size=56, patch_size=14, d_model=32, n_layers=2, n_heads=2,
            d_feedforward=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These small models gain nothing from intra-op threads, and the suite
    runs several test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def catalog():
    jds, ds = (m.make_synthetic(seed=0, n_stays=60, n_subjects=20)
               for m in (JS, S))
    np.testing.assert_array_equal(ds.cxr_catalog.labels,
                                  jds.cxr_catalog.labels)
    cat = ds.cxr_catalog
    # some CheXpert-style uncertain labels, and a row with no label at all
    labels = cat.labels.copy()
    rng = np.random.default_rng(0)
    labels[rng.random(labels.shape) < 0.1] = -1.0
    labels[3] = np.nan
    return cat.subject_ids, cat.image_ids, labels


@pytest.mark.parametrize("policy", ["to_positive", "to_zero", "keep"])
def test_uncertain_policy_matches_jax(catalog, policy):
    _, _, labels = catalog
    np.testing.assert_array_equal(H.apply_uncertain_policy(labels, policy),
                                  JC.apply_uncertain_policy(labels, policy))


def test_unknown_uncertain_policy_raises():
    with pytest.raises(ValueError, match="unknown uncertain policy"):
        H.apply_uncertain_policy(np.zeros((1, 7)), "to_half")


def test_split_matches_jax(catalog):
    subjects, _, labels = catalog
    want = JH.split_catalog_subjects(subjects, labels, 42)
    got = H.split_catalog_subjects(subjects, labels, 42)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert 3 not in np.concatenate(list(got.values()))  # the unlabeled row


@pytest.fixture(scope="module")
def features(catalog):
    _, image_ids, labels = catalog
    ids, labels = image_ids[:40], labels[:40]
    hook = make_synthetic_pixel_hook(JVIT.image_size)
    px = np.zeros((1, 56, 56, 3), np.float32)
    params, _ = init_perturbed(JViTModel(JVIT), px)
    # the JAX function traces its image source: index the same pixels there
    pixels = jax.numpy.asarray(hook({
        "image_ids": ids, "y_multi": np.nan_to_num(labels, nan=0.0)})
        ["pixel_values"])
    assert (np.diff(ids) == 1).all()
    want = JH.extract_cls_features(
        params, JVIT, lambda b: pixels[b["image_ids"] - int(ids[0])], ids,
        labels, batch_size=16)
    vit = load_flax(DinoViT(ViTConfig.from_dict(JVIT.to_dict())), params)
    return ids, labels, hook, vit, want


def test_cls_features_match_jax(features, tmp_path):
    ids, labels, hook, vit, want = features
    cache = str(tmp_path / "cls.npz")
    got = H.extract_cls_features(vit, hook, ids, labels, batch_size=16,
                                 cache_path=cache)
    assert got.shape == (40, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the cache is the JAX package's layout: each package reads the other's
    np.testing.assert_array_equal(np.load(cache)["cls"], got)
    np.testing.assert_array_equal(JH.extract_cls_features(
        None, JVIT, None, ids, labels, cache_path=cache), got)


@pytest.mark.parametrize("head_batch", [0, 64])
def test_head_training_matches_jax(catalog, tmp_path, head_batch):
    """The same CLS features and initial weights: the same splits, head
    weights ≤1e-4 after 50 epochs, the same best val macro AUROC; each
    package's checkpoint read by the other."""
    subjects, _, labels = catalog
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(len(labels), 24)).astype(np.float32)
    # a learnable signal: each label's logit in two feature columns
    feats[:, :7] += 0.8 * np.nan_to_num(labels, nan=0.0)
    splits = JH.split_catalog_subjects(subjects, labels, 42)
    jpath, path = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    want = JH.train_cxr_head(feats, labels, splits, LABELS, jpath,
                             dropout=0.0, seed=42, batch_size=head_batch)
    init = JHead(7, 0.0).init({"params": jax.random.key(42)},
                              feats[:2])["params"]
    head = load_flax(CXRLinearHead(24, 7, 0.0),
                     jax.tree.map(np.asarray, init))
    got = H.train_cxr_head(feats, labels, splits, LABELS, path,
                           dropout=0.0, seed=42, batch_size=head_batch,
                           head=head, device="cpu", log=lambda s: None)
    assert got["best_val_macro_auroc"] == want["best_val_macro_auroc"]
    assert got["test_macro_auroc"] == want["test_macro_auroc"]
    assert len(got["val_macro_auroc"]) == 50
    lin = want["params"]["linear"]
    np.testing.assert_allclose(got["head"].linear.weight.detach().numpy(),
                               np.asarray(lin["kernel"]).T, atol=1e-4)
    np.testing.assert_allclose(got["head"].linear.bias.detach().numpy(),
                               np.asarray(lin["bias"]), atol=1e-4)
    # checkpoints across the packages: layout, sidecar and values
    for written in (path, jpath):
        ours, other = load_checkpoint(written), jax_load(written)
        assert ours["config"] == other["config"] == {
            "label_cols": LABELS, "num_classes": 7,
            "kind": "cxr_linear_head"}
        assert ours["step"] == 50
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(
                np.asarray(other["params"]["linear"][k]),
                ours["params"]["linear"][k])
    x = feats[:5]
    jout = JHead(7, 0.0).apply({"params": jax_load(path)["params"]}, x)
    pout = load_flax(CXRLinearHead(24, 7), load_checkpoint(jpath)["params"])(
        torch.from_numpy(x))
    np.testing.assert_allclose(np.asarray(jout), got["head"](
        torch.from_numpy(x)).detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pout.detach().numpy(), JHead(7, 0.0).apply(
        {"params": want["params"]}, x), rtol=1e-6, atol=1e-6)


def test_cli_trains_the_head_on_the_cpu_when_asked(tmp_path):
    res = cli.main(["--device", "cpu", "--vit_size", "tiny",
                    "--synthetic_stays", "40", "--batch_size", "64",
                    "--epochs", "3", "--ckpt_dir", str(tmp_path),
                    "--feature_cache", str(tmp_path / "cls.npz")])
    assert res["ckpt_path"] == str(tmp_path / "cxr_linear_head.msgpack")
    assert np.isfinite(res["best_val_macro_auroc"])
    assert res["n_images"] == len(S.make_synthetic(
        seed=0, n_stays=40, n_subjects=13).cxr_catalog.image_ids)
    assert jax_load(res["ckpt_path"])["config"]["kind"] == "cxr_linear_head"


def test_cli_refuses_jpegs_and_defaults_to_the_card(tmp_path):
    """``--cxr_jpeg_root`` is ported (P15): a directory that lacks the
    catalog's JPEGs fails at the first one it reads, before any training;
    the device defaults to the card."""
    with pytest.raises(FileNotFoundError):
        cli.main(["--device", "cpu", "--vit_size", "tiny",
                  "--synthetic_stays", "40", "--ckpt_dir",
                  str(tmp_path / "run"), "--cxr_jpeg_root", str(tmp_path)])
    assert not (tmp_path / "run" / "cxr_linear_head.msgpack").exists()
    assert cli.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--vit_size", "tiny", "--synthetic_stays", "40",
                  "--ckpt_dir", str(tmp_path)])
