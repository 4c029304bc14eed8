"""The host tier of the port's encode-once feature cache
(``data/features.py::HostFeatureStore``, ``features_from_batch``), the raw-id
feature source, and the teacher loop's ``host`` and ``auto`` tiers, after
the JAX package's ``tests/test_feature_cache.py:167, :206, :236, :274``.

What is held, and how closely:
- a store in RAM and one on disk give the bank's tokens bit for bit, and a
  disk store reopens on a matching fingerprint and refuses another image
  set;
- the store's files are the JAX package's, byte for byte, for the same
  tokens (float32, and bf16 as ml_dtypes writes it: ``'<V2'``); a store
  written by either package opens in the other with equal bits;
- ``CXRFeatureBank.feature_source(keyed_by_row=False)`` gathers what JAX's
  does for the same raw ids, an unknown id as the NaN row;
- ``make_teacher_eval_from_windows(feature_source=…)`` equals the pixel
  path within 1e-4 (float32);
- the teacher loop on the ``host`` tier (RAM and disk) and on ``auto`` past
  its budget trains exactly as on ``hbm`` (float32, the same tokens), and a
  step on other images' tokens does not.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.data import features as JF
from multimodal_edema_prediction_tpu_torch.cli import train_teacher as cli
from multimodal_edema_prediction_tpu_torch.config import (
    DataConfig, DuettConfig, PerceiverConfig, TeacherConfig, TrainConfig,
    ViTConfig)
from multimodal_edema_prediction_tpu_torch.data import features as F
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.models.teacher import init_teacher
from multimodal_edema_prediction_tpu_torch.train import engine
from multimodal_edema_prediction_tpu_torch.train import teacher_loop as L
from multimodal_edema_prediction_tpu_torch.train.optim import MultiGroupAdamW
from multimodal_edema_prediction_tpu_torch.train.state import TrainState

N_IMG, SIDE = 11, 4        # pixels [SIDE, SIDE, 3] → cls [6], patches [8, 6]
CPU = torch.device("cpu")


def _pixels(ids) -> np.ndarray:
    return np.stack([np.random.default_rng(int(i)).normal(
        size=(SIDE, SIDE, 3)) for i in np.asarray(ids)]).astype(np.float32)


def _tokens(px: np.ndarray):
    """A stand-in encoder's tokens, the same float32 values in both
    packages: cls [n, 6], patches [n, 8, 6]."""
    n = len(px)
    flat = px.reshape(n, 8, 6)
    return flat.sum(axis=1) * np.float32(0.5), flat * np.float32(1.5)


def port_encode(px):
    c, p = _tokens(np.asarray(px, np.float32))
    return torch.from_numpy(c), torch.from_numpy(p)


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


IDS = np.arange(N_IMG) * 7 + 3           # raw ids: id != row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("on_disk", [False, True])
def test_store_gives_the_bank_tokens(dtype, on_disk, tmp_path):
    bank = F.CXRFeatureBank.build(port_encode, _pixels, IDS, chunk=4,
                                  out_dtype=dtype)
    path = str(tmp_path / "feat") if on_disk else None
    st = F.HostFeatureStore.build(port_encode, _pixels, IDS[::-1], chunk=4,
                                  path=path, out_dtype=dtype)
    assert isinstance(st.patches, np.memmap) == on_disk
    ids = IDS[[3, 0, 10, 3, 7, 1, 2, 9, 5]]          # 9 rows: threaded
    rows = bank.rows_for(ids)
    b = st.host_fn()({"image_ids": ids, "y": np.zeros(len(ids))})
    cls, patches = F.features_from_batch(b)
    assert cls.dtype == patches.dtype == dtype
    assert cls.shape == (9, 6) and patches.shape == (9, 8, 6)
    np.testing.assert_array_equal(_bits(cls), _bits(bank.cls[rows]))
    np.testing.assert_array_equal(_bits(patches), _bits(bank.patches[rows]))
    with pytest.raises(KeyError, match="not in feature store"):
        st.rows_for(np.array([IDS[0], 4]))


def test_store_reopens_on_its_fingerprint_and_refuses_another(tmp_path):
    path = str(tmp_path / "sub" / "feat")
    calls = []

    def encode(px):
        calls.append(len(px))
        return port_encode(px)

    F.HostFeatureStore.build(encode, _pixels, IDS, chunk=4, path=path)
    assert len(calls) == 3                      # 11 images in chunks of 4
    again = F.HostFeatureStore.build(encode, _pixels, IDS, chunk=4,
                                     path=path)
    assert len(calls) == 3 and isinstance(again.cls, np.memmap)
    with pytest.raises(ValueError, match="different image set"):
        F.HostFeatureStore.build(encode, _pixels, IDS[:-2], path=path)
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    with open(path + ".meta.json", "w") as f:
        json.dump({**meta, "complete": False}, f)
    with pytest.raises(ValueError, match="incomplete"):
        F.HostFeatureStore.open(path)


@pytest.mark.parametrize("bf16", [False, True])
def test_store_files_are_the_jax_package_s(bf16, tmp_path):
    """The same tokens written by both packages give the same four files
    byte for byte; each package opens the other's store with equal bits
    (JAX reads bf16 items as 2-byte voids, as numpy without ml_dtypes
    does)."""
    jpath, ppath = str(tmp_path / "jax" / "f"), str(tmp_path / "port" / "f")
    JF.HostFeatureStore.build(lambda px: _tokens(np.asarray(px)), _pixels,
                              IDS, chunk=4, path=jpath,
                              out_dtype=None if bf16 else np.float32)
    F.HostFeatureStore.build(port_encode, _pixels, IDS, chunk=4, path=ppath,
                             out_dtype=torch.bfloat16 if bf16
                             else torch.float32)
    for suffix in (".ids.npy", ".cls.npy", ".patches.npy", ".meta.json"):
        with open(jpath + suffix, "rb") as a, open(ppath + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    ids = IDS[[4, 4, 0, 9]]
    from_jax = F.HostFeatureStore.open(jpath).get_batch(ids)
    from_port = JF.HostFeatureStore.open(ppath).get_batch(ids)
    c, p = _tokens(_pixels(ids))
    for got_p, got_j, want in zip(from_jax, from_port, (c, p)):
        if bf16:
            want = _bits(torch.from_numpy(want).to(torch.bfloat16))
            assert got_j.dtype == np.dtype("V2")
            got_j = got_j.view(np.int16)
        np.testing.assert_array_equal(got_p, want)
        np.testing.assert_array_equal(got_j, want)


def test_feature_source_keyed_by_raw_ids_matches_jax():
    jbank = JF.CXRFeatureBank.build(lambda px: _tokens(np.asarray(px)),
                                    _pixels, IDS, chunk=4,
                                    out_dtype=np.float32)
    bank = F.CXRFeatureBank.build(port_encode, _pixels, IDS, chunk=4,
                                  out_dtype=torch.float32)
    ids = np.array([IDS[5], 999999, IDS[0], IDS[10], 4, IDS[5]], np.int32)
    want = jbank.feature_source(keyed_by_row=False)(
        {"image_ids": jnp.asarray(ids)})
    got = bank.feature_source(keyed_by_row=False)(
        {"image_ids": torch.from_numpy(ids)})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.isnan(got[1][[1, 4]].numpy()).all()
    assert np.isfinite(got[1][[0, 2, 3, 5]].numpy()).all()


TINY = TeacherConfig(
    duett=DuettConfig(n_variables=8, n_timesteps=24, d_static=18,
                      d_embedding=8, n_layers=1, d_feedforward=32,
                      d_hidden_mlp_embedding=16, d_hidden_tab_encoder=16),
    vit=ViTConfig(image_size=56, patch_size=14, d_model=32, n_layers=2,
                  n_heads=2, d_feedforward=64),
    perceiver=PerceiverConfig(n_pathologies=7, d_latent=32, n_heads=2,
                              dropout=0.0, head_dropout=0.0, head_hidden=16))


def test_eval_from_windows_on_raw_id_features_equals_pixels():
    """Counterfactual evaluation on cached tokens: raw image ids through
    ``keyed_by_row=False`` give the pixel path's outputs (≤1e-4, float32),
    and an unknown id gives NaN image logits in its row only."""
    model = init_teacher(TINY, 0).eval()
    rng = np.random.default_rng(0)
    S_ = TINY.vit.image_size
    pix = {int(i): rng.normal(size=(S_, S_, 3)).astype(np.float32)
           for i in IDS}

    def pixels_for_ids(ids):
        return np.stack([pix[int(i)] for i in ids])

    bank = F.CXRFeatureBank.build(F.encode_fn_for_teacher(model,
                                                          torch.float32),
                                  pixels_for_ids, IDS, chunk=4,
                                  out_dtype=torch.float32)
    B, T = 6, 24
    x_ts = rng.normal(size=(B, T, 16)).astype(np.float32)
    x_static = rng.normal(size=(B, 18)).astype(np.float32)
    ids = IDS[[2, 0, 7, 2, 10, 5]].astype(np.int32)
    bin_ends = np.tile(np.arange(1, T + 1, dtype=np.float32) / 24, (B, 1))
    ev_px = engine.make_teacher_eval_from_windows(
        model, torch.float32, image_source=lambda b: b["pixel_values"])
    ev_ft = engine.make_teacher_eval_from_windows(
        model, torch.float32,
        feature_source=bank.feature_source(keyed_by_row=False))
    o_px = ev_px(x_ts, x_static, {"bin_ends": bin_ends,
                                  "pixel_values": pixels_for_ids(ids)})
    o_ft = ev_ft(x_ts, x_static, {"bin_ends": bin_ends, "image_ids": ids})
    for k in engine.EVAL_KEYS:
        np.testing.assert_allclose(o_ft[k].numpy(), o_px[k].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    bad = ids.copy()
    bad[0] = 999999
    o_bad = ev_ft(x_ts, x_static, {"bin_ends": bin_ends, "image_ids": bad})
    assert np.isnan(o_bad["img_logits"][0].numpy()).all()
    assert np.isfinite(o_bad["img_logits"][1:].numpy()).all()


COHORT = dict(seed=0, n_subjects=30, n_stays=60, n_variables=8, min_len=26,
              max_len=40)
TRAIN = dict(batch_size=16, epochs=1, limit_batches=2, patience=3,
             dtype="float32",
             optim=dict(lr=2e-3, warmup_steps=2, weight_decay=1e-4))


def _data():
    ds = S.make_synthetic(**COHORT)
    return P.build_anchor_dataset(ds, P.meta_from_events(ds, DataConfig()),
                                  DataConfig())


@pytest.fixture(scope="module")
def tier_runs(tmp_path_factory):
    """The teacher loop from the same weights on each cached tier (a fresh
    dataset each: every tier sets its own batch hook)."""
    root = tmp_path_factory.mktemp("tiers")
    hook = L.make_synthetic_pixel_hook(TINY.vit.image_size)
    runs = {}
    for name, kw in (
            ("hbm", dict(feature_cache="hbm")),
            ("host", dict(feature_cache="host")),
            ("auto", dict(feature_cache="auto", hbm_feature_budget_gb=0.0)),
            ("host_disk", dict(feature_cache="host", feature_store_path=str(
                root / "store" / "feat")))):
        runs[name] = L.train_teacher(
            _data(), TINY, TrainConfig.from_dict(TRAIN), str(root / name),
            DataConfig().pathology_labels, model=init_teacher(TINY, 0),
            device="cpu", image_hook=hook, log=lambda s: None, **kw)
    return runs, root


@pytest.mark.parametrize("tier", ["host", "auto", "host_disk"])
def test_teacher_loop_host_tiers_train_as_hbm(tier_runs, tier):
    runs, _ = tier_runs
    res, want = runs[tier], runs["hbm"]
    assert res.extras["feature_tier"]["tier"] == "host"
    assert want.extras["feature_tier"]["tier"] == "hbm"
    assert len(res.history) == len(want.history) == 1
    for got, exp in zip(res.history, want.history):
        assert got == exp
    assert res.test_metrics["main_auroc"] == want.test_metrics["main_auroc"]
    assert res.extras["n_eval_steps"] == want.extras["n_eval_steps"]


def test_teacher_step_on_host_tokens_sees_a_wrong_row(tier_runs):
    """One step from the same weights on one batch: the host store's hook
    and the bank's gather give the same losses; a store whose rows hold
    other images' tokens does not (the comparison sees a wrong row)."""
    data = _data()
    model = init_teacher(TINY, 0)
    hook = L.make_synthetic_pixel_hook(TINY.vit.image_size)
    all_ids, pixels_for_ids = L.pixels_for_ids_fn(data, hook)
    encode = F.encode_fn_for_teacher(model, torch.float32)
    bank = F.CXRFeatureBank.build(encode, pixels_for_ids, all_ids,
                                  out_dtype=torch.float32)
    store = F.HostFeatureStore.build(encode, pixels_for_ids, all_ids,
                                     out_dtype=torch.float32)
    wrong = F.HostFeatureStore(store.ids, np.roll(store.cls, 1, axis=0),
                               np.roll(store.patches, 1, axis=0))
    host = next(data.iter_batches("train", 16, shuffle=True, seed=0))
    host.pop("valid")
    cfg = TrainConfig.from_dict(TRAIN)

    def step(source, batch):
        m = init_teacher(TINY, 0)
        state = TrainState(m, MultiGroupAdamW(m, cfg.optim, 10,
                                              frozen_prefixes=("cxr/",)))
        out = engine.make_teacher_step(
            cfg, TINY.duett, 24, np.ones(7, np.float32), None,
            torch.float32, feature_source=source)(
            state, data.grid, data.static, engine.to_device(batch, CPU),
            torch.Generator().manual_seed(0))
        return {k: float(out[k]) for k in ("total", "img_total",
                                           "fus_total")}

    want = step(bank.feature_source(), bank.host_fn()(host))
    assert step(F.features_from_batch, store.host_fn()(host)) == want
    off = step(F.features_from_batch, wrong.host_fn()(host))
    assert max(abs(off[k] - want[k]) / abs(want[k]) for k in want) > 1e-4


def test_cli_host_tier_reopens_its_disk_store(tmp_path):
    """``--cxr_feature_cache host --cxr_feature_store_path``: the first run
    writes the store, the second reopens it unchanged."""
    store = str(tmp_path / "store" / "feat")
    argv = ["--device", "cpu", "--vit_size", "tiny", "--synthetic_stays",
            "40", "--n_variables", "8", "--d_embedding", "8",
            "--n_duett_layers", "1", "--batch_size", "16", "--epochs", "1",
            "--limit_batches", "2", "--warmup_steps", "2",
            "--mixed_precision", "no",
            "--cxr_feature_cache", "host", "--cxr_feature_store_path", store]
    first = cli.main(argv + ["--ckpt_dir", str(tmp_path / "runs1")])
    stamp = os.stat(store + ".patches.npy").st_mtime_ns
    second = cli.main(argv + ["--ckpt_dir", str(tmp_path / "runs2")])
    assert os.stat(store + ".patches.npy").st_mtime_ns == stamp
    assert second.history == first.history
    assert np.isfinite(first.history[0]["train_total"])
    assert first.extras["feature_tier"]["tier"] == "host"
