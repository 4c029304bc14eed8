"""The teacher's other modes in the port against the JAX package, forward
only: ``single`` (``PathologyPerceiver``), ``legacy``
(``TemporalPerceiver`` and its heads), ``dual_patch_event``
(``EventPatchPerceiver``, ``EventPerceiverBlock``), the attention's
``key_padding_mask`` and ``adaptive_avg_pool_tokens``; their weights
carried both ways by ``convert.py``.

The teacher geometry is ``tests/test_torch_dual.py``'s (DuETT of 5
variables at T = 24, a 56² ViT of 4 × 4 patches, so the 7 × 7 pooling does
not divide its grid); the module sizes are those of the JAX package's own
``tests/test_event_perceiver.py``. Everything runs in float32 on the CPU
with dropout off. Tolerance: every output ≤1e-5 (relative and absolute).
"""
import jax
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.config import (
    DuettConfig as JDuett, PerceiverConfig as JPerc, TeacherConfig as JTeacher,
    ViTConfig as JViT)
from multimodal_edema_prediction_tpu.models.layers import \
    MultiHeadAttention as JMHA
from multimodal_edema_prediction_tpu.models.perceiver import (
    EventPatchPerceiver as JEvent, PathologyPerceiver as JPath,
    TemporalPerceiver as JTemporal,
    adaptive_avg_pool_tokens as jax_pool)
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu_torch.config import (PerceiverConfig,
                                                          TeacherConfig)
from multimodal_edema_prediction_tpu_torch.convert import (flax_paths,
                                                           load_flax, to_flax)
from multimodal_edema_prediction_tpu_torch.models import layers
from multimodal_edema_prediction_tpu_torch.models.layers import (
    MultiHeadAttention, init_like_flax)
from multimodal_edema_prediction_tpu_torch.models.perceiver import (
    EventPatchPerceiver, PathologyPerceiver, TemporalPerceiver,
    adaptive_avg_pool_tokens)
from multimodal_edema_prediction_tpu_torch.models.teacher import TeacherModel
from torch_port_util import init_perturbed, t

B, T, V = 3, 24, 5
JCFG = JTeacher(
    duett=JDuett(n_variables=V, n_timesteps=T, d_embedding=8, n_layers=1,
                 d_feedforward=16, d_hidden_mlp_embedding=8,
                 d_hidden_tab_encoder=8),
    vit=JViT(image_size=56, patch_size=14, d_model=32, n_layers=1, n_heads=2,
             d_feedforward=64),
    perceiver=JPerc(n_pathologies=7, d_latent=32, n_heads=2, dropout=0.0,
                    head_dropout=0.0, head_hidden=16, n_latents=4,
                    n_layers=2))
MODES = ("single", "legacy", "dual_patch_event")
OUT_KEYS = {
    "single": ("main_logit", "stage2_logits", "stage4_logits"),
    "legacy": ("main_logit", "aux_logit"),
    "dual_patch_event": ("main_logit", "img_logits", "ts_logits",
                         "fusion_logits", "ts_correction",
                         "scaled_correction")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These small models gain nothing from intra-op threads, and the suite
    runs several test processes on the host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_close(got: dict, want: dict, keys) -> None:
    assert set(got) == set(keys)
    for k in keys:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


# ---- key_padding_mask and the pooling ---------------------------------------
def test_key_padding_mask_matches_jax(monkeypatch):
    """[B, K] masks: some keys masked, a row with every key masked (uniform
    attention in both packages), and ``valid_len`` standing for a mask only
    when none is given; a mask closes the flash gate even at a shape that
    opens it."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(3, 4, 128)).astype(np.float32)
    kv = rng.normal(size=(3, 300, 128)).astype(np.float32)
    mask = rng.random((3, 300)) < 0.3
    mask[2] = True
    jmod = JMHA(2, 64, use_flash=True)
    params, _ = init_perturbed(jmod, q, kv)
    model = load_flax(MultiHeadAttention(128, 2, 64, use_flash=True), params)
    monkeypatch.setattr(layers, "flash_mha", lambda *a, **k: pytest.fail(
        "a key_padding_mask must close the flash gate"))
    for kw in ({"key_padding_mask": mask},
               {"key_padding_mask": mask, "valid_len": 100}):
        want = jmod.apply({"params": params}, q, kv, **kw)
        got = model(t(q), t(kv), **{k: t(v) if k == "key_padding_mask"
                                    else v for k, v in kw.items()})
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    # the all-masked row is the mean of the values, projected
    jv = (kv[2] @ params["v"]["kernel"] + params["v"]["bias"]).mean(0)
    np.testing.assert_allclose(
        got[2, 0].detach().numpy(),
        jv @ params["out"]["kernel"] + params["out"]["bias"], rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("g", [37, 4, 10])
def test_adaptive_avg_pool_tokens_matches_jax(g):
    """37 × 37 → 7 × 7 (the ViT-B/14 grid at 518), and grids 7 does not
    divide: 4 × 4 (cells overlap) and 10 × 10."""
    x = np.random.default_rng(g).normal(size=(2, g * g, 6)).astype(
        np.float32)
    got = adaptive_avg_pool_tokens(t(x))
    assert got.shape == (2, 49, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_pool(x, 7)),
                               rtol=1e-5, atol=1e-6)


# ---- the perceivers ---------------------------------------------------------
def _event_inputs(seed=0):
    rng = np.random.default_rng(seed)
    grid = rng.normal(size=(3, 6, 5, 8)).astype(np.float32)
    patches = rng.normal(size=(3, 10, 32)).astype(np.float32)
    mask = np.zeros((3, 5), bool)
    mask[0, [0, 3]] = True          # two variables never observed
    mask[1] = True                  # none observed: attends to all
    return grid, patches, mask


def test_event_perceiver_matches_jax():
    grid, patches, mask = _event_inputs()
    jcfg = JPerc(n_pathologies=4, d_latent=32, n_heads=2, dropout=0.0,
                 head_hidden=16, head_dropout=0.0)
    jmod = JEvent(jcfg)
    params, _ = init_perturbed(jmod, grid, patches, ts_padding_mask=mask)
    model = load_flax(EventPatchPerceiver(
        PerceiverConfig.from_dict(jcfg.to_dict()), 6 * 8), params)
    keys = ("img_logits", "ts_logits", "fusion_logits", "img_tokens",
            "ts_tokens", "fusion_tokens", "ts_correction",
            "scaled_correction")
    for m in (mask, None):
        want = jmod.apply({"params": params}, grid, patches,
                          ts_padding_mask=m)
        got = model(t(grid), t(patches),
                    ts_padding_mask=None if m is None else t(m))
        _assert_close(got, want, keys)
    # a masked variable's trajectory does not reach the temporal branch
    grid2 = grid.copy()
    grid2[:, :, 3] = 123.0
    again = model(t(grid2), t(patches), ts_padding_mask=t(mask))
    got = model(t(grid), t(patches), ts_padding_mask=t(mask))
    np.testing.assert_array_equal(again["ts_logits"][0].detach().numpy(),
                                  got["ts_logits"][0].detach().numpy())
    assert not torch.equal(again["ts_logits"][2], got["ts_logits"][2])


@pytest.mark.parametrize("ablation", [None, "hourly_only", "rep_only"])
def test_pathology_perceiver_matches_jax(ablation):
    """``single``'s perceiver; its ablation default is ``full`` whatever
    ``cfg.ts_ablation`` says."""
    rng = np.random.default_rng(1)
    ts = rng.normal(size=(3, 9, 12)).astype(np.float32)
    img = rng.normal(size=(3, 49, 16)).astype(np.float32)
    jcfg = JPerc(n_pathologies=4, d_latent=16, n_heads=2, head_hidden=8,
                 dropout=0.0, head_dropout=0.0, ts_ablation="hourly_only")
    jmod = JPath(jcfg, 12)
    params, _ = init_perturbed(jmod, ts, img)
    want = jmod.apply({"params": params}, ts, img, ts_ablation=ablation)
    model = load_flax(PathologyPerceiver(
        PerceiverConfig.from_dict(jcfg.to_dict()), 12), params)
    _assert_close(model(t(ts), t(img), ts_ablation=ablation), want,
                  ("stage2_logits", "stage4_logits", "stage2_tokens",
                   "stage4_tokens"))


def test_temporal_perceiver_matches_jax():
    rng = np.random.default_rng(2)
    ts = rng.normal(size=(3, 9, 12)).astype(np.float32)
    img = rng.normal(size=(3, 50, 16)).astype(np.float32)
    jcfg = JPerc(d_latent=16, n_heads=2, dropout=0.0, n_latents=5,
                 n_layers=3)
    jmod = JTemporal(jcfg, 12)
    params, _ = init_perturbed(jmod, ts, img)
    model = load_flax(TemporalPerceiver(
        PerceiverConfig.from_dict(jcfg.to_dict()), 12), params)
    got = model(t(ts), t(img))
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jmod.apply({"params": params}, ts,
                                                     img)),
                               rtol=1e-5, atol=1e-5)


# ---- the teacher in each mode -----------------------------------------------
@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 3, size=(B, T, V)).astype(np.float32)
    counts[0, :, [1, 4]] = 0.0       # two variables never observed
    counts[1] = 0.0                  # none observed
    x_in = np.concatenate([rng.normal(size=(B, T, V)), counts,
                           np.zeros((B, T, 1))], -1).astype(np.float32)
    return (x_in, rng.normal(size=(B, 18)).astype(np.float32),
            np.tile(np.arange(1, T + 1, dtype=np.float32) / 24, (B, 1)),
            rng.normal(size=(B, 56, 56, 3)).astype(np.float32))


def _pair(mode, inputs):
    jcfg = JCFG.replace(perceiver_type=mode)
    jmodel = JT(jcfg)
    params, stats = init_perturbed(jmodel, *inputs)
    model = load_flax(TeacherModel(TeacherConfig.from_dict(jcfg.to_dict())),
                      params, stats).eval()
    return jmodel, params, stats, model


@pytest.mark.parametrize("mode", MODES)
def test_teacher_forward_matches_jax(mode, inputs):
    """Every output of the mode, on pixels and on the encode-once tier's
    cached tokens (which ``legacy``'s loop refuses, but its forward takes,
    as KD's teacher does)."""
    jmodel, params, stats, model = _pair(mode, inputs)
    want = jmodel.apply({"params": params, "batch_stats": stats}, *inputs)
    with torch.no_grad():
        got = model(*map(t, inputs))
        cached = model(*map(t, inputs[:3]), None,
                       cxr_feats=model.cxr(t(inputs[3])))
    _assert_close(got, want, OUT_KEYS[mode])
    for k in OUT_KEYS[mode]:
        np.testing.assert_array_equal(cached[k].numpy(), got[k].numpy())


@pytest.mark.parametrize("mode", MODES)
def test_mode_tree_converts_both_ways(mode, inputs):
    """The mode's flax tree → torch → flax unchanged; the new leaves'
    flax paths and optimizer groups; ``init_like_flax`` draws the query
    banks and latents N(0, 0.02²) and zeroes the correction output."""
    _, params, stats, model = _pair(mode, inputs)
    back = to_flax(model)
    for tree, theirs in ((params, back[0]), (stats, back[1])):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        other = dict(jax.tree_util.tree_flatten_with_path(theirs)[0])
        assert len(other) == len(flat)
        for path, leaf in flat:
            np.testing.assert_array_equal(other[path], leaf,
                                          err_msg=str(path))
    paths = {v[1] for v in flax_paths(model).values()}
    fresh = init_like_flax(TeacherModel(model.cfg), 0)
    p = fresh.perceiver
    if mode == "single":
        assert "perceiver/pathology_queries" in paths
        assert "perceiver/stage4_heads/w1" in paths
        banks = [p.pathology_queries]
    elif mode == "legacy":
        assert {"perceiver/latents", "perceiver/img_block_1/attn/q/kernel",
                "perceiver/norm_out/scale", "head_in/kernel",
                "aux_out/bias"} <= paths
        banks = [p.latents]
    else:
        assert {"perceiver/image_queries",
                "perceiver/event_cross/event_query_proj/kernel",
                "perceiver/event_cross/event_query_norm/scale",
                "perceiver/event_kv_proj/kernel"} <= paths
        banks = [p.image_queries, p.temporal_queries]
        assert not p.correction_head.head.out.weight.detach().any()
        assert (p.beta.detach() == 1).all()
    for bank in banks:
        np.testing.assert_allclose(float(bank.detach().std()), 0.02,
                                   rtol=0.35)
