"""The port's int8 branch (``ops/int8.py``, ``MultiHeadAttention(quant=)``,
``DinoViT`` with ``ViTConfig.quant="int8"``) against the JAX package's, on
the CPU.

- The ops: codes, scales and outputs equal JAX's bit for bit, in float32
  and bfloat16, on ragged shapes with an all-zero row (the 1e-12 clamp);
  the product equals its exact plain version.
- The tiny ViT on both attention routes (56², 2 layers, no flash; 224², 1
  layer of 2 × 64 heads, flash-gated), at float32 with converted weights.
  Given JAX's own codes and scales, the port's ViT gives JAX's CLS and
  patch tokens within 1e-5 of their max abs (the float32 rounding of
  another order). Run end to end, a float32 rounding difference before a
  quantization step (GELU's erf, the LayerNorm) flips a few codes: at
  most 1e-3 of them (measured: 14 of 96,000 and 21 of 591,616). The CLS
  token, and every patch token no flipped code reaches, is within 1e-3 of
  the output's max abs; a flipped code moves its own token by up to
  ~2.5e-3 of it, as much as JAX's eager and jitted runs of the same ViT
  differ. The control: the quantized ViT is at least 10× that tolerance
  away from the unquantized one.
- The frozen int8 teacher's 2-epoch loop against JAX's on the pixel and
  the encode-once tiers (per-epoch losses and val AUROC within 5e-3
  relative), and the JAX-written int8 checkpoint opened by every consumer:
  ``cli.predict`` (float32 eval within 1e-3 of JAX's outputs' max abs),
  serving, KD and the analysis scripts' ``load_teacher``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_edema_prediction_tpu.ops.int8 as JI
import multimodal_edema_prediction_tpu_torch.ops.int8 as PI
from multimodal_edema_prediction_tpu.config import (
    DataConfig as JData, DuettConfig as JDuett, OptimConfig as JOptim,
    PerceiverConfig as JPerc, TeacherConfig as JTeacher, TrainConfig as JTrain,
    ViTConfig as JViT)
from multimodal_edema_prediction_tpu.data import pipeline as JP
from multimodal_edema_prediction_tpu.data import synthetic as JS
from multimodal_edema_prediction_tpu.models import vit as JV
from multimodal_edema_prediction_tpu.models.teacher import TeacherModel as JT
from multimodal_edema_prediction_tpu.train import engine as jengine
from multimodal_edema_prediction_tpu.train import teacher_loop as JL
from multimodal_edema_prediction_tpu_torch.config import (DataConfig,
                                                          TeacherConfig,
                                                          TrainConfig,
                                                          ViTConfig)
from multimodal_edema_prediction_tpu_torch.convert import load_flax
from multimodal_edema_prediction_tpu_torch.data import pipeline as P
from multimodal_edema_prediction_tpu_torch.data import synthetic as S
from multimodal_edema_prediction_tpu_torch.models import vit as PV
from multimodal_edema_prediction_tpu_torch.models.teacher import TeacherModel
from multimodal_edema_prediction_tpu_torch.train import teacher_loop as L
from torch_port_util import init_perturbed, t

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the two attention routes of the tiny ViT
ROUTES = {
    "dense": dict(image_size=56, patch_size=14, d_model=64, n_layers=2,
                  n_heads=2, d_feedforward=128, use_flash_attention=False),
    "flash": dict(image_size=224, patch_size=14, d_model=128, n_layers=1,
                  n_heads=2, d_feedforward=256)}
VIT_TOL = 1e-3
REPLAY_TOL = 1e-5
FLIP_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ragged(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    x.reshape(-1, shape[-1])[3] = 0.0           # the 1e-12 clamp's row
    return x


def _eq(jax_out, port_out, what):
    a = np.asarray(jnp.asarray(jax_out).astype(jnp.float32))
    b = port_out.float().numpy()
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(b, a, err_msg=what)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape,axis", [((37, 96), -1), ((2, 5, 19, 16),
                                                         (1, 3))])
def test_quantize_rows_matches_jax(dtype, shape, axis):
    jdt, pdt = DTYPES[dtype]
    x = _ragged(np.random.default_rng(0), *shape)
    qj, sj = JI.quantize_rows(jnp.asarray(x, jdt), axis)
    qp, sp = PI.quantize_rows(t(x).to(pdt), axis)
    assert qp.dtype == torch.int8 and sp.dtype == torch.float32
    _eq(qj, qp, "codes")
    _eq(sj, sp, "scales")


def _op_inputs(op, rng):
    """(JAX args, port args) of one op on ragged shapes; the port's weights
    in its ``Dense`` layout ``[out, in]``."""
    B, N, d, H, dh, F = 2, 19, 96, 3, 16, 40
    if op == "dense":
        x, w, b = _ragged(rng, B, N, d), rng.normal(size=(d, F)), \
            rng.normal(size=F)
        return (x, w, b), (x, w.T, b), ()
    if op == "proj_bhnk":
        x, w, b = _ragged(rng, B, N, d), rng.normal(size=(d, H * dh)), \
            rng.normal(size=H * dh)
        return (x, w, b), (x, w.T, b), (H, dh)
    o, w, b = _ragged(rng, B, H, N, dh), rng.normal(size=(H * dh, d)), \
        rng.normal(size=d)
    return (o, w.reshape(H, dh, d), b), (o, w.T, b), ()


JAX_OPS = {"dense": JI.int8_dense, "proj_bhnk": JI.int8_proj_bhnk,
           "out_bhnk": JI.int8_out_bhnk}
PORT_OPS = {"dense": (PI.int8_dense, PI.int8_dense_reference),
            "proj_bhnk": (PI.int8_proj_bhnk, PI.int8_proj_bhnk_reference),
            "out_bhnk": (PI.int8_out_bhnk, PI.int8_out_bhnk_reference)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", sorted(JAX_OPS))
def test_int8_op_matches_jax_bit_for_bit(op, dtype):
    """Each op equals JAX's in the input's dtype, and its plain version
    (the exact int32 product) equals it."""
    jdt, pdt = DTYPES[dtype]
    (x, w, b), (px, pw, pb), extra = _op_inputs(op, np.random.default_rng(1))
    w, b = (np.asarray(a, np.float32) for a in (w, b))
    want = JAX_OPS[op](jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b),
                       *extra)
    fn, ref = PORT_OPS[op]
    args = (t(px).to(pdt), t(np.ascontiguousarray(pw, np.float32)),
            t(np.asarray(pb, np.float32)), *extra)
    got = fn(*args)
    assert got.dtype == pdt
    _eq(want, got, op)
    assert torch.equal(ref(*args), got)


def test_product_equals_its_exact_plain_version():
    """At the extremes (every code ±127 over K = 3072, |acc| up to
    127²·3072) ``torch._int_mm`` equals the int32 plain product."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.choice([-127, 127], (33, 3072)).astype(np.int8))
    b = torch.from_numpy(rng.choice([-127, 127], (3072, 24)).astype(np.int8))
    a[0] = 127
    b[:, 0] = 127
    got = PI.int_mm(a, b)
    assert got.dtype == torch.int32 and int(got[0, 0]) == 127 ** 2 * 3072
    assert torch.equal(got, PI.int_mm_reference(a, b))


def _pixels(S):
    px = np.random.default_rng(0).random((2, S, S, 3)).astype(np.float32)
    return np.asarray(JV.normalize_image(px))


def _port_layout(q, axis, rows):
    """JAX's codes (or scales) of one quantization site in the port's
    layout: weights transposed to ``[out, in]``, activations as ``[tokens,
    K]`` without JAX's padded tokens (``rows`` = the port's token rows)."""
    if axis == 0:
        return q.T
    B = q.shape[0]
    n = rows // B
    if q.ndim == 4:                      # [B, H, N, dh], a scale per token
        q = q.transpose(0, 2, 1, 3)
    return q[:, :n].reshape(B * n, -1)


@pytest.fixture(scope="module", params=sorted(ROUTES))
def vits(request):
    """Both packages' int8 ViTs on the same weights and pixels, each
    quantization site's codes and scales recorded in call order; JAX's run
    eagerly so that its codes are concrete, and its unquantized ViT."""
    geo = ROUTES[request.param]
    px = _pixels(geo["image_size"])
    module = JV.DinoViT(JViT(**geo))
    params, _ = init_perturbed(module, px)
    jax_sites, port_sites = [], []
    jq, pq = JI.quantize_rows, PI.quantize_rows

    def jrec(x, axis=-1):
        q, s = jq(x, axis)
        jax_sites.append((np.asarray(q), np.asarray(s), axis))
        return q, s

    def prec(x, dim=-1):
        q, s = pq(x, dim)
        port_sites.append(q.numpy())
        return q, s

    JI.quantize_rows, PI.quantize_rows = jrec, prec
    try:
        jout = JV.DinoViT(JViT(**geo, quant="int8")).apply(
            {"params": params}, px)
        model = load_flax(PV.DinoViT(ViTConfig(**geo, quant="int8")),
                          params).eval()
        with torch.inference_mode():
            pout = model(t(px))
    finally:
        JI.quantize_rows, PI.quantize_rows = jq, pq
    jfloat = jax.jit(module.apply)({"params": params}, px)
    return dict(route=request.param, px=px, model=model, jout=jout,
                pout=pout, jfloat=jfloat, jax_sites=jax_sites,
                port_sites=port_sites)


def test_int8_vit_matches_jax(vits):
    jsites, psites = vits["jax_sites"], vits["port_sites"]
    n_layers = ROUTES[vits["route"]]["n_layers"]
    # q, k, v, out, mlp_in, mlp_out: an activation and a weight each
    assert len(jsites) == len(psites) == 12 * n_layers
    flips, total = 0, 0
    B = vits["px"].shape[0]
    touched = np.zeros(psites[0].shape[0], bool)     # token rows
    for (q, _, axis), qp in zip(jsites, psites):
        qj = _port_layout(q, axis, qp.shape[0])
        assert qj.shape == qp.shape
        flips += int((qj != qp).sum())
        total += qp.size
        if axis != 0:
            touched |= (qj != qp).any(axis=1)
    print(f"{vits['route']}: {flips} of {total} codes flipped, "
          f"{int(touched.sum())} of {touched.size} tokens")
    assert flips <= FLIP_SHARE * total
    assert touched.mean() <= 0.1
    (jcls, jpatch), (cls, patch) = vits["jout"], vits["pout"]
    jcls, jpatch = np.asarray(jcls), np.asarray(jpatch)
    assert patch.shape == jpatch.shape
    np.testing.assert_allclose(cls.numpy(), jcls, rtol=0,
                               atol=VIT_TOL * np.abs(jcls).max())
    keep = ~touched.reshape(B, -1)[:, 1:]            # patch tokens
    np.testing.assert_allclose(patch.numpy()[keep], jpatch[keep], rtol=0,
                               atol=VIT_TOL * np.abs(jpatch).max())
    # the control: quantization itself moves the output 10× further
    gap = max(float(np.abs(np.asarray(f) - q).max() / np.abs(q).max())
              for f, q in zip(vits["jfloat"], (jcls, jpatch)))
    assert gap >= 10 * VIT_TOL, gap


def test_int8_vit_replays_jax_codes(vits, monkeypatch):
    """Handed JAX's codes and scales site by site, the port's ViT computes
    JAX's function: everything around the products matches to float32
    rounding."""
    sites = iter(vits["jax_sites"])

    def replay(x, dim=-1):
        q, s, axis = next(sites)
        rows = x.reshape(-1, x.shape[-1]).shape[0]
        return tuple(torch.from_numpy(np.ascontiguousarray(
            _port_layout(a, axis, rows))) for a in (q, s))

    monkeypatch.setattr(PI, "quantize_rows", replay)
    with torch.inference_mode():
        cls, patch = vits["model"](t(vits["px"]))
    for got, want in zip((cls, patch), vits["jout"]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=REPLAY_TOL * np.abs(want).max())


def test_int8_teacher_config_is_frozen_only():
    """``TeacherConfig`` keeps its check: a quantized ViT cannot train."""
    with pytest.raises(ValueError, match="freeze_cxr=True"):
        TeacherConfig(vit=ViTConfig(quant="int8"), freeze_cxr=False)
    with pytest.raises(ValueError, match="quant"):
        PV.DinoViT(ViTConfig(image_size=28, d_model=32, n_layers=1,
                             n_heads=2, d_feedforward=64, quant="int4"))


# ---------------------------------------------------------------------------
# the frozen int8 teacher: its loop and its checkpoint's consumers
# ---------------------------------------------------------------------------
LABELS = JData().pathology_labels
JCFG = JTeacher(
    duett=JDuett(n_variables=8, n_timesteps=24, d_static=18, d_embedding=8,
                 n_layers=1, d_feedforward=32, d_hidden_mlp_embedding=16,
                 d_hidden_tab_encoder=16),
    vit=JViT(image_size=56, patch_size=14, d_model=32, n_layers=2, n_heads=2,
             d_feedforward=64, quant="int8"),
    perceiver=JPerc(n_pathologies=7, d_latent=32, n_heads=2, dropout=0.0,
                    head_dropout=0.0, head_hidden=16))
TRAIN = dict(batch_size=16, epochs=2, limit_batches=2, patience=3,
             dtype="float32",
             optim=dict(lr=2e-3, warmup_steps=2, weight_decay=1e-4))
COHORT = dict(seed=0, n_subjects=30, n_stays=60, n_variables=8, min_len=26,
              max_len=40)


def _train_both(root, tier):
    hook = L.make_synthetic_pixel_hook(JCFG.vit.image_size)
    jds = JS.make_synthetic(**COHORT)
    jad = JP.build_anchor_dataset(jds, JP.meta_from_events(jds, JData()),
                                  JData())
    variables = jax.tree.map(np.asarray, JL.init_teacher(
        JT(JCFG), JCFG, 16, 24, jax.random.key(0)))
    if tier == "none":
        # the port's pixels, attached on the host in both packages
        jad.batch_hook = lambda b: {**b,
                                    "pixel_values": hook(b)["pixel_values"]}
        source = jengine.default_image_source
    else:
        source = lambda b: hook(b)["pixel_values"]    # noqa: E731
    jres = JL.train_teacher(
        jad, JCFG, JTrain(**{**TRAIN, "optim": JOptim(**TRAIN["optim"])}),
        str(root / "jax"), LABELS,
        init_variables=jax.tree.map(jnp.asarray, variables),
        image_source=source, feature_cache=tier)

    cfg = TeacherConfig.from_dict(JCFG.to_dict())
    ds = S.make_synthetic(**COHORT)
    ad = P.build_anchor_dataset(ds, P.meta_from_events(ds, DataConfig()),
                                DataConfig())
    model = load_flax(TeacherModel(cfg), variables["params"],
                      variables["batch_stats"])
    PI.reset_calls()
    res = L.train_teacher(ad, cfg, TrainConfig.from_dict(TRAIN),
                          str(root / "port"), LABELS, model=model,
                          device="cpu", image_hook=hook, feature_cache=tier,
                          log=lambda s: None)
    return jres, res, dict(PI.CALLS)


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("int8_loops")
    cache = {}

    def get(tier):
        if tier not in cache:
            cache[tier] = _train_both(root / tier, tier)
        return cache[tier]
    return get


@pytest.mark.parametrize("tier", ["none", "hbm"])
def test_frozen_int8_teacher_loop_matches_jax(loop_runs, tier):
    """The pixel step runs the int8 ViT in every step; the encode-once
    tier runs it once per image (``encode_fn_for_teacher``)."""
    jres, res, calls = loop_runs(tier)
    assert calls["int_mm"] > 0
    assert len(res.history) == len(jres.history) == 2
    for got, want in zip(res.history, jres.history):
        for k in ("train_total", "train_img_total", "train_ts_total",
                  "train_fus_total", "val_main_auroc"):
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3,
                                       err_msg=f"epoch {got['epoch']} {k}")
    np.testing.assert_allclose(res.test_metrics["main_auroc"],
                               jres.test_metrics["main_auroc"], rtol=5e-3)
    model, tcfg, _ = L.load_teacher_from_ckpt(res.best_path, device="cpu")
    assert tcfg.vit.quant == "int8" and model.cxr.cfg.quant == "int8"


def _predict_argv(ckpt, out):
    return ["--ckpt", ckpt, "--synthetic_stays", "60", "--out", out]


@pytest.mark.parametrize("consumer", ["predict", "serve", "kd", "analysis"])
def test_jax_int8_checkpoint_opens_in_every_consumer(loop_runs, consumer,
                                                     tmp_path):
    """The JAX loop's int8 checkpoint (its config says ``vit.quant:
    int8``) loads, and every consumer runs its ViT on int8 products."""
    jres, _, _ = loop_runs("hbm")
    ckpt = jres.best_path
    PI.reset_calls()
    if consumer == "predict":
        from multimodal_edema_prediction_tpu_torch.cli import predict
        res = predict.main(_predict_argv(ckpt, str(tmp_path / "p.npz"))
                           + ["--device", "cpu"])
        assert res["n"] > 0 and (tmp_path / "p.npz").exists()
    elif consumer == "serve":
        from multimodal_edema_prediction_tpu_torch.serve.predictor import \
            BatchingPredictor
        model, _, _ = L.load_teacher_from_ckpt(ckpt, device="cpu")
        pred = BatchingPredictor(model, max_batch=2, dtype=torch.float32,
                                 labels=LABELS, device="cpu").start()
        try:
            rng = np.random.default_rng(0)
            out = pred.predict({
                "x_ts": rng.normal(size=(24, 16)).astype(np.float32),
                "static": rng.normal(size=18).astype(np.float32),
                "pixel_u8": rng.integers(0, 256, (56, 56, 3), np.uint8)})
        finally:
            pred.close()
        assert np.isfinite(out["probabilities"]).all()
    elif consumer == "kd":
        from multimodal_edema_prediction_tpu_torch.cli import train_student
        res = train_student.main([
            "--device", "cpu", "--teacher_ckpt", ckpt, "--synthetic_stays",
            "60", "--n_variables", "8", "--d_embedding", "8",
            "--n_duett_layers", "1", "--batch_size", "16", "--epochs", "1",
            "--limit_batches", "1", "--warmup_steps", "1",
            "--no_save_state", "--ckpt_dir", str(tmp_path)])
        assert np.isfinite(res.history[0]["train_total"])
    else:
        from multimodal_edema_prediction_tpu_torch.analysis.common import \
            load_teacher
        model, tcfg, _ = load_teacher(ckpt, device="cpu")
        with torch.inference_mode():
            cls, _ = model.cxr(torch.zeros(1, 56, 56, 3))
        assert tcfg.vit.quant == "int8" and torch.isfinite(cls).all()
    assert PI.CALLS["int_mm"] > 0


def test_jax_int8_checkpoint_predicts_as_jax(loop_runs, monkeypatch):
    """``cli.predict``'s float32 eval of the JAX-written int8 teacher on
    procedural pixels against the JAX package's. A flipped code (above)
    moves the few samples it reaches by up to a few 1e-3 of an output's
    max abs, and where it falls depends on JAX's own compile options (the
    suite's conftest sets some). So: at least 90% of the entries within
    1e-5 of the output's max abs (float32 rounding) and every entry within
    1e-2; the control, the same weights with the ViT unquantized, leaves
    at most 10% of the image logits within 1e-5."""
    from test_torch_predict import _jax_outputs
    from multimodal_edema_prediction_tpu_torch.cli import predict
    jres, _, _ = loop_runs("hbm")
    ckpt = jres.best_path
    want = _jax_outputs(ckpt, "pixels")
    args = predict.build_parser().parse_args(
        _predict_argv(ckpt, "-") + ["--device", "cpu"])
    got = predict.predict(args, dtype=torch.float32)["outputs"]
    assert got.keys() == want.keys()
    for k in got:
        scale = np.abs(want[k]).max()
        err = np.abs(got[k] - want[k])
        assert (err <= 1e-5 * scale).mean() >= 0.9, k
        assert err.max() <= 1e-2 * scale, k
    load = predict.load_teacher

    def unquantized(path, device):
        model, cfg, ck = load(path, device)
        for m in model.cxr.modules():
            if hasattr(m, "quant"):
                m.quant = "none"
        return model, cfg, ck

    monkeypatch.setattr(predict, "load_teacher", unquantized)
    ctrl = predict.predict(args, dtype=torch.float32)["outputs"]["img"]
    scale = np.abs(want["img"]).max()
    assert (np.abs(ctrl - want["img"]) <= 1e-5 * scale).mean() <= 0.1
