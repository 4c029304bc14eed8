"""K3, the fused DuETT dual-axis encoder block
(``ops/dual_axis.py::fused_encoder_block``), against the JAX package's
``ops/pallas_dual_axis.py`` on the CPU, where the port runs its plain
version and the JAX op runs its Pallas kernel in interpret mode.

The cases are the JAX test's own (``tests/test_pallas_dual_axis.py``):
float32, 2 heads x 12, F 512, weights N(0, 0.1²), unit gains. Tolerances:
≤1e-5 of the output's largest magnitude against ``encoder_block_reference``
(the same float32 math in another summation order: 840- and 512-term dot
products reach 1.8e-5 absolute on outputs up to ~4.5); rtol 2e-4, atol 2e-5
against the
interpret-mode kernel (the JAX test's bounds); the backward rtol 2e-3, atol
1e-5 (``test_pallas_dual_axis.py:45-49``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.ops.pallas_dual_axis import (
    encoder_block_reference as j_reference, fused_encoder_block as j_fused)
from multimodal_edema_prediction_tpu_torch.ops import dual_axis as DA


def _params(rng, D, inner, F_, gains=(1.0, 1.0, 1.0), scale=0.1):
    def r(*s):
        return (rng.normal(size=s) * scale).astype(np.float32)
    g = {k: np.full(1, v, np.float32) for k, v in zip(DA.GAINS, gains)}
    return {**g, "wq": r(D, inner), "wk": r(D, inner), "wv": r(D, inner),
            "wo": r(inner, D), "bo": r(D), "w1": r(D, F_), "b1": r(F_),
            "w2": r(F_, D), "b2": r(D)}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("B,L,D", [(8, 35, 600), (4, 25, 840), (6, 7, 96)])
def test_plain_block_matches_jax(B, L, D):
    rng = np.random.default_rng(0)
    jp, tp = _both(_params(rng, D, 24, 512))
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    got = DA.fused_encoder_block(torch.from_numpy(x), tp, 2, 12).numpy()
    want = np.asarray(j_reference(jnp.asarray(x), jp, 2, 12))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(
        got, np.asarray(j_fused(jnp.asarray(x), jp, 2, 12)),
        rtol=2e-4, atol=2e-5)


def test_backward_matches_jax_grad():
    """The autograd Function's backward (a recompute of the plain version)
    against ``jax.grad`` of the JAX fused op (its custom VJP)."""
    rng = np.random.default_rng(1)
    B, L, D, F_ = 4, 25, 96, 64
    params = _params(rng, D, 24, F_, gains=(1.1, 0.9, 1.2))
    jp, _ = _both(params)
    x = rng.normal(size=(B, L, D)).astype(np.float32)

    def loss(x_, p_):
        return (j_fused(x_, p_, 2, 12) ** 2).mean()

    jgx, jgp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jp)
    tx = torch.from_numpy(x).requires_grad_()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    (DA.fused_encoder_block(tx, tp, 2, 12) ** 2).mean().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=2e-3,
                               atol=1e-5)
    for k in DA.PARAM_KEYS:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]),
                                   rtol=2e-3, atol=1e-5, err_msg=k)


def test_block_gelu_is_the_tanh_form(monkeypatch):
    """Both JAX functions call ``jax.nn.gelu(x)``, whose default is the tanh
    form. At float32, with the FF pre-activations of size ~1, the erf form
    moves the block's output by well over 1e-5 (3.7e-4 here): the port
    agrees with JAX within 1e-6 of the output's largest magnitude, and an
    erf variant of it does not."""
    rng = np.random.default_rng(2)
    jp, tp = _both(_params(rng, 96, 24, 64))
    x = rng.normal(size=(3, 7, 96)).astype(np.float32)
    want = np.asarray(j_reference(jnp.asarray(x), jp, 2, 12))
    got = DA.encoder_block_reference(torch.from_numpy(x), tp, 2, 12).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()

    gelu = DA.F.gelu
    monkeypatch.setattr(DA.F, "gelu",
                        lambda t, approximate: gelu(t, approximate="none"))
    erf_out = DA.encoder_block_reference(torch.from_numpy(x), tp, 2,
                                         12).numpy()
    assert np.abs(erf_out - want).max() > 1e-4


@pytest.mark.parametrize("axis", ["event", "time"])
def test_block_computes_a_duett_axis_layer(axis):
    """``params_from_encoder`` maps a DuETT axis (a one-layer
    ``TransformerEncoder``, its weights and gains moved off their init) onto
    K3's dict: at bfloat16, where both take GELU's tanh form, the block gives
    the encoder's own output within 2e-2 of its largest magnitude (0.009
    here: the encoder rounds each product to bfloat16, the block sums in
    float32). Swapping two gains, wq and wk, or bo and b2, or zeroing b1
    moves it by 0.028 or more."""
    from multimodal_edema_prediction_tpu_torch.config import DuettConfig
    from multimodal_edema_prediction_tpu_torch.models.duett import \
        DuettEncoder
    from multimodal_edema_prediction_tpu_torch.models.layers import \
        init_like_flax
    cfg = DuettConfig(n_variables=6, n_timesteps=8, d_embedding=8,
                      n_layers=1, d_feedforward=32)
    enc = getattr(init_like_flax(DuettEncoder(cfg), 0),
                  f"{axis}_transformer_0")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in enc.parameters():
            p.add_((0.3 if p.numel() == 1 else 0.05)
                   * torch.randn(p.shape, generator=g))
    D = cfg.et_dim if axis == "event" else cfg.tt_dim
    L = cfg.n_variables + 1 if axis == "event" else cfg.n_timesteps + 1
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, L, D)).astype(np.float32)).to(torch.bfloat16)
    params = DA.params_from_encoder(enc)
    heads = (cfg.n_heads, cfg.d_embedding // cfg.n_heads)
    with torch.no_grad():
        want = enc(x).float()
        got = DA.fused_encoder_block(x, params, *heads).float()
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()
    with pytest.raises(ValueError, match="one layer"):
        enc.n_layers = 2
        DA.params_from_encoder(enc)


def test_rejects_params_of_the_wrong_shape():
    rng = np.random.default_rng(3)
    _, tp = _both(_params(rng, 96, 24, 64))
    with pytest.raises(ValueError, match="wrong shape"):
        DA.fused_encoder_block(torch.zeros(2, 7, 80), tp, 2, 12)
    with pytest.raises(ValueError, match="missing"):
        DA.fused_encoder_block(torch.zeros(2, 7, 96),
                               {k: v for k, v in tp.items() if k != "gf"},
                               2, 12)


@pytest.mark.parametrize("L,D,fits", [(35, 600, True), (25, 840, True),
                                      (64, 840, False)])
def test_shared_memory_budget(L, D, fits):
    """DuETT's two axes fit one block's 227 KB; a longer axis is refused
    by the kernel wrapper (the check runs before any launch)."""
    assert (DA.smem_bytes(L, D, 2, 12) <= DA.SMEM_LIMIT) == fits


@pytest.mark.parametrize("dtype,L,D,F_,way", [
    (torch.bfloat16, 35, 600, 512, "tc"),      # DuETT's event axis
    (torch.bfloat16, 25, 840, 512, "tc"),      # DuETT's time axis
    (torch.bfloat16, 7, 96, 128, "tc"),
    (torch.bfloat16, 64, 96, 128, "tc"),       # four m16 row tiles
    (torch.float32, 35, 600, 512, "tf32"),     # DuETT's event axis
    (torch.float32, 25, 840, 512, "tf32"),     # DuETT's time axis
    (torch.float32, 7, 96, 128, "tf32"),
    (torch.float32, 64, 96, 128, "tf32"),      # four m16 row tiles
    (torch.float32, 7, 100, 128, "tf32"),      # D % 8 == 4: zero-filled
    (torch.bfloat16, 1, 8, 130, "simt"),       # F not a multiple of 128
    (torch.bfloat16, 7, 96, 64, "simt"),
    (torch.bfloat16, 7, 100, 128, "simt"),     # D not a multiple of 8
    (torch.bfloat16, 65, 96, 128, "simt"),     # past four row tiles
    (torch.bfloat16, 64, 840, 512, "simt"),    # over one block's memory
    (torch.float32, 7, 98, 128, "simt"),       # D not a multiple of 4
    (torch.float32, 35, 602, 512, "simt"),
    (torch.float32, 7, 96, 64, "simt"),        # F not a multiple of 128
    (torch.float32, 1, 8, 130, "simt"),
    (torch.float32, 65, 96, 128, "simt"),      # past four row tiles
    (torch.float32, 36, 600, 512, "tf32"),     # 231,488 bytes: it fits
    (torch.float32, 37, 600, 512, "simt"),     # over one block's memory
    (torch.float32, 26, 840, 512, "simt"),
    (torch.float32, 64, 840, 512, "simt"),
])
def test_route_is_chosen_by_dtype_and_shape(dtype, L, D, F_, way):
    """Which of K3's three kernels a CUDA call takes, decided in Python from
    the dtype and the shape before any launch (no card needed). DuETT's
    float32 axes nearly fill the float32 tensor-core kernel's shared memory:
    the event axis fits one more row, not two, and the time axis none."""
    assert DA.route(dtype, L, D, F_, 2, 12) == way


@pytest.mark.parametrize("dtype,L,D,F_,n_heads,d_head,way", [
    (torch.float32, 9, 96, 128, 4, 12, "tf32"),    # q|k|v over two chunks
    (torch.float32, 35, 96, 512, 4, 12, "tf32"),
    (torch.float32, 17, 136, 256, 8, 16, "tf32"),  # three chunks
    (torch.float32, 35, 600, 512, 4, 12, "simt"),  # q|k|v after h: too big
    (torch.float32, 25, 840, 512, 4, 12, "simt"),
    (torch.bfloat16, 9, 96, 128, 4, 12, "tc"),
    (torch.bfloat16, 35, 600, 512, 4, 12, "tc"),
])
def test_route_counts_qkv_wider_than_a_ring_chunk(dtype, L, D, F_, n_heads,
                                                  d_head, way):
    """With 3·H·dh over the W ring's 128 columns, the float32 tensor-core
    route keeps q|k|v apart from h, and ``route`` sends a shape there only
    if that larger layout fits: DuETT's axes at 4 heads × 12 go to the SIMT
    kernel in float32, and stay on the bf16 tensor-core route."""
    assert DA.route(dtype, L, D, F_, n_heads, d_head) == way


def test_tensor_core_route_memory():
    """The tensor-core route's workspace is one float32 [B, L, D] partial
    per 128 FF units (10.8 MB at [32, 35, 600], F 512), and its shared
    memory at DuETT's axes (``make_layout`` in the source: z, h, the
    attention or FF work area, the W ring, the biases) fits one block's
    227 KB."""
    assert DA.workspace_bytes(32, 35, 600, 512, "tc") == \
        4 * 4 * 32 * 35 * 600
    assert DA.workspace_bytes(128, 25, 840, 512, "tc") == \
        4 * 4 * 128 * 25 * 840
    ring = 2 * 2 * 64 * 136
    # event: z 84,000; h 48 x 616 bf16; q|k|v 35 x 73 float32 (10,224
    # aligned) + P 9,808 + o 48 x 40 bf16 (larger than f 48 x 136 bf16);
    # the ring; bo, b2 and 128 of b1 in float32
    assert DA.tc_smem_bytes(35, 600, 2, 12) == \
        84000 + 2 * 48 * 616 + 10224 + 9808 + 2 * 48 * 40 + ring \
        + 4 * (2 * 600 + 128)
    # time: z 84,000; h 32 x 856 bf16; q|k|v 7,312 + P 5,008 + o 32 x 40
    # bf16 (larger than f 32 x 136 bf16); the ring; the biases
    assert DA.tc_smem_bytes(25, 840, 2, 12) == \
        84000 + 2 * 32 * 856 + 7312 + 5008 + 2 * 32 * 40 + ring \
        + 4 * (2 * 840 + 128)
    for L, D in ((35, 600), (25, 840)):
        assert DA.tc_smem_bytes(L, D, 2, 12) <= DA.SMEM_LIMIT


def test_tf32_route_memory():
    """The float32 tensor-core route's workspace holds one more [B, L, D]
    slot than the bf16 route's (z, for the sum of the partials), and its
    shared memory at DuETT's axes (``make_layout`` in
    ``csrc/dual_axis_block_tf32.cu``: h's two TF32 parts, larger than z with
    the attention buffers or than f's parts; the W ring; the biases) fits
    one block's 227 KB. A row's stride is K rounded to 8, plus 4: 600 ->
    604, 840 -> 844, 24 -> 28, 128 -> 132."""
    assert DA.workspace_bytes(32, 35, 600, 512, "tf32") == \
        4 * 5 * 32 * 35 * 600
    assert DA.workspace_bytes(32, 35, 600, 512, "tc") == \
        4 * 4 * 32 * 35 * 600
    ring = 4 * 3 * 32 * 136
    # event: h_big | h_small 35 x 604 float32 each (169,120), larger than
    # z 84,560 + q|k|v 10,224 + P 9,800 + o's parts 2 x 35 x 28 x 4 and
    # than f's parts 2 x 35 x 132 x 4; the ring; bo, b2, 128 of b1
    assert 2 * 4 * 35 * 604 > 84560 + 10224 + 9800 + 2 * 4 * 35 * 28 \
        > 2 * 4 * 35 * 132
    assert DA.tf32_smem_bytes(35, 600, 2, 12) == \
        2 * 4 * 35 * 604 + ring + 4 * (2 * 600 + 128) == 226656
    # time: h's parts 25 x 844 each
    assert DA.tf32_smem_bytes(25, 840, 2, 12) == \
        2 * 4 * 25 * 844 + ring + 4 * (2 * 840 + 128) == 228256
    # a short axis: f's parts (7 x 132 each) are the largest
    assert DA.tf32_smem_bytes(7, 96, 2, 12) == \
        2 * 4 * 7 * 132 + ring + 4 * (2 * 96 + 128)
    # a long, narrow one: z 64 x 100, q|k|v 64 x 73, P 2 x 64 x 64 and o's
    # parts 64 x 28 each are
    assert DA.tf32_smem_bytes(64, 96, 2, 12) == \
        4 * 64 * (100 + 73 + 2 * 64 + 2 * 28) + ring + 4 * (2 * 96 + 128)
    for L, D in ((35, 600), (25, 840)):
        assert DA.tf32_smem_bytes(L, D, 2, 12) <= DA.SMEM_LIMIT


@pytest.mark.parametrize("L,D,n_heads,d_head,nbytes", [
    # 3 x 48 = 144 columns, two 128-column chunks: after h's parts (9 x 100
    # float32 each, 3,600 B), q|k|v 9 x 145 (5,220 B, 5,232 aligned), P
    # 4 x 9 x 9 and o's parts 9 x 52 each, larger than f's parts (2 x 4,752)
    (9, 96, 4, 12, 2 * 3600 + 5232 + 4 * 4 * 9 * 9 + 2 * 4 * 9 * 52),
    # 3 x 128 = 384 columns, three chunks: h's parts 17 x 140 each, q|k|v
    # 17 x 385 (26,180 B, 26,192 aligned), P 8 x 17 x 17, o's 17 x 132
    (17, 136, 8, 16,
     2 * 4 * 17 * 140 + 26192 + 4 * 8 * 17 * 17 + 2 * 4 * 17 * 132),
    # 3 x 40 = 120 columns, one chunk: over h_small, as at 2 x 12 (q|k|v
    # 9 x 121, 4,356 B, 4,368 aligned; o's parts 9 x 44)
    (9, 96, 4, 10, 3600 + 4368 + 4 * 4 * 9 * 9 + 2 * 4 * 9 * 44),
])
def test_tf32_route_places_qkv_after_h_when_it_spans_ring_chunks(
        L, D, n_heads, d_head, nbytes):
    """The float32 tensor-core kernel's QKV product writes q|k|v after each
    128-column chunk of Wqkv while a later chunk still reads h: when 3·H·dh
    (rounded up to 4) is over 128, ``make_layout`` puts q|k|v, P and o
    after both of h's TF32 parts rather than over h_small, and the mirror
    counts it (rows of h: 96 -> 100 floats, 136 -> 140)."""
    ring, bias = 4 * 3 * 32 * 136, 4 * (2 * D + 128)
    assert DA.tf32_smem_bytes(L, D, n_heads, d_head) == nbytes + ring + bias


def _tc_arithmetic(x, p, n_heads, d_head, slice_=128):
    """The tensor-core route's arithmetic written out in torch: bf16
    weights; h, o, h2 and f rounded to bf16 as product operands; every
    sum float32; the FF's partials summed slice by slice in order."""
    def bf(t):
        return t.bfloat16().float()

    def sn(t, g):
        n = torch.sqrt((t * t).sum(-1, keepdim=True)) * t.shape[-1] ** -0.5
        return t / n.clamp_min(1e-5) * g

    B, L, D = x.shape
    w = {k: bf(p[k]) for k in DA.WEIGHTS}
    g1, g2, gf = (p[k].reshape(()) for k in DA.GAINS)
    xf = x.float()
    h = bf(sn(xf, g1))
    q, k, v = (t.reshape(B, L, n_heads, d_head)
               for t in (h @ w["wq"], h @ w["wk"], h @ w["wv"]))
    att = torch.softmax(torch.einsum("blhd,bmhd->bhlm", q, k)
                        * d_head ** -0.5, -1)
    o = bf(torch.einsum("bhlm,bmhd->blhd", att, v).reshape(B, L, -1))
    z = (xf + o @ w["wo"]) + w["bo"]
    h2 = bf(sn(z, g2))
    ff = 0
    for s in range(0, w["w1"].shape[1], slice_):
        f = bf(torch.nn.functional.gelu(
            h2 @ w["w1"][:, s:s + slice_] + w["b1"][s:s + slice_],
            approximate="tanh"))
        ff = ff + f @ w["w2"][s:s + slice_]
    return sn((z + ff) + w["b2"], gf).bfloat16()


@pytest.mark.parametrize("B,L,D", [(4, 35, 600), (4, 25, 840)])
def test_tensor_core_rounding_is_within_the_bf16_tolerance(B, L, D):
    """The rounding the tensor-core kernel adds (its product operands in
    bf16) keeps DuETT's axes within 2e-2 of the output's max abs of the
    float32 plain version, at chip_smoke.py's weight scales (N(0, 1/fan_in),
    gains 1 + N(0, 0.1²)), and it does move the output (so the check sees
    the rounding at all)."""
    rng = np.random.default_rng(5)
    inner, F_ = 24, 512

    def r(*s, std):
        return torch.from_numpy((rng.normal(size=s) * std).astype(
            np.float32))
    p = {**{k: 1.0 + r(1, std=0.1) for k in DA.GAINS},
         **{k: r(D, inner, std=D ** -0.5) for k in ("wq", "wk", "wv")},
         "wo": r(inner, D, std=inner ** -0.5), "bo": r(D, std=0.02),
         "w1": r(D, F_, std=D ** -0.5), "b1": r(F_, std=0.02),
         "w2": r(F_, D, std=F_ ** -0.5), "b2": r(D, std=0.02)}
    x = r(B, L, D, std=1.0).bfloat16()
    want = DA.encoder_block_reference(x, p, 2, 12).float()
    got = _tc_arithmetic(x, p, 2, 12).float()
    err = (got - want).abs().max().item()
    assert 0 < err <= 2e-2 * want.abs().max().item()


@pytest.mark.parametrize("dtype,granule", [(torch.bfloat16, 8),
                                           (torch.float32, 4)])
@pytest.mark.parametrize("inner", [24, 36, 22])
def test_tensor_core_weights_share_one_aligned_buffer(inner, dtype,
                                                      granule):
    """Each tensor-core route casts its weights to its dtype in one buffer:
    wq | wk | wv side by side (zero columns up to a 16-byte granule, 8 bf16
    or 4 float32, when 3·inner is not a multiple of one), then wo, bo, w1,
    b1, w2, b2, each starting on a 16-byte boundary, each equal to its own
    cast."""
    rng = np.random.default_rng(6)
    D, F_ = 96, 256
    _, tp = _both(_params(rng, D, inner, F_))
    wqkv, nq, rest = DA._tc_weights(tp, D, inner, torch.device("cpu"),
                                    dtype)
    assert nq % granule == 0 and nq - 3 * inner in range(granule)
    assert wqkv.shape == (D * nq,) and wqkv.dtype == dtype
    grid = wqkv.view(D, nq)
    want = torch.cat([tp[k] for k in ("wq", "wk", "wv")], 1).to(dtype)
    assert torch.equal(grid[:, :3 * inner], want)
    assert not grid[:, 3 * inner:].any()
    for t, k in zip(rest, ("wo", "bo", "w1", "b1", "w2", "b2")):
        assert torch.equal(t, tp[k].reshape(-1).to(dtype)), k
    for t in (wqkv, *rest):
        assert t.storage_offset() * t.element_size() % 16 == 0


def test_each_route_counts_under_its_entry_point():
    """K3 counts launches by C entry point, one counter per kernel (the
    route's kernel in ``ROUTE_KERNELS``); a CPU call launches nothing and
    ``reset_launches`` zeroes every counter."""
    assert set(DA.LAUNCHES) == set(DA.ENTRY_POINTS) \
        == set(DA.ROUTE_KERNELS.values())
    saved = dict(DA.LAUNCHES)
    try:
        rng = np.random.default_rng(7)
        _, tp = _both(_params(rng, 96, 24, 128))
        DA.fused_encoder_block(torch.zeros(2, 7, 96).bfloat16(), tp, 2, 12)
        DA.fused_encoder_block(torch.zeros(2, 7, 96), tp, 2, 12)
        assert DA.LAUNCHES == saved
        DA.LAUNCHES["dual_axis_block_tc"] += 3
        DA.LAUNCHES["dual_axis_block_tf32"] += 2
        DA.reset_launches()
        assert set(DA.LAUNCHES.values()) == {0}
    finally:
        DA.LAUNCHES.update(saved)
