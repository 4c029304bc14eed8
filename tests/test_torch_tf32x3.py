"""The float32 kernels' arithmetic, 3xTF32 (``csrc/mma_tf32.cuh``), modelled
on the CPU and held against the JAX package's float32 functions.

The card's float32 routes of K1's forward (``flash_fwd_f32``) and backward
(``flash_bwd_delta_f32``, ``flash_bwd_dkv_f32``, ``flash_bwd_dq_f32``), of
K3 (``dual_axis_block_tf32_kernel``) and of K4 (``ln_qkv_f32_kernel``) run
their products on the tensor cores: each
operand is split into TF32 parts (``cvt.rna.tf32.f32``: round to nearest,
ties away from zero, 10 mantissa bits), and each product is summed as
small·big + big·small + big·big (P·V adds big·tiny, with V = big + small +
tiny exactly), one mma.sync m16n8k8 per kind of product and k-step of 8.
The tensor cores truncate what they add: each mma.sync adds its product to
its C operand and rounds the sum toward zero. So the attention kernel sums
each pair of k-steps from zero on the tensor cores and adds the pair to
its float32 accumulators (rounded to nearest); K3 and K4 add every product
straight into their accumulators. No compiler or card runs here, so this
file models that arithmetic in torch (each mma.sync's product exact in
float64, its sum with C rounded toward zero to float32) with the kernels'
structure: Q pre-scaled into log2 units, 64-key tiles with an online
softmax in exp2, keys past kv_valid at -inf; the LayerNorm in float32
before the projection; K3's four products (QKV, Wo, FF1 and FF2 by
128-unit slices of the FF) with each ScaleNorm, the softmax, P·V and GELU
in float32, and the slices' partials summed in order. The model of the truncation is this file's: the
tensor cores' internal order within a k-step is not published.

The backward recomputes P = exp2(S·scale·log2 e − lse·log2 e) from its own
3xTF32 S, then dP, dS = P∘(dP − D), dV = Pᵀ·dO, dK = dSᵀ·Q·scale and
dQ = dS·K·scale, every product summed in pairs of k-steps as the forward's;
D = rowsum(dO∘O) is the diagonal of dO·Oᵀ through the same products, so
that at one live key, where the forward passes V whole (O = V), dP − D is
exactly 0 and so are dQ and dK.

Tolerances are the card's: attention 1e-5 absolute (``chip_smoke.TOL_F32``)
and lse 1e-4; the backward's gradients 1e-4 of each one's max abs floored
at 1e-2 (``TOL_BWD_F32``, ``tests/test_torch_cuda.py``) and D 1e-6 of its
max abs (``TOL_DELTA``); LayerNorm → QKV 1e-4 of each output's max abs
(``TOL_FUSED_F32``), and K3's block 1e-4 of the output's max abs (the
same). The controls: one TF32 product (big·big) misses them,
which is why the kernels take three; the attention kernel's products
added straight into its accumulators, as K4 adds them, miss 1e-5 where one
key takes most of a row's weight, which is why it sums pairs from zero;
and a D summed in another order than dP misses at one live key, which is
why D takes dP's products.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.ops.attention import flash_mha as jax_flash
from multimodal_edema_prediction_tpu.ops.pallas_dual_axis import \
    encoder_block_reference as jax_block
from multimodal_edema_prediction_tpu.ops.pallas_ln_qkv import \
    ln_qkv_reference as jax_ln_qkv

TOL_ATTENTION, TOL_LSE, TOL_LN_QKV, TOL_BLOCK = 1e-5, 1e-4, 1e-4, 1e-4
TOL_BWD, BWD_FLOOR, TOL_DELTA = 1e-4, 1e-2, 1e-6
LOG2E = np.float32(1.4426950408889634)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: the low 13 mantissa bits rounded off, half
    away from zero (adding half of 2^13 to the sign-magnitude bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x, parts):
    """x as ``parts`` TF32 values (2: big, small; 3: also tiny)."""
    out, rest = [], x
    for _ in range(parts):
        out.append(tf32(rest))
        rest = rest - out[-1]
    return out


def truncate(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32 rounded toward zero, as the tensor cores round the
    sum of a product and its C operand."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def products(a, b, terms: str, exact_b: bool = False, steps=None,
             acc=None):
    """acc + a [..., M, K] @ b [..., K, N] in float32 as the kernels take
    it: one mma.sync per TF32 product (``terms`` "3x": small·big,
    big·small, big·big, with ``exact_b`` big·tiny after small·big, in the
    kernels' order; "1x": big·big) and k-step of 8, each adding its
    product, exact, to its C operand, the sum rounded toward zero. With
    ``steps``, each run of ``steps`` k-steps is summed so from zero and
    then added to the float32 accumulator ``acc``, rounded to nearest (the
    attention kernel); without, every mma.sync adds straight into ``acc``
    (K4)."""
    a_big, a_small = split(a, 2)
    b_parts = split(b, 3 if exact_b else 2)
    pairs = [(a_big, b_parts[0])]
    if terms == "3x":
        pairs = [(a_small, b_parts[0]), *[(a_big, t) for t in b_parts[2:]],
                 (a_big, b_parts[1])] + pairs
    if acc is None:
        acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)

    def mma(c, k0):
        for x, y in pairs:
            c = truncate(c.double() + x[..., k0:k0 + 8].double()
                         @ y[..., k0:k0 + 8, :].double())
        return c

    K = a.shape[-1]
    if steps is None:
        for k0 in range(0, K, 8):
            acc = mma(acc, k0)
        return acc
    for k0 in range(0, K, 8 * steps):
        part = torch.zeros_like(acc)
        for k in range(k0, k0 + 8 * steps, 8):
            part = mma(part, k)
        acc = acc + part
    return acc


def attention(q, k, v, scale, kv_valid, terms, pairs: bool = True):
    """flash_fwd_f32's algorithm: (o, lse). ``pairs=False``: the control,
    every product added straight into the accumulators."""
    Nk = k.shape[2]
    n_keys = Nk if kv_valid is None else kv_valid
    steps = 2 if pairs else None
    qs = q * (np.float32(scale) * LOG2E)
    m = torch.full(q.shape[:3], -float("inf"))
    l = torch.zeros(q.shape[:3])
    o = torch.zeros(q.shape)
    for n0 in range(0, n_keys, 64):
        keys = torch.arange(n0, n0 + 64)
        valid = keys < n_keys
        rows = keys.clamp(max=Nk - 1)
        kt = torch.where(valid[:, None], k[:, :, rows], 0.0)
        vt = torch.where(valid[:, None], v[:, :, rows], 0.0)
        s = products(qs, kt.transpose(-1, -2), terms, steps=steps)
        s = torch.where(valid, s, -float("inf"))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        m, l = m_new, l * alpha + p.sum(-1)
        o = products(p, vt, terms, exact_b=True, steps=steps,
                     acc=o * alpha[..., None])
    return o / l[..., None], (m + torch.log2(l)) * np.float32(np.log(2))


def ln_qkv(x, params, H, terms, eps=1e-6):
    """ln_qkv_f32_kernel's arithmetic: (q, k, v), each [B, H, N, 64]."""
    B, N, D = x.shape
    mean = x.sum(-1, keepdim=True) / D
    var = ((x - mean) ** 2).sum(-1, keepdim=True) / D
    h = (x - mean) * torch.rsqrt(var + eps) * params["ln_scale"] \
        + params["ln_bias"]
    w = torch.cat([params[n] for n in ("wq", "wk", "wv")], 1)
    b = torch.cat([params[n] for n in ("bq", "bk", "bv")])
    y = products(h.reshape(B * N, D), w, terms) + b
    y = y.view(B, N, 3, H, 64).permute(2, 0, 3, 1, 4)
    return y[0], y[1], y[2]


def _qkv(B, H, N, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, N, 64)).astype(np.float32)
            for _ in range(3)]


def _attention_errors(terms, N, kv_valid, seed, same=False, pairs=True):
    """(o's max abs error, lse's); ``same``: q = k = v, so that each query
    row's own key takes most of its weight."""
    q, k, v = _qkv(1, 2, N, seed)
    if same:
        k = v = q
    scale = 64 ** -0.5
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), sm_scale=scale,
                                kv_valid=kv_valid))
    got, lse = attention(*map(torch.from_numpy, (q, k, v)), scale, kv_valid,
                         terms, pairs)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64))[..., :kv_valid] * scale
    lse_want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    return (float(np.abs(got.numpy() - want).max()),
            float(np.abs(lse.numpy() - lse_want).max()))


@pytest.mark.parametrize("N,kv_valid,seed,same", [
    (200, 150, 0, False), (200, 64, 1, False), (130, 129, 2, False),
    (300, None, 3, True)])
def test_3xtf32_attention_matches_jax(N, kv_valid, seed, same):
    """o within 1e-5 of JAX's float32 ``flash_mha`` and lse within 1e-4 of
    the float64 log-sum-exp, through the kernel's arithmetic; the masked
    keys at and off the 64-key tile edge, and q = k = v (the card test's
    strided case)."""
    err, lse_err = _attention_errors("3x", N, kv_valid, seed, same)
    assert err <= TOL_ATTENTION, err
    assert lse_err <= TOL_LSE, lse_err


def test_1xtf32_attention_misses_the_tolerance():
    """The control: one TF32 product per product is 10 bits of mantissa,
    and the output misses 1e-5 by more than an order of magnitude."""
    err, _ = _attention_errors("1x", 200, 150, 0)
    assert err > 10 * TOL_ATTENTION, err


def test_products_added_straight_in_miss_the_tolerance():
    """The control: the same 3xTF32 products, each added into the float32
    accumulators by the tensor cores (truncated), drift toward zero along
    the 5 tiles × 8 k-steps × 4 products of a row whose own key takes most
    of its weight (q = k = v), and miss 1e-5; summed in pairs from zero
    they hold it (the case above)."""
    err, _ = _attention_errors("3x", 300, None, 3, same=True, pairs=False)
    assert err > TOL_ATTENTION, err


def test_truncate_rounds_toward_zero():
    x = torch.tensor([1.0 + 2 ** -30, -(1.0 + 2 ** -30), 1.0 - 2 ** -30,
                      3.0], dtype=torch.float64)
    assert truncate(x).tolist() == [1.0, -1.0, 1.0 - 2 ** -24, 3.0]


def test_3xtf32_weight_one_passes_v_whole():
    """With one key of weight 1 (kv_valid 1) the output is that key's row
    of V to the bit, as the backward's D = rowsum(dO∘O) needs to cancel
    dP = dO·V: V's third part (tiny) is what gives it."""
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 70, 3))
    got, _ = attention(q, k, v, 0.125, 1, "3x")
    assert torch.equal(got, v[:, :, :1].expand_as(got))


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -11 + 2 ** -23,
                      -(1.0 + 2 ** -11), 1.0 + 3 * 2 ** -11,
                      1.0 - 2 ** -24], dtype=torch.float32)
    want = [1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 ** -10),
            1.0 + 2 * 2 ** -10, 1.0]
    assert tf32(x).tolist() == want
    # three parts hold a float32 value whole: big + small + tiny = x in
    # exact (float64) arithmetic, each part a TF32 value
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    parts = split(x, 3)
    assert torch.equal(sum(t.double() for t in parts), x.double())
    assert all(torch.equal(tf32(t), t) for t in parts)


def _pad16(x):
    """[..., n, c] with zero rows up to a multiple of 16 (a pair of k-steps):
    the kernels zero-fill the ragged rows of their tiles, whose products
    add exact zeros."""
    return torch.nn.functional.pad(x, (0, 0, 0, -x.shape[-2] % 16))


def backward(q, k, v, o, lse, do, scale, kv_valid, terms,
             delta_rule: bool = True):
    """The float32 backward kernels' arithmetic: (dq, dk, dv, D), from the
    forward's o and lse. dkv takes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with the first
    two kinds of product swapped (big·small, then small·big), dq S = Q·Kᵀ
    and dP = dO·Vᵀ in the usual order: element for element the same exact
    products added in the same order, so one model is both. D is the
    diagonal of dO·Oᵀ through the same products (``delta_rule=False``: the
    control, a plain float32 sum). dV, dK and dQ sum over the queries or
    keys (k) in pairs of k-steps, from zero, as everything else."""
    Nk = k.shape[2]
    n_keys = Nk if kv_valid is None else kv_valid
    kt, vt = k[:, :, :n_keys], v[:, :, :n_keys]
    if delta_rule:
        dlt = products(do[..., None, :], o[..., :, None], terms,
                       steps=2)[..., 0, 0]
    else:
        dlt = (o * do).sum(-1)
    s = products(q, kt.transpose(-1, -2), terms, steps=2)
    p = torch.exp2(s * (np.float32(scale) * LOG2E) - (lse * LOG2E)[..., None])
    dp = products(do, vt.transpose(-1, -2), terms, steps=2)
    ds = p * (dp - dlt[..., None])
    dv = products(_pad16(p).transpose(-1, -2), _pad16(do), terms, steps=2)
    dk = products(_pad16(ds).transpose(-1, -2), _pad16(q), terms,
                  steps=2) * np.float32(scale)
    dq = products(_pad16(ds.transpose(-1, -2)).transpose(-1, -2),
                  _pad16(kt), terms, steps=2) * np.float32(scale)
    rest = torch.zeros(*k.shape[:2], Nk - n_keys, 64)
    return dq, torch.cat([dk, rest], 2), torch.cat([dv, rest], 2), dlt


def _backward_errors(terms, N, kv_valid, seed, delta_rule=True):
    """({dq, dk, dv: max abs error over the gradient's max abs floored at
    1e-2}, D's max abs error over its max abs): the forward's and the
    backward's arithmetic against ``jax.vjp`` of the JAX package's
    ``flash_mha`` (at ``sm_scale=1`` on q·scale, whose off-TPU route is
    ``mha_reference``), D against float64. With one live key the exact dq
    and dk are 0 (the softmax of one score is 1 whatever the score), and
    JAX's float32 rounding noise there is above the tolerance: zeros are
    their reference."""
    import jax
    q, k, v = _qkv(1, 2, N, seed)
    do = np.random.default_rng(seed + 100).normal(
        size=q.shape).astype(np.float32)
    scale = 64 ** -0.5
    _, vjp = jax.vjp(lambda *a: jax_flash(a[0] * scale, a[1], a[2],
                                          sm_scale=1.0, q_valid=kv_valid,
                                          kv_valid=kv_valid),
                     *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(w) for w in vjp(jnp.asarray(do))]
    if kv_valid == 1:
        want[0], want[1] = np.zeros_like(want[0]), np.zeros_like(want[1])
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = attention(*t[:3], scale, kv_valid, "3x")
    *got, dlt = backward(*t[:3], o, lse, t[3], scale, kv_valid, terms,
                         delta_rule)
    rel = {name: float(np.abs(g.numpy() - w).max()
                       / max(np.abs(w).max(), BWD_FLOOR))
           for name, g, w in zip(("dq", "dk", "dv"), got, want)}
    d64 = (o.double() * t[3].double()).sum(-1)
    return rel, float((dlt.double() - d64).abs().max() / d64.abs().max())


@pytest.mark.parametrize("N,kv_valid,seed", [
    (65, None, 4), (65, 1, 5), (300, None, 6), (300, 1, 7), (300, 257, 8)])
def test_3xtf32_backward_matches_jax(N, kv_valid, seed):
    """dq, dk, dv within 1e-4 of each one's max abs (floored at 1e-2) of
    ``jax.vjp`` and D within 1e-6 of float64, through the forward's and the
    backward's arithmetic: one 64-key tile and a ragged one, one live key,
    the masked keys off the tile edge."""
    rel, d_rel = _backward_errors("3x", N, kv_valid, seed)
    assert max(rel.values()) <= TOL_BWD, rel
    assert d_rel <= TOL_DELTA, d_rel


def test_3xtf32_backward_at_one_key_is_exactly_zero():
    """At one live key the forward passes V whole, D takes dP's products,
    so dP − D is 0 to the bit and dq and dk are exactly 0."""
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 300, 9))
    do = torch.from_numpy(np.random.default_rng(9).normal(
        size=q.shape).astype(np.float32))
    o, lse = attention(q, k, v, 0.125, 1, "3x")
    dq, dk, dv, _ = backward(q, k, v, o, lse, do, 0.125, 1, "3x")
    assert not dq.any() and not dk.any() and dv[:, :, 0].abs().min() > 0


def test_1xtf32_backward_misses_the_tolerance():
    """The control: one TF32 product per product misses 1e-4 on the
    gradients and 1e-6 on D by more than a factor of 3."""
    rel, d_rel = _backward_errors("1x", 300, 257, 8)
    assert max(rel.values()) > 3 * TOL_BWD, rel
    assert d_rel > 3 * TOL_DELTA, d_rel


@pytest.mark.parametrize("N,seed", [(65, 5), (300, 7)])
def test_delta_in_another_order_misses_at_one_key(N, seed):
    """The control: D as a plain float32 sum, another order than dP's
    products, leaves dP − D at rounding size where it should be 0, and at
    one live key dk misses its 1e-4 of the 1e-2 floor."""
    rel, _ = _backward_errors("3x", N, 1, seed, delta_rule=False)
    assert rel["dk"] > 2 * TOL_BWD, rel


def _ln_params(rng, D, H):
    def r(*s):
        return (rng.normal(size=s) * 0.05).astype(np.float32)
    return {"ln_scale": (1.0 + r(D)).astype(np.float32),
            "ln_bias": (0.1 + r(D)).astype(np.float32),
            **{n: r(D, H * 64) for n in ("wq", "wk", "wv")},
            **{n: r(H * 64) for n in ("bq", "bk", "bv")}}


def _ln_qkv_errors(terms, B, N, D, H):
    rng = np.random.default_rng(D + N)
    params = _ln_params(rng, D, H)
    x = (2.0 * rng.normal(size=(B, N, D)) + 0.5).astype(np.float32)
    want = jax_ln_qkv(jnp.asarray(x), {n: jnp.asarray(p) for n, p in
                                       params.items()}, H, 64)
    got = ln_qkv(torch.from_numpy(x), {n: torch.from_numpy(p) for n, p in
                                       params.items()}, H, terms)
    return max(float(np.abs(g.numpy() - np.asarray(w)).max()
                     / np.abs(np.asarray(w)).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("B,N,D,H", [(2, 512, 256, 4), (3, 100, 128, 2),
                                     (2, 200, 96, 3), (1, 1, 64, 1)])
def test_3xtf32_ln_qkv_matches_jax(B, N, D, H):
    """q, k, v within 1e-4 of each one's max abs of JAX's float32
    ``ln_qkv_reference``, through the kernel's arithmetic, at the card
    test's float32 shapes of small width."""
    rel = _ln_qkv_errors("3x", B, N, D, H)
    assert rel <= TOL_LN_QKV, rel


def test_1xtf32_ln_qkv_misses_the_tolerance():
    rel = _ln_qkv_errors("1x", 2, 512, 256, 4)
    assert rel > TOL_LN_QKV, rel


def _scalenorm(t, g):
    n = torch.sqrt((t * t).sum(-1, keepdim=True)) * t.shape[-1] ** -0.5
    return t / n.clamp_min(1e-5) * g


def dual_axis_block(x, p, n_heads, d_head, terms, slice_=128):
    """dual_axis_block_tf32_kernel's arithmetic: each of the four products
    (QKV; Wo, its K = 2·12; FF1 and FF2 for each 128-unit slice of the FF)
    with every product added straight into its accumulators; z = (x +
    o·Wo) + bo; the slices' partials summed in order, then (z + their sum)
    + b2 and the final ScaleNorm."""
    B, L, D = x.shape
    inner = n_heads * d_head
    g1, g2, gf = (p[k].reshape(()) for k in ("g1", "g2", "gf"))
    h = _scalenorm(x, g1)
    qkv = products(h, torch.cat([p["wq"], p["wk"], p["wv"]], 1), terms)
    q, k, v = (qkv[..., i * inner:(i + 1) * inner].reshape(
        B, L, n_heads, d_head) for i in range(3))
    att = torch.softmax(torch.einsum("blhd,bmhd->bhlm", q, k)
                        * d_head ** -0.5, -1)
    o = torch.einsum("bhlm,bmhd->blhd", att, v).reshape(B, L, inner)
    z = (x + products(o, p["wo"], terms)) + p["bo"]
    h2 = _scalenorm(z, g2)
    ff = None
    for s in range(0, p["w1"].shape[1], slice_):
        f = torch.nn.functional.gelu(
            products(h2, p["w1"][:, s:s + slice_], terms)
            + p["b1"][s:s + slice_], approximate="tanh")
        part = products(f, p["w2"][s:s + slice_], terms)
        ff = part if ff is None else ff + part
    return _scalenorm((z + ff) + p["b2"], gf)


def _block_errors(terms, B, L, D, inner=24, F_=512):
    """The model against JAX's float32 ``encoder_block_reference``, relative
    to the output's max abs, at chip_smoke.py's weight scales (N(0,
    1/fan_in), biases N(0, 0.02²), gains 1 + N(0, 0.1²)), x N(0, 1)."""
    rng = np.random.default_rng(D + L)

    def r(*s, std):
        return (rng.normal(size=s) * std).astype(np.float32)
    p = {**{k: 1.0 + r(1, std=0.1) for k in ("g1", "g2", "gf")},
         **{k: r(D, inner, std=D ** -0.5) for k in ("wq", "wk", "wv")},
         "wo": r(inner, D, std=inner ** -0.5), "bo": r(D, std=0.02),
         "w1": r(D, F_, std=D ** -0.5), "b1": r(F_, std=0.02),
         "w2": r(F_, D, std=F_ ** -0.5), "b2": r(D, std=0.02)}
    x = r(B, L, D, std=1.0)
    want = np.asarray(jax_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v
                                                 in p.items()}, 2, 12))
    got = dual_axis_block(torch.from_numpy(x), {k: torch.from_numpy(v) for
                                                k, v in p.items()}, 2, 12,
                          terms).numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("B,L,D", [(2, 35, 600), (2, 25, 840)])
def test_3xtf32_dual_axis_block_matches_jax(B, L, D):
    """K3's float32 tensor-core route, through its arithmetic, within 1e-4
    of the output's max abs of JAX's float32 block at DuETT's two axes (the
    products added straight in, as K4 adds them: 5.3e-6 and 4.7e-6 here, so
    the pair sums of the attention kernels are not needed)."""
    rel = _block_errors("3x", B, L, D)
    assert rel <= TOL_BLOCK, rel


@pytest.mark.parametrize("B,L,D", [(2, 35, 600), (2, 25, 840)])
def test_1xtf32_dual_axis_block_misses_the_tolerance(B, L, D):
    """One TF32 product (big·big) a product misses 1e-4 (3.0e-4 and
    2.2e-4 here)."""
    rel = _block_errors("1x", B, L, D)
    assert rel > TOL_BLOCK, rel
