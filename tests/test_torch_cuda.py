"""Card-only checks of the port's CUDA kernels against their plain versions.

Skipped without a CUDA card. On a machine with one (and no JAX) run them
without the suite's conftest, which imports JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K1 forward bf16 2e-2 (P and the output rounded to bf16 against
a float32 plain version), float32 1e-5 (TF32 off; another summation order);
K1 backward bf16 2e-2 and float32 1e-4 of each gradient's largest magnitude
(P and dS rounded to bf16 before their products; in float32, exp of
recomputed scores against the plain softmax), at the edges of the bf16
kernels' 128-row blocks and 64-row tiles; K2 bit-exact (a gather moves
bytes).
"""
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu_torch.ops import attention as A
from multimodal_edema_prediction_tpu_torch.ops import gather as G

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(B, H, Nq, Nk, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(B, H, n, 64, generator=g, device=device).to(dtype)
            for n in (Nq, Nk, Nk)]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("Nq,Nk,kv_valid", [
    (1, 1, None), (63, 63, None), (64, 64, None), (65, 65, 1),
    (300, 300, 257), (7, 1369, None), (1370, 1370, 1370)])
def test_kernel_matches_plain(cuda, dtype, tol, Nq, Nk, kv_valid):
    q, k, v = _qkv(2, 3, Nq, Nk, dtype, cuda)
    before = A.LAUNCHES["flash_attention"]
    got = A.flash_mha(q, k, v, 0.125, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert A.LAUNCHES["flash_attention"] == before + 1
    want = A.flash_mha_reference(q, k, v, 0.125, kv_valid=kv_valid)
    assert got.shape == want.shape and got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_kernel_reads_strided_views(cuda):
    """[B, N, H·64] projections viewed as [B, H, N, 64], as the ViT passes
    them; an odd-strided input is copied to a layout the kernel reads."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 300, 3 * 128, generator=g, device=cuda).bfloat16()
    q, k, v = (x[..., i * 128:(i + 1) * 128].view(2, 300, 2, 64)
               .transpose(1, 2) for i in range(3))
    got = A.flash_mha(q, k, v, 0.125)
    want = A.flash_mha_reference(q, k, v, 0.125)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    odd = torch.randn(2, 2, 300, 65, generator=g, device=cuda)[..., 1:]
    got = A.flash_mha(odd, odd, odd, 0.125)
    want = A.flash_mha_reference(odd, odd, odd, 0.125)
    assert (got - want).abs().max().item() <= 1e-5


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 1, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim 64"):
        A.flash_mha(q, q, q)
    h = torch.zeros(1, 1, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        A.flash_mha(h, h, h)
    f = torch.zeros(1, 1, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="kv_valid"):
        A.flash_mha(f, f, f, kv_valid=0)


def _grads(q, k, v, do, kv_valid):
    """(o, dq, dk, dv) of ``flash_mha`` at ``do``, through the autograd
    Function (the kernels on the card)."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    o = A.flash_mha(q, k, v, 0.125, kv_valid=kv_valid)
    return (o, *torch.autograd.grad(o, (q, k, v), do))


def _plain_grads(q, k, v, do, kv_valid):
    o = A.flash_mha_reference(q, k, v, 0.125, kv_valid=kv_valid)
    lse = A.flash_mha_lse_reference(q, k, 0.125, kv_valid)
    return A.flash_mha_backward_reference(q, k, v, o, lse, do, 0.125,
                                          kv_valid)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("Nq,Nk,kv_valid", [
    (1, 1, None), (63, 63, None), (64, 64, None), (65, 65, 1),
    (127, 127, None), (128, 128, None), (129, 129, None),
    (300, 300, 257), (7, 1369, None), (1370, 1370, 1370),
    (1370, 1370, 1301), (200, 1369, 1000)])
def test_backward_kernels_match_plain(cuda, dtype, tol, Nq, Nk, kv_valid):
    """dq, dk, dv from the dkv and dq kernels against
    ``flash_mha_backward_reference`` (float32, from the plain forward's o
    and lse), each relative to its largest magnitude floored at 1e-2 (at
    one key dS is 0 and the gradients of q and k are rounding noise);
    keys at or past ``kv_valid`` get exactly zero dk and dv."""
    q, k, v = _qkv(2, 3, Nq, Nk, dtype, cuda)
    do = _qkv(2, 3, Nq, Nq, dtype, cuda, seed=1)[0]
    before = dict(A.LAUNCHES)
    _, *got = _grads(q, k, v, do, kv_valid)
    torch.cuda.synchronize()
    for name in ("flash_attention", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert A.LAUNCHES[name] == before[name] + 1, name
    want = _plain_grads(q, k, v, do, kv_valid)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == dtype
        scale = max(w.float().abs().max().item(), 1e-2)
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * scale, f"d{name}: {err} vs scale {scale}"
    if kv_valid is not None and kv_valid < Nk:
        assert not got[1][:, :, kv_valid:].any()
        assert not got[2][:, :, kv_valid:].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_lse_matches_logsumexp(cuda, dtype):
    """The forward's log-sum-exp output against the plain logsumexp of the
    scaled, masked scores (float32 accumulation on both sides)."""
    q, k, _ = _qkv(2, 3, 300, 300, dtype, cuda)
    _, lse = A.forward_kernel(q, k, k, 0.125, 257, True)
    want = A.flash_mha_lse_reference(q, k, 0.125, 257)
    assert (lse - want).abs().max().item() <= 1e-4


def test_backward_is_bit_reproducible_on_strided_views(cuda):
    """No atomics: two backward passes give the same bits. q, k, v are
    [B, N, H·64] projections viewed as [B, H, N, 64], as the ViT passes
    them; their gradients come back in that layout."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 300, 3 * 128, generator=g, device=cuda).bfloat16()
    x.requires_grad_()
    q, k, v = (x[..., i * 128:(i + 1) * 128].view(2, 300, 2, 64)
               .transpose(1, 2) for i in range(3))
    do = torch.randn(2, 2, 300, 64, generator=g, device=cuda).bfloat16()
    runs = []
    for _ in range(2):
        o = A.flash_mha(q, k, v, 0.125)
        runs.append(torch.autograd.grad(o, (x,), do)[0])
    assert torch.equal(runs[0].view(torch.int16), runs[1].view(torch.int16))
    want = _plain_grads(q.detach(), k.detach(), v.detach(), do, None)
    got = runs[0].view(2, 300, 3, 2, 64).permute(2, 0, 3, 1, 4)
    for gi, w in zip(got, want):
        scale = w.float().abs().max().item()
        assert (gi.float() - w.float()).abs().max().item() <= 2e-2 * scale


def test_backward_kernels_issue_wgmma(cuda):
    """Both bf16 backward kernels run their products as warpgroup MMAs: the
    built library's SASS holds HGMMA instructions in each."""
    from multimodal_edema_prediction_tpu_torch.ops import build
    listing = build.sass("flash_attention_bwd")
    if listing is None:
        pytest.skip("the CUDA toolkit has no cuobjdump")
    counts = build.sass_opcode_counts(listing, "HGMMA")
    for kernel in ("flash_bwd_dkv_bf16", "flash_bwd_dq_bf16"):
        hits = [n for fn, n in counts.items() if kernel in fn]
        assert hits and min(hits) > 0, (kernel, counts)


@pytest.mark.parametrize("shape,dtype", [
    ((41, 1370, 768), torch.bfloat16), ((41, 768), torch.bfloat16),
    ((41, 137, 768), torch.float32), ((9, 3, 7), torch.float32),
    ((9, 3, 5), torch.bfloat16), ((9, 5), torch.uint8)])
def test_gather_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    bank = (torch.randn(shape, generator=g, device=cuda) * 10).to(dtype)
    n = shape[0]
    rows = torch.tensor([0, 5, 5, n - 1, 3, n, -1] + [2] * 25,
                        dtype=torch.int32, device=cuda)
    before = G.LAUNCHES["gather_rows"]
    got = G.gather_rows(bank, rows)
    torch.cuda.synchronize()
    assert G.LAUNCHES["gather_rows"] == before + 1
    want = G.gather_rows_reference(bank, rows)
    assert got.shape == want.shape and got.dtype == dtype
    same = torch.eq(got, want) | (torch.isnan(got.float())
                                  & torch.isnan(want.float()))
    assert bool(same.all())
    oob = got[5:7].float()
    assert bool(torch.isnan(oob).all()) if dtype != torch.uint8 \
        else bool((oob == 0).all())


def test_gather_kernel_fills_rows_of_an_empty_bank(cuda):
    """A bank of 0 rows: every row is outside it, so every output row is
    NaN, as the plain version gives; no rows means no launch."""
    bank = torch.zeros(0, 3, 8, device=cuda, dtype=torch.bfloat16)
    rows = torch.zeros(4, dtype=torch.int32, device=cuda)
    before = G.LAUNCHES["gather_rows"]
    got = G.gather_rows(bank, rows)
    torch.cuda.synchronize()
    assert G.LAUNCHES["gather_rows"] == before + 1
    assert bool(torch.isnan(got.float()).all())
    assert bool(torch.isnan(G.gather_rows_reference(bank, rows).float()).all())
    empty = G.gather_rows(bank, rows[:0])
    assert empty.shape == (0, 3, 8)
    assert G.LAUNCHES["gather_rows"] == before + 1


def test_gather_kernel_rejects_what_it_does_not_take(cuda):
    bank = torch.zeros(4, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        G.gather_rows(bank.transpose(1, 2),
                      torch.zeros(2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="bank on cuda"):
        G.gather_rows(bank, torch.zeros(2, dtype=torch.int32))


def _block_params(D, inner, F, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def r(*s):
        return 0.1 * torch.randn(*s, generator=g, device=device)
    return {"g1": 1.0 + r(1), "g2": 1.0 + r(1), "gf": 1.0 + r(1),
            "wq": r(D, inner), "wk": r(D, inner), "wv": r(D, inner),
            "wo": r(inner, D), "bo": r(D), "w1": r(D, F), "b1": r(F),
            "w2": r(F, D), "b2": r(D)}


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,L,D,F", [(4, 35, 600, 512), (3, 25, 840, 512),
                                     (2, 7, 96, 64), (2, 1, 8, 130)])
def test_dual_axis_kernel_matches_plain(cuda, dtype, tol, B, L, D, F):
    """K3 against ``encoder_block_reference`` (float32 arithmetic on both
    sides; another summation order), relative to the output's max abs; two
    launches give the same bits."""
    from multimodal_edema_prediction_tpu_torch.ops import dual_axis as DA
    params = _block_params(D, 24, F, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(B, L, D, generator=g, device=cuda).to(dtype)
    before = DA.LAUNCHES["dual_axis_block"]
    got = DA.fused_encoder_block(x, params, 2, 12)
    again = DA.fused_encoder_block(x, params, 2, 12)
    torch.cuda.synchronize()
    assert DA.LAUNCHES["dual_axis_block"] == before + 2
    want = DA.encoder_block_reference(x, params, 2, 12)
    assert got.shape == want.shape and got.dtype == dtype
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol * scale
    assert torch.equal(got, again)


def test_dual_axis_kernel_backward_recomputes_plain(cuda):
    from multimodal_edema_prediction_tpu_torch.ops import dual_axis as DA
    params = {k: v.requires_grad_() for k, v in
              _block_params(96, 24, 64, cuda).items()}
    x = torch.randn(2, 7, 96, device=cuda, requires_grad=True)
    (DA.fused_encoder_block(x, params, 2, 12) ** 2).mean().backward()
    leaves = [x.detach().requires_grad_()] + [
        v.detach().requires_grad_() for v in params.values()]
    out = DA.encoder_block_reference(
        leaves[0], dict(zip(params, leaves[1:])), 2, 12)
    want = torch.autograd.grad((out ** 2).mean(), leaves)
    for got, w in zip([x.grad] + [v.grad for v in params.values()], want):
        assert torch.allclose(got, w, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,N,D,H", [(2, 1536, 768, 12), (2, 512, 256, 4),
                                     (3, 100, 128, 2), (1, 1, 64, 1)])
def test_ln_qkv_kernel_matches_plain(cuda, dtype, tol, B, N, D, H):
    """K4 against ``ln_qkv_reference``: h rounded to x's dtype on both
    sides, products accumulated in float32 in another order; relative to
    each output's max abs; reruns bit-equal."""
    from multimodal_edema_prediction_tpu_torch.ops import ln_qkv as LQ
    g = torch.Generator(device=cuda).manual_seed(0)

    def r(*s):
        return 0.05 * torch.randn(*s, generator=g, device=cuda)
    params = {"ln_scale": 1.0 + r(D), "ln_bias": r(D),
              **{k: r(D, H * 64) for k in ("wq", "wk", "wv")},
              **{k: r(H * 64) for k in ("bq", "bk", "bv")}}
    x = (2.0 * torch.randn(B, N, D, generator=g, device=cuda) + 0.5).to(dtype)
    before = LQ.LAUNCHES["ln_qkv"]
    got = LQ.fused_ln_qkv(x, params, H, 64)
    again = LQ.fused_ln_qkv(x, params, H, 64)
    torch.cuda.synchronize()
    assert LQ.LAUNCHES["ln_qkv"] == before + 2
    want = LQ.ln_qkv_reference(x, params, H, 64)
    for a, b, w in zip(got, again, want):
        assert a.shape == (B, H, N, 64) and a.dtype == dtype
        scale = w.float().abs().max().item()
        assert (a.float() - w.float()).abs().max().item() <= tol * scale
        assert torch.equal(a, b)


def test_ln_qkv_kernel_rejects_what_it_does_not_take(cuda):
    from multimodal_edema_prediction_tpu_torch.ops import ln_qkv as LQ
    params = {"ln_scale": torch.ones(48, device=cuda),
              "ln_bias": torch.zeros(48, device=cuda),
              **{k: torch.zeros(48, 96, device=cuda)
                 for k in ("wq", "wk", "wv")},
              **{k: torch.zeros(96, device=cuda) for k in ("bq", "bk", "bv")}}
    with pytest.raises(ValueError, match="head dim 64"):
        LQ.fused_ln_qkv(torch.zeros(1, 8, 48, device=cuda), params, 2, 48)


def test_encode_once_train_step_on_the_card(cuda):
    """One bf16 teacher step of the encode-once tier at a small geometry:
    finite losses and exactly two K2 launches (CLS and patch banks)."""
    from multimodal_edema_prediction_tpu_torch.config import (
        DuettConfig, PerceiverConfig, TeacherConfig, TrainConfig, ViTConfig)
    from multimodal_edema_prediction_tpu_torch.data.features import \
        CXRFeatureBank, encode_fn_for_teacher
    from multimodal_edema_prediction_tpu_torch.models.teacher import \
        init_teacher
    from multimodal_edema_prediction_tpu_torch.train import engine
    from multimodal_edema_prediction_tpu_torch.train.optim import \
        MultiGroupAdamW
    from multimodal_edema_prediction_tpu_torch.train.state import TrainState
    cfg = TeacherConfig(
        duett=DuettConfig(n_variables=5, d_embedding=8, n_layers=1),
        vit=ViTConfig(image_size=224, d_model=128, n_layers=1, n_heads=2,
                      d_feedforward=128),
        perceiver=PerceiverConfig(d_latent=32, n_heads=2))
    model = init_teacher(cfg, 0).to(cuda)
    rng = np.random.default_rng(0)
    bank = CXRFeatureBank.build(
        encode_fn_for_teacher(model), lambda ids: rng.normal(
            size=(len(ids), 224, 224, 3)).astype(np.float32), np.arange(5))
    state = TrainState(model, MultiGroupAdamW(model, TrainConfig().optim, 10,
                                              frozen_prefixes=("cxr/",)))
    step = engine.make_teacher_step(TrainConfig(), cfg.duett, 24,
                                    np.ones(7, np.float32),
                                    feature_source=bank.feature_source())
    grid = torch.randn(3, 30, 10, device=cuda).abs()
    batch = engine.to_device({
        "stay_rows": np.array([0, 2, 1, 2], np.int32),
        "slot_idx": np.array([24, 30, 26, 28], np.int32),
        "image_ids": np.array([4, 0, 2, 1], np.int32),
        "y_multi": np.ones((4, 7), np.float32),
        "y_multi_mask": np.ones((4, 7), np.float32),
        "bin_ends": np.tile(np.arange(1, 25, dtype=np.float32) / 24, (4, 1)),
    }, cuda)
    before = G.LAUNCHES["gather_rows"]
    out = step(state, grid, torch.randn(3, 18, device=cuda), batch,
               torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert G.LAUNCHES["gather_rows"] == before + 2
    assert bool(torch.isfinite(out["total"])) and state.step == 1
