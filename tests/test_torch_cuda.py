"""Card-only checks of the port's CUDA kernels against their plain versions.

Skipped without a CUDA card. On a machine with one (and no JAX) run them
without the suite's conftest, which imports JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K1 forward bf16 2e-2 (P and the output rounded to bf16 against
a float32 plain version; also at ``cli/predict``'s [64, 12, 1370, 64] and a
ragged batch of 62), float32 1e-5 (TF32 off; another summation order),
its lse 1e-4; K1 backward bf16 2e-2 and float32 1e-4 of each gradient's
largest magnitude (P and dS rounded to bf16 before their products; in
float32, exp of recomputed scores against the plain softmax), at the edges
of the bf16 kernels' 128-row blocks and 64-row tiles; the backward's D
1e-6 of its largest magnitude (64 float32 products summed in another
order); K2 bit-exact (a gather moves bytes), on both of its routes (TMA
bulk copies for 16-byte-aligned rows, vector copies otherwise); K4 bf16
2e-2 and float32 1e-4 of each output's largest magnitude (h rounded to
bf16, products accumulated in float32 in another order); one float32 KD
step on the card against a CPU copy, losses 1e-4 relative and each student
gradient 1e-4 of its max abs floored at 1e-2 of the largest gradient (a
leaf whose exact gradient is 0 keeps only rounding noise); one float32
gradient-flow diagnostics batch on the card against a CPU copy, each array
1e-4 of its max abs; the figure suite's kNN and t-SNE on the card against
a CPU copy (``test_knn_and_tsne_on_the_card_match_a_cpu_copy``); two
ranks sharing the card over gloo, a ViT-B block's all-reduced gradient
against one rank's, 1e-4 of each leaf's max abs floored at 1e-2 of the
largest gradient; three teacher steps captured as one CUDA graph and
replayed (``engine.scan_steps``) against three eager steps, bit for bit.
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
    (300, 300, 257), (7, 1369, None), (1370, 1370, 1370),
    (127, 127, None), (128, 128, None), (129, 129, None), (7, 1369, 1369),
    (300, 300, 63), (300, 300, 64), (300, 300, 65), (1370, 1370, 1301)])
def test_kernel_matches_plain(cuda, dtype, tol, Nq, Nk, kv_valid):
    q, k, v = _qkv(2, 3, Nq, Nk, dtype, cuda)
    key = A.launch_key("flash_attention", dtype)
    before = dict(A.LAUNCHES)
    got = A.flash_mha(q, k, v, 0.125, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert A.LAUNCHES == {**before, key: before[key] + 1}
    want = A.flash_mha_reference(q, k, v, 0.125, kv_valid=kv_valid)
    assert got.shape == want.shape and got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("B", [64, 62])
def test_bf16_kernel_at_the_predict_batch(cuda, B):
    """K1's bf16 forward at ``cli/predict``'s batch of 64 ViT-B/14 images
    (12 heads, 1370 tokens) and at a ragged batch of 62, the remainder of
    its default split: the TMA descriptors and the grid come from the
    shape."""
    q, k, v = _qkv(B, 12, 1370, 1370, torch.bfloat16, cuda, seed=B)
    got = A.flash_mha(q, k, v, 0.125)
    again = A.flash_mha(q, k, v, 0.125)
    want = A.flash_mha_reference(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
def test_kernel_reads_strided_views(cuda, dtype, tol):
    """[B, N, H·64] projections viewed as [B, H, N, 64], as the ViT passes
    them; an odd-strided input is copied to a layout the kernel reads."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 300, 3 * 128, generator=g, device=cuda).to(dtype)
    q, k, v = (x[..., i * 128:(i + 1) * 128].view(2, 300, 2, 64)
               .transpose(1, 2) for i in range(3))
    got = A.flash_mha(q, k, v, 0.125)
    want = A.flash_mha_reference(q, k, v, 0.125)
    assert (got.float() - want.float()).abs().max().item() <= tol
    odd = torch.randn(2, 2, 300, 65, generator=g, device=cuda)[..., 1:]
    got = A.flash_mha(odd, odd, odd, 0.125)
    want = A.flash_mha_reference(odd, odd, odd, 0.125)
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("kv_valid", [1, 63, 64, 65, 1301])
def test_keys_past_kv_valid_take_no_weight(cuda, kv_valid, dtype, tol):
    """Keys at or past ``kv_valid`` (on and off the forward's 64-key tiles)
    carry no weight: filling them with other values changes no bit of the
    output."""
    q, k, v = _qkv(2, 3, 300, 1370, dtype, cuda, seed=3)
    got = A.flash_mha(q, k, v, 0.125, kv_valid=kv_valid)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, kv_valid:] = 30.0
    v2[:, :, kv_valid:] = -7.0
    again = A.flash_mha(q, k2, v2, 0.125, kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(again))
    want = A.flash_mha_reference(q, k, v, 0.125, kv_valid=kv_valid)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_lse", [False, True])
def test_forward_is_bit_reproducible(cuda, with_lse, dtype):
    """No atomics: two forward launches give the same bits, o and lse."""
    q, k, v = _qkv(3, 2, 1370, 1370, dtype, cuda, seed=4)
    o1, l1 = A.forward_kernel(q, k, v, 0.125, 1301, with_lse)
    o2, l2 = A.forward_kernel(q, k, v, 0.125, 1301, with_lse)
    torch.cuda.synchronize()
    assert torch.equal(_bits(o1), _bits(o2))
    assert (l1 is None) == (l2 is None) == (not with_lse)
    if with_lse:
        assert torch.equal(l1.view(torch.int32), l2.view(torch.int32))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("N,kv_valid", [(129, 64), (1370, 1301), (1370, 1)])
def test_forward_lse_at_the_tile_edges(cuda, N, kv_valid, dtype, tol):
    """lse and o at the edges of both kernels' 128-row blocks and the
    float32 kernel's 64-key tiles, on strided views of
    [B, N, H·64] (the ViT's layout)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(2, N, 3 * 64, generator=g, device=cuda).to(dtype)
               .view(2, N, 3, 64).transpose(1, 2) for _ in range(3))
    o, lse = A.forward_kernel(q, k, v, 0.125, kv_valid, True)
    want = A.flash_mha_lse_reference(q, k, 0.125, kv_valid)
    assert (lse - want).abs().max().item() <= 1e-4
    ref = A.flash_mha_reference(q, k, v, 0.125, kv_valid=kv_valid)
    assert (o.float() - ref.float()).abs().max().item() <= tol


def _bits(x):
    return x.view({2: torch.int16, 4: torch.int32}[x.element_size()])


def test_forward_kernel_issues_wgmma(cuda):
    """The bf16 forward runs its products as warpgroup MMAs: the built
    library's SASS holds HGMMA instructions in flash_fwd_bf16."""
    from multimodal_edema_prediction_tpu_torch.ops import build
    listing = build.sass("flash_attention")
    if listing is None:
        pytest.skip("the CUDA toolkit has no cuobjdump")
    counts = build.sass_opcode_counts(listing, "HGMMA")
    hits = [n for fn, n in counts.items() if "flash_fwd_bf16" in fn]
    assert hits and min(hits) > 0, counts


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Nq", [1, 31, 33, 1370])
def test_delta_kernel_matches_plain(cuda, dtype, Nq):
    """D = rowsum(dO∘O) from the one-pass kernel against ``delta_reference``
    on the forward's output layout ([B, N, H, 64] storage) and a strided
    dO, Nq on and off the bf16 kernel's 32-row blocks; reruns bit-equal;
    an odd-strided dO is copied to a layout the kernel reads."""
    g = torch.Generator(device=cuda).manual_seed(6)
    o = torch.randn(2, Nq, 3, 64, generator=g, device=cuda).to(dtype) \
        .permute(0, 2, 1, 3)
    do = torch.randn(2, Nq, 3 * 128, generator=g, device=cuda).to(dtype)[
        ..., 64:256].reshape(2, Nq, 3, 64).transpose(1, 2)
    key = A.launch_key("flash_attention_bwd_delta", dtype)
    before = dict(A.LAUNCHES)
    got, again = A.delta(o, do), A.delta(o, do)
    torch.cuda.synchronize()
    assert A.LAUNCHES == {**before, key: before[key] + 2}
    want = A.delta_reference(o, do)
    assert got.shape == (2, 3, Nq) and got.dtype == torch.float32
    assert got.is_contiguous()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    scale = max(want.abs().max().item(), 1e-6)
    assert (got - want).abs().max().item() <= 1e-6 * scale
    odd = torch.randn(2, 3, Nq, 65, generator=g, device=cuda).to(dtype)[
        ..., 1:]
    want = A.delta_reference(o, odd)
    assert (A.delta(o, odd) - want).abs().max().item() <= 1e-6 * max(
        want.abs().max().item(), 1e-6)


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
    """(dq, dk, dv) of plain masked attention at ``do``, by autograd in
    float64: an oracle whose own rounding is far below the kernels'. (With
    one live key the exact dq and dk are 0, and a float32 oracle's rounding
    noise alone reaches the float32 tolerance there.)"""
    leaves = [x.detach().double().requires_grad_() for x in (q, k, v)]
    s = leaves[0] @ leaves[1].transpose(-1, -2) * 0.125
    if kv_valid is not None:
        s = s.masked_fill(torch.arange(s.shape[-1], device=s.device)
                          >= kv_valid, float("-inf"))
    o = torch.softmax(s, dim=-1) @ leaves[2]
    return torch.autograd.grad(o, leaves, do.double())


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("Nq,Nk,kv_valid", [
    (1, 1, None), (63, 63, None), (64, 64, None), (65, 65, 1),
    (127, 127, None), (128, 128, None), (129, 129, None),
    (300, 300, 257), (7, 1369, None), (1370, 1370, 1370),
    (1370, 1370, 1301), (200, 1369, 1000)])
def test_backward_kernels_match_plain(cuda, dtype, tol, Nq, Nk, kv_valid):
    """dq, dk, dv from the D, dkv and dq kernels against plain attention's
    gradients (``_plain_grads``, float64), each relative to its largest
    magnitude floored at 1e-2 (at one key dS is 0 and the gradients of q
    and k are rounding noise); keys at or past ``kv_valid`` get exactly
    zero dk and dv."""
    q, k, v = _qkv(2, 3, Nq, Nk, dtype, cuda)
    do = _qkv(2, 3, Nq, Nq, dtype, cuda, seed=1)[0]
    before = dict(A.LAUNCHES)
    _, *got = _grads(q, k, v, do, kv_valid)
    torch.cuda.synchronize()
    once = {A.launch_key(name, dtype) for name in (
        "flash_attention", "flash_attention_bwd_delta",
        "flash_attention_bwd_dkv", "flash_attention_bwd_dq")}
    assert A.LAUNCHES == {k: n + (k in once) for k, n in before.items()}
    want = _plain_grads(q, k, v, do, kv_valid)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and g.dtype == dtype
        scale = max(w.float().abs().max().item(), 1e-2)
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * scale, f"d{name}: {err} vs scale {scale}"
    if kv_valid is not None and kv_valid < Nk:
        assert not got[1][:, :, kv_valid:].any()
        assert not got[2][:, :, kv_valid:].any()


@pytest.mark.parametrize("N", [65, 300, 1370])
def test_float32_backward_at_one_key_is_exactly_zero(cuda, N):
    """At one live key the float32 forward passes that key's row of V
    whole, and D takes the products of dP, so dP − D is 0 to the bit: dq
    and dk are exactly 0 (their exact value), dv that key's Σ dO."""
    q, k, v = _qkv(2, 3, N, N, torch.float32, cuda, seed=2)
    do = _qkv(2, 3, N, N, torch.float32, cuda, seed=3)[0]
    _, dq, dk, dv = _grads(q, k, v, do, 1)
    torch.cuda.synchronize()
    assert not dq.any() and not dk.any()
    want = do.double().sum(2)
    assert (dv[:, :, 0].double() - want).abs().max().item() <= 1e-4 * \
        want.abs().max().item()


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
    row_bytes = bank[0].numel() * bank.element_size()
    kernel = "gather_rows_bulk" if row_bytes % 16 == 0 else "gather_rows"
    before = dict(G.LAUNCHES)
    got = G.gather_rows(bank, rows)
    torch.cuda.synchronize()
    assert G.LAUNCHES == {**before, kernel: before[kernel] + 1}
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
    before = G.LAUNCHES["gather_rows_bulk"]
    got = G.gather_rows(bank, rows)
    torch.cuda.synchronize()
    assert G.LAUNCHES["gather_rows_bulk"] == before + 1
    assert bool(torch.isnan(got.float()).all())
    assert bool(torch.isnan(G.gather_rows_reference(bank, rows).float()).all())
    empty = G.gather_rows(bank, rows[:0])
    assert empty.shape == (0, 3, 8)
    assert G.LAUNCHES["gather_rows_bulk"] == before + 1


def _bits(x):
    return x.view({2: torch.int16, 4: torch.int32}.get(x.element_size(),
                                                       torch.uint8))


@pytest.mark.parametrize("shape,route", [
    ((401, 1370, 768), "bulk"), ((401, 768), "bulk"), ((41, 3), "vector")])
def test_gather_routes_are_bit_exact(cuda, shape, route):
    """Each route bit for bit against the plain version: the bulk route at
    the main path's rows (the patch bank's 2,104,320 B, the CLS bank's
    1,536 B), the vector route at 6-byte rows ([N, 3] bf16); repeated rows,
    the NaN sentinel (the bank's last row), rows outside the bank; then an
    empty bank, whose every row is outside it."""
    g = torch.Generator(device=cuda).manual_seed(2)
    bank = torch.randn(shape, generator=g, device=cuda).bfloat16()
    bank[-1] = float("nan")
    n = shape[0]
    rows = torch.randint(0, n, (32,), generator=g, device=cuda,
                         dtype=torch.int32)
    rows[1] = rows[0]
    rows[5] = rows[0]
    rows[-1] = n - 1
    rows[-2] = n
    rows[-3] = -7
    kernel = {"bulk": "gather_rows_bulk", "vector": "gather_rows"}[route]
    for b in (bank, bank[:0]):
        before = dict(G.LAUNCHES)
        got = G.gather_rows(b, rows)
        torch.cuda.synchronize()
        assert G.LAUNCHES == {**before, kernel: before[kernel] + 1}
        want = G.gather_rows_reference(b, rows)
        assert torch.equal(_bits(got), _bits(want))
    assert bool(torch.isnan(got.float()).all())


@pytest.mark.parametrize("shape", [(9, 8), (9, 3)])
def test_gather_takes_more_rows_than_a_grid_dimension(cuda, shape):
    """70,000 output rows (beyond the 65,535 of a grid's y dimension), on
    the bulk route (16-byte rows) and the vector route (6-byte rows)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    bank = torch.randn(shape, generator=g, device=cuda).bfloat16()
    rows = torch.randint(-1, shape[0] + 1, (70000,), generator=g,
                         device=cuda, dtype=torch.int32)
    got = G.gather_rows(bank, rows)
    want = G.gather_rows_reference(bank, rows)
    assert got.shape == (70000, shape[1])
    assert torch.equal(_bits(got), _bits(want))


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


def _k3_route(dtype, D, F):
    """The route a case is expected to take, written out: each dtype's
    tensor-core kernel where F % 128 == 0 and D is a multiple of its 16-byte
    granule (8 bf16, 4 float32), else the SIMT kernel (every case here has
    L <= 35 and fits)."""
    if F % 128 or D % (8 if dtype == torch.bfloat16 else 4):
        return "simt"
    return "tc" if dtype == torch.bfloat16 else "tf32"


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,L,D,F", [(4, 35, 600, 512), (3, 25, 840, 512),
                                     (2, 7, 96, 64), (2, 1, 8, 130),
                                     (1, 35, 600, 512), (1, 25, 840, 512),
                                     (2, 7, 96, 128), (3, 17, 136, 256),
                                     (2, 35, 602, 512), (3, 9, 100, 128)])
def test_dual_axis_kernel_matches_plain(cuda, dtype, tol, B, L, D, F):
    """K3 against ``encoder_block_reference`` (float32 arithmetic on both
    sides; another summation order; the bf16 tensor-core route rounds its
    product operands to bf16, the float32 one takes three TF32 products a
    product), relative to the output's max abs; two launches give the same
    bits. Each case's route is asserted: DuETT's two axes (batch 1 among
    them), L = 7, 9 and 17 (not multiples of 16) and D = 136 (17 granules)
    take each dtype's tensor-core route, D = 100 (not a multiple of 8) the
    float32 one only; F = 64 and F = 130 (not multiples of 128) and
    D = 602 the SIMT route in both dtypes."""
    from multimodal_edema_prediction_tpu_torch.ops import dual_axis as DA
    params = _block_params(D, 24, F, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(B, L, D, generator=g, device=cuda).to(dtype)
    way = _k3_route(dtype, D, F)
    assert DA.route(dtype, L, D, F, 2, 12) == way
    kernel = DA.ROUTE_KERNELS[way]
    before = dict(DA.LAUNCHES)
    got = DA.fused_encoder_block(x, params, 2, 12)
    again = DA.fused_encoder_block(x, params, 2, 12)
    torch.cuda.synchronize()
    assert DA.LAUNCHES == {**before, kernel: before[kernel] + 2}
    want = DA.encoder_block_reference(x, params, 2, 12)
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.isfinite(got).all()
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol * scale
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,L,D,F,n_heads,d_head", [
    (2, 9, 96, 128, 4, 12), (3, 35, 96, 512, 4, 12),
    (2, 17, 136, 256, 8, 16)])
def test_dual_axis_kernel_matches_plain_with_wide_qkv(cuda, dtype, tol, B, L,
                                                      D, F, n_heads, d_head):
    """K3 on each dtype's tensor-core route with q|k|v wider than the W
    ring's 128 columns (3 × 48 = 144: two chunks; 3 × 128 = 384: three),
    against ``encoder_block_reference``, two launches bit-equal. The float32
    kernel keeps q|k|v apart from h there, since the QKV product still reads
    h after its first chunk's sums are written."""
    from multimodal_edema_prediction_tpu_torch.ops import dual_axis as DA
    params = _block_params(D, n_heads * d_head, F, cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(B, L, D, generator=g, device=cuda).to(dtype)
    way = "tc" if dtype == torch.bfloat16 else "tf32"
    assert DA.route(dtype, L, D, F, n_heads, d_head) == way
    kernel = DA.ROUTE_KERNELS[way]
    before = dict(DA.LAUNCHES)
    got = DA.fused_encoder_block(x, params, n_heads, d_head)
    again = DA.fused_encoder_block(x, params, n_heads, d_head)
    torch.cuda.synchronize()
    assert DA.LAUNCHES == {**before, kernel: before[kernel] + 2}
    want = DA.encoder_block_reference(x, params, n_heads, d_head)
    assert torch.isfinite(got).all()
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol * scale
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
def test_dual_axis_tc_kernel_reruns_after_a_larger_batch(cuda, dtype, tol):
    """Each tensor-core route's arrival counters are left at 0 by every
    launch: a batch of 8, then of 3, then of 8 again on the same stream
    give the bits of fresh launches, and a strided (not dense) input is
    copied to the aligned layout the kernel reads."""
    from multimodal_edema_prediction_tpu_torch.ops import dual_axis as DA
    params = _block_params(96, 24, 256, cuda, seed=3)
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(8, 9, 192, generator=g, device=cuda).to(dtype)
    x = x[:, :, 96:]                         # a strided view
    kernel = DA.ROUTE_KERNELS[_k3_route(dtype, 96, 256)]
    before = DA.LAUNCHES[kernel]
    first = DA.fused_encoder_block(x, params, 2, 12)
    small = DA.fused_encoder_block(x[:3], params, 2, 12)
    second = DA.fused_encoder_block(x, params, 2, 12)
    torch.cuda.synchronize()
    assert DA.LAUNCHES[kernel] == before + 3
    assert torch.equal(first, second)
    assert torch.equal(small, first[:3])
    want = DA.encoder_block_reference(x, params, 2, 12)
    scale = want.float().abs().max().item()
    assert (first.float() - want.float()).abs().max().item() <= tol * scale


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("F", [256, 64])
def test_dual_axis_kernel_takes_a_permuted_input(cuda, F, dtype, tol):
    """A dense but permuted x (the transpose of a contiguous [L, B, D]) on
    each dtype's tensor-core route (F = 256) and the SIMT route (F = 64):
    the output is a contiguous [B, L, D] that holds the block of x, equal
    to the block of x made contiguous."""
    from multimodal_edema_prediction_tpu_torch.ops import dual_axis as DA
    params = _block_params(96, 24, F, cuda, seed=4)
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(9, 3, 96, generator=g, device=cuda).to(dtype)
    x = x.transpose(0, 1)                    # [3, 9, 96], not contiguous
    assert not x.is_contiguous()
    way = _k3_route(dtype, 96, F)
    assert DA.route(x.dtype, 9, 96, F, 2, 12) == way
    kernel = DA.ROUTE_KERNELS[way]
    before = DA.LAUNCHES[kernel]
    got = DA.fused_encoder_block(x, params, 2, 12)
    dense = DA.fused_encoder_block(x.contiguous(), params, 2, 12)
    torch.cuda.synchronize()
    assert DA.LAUNCHES[kernel] == before + 2
    assert got.shape == (3, 9, 96) and got.is_contiguous()
    assert torch.equal(got, dense)
    want = DA.encoder_block_reference(x, params, 2, 12)
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


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


@pytest.mark.parametrize("dtype,tol,B,N,D,H", [
    (dtype, tol, *shape)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4))
    for shape in ((2, 1536, 768, 12), (2, 512, 256, 4), (3, 100, 128, 2),
                  (1, 1, 64, 1), (2, 200, 96, 3), (2, 200, 768, 12),
                  (2, 200, 96, 1), (1, 512, 2048, 4), (3, 1, 64, 2),
                  (3, 100, 160, 2))])
def test_ln_qkv_kernel_matches_plain(cuda, dtype, tol, B, N, D, H):
    """K4 against ``ln_qkv_reference``: h rounded to x's dtype on both
    sides, products accumulated in float32 in another order (in float32 as
    3xTF32 tensor-core products); relative to each output's max abs;
    reruns bit-equal. Among the cases D = 96 (half of the last 64-wide
    tile of h in bf16, three 32-deep stages in float32) and N = 200 (a
    ragged last row tile); 3·H heads that do not fill the last 256-column
    tile (H = 1), the widest D the bf16 kernel takes (2048), and row tiles
    that span batch elements (N = 1, N = 100) with a last tile past B·N."""
    from multimodal_edema_prediction_tpu_torch.ops import ln_qkv as LQ
    params, x = _ln_qkv_inputs(B, N, D, H, dtype, cuda)
    key = "ln_qkv_f32" if dtype == torch.float32 else "ln_qkv"
    before = dict(LQ.LAUNCHES)
    got = LQ.fused_ln_qkv(x, params, H, 64)
    again = LQ.fused_ln_qkv(x, params, H, 64)
    torch.cuda.synchronize()
    assert LQ.LAUNCHES == {**before, key: before[key] + 2}
    want = LQ.ln_qkv_reference(x, params, H, 64)
    for a, b, w in zip(got, again, want):
        assert a.shape == (B, H, N, 64) and a.dtype == dtype
        scale = w.float().abs().max().item()
        assert (a.float() - w.float()).abs().max().item() <= tol * scale
        assert torch.equal(a, b)


def _ln_qkv_inputs(B, N, D, H, dtype, device):
    g = torch.Generator(device=device).manual_seed(0)

    def r(*s):
        return 0.05 * torch.randn(*s, generator=g, device=device)
    params = {"ln_scale": 1.0 + r(D), "ln_bias": r(D),
              **{k: r(D, H * 64) for k in ("wq", "wk", "wv")},
              **{k: r(H * 64) for k in ("bq", "bk", "bv")}}
    x = (2.0 * torch.randn(B, N, D, generator=g, device=device)
         + 0.5).to(dtype)
    return params, x


def test_ln_qkv_bf16_kernel_issues_wgmma(cuda):
    """The bf16 kernel runs its products as warpgroup MMAs (HGMMA in its
    SASS), spills nothing, and ptxas reports no serialised wgmma (C7511,
    C7514, C7515) for it."""
    from multimodal_edema_prediction_tpu_torch.ops import build
    build.load("ln_qkv")
    log = build.build_log("ln_qkv")
    usage = {fn: u for fn, u in build.ptxas_usage(log).items()
             if "ln_qkv_bf16_kernel" in fn}
    assert len(usage) == 1, build.ptxas_usage(log)
    for fn, u in usage.items():
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0, (fn, u)
    codes = [w["code"] for w in build.ptxas_warnings(log)
             if w["function"] is None or "ln_qkv_bf16_kernel" in w["function"]]
    assert not set(codes) & {"C7511", "C7514", "C7515"}, codes
    listing = build.sass("ln_qkv")
    if listing is None:
        pytest.skip("the CUDA toolkit has no cuobjdump")
    counts = build.sass_opcode_counts(listing, "HGMMA")
    hits = [n for fn, n in counts.items() if "ln_qkv_bf16_kernel" in fn]
    assert len(hits) == 1 and hits[0] > 0, counts


@pytest.mark.parametrize("lib,kernel", [
    ("flash_attention", "flash_fwd_f32"), ("ln_qkv", "ln_qkv_f32_kernel"),
    ("flash_attention_bwd", "flash_bwd_dkv_f32"),
    ("flash_attention_bwd", "flash_bwd_dq_f32")])
def test_float32_kernels_issue_tf32_mma(cuda, lib, kernel):
    """The float32 forward of K1, its float32 dkv and dq and K4's float32
    kernel run their products on the tensor cores (mma.sync TF32: HMMA ...
    .TF32 in the SASS) and spill nothing."""
    from multimodal_edema_prediction_tpu_torch.ops import build
    build.load(lib)
    usage = {fn: u for fn, u in build.ptxas_usage(
        build.build_log(lib)).items() if kernel in fn}
    assert len(usage) == 1, build.ptxas_usage(build.build_log(lib))
    for fn, u in usage.items():
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0, (fn, u)
    listing = build.sass(lib)
    if listing is None:
        pytest.skip("the CUDA toolkit has no cuobjdump")
    counts = build.sass_opcode_counts(listing, "HMMA", "TF32")
    hits = [n for fn, n in counts.items() if kernel in fn]
    assert len(hits) == 1 and hits[0] > 0, counts


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
    before = G.LAUNCHES["gather_rows_bulk"]
    out = step(state, grid, torch.randn(3, 18, device=cuda), batch,
               torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert G.LAUNCHES["gather_rows_bulk"] == before + 2
    assert bool(torch.isfinite(out["total"])) and state.step == 1


def test_captured_teacher_steps_equal_eager_steps(cuda):
    """``engine.scan_steps`` on the card: calls of 3 bf16 teacher steps on
    the encode-once tier (the first eager, the second captured as one CUDA
    graph and replayed, the third a replay) against 9 eager single steps
    from the same weights on the same batches: every loss, parameter,
    buffer, AdamW moment, both step counts and the generator's state bit
    for bit, and K2's ``LAUNCHES`` count the replays' gathers as the eager
    steps' (2 a step)."""
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
        perceiver=PerceiverConfig(d_latent=32, n_heads=2, dropout=0.1))
    rng = np.random.default_rng(0)
    bank = CXRFeatureBank.build(
        encode_fn_for_teacher(init_teacher(cfg, 0).to(cuda)),
        lambda ids: rng.normal(size=(len(ids), 224, 224, 3)).astype(
            np.float32), np.arange(5))
    step = engine.make_teacher_step(TrainConfig(), cfg.duett, 24,
                                    np.ones(7, np.float32),
                                    feature_source=bank.feature_source())
    grid = torch.randn(3, 30, 10, device=cuda).abs()
    static = torch.randn(3, 18, device=cuda)
    batches = [{
        "stay_rows": rng.integers(0, 3, 4).astype(np.int32),
        "slot_idx": rng.integers(24, 31, 4).astype(np.int32),
        "image_ids": rng.integers(0, 5, 4).astype(np.int32),
        "y_multi": rng.integers(0, 2, (4, 7)).astype(np.float32),
        "y_multi_mask": np.ones((4, 7), np.float32),
        "bin_ends": np.tile(np.arange(1, 25, dtype=np.float32) / 24,
                            (4, 1))} for _ in range(9)]

    def fresh():
        model = init_teacher(cfg, 0).to(cuda)
        return TrainState(model, MultiGroupAdamW(
            model, TrainConfig().optim, 10, frozen_prefixes=("cxr/",))), \
            torch.Generator(device=cuda).manual_seed(3)

    eager, g1 = fresh()
    before = G.LAUNCHES["gather_rows_bulk"]
    want = [step(eager, grid, static, engine.to_device(b, cuda), g1)
            for b in batches]
    torch.cuda.synchronize()
    eager_launches = G.LAUNCHES["gather_rows_bulk"] - before
    graph, g2 = fresh()
    lines = []
    multi = engine.scan_steps(step, 3, lines.append)
    before = G.LAUNCHES["gather_rows_bulk"]
    got = []
    for i in range(3):
        stacked = {k: np.stack([b[k] for b in batches[3 * i:3 * i + 3]])
                   for k in batches[0]}
        got.append(multi(graph, grid, static, engine.to_device(stacked, cuda),
                         g2))
    torch.cuda.synchronize()
    assert eager_launches == 18
    assert G.LAUNCHES["gather_rows_bulk"] - before == eager_launches
    assert len(lines) == 1 and "captured K=3" in lines[0]
    for i, w in enumerate(want):
        for k, v in w.items():
            if v.ndim == 0:
                assert torch.equal(got[i // 3]["per_step"][k][i % 3], v), k
            else:
                assert torch.equal(got[i // 3][k][i % 3], v), k
    for (k, a), b in zip(eager.model.state_dict().items(),
                         graph.model.state_dict().values()):
        assert torch.equal(a, b), k
    for m in ("mu", "nu"):
        for a, b in zip(getattr(eager.optimizer, m),
                        getattr(graph.optimizer, m)):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), m
    assert eager.step == graph.step == 9
    assert int(eager.step_t) == int(graph.step_t) == 9
    assert torch.equal(g1.get_state(), g2.get_state())


def test_kd_step_on_the_card_matches_a_cpu_copy(cuda):
    """One float32 KD step on the pixel tier (TF32 off), on the card and on
    a CPU copy of the same teacher and student: losses within 1e-4
    relative, each student gradient within 1e-4 of its leaf's max abs
    (floored at 1e-2 of the largest gradient), one float32 K1 forward per
    ViT layer."""
    from multimodal_edema_prediction_tpu_torch.config import (
        DuettConfig, PerceiverConfig, StudentConfig, TeacherConfig,
        TrainConfig, ViTConfig)
    from multimodal_edema_prediction_tpu_torch.models.student import \
        init_student
    from multimodal_edema_prediction_tpu_torch.models.teacher import \
        init_teacher
    from multimodal_edema_prediction_tpu_torch.train import engine
    from multimodal_edema_prediction_tpu_torch.train.optim import \
        MultiGroupAdamW
    from multimodal_edema_prediction_tpu_torch.train.state import TrainState
    duett = DuettConfig(n_variables=5, d_embedding=8, n_layers=1)
    tcfg = TeacherConfig(
        duett=duett, vit=ViTConfig(image_size=224, d_model=128, n_layers=2,
                                   n_heads=2, d_feedforward=128),
        perceiver=PerceiverConfig(d_latent=32, n_heads=2))
    cfg = TrainConfig(dtype="float32")
    rng = np.random.default_rng(0)
    host = {"stay_rows": np.array([0, 2, 1, 2], np.int32),
            "slot_idx": np.array([24, 30, 26, 28], np.int32),
            "image_ids": np.arange(4, dtype=np.int32),
            "y": np.array([1, 0, 0, 1], np.float32),
            "y_multi": np.ones((4, 7), np.float32),
            "y_multi_mask": np.ones((4, 7), np.float32),
            "bin_ends": np.tile(np.arange(1, 25, dtype=np.float32) / 24,
                                (4, 1)),
            "pixel_values": rng.normal(size=(4, 224, 224, 3)).astype(
                np.float32)}
    grid = torch.from_numpy(np.abs(rng.normal(size=(3, 30, 10))).astype(
        np.float32))
    static = torch.from_numpy(rng.normal(size=(3, 18)).astype(np.float32))
    out, grads = {}, {}
    for dev in (cuda, torch.device("cpu")):
        teacher = init_teacher(tcfg, 0).to(dev).eval()
        student = init_student(StudentConfig(duett=duett, head_dropout=0.0),
                               1).to(dev)
        state = TrainState(student, MultiGroupAdamW(student, cfg.optim, 10))
        step = engine.make_kd_step(cfg, duett, 24, torch.float32)
        before = A.LAUNCHES["flash_attention_f32"]
        res = step(state, teacher, grid.to(dev), static.to(dev),
                   engine.to_device(host, dev),
                   torch.Generator(device=dev).manual_seed(0))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert A.LAUNCHES["flash_attention_f32"] == before + 2
        out[dev.type] = {k: float(res[k]) for k in ("total", "bce", "kd")}
        grads[dev.type] = {n: p.grad.detach().cpu()
                           for n, p in student.named_parameters()}
    for k, v in out["cpu"].items():
        assert abs(out["cuda"][k] - v) <= 1e-4 * abs(v), k
    floor = 1e-2 * max(float(g.abs().max()) for g in grads["cpu"].values())
    for n, g in grads["cpu"].items():
        scale = max(float(g.abs().max()), floor)
        assert float((grads["cuda"][n] - g).abs().max()) <= 1e-4 * scale, n


def test_grad_flow_batch_on_the_card_matches_a_cpu_copy(cuda):
    """One gradient-flow diagnostics batch (``analysis/
    grad_flow_diagnostics.make_diag_step``, float32, TF32 off) of a
    teacher whose ViT trains, at a geometry that opens K1's gate (224² →
    257 tokens, 2 heads of 64), on the card and on a CPU copy: every
    array within 1e-4 of its max abs; the pixels' gradient reaches the
    image branch alone; on the card one float32 K1 forward and one each
    of D, dkv and dq per ViT layer (the image branch's pixel gradient is
    the only one that runs the ViT's backward)."""
    from multimodal_edema_prediction_tpu_torch.analysis import \
        grad_flow_diagnostics as GF
    from multimodal_edema_prediction_tpu_torch.config import (
        DuettConfig, PerceiverConfig, TeacherConfig, ViTConfig)
    from multimodal_edema_prediction_tpu_torch.models.teacher import \
        init_teacher
    from multimodal_edema_prediction_tpu_torch.train import engine
    tcfg = TeacherConfig(
        duett=DuettConfig(n_variables=5, d_embedding=8, n_layers=1),
        vit=ViTConfig(image_size=224, d_model=128, n_layers=2, n_heads=2,
                      d_feedforward=128),
        perceiver=PerceiverConfig(d_latent=32, n_heads=2),
        freeze_cxr=False)
    rng = np.random.default_rng(0)
    x_ts = np.abs(rng.normal(size=(4, 24, 10))).astype(np.float32)
    x_static = rng.normal(size=(4, 18)).astype(np.float32)
    host = {"y_multi": (rng.random((4, 7)) < 0.5).astype(np.float32),
            "y_multi_mask": np.ones((4, 7), np.float32),
            "bin_ends": np.tile(np.arange(1, 25, dtype=np.float32) / 24,
                                (4, 1)),
            "pixel_values": rng.normal(size=(4, 224, 224, 3)).astype(
                np.float32)}
    keys = [A.launch_key(k, torch.float32) for k in (
        "flash_attention", "flash_attention_bwd_delta",
        "flash_attention_bwd_dkv", "flash_attention_bwd_dq")]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = init_teacher(tcfg, 0).to(dev).eval()
        before = {k: A.LAUNCHES[k] for k in keys}
        res = GF.make_diag_step(model, engine.default_image_source)(
            x_ts, x_static, engine.to_device(host, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert {k: A.LAUNCHES[k] - before[k] for k in keys} == \
                dict.fromkeys(keys, 2)
        out[dev.type] = {k: v.detach().cpu().numpy() for k, v in res.items()}
    for k, want in out["cpu"].items():
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(out["cuda"][k] - want).max()) <= 1e-4 * scale, k
    px = out["cuda"]["px_input_grad"]
    assert px[0] > 0 and (px[1:] == 0).all()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.1)])
@pytest.mark.parametrize("mode", ["single", "legacy", "dual_patch_event"])
def test_mode_forward_on_the_card_matches_plain(cuda, mode, dtype, tol,
                                                monkeypatch):
    """The other teacher modes' pixel forward on the card at a geometry
    that opens K1's gate (224² → 257 tokens, 2 heads of 64): through K1,
    one launch a ViT layer and no other kernel (``dual_patch_event``'s
    image cross-attention takes no ``use_flash``, and its event mask
    closes the gate), against the same model's forward with the plain
    attention on the same card: float32 (TF32 off) within 1e-4 of each
    output's largest magnitude (at least 1), bf16 within 0.1 (as
    ``tests/test_torch_teacher.py`` bounds bf16)."""
    from multimodal_edema_prediction_tpu_torch.config import (
        DuettConfig, PerceiverConfig, TeacherConfig, ViTConfig)
    from multimodal_edema_prediction_tpu_torch.models import layers
    from multimodal_edema_prediction_tpu_torch.models.teacher import \
        init_teacher
    cfg = TeacherConfig(
        duett=DuettConfig(n_variables=5, d_embedding=8, n_layers=1),
        vit=ViTConfig(image_size=224, d_model=128, n_layers=2, n_heads=2,
                      d_feedforward=128),
        perceiver=PerceiverConfig(d_latent=32, n_heads=2, n_latents=4,
                                  use_flash=True),
        perceiver_type=mode)
    model = init_teacher(cfg, 0).to(cuda).eval()
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 3, size=(4, 24, 5)).astype(np.float32)
    counts[0, :, 2] = 0.0                # variable 2 never observed
    inputs = [torch.from_numpy(a).to(cuda, dtype) for a in (
        np.concatenate([rng.normal(size=(4, 24, 5)), counts,
                        np.zeros((4, 24, 1))], -1).astype(np.float32),
        rng.normal(size=(4, 18)).astype(np.float32),
        np.tile(np.arange(1, 25, dtype=np.float32) / 24, (4, 1)),
        rng.normal(size=(4, 224, 224, 3)).astype(np.float32))]
    key = A.launch_key("flash_attention", dtype)
    before = dict(A.LAUNCHES)
    with torch.no_grad():
        got = model(*inputs)
    torch.cuda.synchronize()
    assert A.LAUNCHES == {**before, key: before[key] + 2}
    monkeypatch.setattr(layers, "flash_mha", A.flash_mha_reference)
    with torch.no_grad():
        want = model(*inputs)
    assert set(got) == set(want)
    for k, w in want.items():
        w = w.float()
        assert torch.isfinite(got[k]).all(), k
        scale = max(1.0, float(w.abs().max())) if dtype == torch.float32 \
            else 1.0
        assert float((got[k].float() - w).abs().max()) <= tol * scale, k


def _host_batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"pixel_u8": rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8),
            "image_ids": np.arange(n, dtype=np.int32),
            "y": rng.normal(size=(n, 7)).astype(np.float32),
            "mask": rng.random(n) > 0.5}


def test_prefetched_pinned_copies_equal_synchronous_copies(cuda):
    """The prefetcher's pinned copies on its side stream give the tensors a
    synchronous copy gives, in order, while the consumer's stream is busy;
    its worker is joined at the end."""
    import threading
    from multimodal_edema_prediction_tpu_torch.data.prefetch import prefetch
    from multimodal_edema_prediction_tpu_torch.train import engine
    host = [_host_batch(seed=s) for s in range(6)]
    busy = torch.randn(4096, 4096, device=cuda)
    got = []
    for b in prefetch(iter(host), cuda, depth=2):
        busy = busy @ busy.T * 1e-4            # keep the default stream busy
        got.append({k: v.clone() for k, v in b.items()})
    torch.cuda.synchronize()
    assert not [t for t in threading.enumerate() if t.name == "prefetch"]
    assert len(got) == 6
    for g, h in zip(got, host):
        want = engine.to_device(h, cuda)
        for k in h:
            assert g[k].device.type == "cuda" and g[k].dtype == want[k].dtype
            assert torch.equal(g[k], want[k]), k


def test_hbm_image_bank_lives_on_the_card(cuda):
    """``HBMImageBank`` holds its u8 rows on the card and its source
    normalizes them there, equal to the step's normalization of the same
    rows copied from the host."""
    import os
    import sys
    from multimodal_edema_prediction_tpu_torch.data import images as I
    from multimodal_edema_prediction_tpu_torch.train.engine import \
        default_image_source
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import jpeg_fixtures as J
    blobs = {i: J.encode_gray(J.cxr_like(i, 40 + i, 36), 90)
             for i in (5, 2, 9)}
    bank = I.HBMImageBank(I.JpegStore(blobs=blobs), [9, 2, 5], 28,
                          device=cuda)
    assert bank.bank.device.type == "cuda" and bank.bank.dtype == torch.uint8
    rows = torch.from_numpy(bank.rows_for(np.array([5, 9]))).to(cuda)
    got = bank.image_source()({"image_ids": rows})
    assert got.device.type == "cuda"
    want = default_image_source({"pixel_u8": bank.bank[rows.long()]})
    assert torch.equal(got, want)
    bad = bank.image_source()({"image_ids": torch.tensor(
        [0, 7], dtype=torch.int32, device=cuda)})
    assert torch.isfinite(bad[0]).all() and torch.isnan(bad[1]).all()


def test_card_decoder_within_two_levels_of_libjpeg(cuda):
    """Where the host has no libjpeg, the card's route (nvJPEG and the
    resize kernel) decodes the grayscale golden files within 2 levels of
    the rows libjpeg decoded (``tests/goldens/jpeg_rows_56.npz``)."""
    import os
    from multimodal_edema_prediction_tpu_torch.ops import jpeg
    if not jpeg.nvjpeg_available():
        pytest.skip("the CUDA toolkit here has no nvJPEG")
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                             "jpeg_rows_56.npz"))
    blobs = [g["blob"][s:e].tobytes()
             for s, e in zip(g["offsets"][:-1], g["offsets"][1:])]
    u8, status = jpeg.decoder(cuda).decode_batch(blobs, 56)
    assert not status.any() and u8.device.type == "cuda"
    u8 = u8.cpu().numpy()
    gray = g["gray"].astype(bool)
    diff = np.abs(u8.astype(int) - g["u8"].astype(int))
    assert diff[gray].max() <= 2
    _, bad = jpeg.decoder(cuda).decode_batch([b"\xff\xd8junk", blobs[0]],
                                             56)
    assert bad.tolist() == [1, 0]


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("normalize", [False, True])
def test_resize_kernel_matches_plain(cuda, channels, normalize):
    from multimodal_edema_prediction_tpu_torch.models.vit import (IMAGE_MEAN,
                                                                  IMAGE_STD)
    from multimodal_edema_prediction_tpu_torch.ops import jpeg
    g = torch.Generator(device=cuda).manual_seed(channels)
    src = torch.randint(0, 256, (301, 257, channels), generator=g,
                        device=cuda, dtype=torch.uint8)
    mean, std = (IMAGE_MEAN, IMAGE_STD) if normalize else (None, None)
    before = dict(jpeg.LAUNCHES)
    got = jpeg.jpeg_resize(src, 518, mean, std)
    torch.cuda.synchronize()
    key = "jpeg_resize_f32" if normalize else "jpeg_resize_u8"
    assert jpeg.LAUNCHES[key] == before[key] + 1
    want = jpeg.jpeg_resize_reference(src, 518, mean, std)
    assert got.shape == want.shape == (518, 518, 3)
    err = (got.float() - want.float()).abs().max().item()
    # the kernel contracts the sample position into an FMA: the weights may
    # move by an ulp of a coordinate, times a neighbour step ≤ 255 levels
    # (chip_smoke.py's TOL_RESIZE_U8 and TOL_RESIZE_F32)
    assert err <= (3e-3 if normalize else 1.0)


def test_card_decode_is_the_same_while_the_card_is_busy(cuda):
    """Fault F5: the card route's files decoded while other work keeps the
    default stream busy (as the prefetch worker decodes during a step)
    equal the files decoded on an idle card, bit for bit."""
    import os
    import sys
    import threading
    from multimodal_edema_prediction_tpu_torch.models.vit import (IMAGE_MEAN,
                                                                  IMAGE_STD)
    from multimodal_edema_prediction_tpu_torch.ops import jpeg
    if not jpeg.nvjpeg_available():
        pytest.skip("the CUDA toolkit here has no nvJPEG")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import jpeg_fixtures as J
    blobs = [J.encode_gray(J.cxr_like(50000 + i, 512, 416), 90)
             for i in range(16)]
    dec = jpeg.decoder(cuda)
    idle = dec.decode_batch(blobs, 518, IMAGE_MEAN, IMAGE_STD)[0].cpu()
    x = torch.randn(8192, 8192, device=cuda)
    stop = threading.Event()

    def busy():
        y = x
        while not stop.is_set():
            for _ in range(20):
                y = (y @ x) * 1e-4
            torch.cuda.synchronize()

    th = threading.Thread(target=busy)
    th.start()
    try:
        loaded = [dec.decode_batch(blobs, 518, IMAGE_MEAN, IMAGE_STD)[0]
                  .cpu() for _ in range(4)]
    finally:
        stop.set()
        th.join(timeout=60)
    assert not th.is_alive()
    for got in loaded:
        assert torch.equal(got, idle)


def test_card_decoded_pixels_stay_on_the_card(cuda):
    """On the nvjpeg route the JPEG hook's pixels are on the card, the
    prefetcher hands them on as they are, and the card's u8 bank holds the
    decoder's rows."""
    import os
    import sys
    from multimodal_edema_prediction_tpu_torch.data import images as I
    from multimodal_edema_prediction_tpu_torch.data import native_loader
    from multimodal_edema_prediction_tpu_torch.data.prefetch import prefetch
    if native_loader.route() != "nvjpeg":
        pytest.skip("this host decodes with libjpeg")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import jpeg_fixtures as J
    blobs = {i: J.encode_gray(J.cxr_like(i, 40 + i, 36), 90)
             for i in (5, 2, 9)}
    store = I.JpegStore(blobs=blobs)
    hook = I.make_jpeg_host_fn(store, 28)
    ids = np.array([9, 2])
    want = hook({"image_ids": ids})["pixel_values"]
    assert want.device.type == "cuda" and want.dtype == torch.float32
    host = [{"image_ids": ids, "y": np.zeros(2, np.float32)}] * 3
    n = 0
    for b in prefetch(iter(host), cuda, depth=2, host_fn=hook):
        assert b["pixel_values"].device == want.device
        assert torch.equal(b["pixel_values"], want)
        assert b["y"].device.type == "cuda"
        n += 1
    assert n == 3
    bank = I.HBMImageBank(store, [9, 2, 5], 28, device=cuda)
    assert torch.equal(bank.bank, I.decode_batch_u8(
        [blobs[i] for i in (2, 5, 9)], 28))


def test_knn_and_tsne_on_the_card_match_a_cpu_copy(cuda):
    """The figure suite's embeddings on the card (the chip phase's 448
    fusion tokens of width 256): the UMAP kNN's indices equal and its
    float64 distances within 1e-12 of their max; t-SNE's P within 1e-9 of
    its max (float64 exp and sums in another order), the PCA start within
    1e-5 of its scale, and 200 iterations of the exaggerated descent from
    one start within 1e-3 of the embedding's scale, the KL read within
    1e-3 relative (float32 steps; the card sums in another order)."""
    from multimodal_edema_prediction_tpu_torch.analysis import tsne as T
    from multimodal_edema_prediction_tpu_torch.analysis import umap_impl as U
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(448, 256))
         + 3 * rng.normal(size=(7, 256)).repeat(64, axis=0)).astype(
        np.float32)
    xc = torch.as_tensor(x, device=cuda)
    i_c, d_c = U._knn(xc, 15)
    i_h, d_h = U._knn(x, 15)
    np.testing.assert_array_equal(i_c, i_h)
    assert np.abs(d_c - d_h).max() <= 1e-12 * np.abs(d_h).max()
    P_c = T.joint_probabilities(xc, 30.0)
    P_h = T.joint_probabilities(torch.as_tensor(x), 30.0)
    assert P_c.device.type == "cuda"
    assert float((P_c.cpu() - P_h).abs().max()) <= 1e-9 * float(P_h.max())
    Y_c, Y_h = T.pca_init(xc), T.pca_init(torch.as_tensor(x))
    assert float((Y_c.cpu() - Y_h).abs().max()) <= 1e-5 * float(
        Y_h.abs().max())
    lr = max(448 / 12 / 4, 50.0)
    out = {}
    for dev, P in (("cuda", P_c), ("cpu", P_h)):
        Y, kl, it = T.gradient_descent(Y_h.to(dev), P * 12.0, 0, 200, 0.5,
                                       lr, 250)
        out[dev] = (Y.cpu().numpy(), kl, it)
    (Yc, klc, itc), (Yh, klh, ith) = out["cuda"], out["cpu"]
    assert itc == ith == 199 and np.isfinite(Yc).all()
    assert np.abs(Yc - Yh).max() <= 1e-3 * np.abs(Yh).max()
    assert abs(klc - klh) <= 1e-3 * abs(klh)


@pytest.mark.parametrize("op", ["dense", "proj_bhnk", "out_bhnk"])
@pytest.mark.parametrize("rows", [5, 16, 17, 1370])
def test_int8_ops_on_the_card_match_their_cpu_plain_versions(cuda, op,
                                                             rows):
    """The int8 ops (``torch._int_mm`` on the card; fewer than 17 rows
    padded with zero rows) against their plain versions on a CPU copy:
    int8 codes, scales and int32 accumulators exactly, outputs bit for bit
    in bf16 and float32; K or N not a multiple of 8 raises."""
    from multimodal_edema_prediction_tpu_torch.ops import int8 as I
    rng = np.random.default_rng(rows)
    H, dh, d = 12, 64, 768
    w = torch.from_numpy(rng.normal(size=(d, d)).astype(np.float32) * 0.03)
    b = torch.from_numpy(rng.normal(size=d).astype(np.float32) * 0.02)
    shape = (1, H, rows, dh) if op == "out_bhnk" else (1, rows, d)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    fns = {"dense": (I.int8_dense, I.int8_dense_reference),
           "proj_bhnk": (lambda x, w, b: I.int8_proj_bhnk(x, w, b, H, dh),
                         lambda x, w, b: I.int8_proj_bhnk_reference(
                             x, w, b, H, dh)),
           "out_bhnk": (I.int8_out_bhnk, I.int8_out_bhnk_reference)}[op]
    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)
        got = fns[0](xd.to(cuda), w.to(cuda), b.to(cuda))
        want = fns[1](xd, w, b)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want), (op, rows, dtype)
    rows2 = xd.reshape(-1, d) if op != "out_bhnk" else \
        xd.transpose(1, 2).reshape(-1, d)
    q, s = I.quantize_rows(rows2.to(cuda))
    qh, sh = I.quantize_rows(rows2)
    assert torch.equal(q.cpu(), qh) and torch.equal(s.cpu(), sh)
    wq, _ = I.quantize_rows(w)
    acc = I.int_mm(q, wq.t().to(cuda))
    assert torch.equal(acc.cpu(), I.int_mm_reference(qh, wq.t()))
    with pytest.raises(ValueError, match="multiples of 8"):
        I.int_mm(q[:, :60].contiguous(), wq.t()[:60].to(cuda))


# one rank of test_two_ranks_on_the_card_sum_a_vit_blocks_gradient: joins a
# gloo group of 2 (the ranks share the card, which NCCL refuses), runs the
# ViT-B block on its half of the batch through K1's float32 forward and
# backward, gathers the outputs for the global loss and all-reduces the
# gradient (parallel/multihost.py), then saves it
_RANK = r"""
import sys, torch
from multimodal_edema_prediction_tpu_torch.config import ViTConfig
from multimodal_edema_prediction_tpu_torch.models.layers import init_like_flax
from multimodal_edema_prediction_tpu_torch.models.vit import DinoBlock
from multimodal_edema_prediction_tpu_torch.parallel import multihost as mh
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
assert mh.initialize_distributed(f"localhost:{port}", 2, rank) == "gloo"
block = init_like_flax(DinoBlock(ViTConfig()), 0).cuda()
x = torch.randn(4, 1370, 768, generator=torch.Generator().manual_seed(1))
y = mh.gather_rows(block(x[2 * rank:2 * rank + 2].cuda()))
(y.float() ** 2).mean().backward()
mh.all_reduce_grads(list(block.parameters()))
torch.save({n: p.grad.cpu() for n, p in block.named_parameters()}, out)
torch.distributed.destroy_process_group()
"""


def test_two_ranks_on_the_card_sum_a_vit_blocks_gradient(cuda, tmp_path):
    """Two processes share the card over gloo (``parallel/multihost``:
    ``choose_backend`` takes gloo for 2 ranks on 1 card; gloo all-reduces
    CUDA tensors), each with 2 of 4 images through a ViT-B/14 block at
    1370 tokens in float32; the all-reduced gradient of the global loss
    equals one process's on all 4 images within 1e-4 of each leaf's max
    abs floored at 1e-2 of the largest gradient (the halves' sums in
    another order; the key bias's exact gradient is 0, and only rounding
    noise of ~1e-12 is left in both)."""
    import os
    import socket
    import subprocess
    import sys

    from multimodal_edema_prediction_tpu_torch.config import ViTConfig
    from multimodal_edema_prediction_tpu_torch.models.layers import \
        init_like_flax
    from multimodal_edema_prediction_tpu_torch.models.vit import DinoBlock
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    s = socket.socket()
    s.bind(("localhost", 0))
    port = str(s.getsockname()[1])
    s.close()
    env = {**os.environ, "PYTHONPATH": repo}
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), port,
         str(tmp_path / f"grad{r}.pt")], cwd=repo, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out.decode(errors="replace")[-3000:]
    block = init_like_flax(DinoBlock(ViTConfig()), 0).to(cuda)
    x = torch.randn(4, 1370, 768, generator=torch.Generator().manual_seed(1))
    before = A.LAUNCHES[A.launch_key("flash_attention", torch.float32)]
    (block(x.to(cuda)).float() ** 2).mean().backward()
    assert A.LAUNCHES[A.launch_key("flash_attention", torch.float32)] \
        == before + 1
    grads = [torch.load(tmp_path / f"grad{r}.pt") for r in range(2)]
    top = max(p.grad.abs().max().item() for p in block.parameters())
    for n, p in block.named_parameters():
        want = p.grad.cpu()
        tol = 1e-4 * max(want.abs().max().item(), 1e-2 * top)
        assert torch.equal(grads[0][n], grads[1][n]), n
        assert (grads[0][n] - want).abs().max().item() <= tol, n
