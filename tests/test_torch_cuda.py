"""Card-only checks of the port's CUDA kernels against their plain versions.

Skipped without a CUDA card. On a machine with one (and no JAX) run them
without the suite's conftest, which imports JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K1 bf16 2e-2 (P and the output rounded to bf16 against a
float32 plain version), float32 1e-5 (TF32 off; another summation order);
K2 bit-exact (a gather moves bytes).
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


def test_flash_refuses_a_gradient_it_cannot_give(cuda):
    """The forward kernel's output has no grad_fn: on the card a q, k or v
    that requires a gradient raises instead of losing it."""
    q = torch.zeros(1, 2, 300, 64, device=cuda, requires_grad=True)
    k = torch.zeros(1, 2, 300, 64, device=cuda)
    with pytest.raises(NotImplementedError, match="K1 backward"):
        A.flash_mha(q, k, k, 0.125)
    with torch.no_grad():
        assert A.flash_mha(q, k, k, 0.125).grad_fn is None


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
