"""Card-only checks of the port's CUDA kernels against their plain versions.

Skipped without a CUDA card. On a machine with one (and no JAX) run them
without the suite's conftest, which imports JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: bf16 2e-2 (P and the output rounded to bf16 against a float32
plain version), float32 1e-5 (TF32 off; another summation order).
"""
import pytest
import torch

from multimodal_edema_prediction_tpu_torch.ops import attention as A

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
