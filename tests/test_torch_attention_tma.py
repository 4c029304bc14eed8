"""The tensor maps of K1's bf16 backward kernels, shaped on the CPU.

The dkv and dq kernels (``csrc/flash_attention_bwd.cu``) load q, k, v and dO
with TMA through 4-D tensor maps (64, rows, H, B) whose byte strides come
from the views themselves (``ops/attention.py::tma_geometry``). The kernels
run only on the card (``tests/test_torch_cuda.py``); what is checked here is
the geometry handed to them: a contiguous tensor, the [B, N, H·64]
projections the ViT views as [B, H, N, 64], rows cut at ``kv_valid``, and the
layouts no tensor map describes, which ``_kernel_ready`` copies.
"""
import ctypes

import pytest
import torch

from multimodal_edema_prediction_tpu_torch.ops import attention as A


def test_contiguous_tensor():
    x = torch.zeros(2, 3, 300, 64, dtype=torch.bfloat16)
    assert A.tma_geometry(x, 300) == (64, 300, 3, 2, 128, 300 * 128,
                                      3 * 300 * 128)


def test_vit_projection_view():
    """[B, N, H·64] viewed as [B, H, N, 64]: rows H·128 bytes apart, heads
    128, batches N·H·128; the map describes the view in place."""
    B, N, H = 2, 1370, 12
    x = torch.zeros(B, N, H * 64, dtype=torch.bfloat16)
    q = x.view(B, N, H, 64).transpose(1, 2)
    assert A.tma_geometry(q, N) == (64, N, H, B, H * 128, 128, N * H * 128)
    assert A._kernel_ready(q) is q


def test_rows_cut_at_kv_valid():
    """k and v end at the keys that take part: rows past ``rows`` read 0."""
    x = torch.zeros(1, 2, 1370, 64, dtype=torch.bfloat16)
    assert A.tma_geometry(x, 1301)[:4] == (64, 1301, 2, 1)
    for rows in (0, 1371):
        with pytest.raises(ValueError, match="rows"):
            A.tma_geometry(x, rows)


def test_single_element_dims_take_a_row_stride():
    """A dim of size one is never stepped over; its stride (which PyTorch
    may leave at another value, 0 included) is replaced by one row's
    bytes."""
    x = torch.zeros(1, 1, 40, 64, dtype=torch.bfloat16).as_strided(
        (1, 1, 40, 64), (8, 0, 64, 1))
    assert A._kernel_ready(x) is x
    assert A.tma_geometry(x, 40) == (64, 40, 1, 1, 128, 128, 128)


@pytest.mark.parametrize("make", [
    # rows 65 elements apart: 130 bytes, not a multiple of 16
    lambda: torch.zeros(2, 2, 300, 65, dtype=torch.bfloat16)[..., 1:],
    # head dim not contiguous
    lambda: torch.zeros(2, 2, 64, 300, dtype=torch.bfloat16).transpose(2, 3),
    # a broadcast batch (stride 0)
    lambda: torch.zeros(1, 2, 300, 64, dtype=torch.bfloat16).expand(
        3, 2, 300, 64),
    # a base that is not 16-byte aligned
    lambda: torch.zeros(2 * 2 * 300 * 64 + 1, dtype=torch.bfloat16)[1:]
    .view(2, 2, 300, 64),
])
def test_layouts_without_a_map_are_refused_then_copied(make):
    x = make()
    with pytest.raises(ValueError, match="no tensor map"):
        A.tma_geometry(x, x.shape[2])
    y = A._kernel_ready(x)
    assert y is not x and torch.equal(y, x)
    B, H, N, _ = x.shape
    assert A.tma_geometry(y, N) == (64, N, H, B, 128, N * 128, H * N * 128)


def test_float32_has_no_map():
    """The float32 kernels read through the strides: no tensor map."""
    x = torch.zeros(1, 2, 300, 64)
    with pytest.raises(ValueError, match="no tensor map"):
        A.tma_geometry(x, 300)
    assert A._tma_maps(x, x, 300) is None


def test_maps_of_the_streamed_tensors_in_order():
    """Seven values per tensor, as the C entry points read them: dkv
    streams q and dO (Nq rows), dq streams k and v (``n_keys`` rows)."""
    B, N, H = 2, 300, 3
    proj = torch.zeros(B, N, 3 * H * 64, dtype=torch.bfloat16)
    q, k, v = (proj[..., i * H * 64:(i + 1) * H * 64].view(B, N, H, 64)
               .transpose(1, 2) for i in range(3))
    do = torch.zeros(B, H, N, 64, dtype=torch.bfloat16)
    view = (H, B, 3 * H * 128, 128, N * 3 * H * 128)
    dkv = A._tma_maps(q, do, N)
    assert isinstance(dkv, ctypes.Array) and len(dkv) == 14
    assert tuple(dkv) == (64, N) + view + (64, N, H, B, 128, N * 128,
                                           H * N * 128)
    assert tuple(A._tma_maps(k, v, 257)) == 2 * ((64, 257) + view)
