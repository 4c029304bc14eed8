"""The tensor maps of K1's bf16 kernels, shaped on the CPU.

The forward (``csrc/flash_attention.cu``) and the dkv and dq kernels
(``csrc/flash_attention_bwd.cu``) load q, k, v and dO with TMA through 4-D
tensor maps (64, rows, H, B) whose byte strides come from the views
themselves (``ops/attention.py::tma_geometry``). The kernels run only on
the card (``tests/test_torch_cuda.py``); what is checked here is the
geometry handed to them: a contiguous tensor, the [B, N, H·64] projections
the ViT views as [B, H, N, 64], rows cut at ``kv_valid``, the layouts no
tensor map describes, which ``_kernel_ready`` copies, and what each
kernel's wrapper passes to its C entry point. Also here: the backward's D
on a CPU tensor is its plain version.
"""
import ctypes

import numpy as np
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


def _vit_views(B, N, H, dtype=torch.bfloat16):
    proj = torch.zeros(B, N, 3 * H * 64, dtype=dtype)
    return [proj[..., i * H * 64:(i + 1) * H * 64].view(B, N, H, 64)
            .transpose(1, 2) for i in range(3)]


@pytest.fixture
def launches(monkeypatch):
    """What the wrappers hand ``_launch``: (name, dtype, args) per call."""
    calls = []
    monkeypatch.setattr(A, "_launch", lambda name, dtype, args, device:
                        calls.append((name, dtype, args)))
    return calls


@pytest.mark.parametrize("with_lse", [False, True])
def test_forward_streams_k_and_v_through_maps_cut_at_n_keys(launches,
                                                            with_lse):
    """The forward takes the ViT's strided q, k, v in place, the maps of k
    and v with ``n_keys`` rows (the dq kernel's), o in [B, N, H, 64]
    storage, and an lse buffer only when asked."""
    B, N, H = 2, 1370, 12
    q, k, v = _vit_views(B, N, H)
    o, lse = A.forward_kernel(q, k, v, 0.125, 1301, with_lse)
    ((name, dtype, args),) = launches
    assert name == "flash_attention_fwd" and dtype == torch.bfloat16
    assert all(a is x for a, x in zip(args[:4], (q, k, v, o)))
    assert o.shape == (B, H, N, 64) and o.permute(0, 2, 1, 3).is_contiguous()
    assert (args[4] is None) == (lse is None) == (not with_lse)
    assert args[5:11] == [B, H, N, N, 1301, 0.125]
    assert tuple(args[11]) == sum((x.stride()[:3] for x in (q, k, v, o)), ())
    view = (H, B, 3 * H * 128, 128, N * 3 * H * 128)
    assert tuple(args[12]) == 2 * ((64, 1301) + view)
    assert tuple(args[12]) == tuple(A._tma_maps(k, v, 1301))


def test_float32_forward_has_no_maps(launches):
    q = torch.zeros(1, 2, 300, 64)
    A.forward_kernel(q, q, q, 0.125, 300, False)
    assert launches[0][2][12] is None


def test_backward_kernels_take_their_streamed_tensors_maps(launches):
    """dkv streams q and dO (Nq rows), dq streams k and v (``n_keys``)."""
    B, N, H = 2, 300, 3
    q, k, v = _vit_views(B, N, H)
    do = torch.zeros(B, H, N, 64, dtype=torch.bfloat16)
    lse = dlt = torch.zeros(B, H, N)
    A.dkv_kernel(q, k, v, do, lse, dlt, 0.125, 257)
    A.dq_kernel(q, k, v, do, lse, dlt, 0.125, 257)
    (dkv, _, a), (dq, _, b) = launches
    assert (dkv, dq) == ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    assert tuple(a[-1]) == tuple(A._tma_maps(q, do, N))
    assert tuple(b[-1]) == tuple(A._tma_maps(k, v, 257))


def test_delta_on_a_cpu_tensor_is_the_plain_version(launches):
    """D = rowsum(dO∘O) in float32 on the CPU, no launch: bit for bit the
    plain version, and within float32 rounding of a float64 sum, on the
    forward's [B, N, H, 64] storage and a strided dO."""
    rng = np.random.default_rng(0)
    o = torch.from_numpy(rng.standard_normal((2, 37, 3, 64), np.float32)) \
        .bfloat16().permute(0, 2, 1, 3)
    do = _vit_views(2, 37, 3)[1].copy_(torch.from_numpy(
        rng.standard_normal((2, 3, 37, 64), np.float32)))
    got = A.delta(o, do)
    assert not launches
    want = A.delta_reference(o, do)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 37)
    assert got.is_contiguous() and torch.equal(got, want)
    exact = (o.double() * do.double()).sum(-1)
    assert (got.double() - exact).abs().max().item() <= \
        1e-6 * exact.abs().max().item()


def test_delta_refuses_a_device_without_a_kernel():
    o = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        A.delta(o, o)
