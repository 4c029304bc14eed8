"""K2, the row gather (``ops/gather.py``), and the feature bank built on it
(``data/features.py::CXRFeatureBank``), against the JAX package.

The JAX kernel runs in Pallas interpret mode, as ``tests/test_pallas_gather.py``
runs it on the CPU; the port's wrapper runs its plain version for CPU
tensors. Tolerance: bit-exact (a gather moves bytes). Invalid ids gather the
NaN sentinel row, as in ``tests/test_pallas_gather.py:61-86`` (valid rows
compared exactly here, where that test allows rtol 1e-6).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.data import features as JF
from multimodal_edema_prediction_tpu.ops.pallas_gather import gather_rows as jgather
from multimodal_edema_prediction_tpu_torch.data import features as F
from multimodal_edema_prediction_tpu_torch.ops import gather as G


def _both(bank: np.ndarray, rows: np.ndarray):
    want = np.asarray(jgather(jnp.asarray(bank), jnp.asarray(rows),
                              interpret=True))
    tb = torch.from_numpy(bank.astype(np.float32))
    if bank.dtype == ml_dtypes.bfloat16:
        tb = tb.to(torch.bfloat16)
    before = G.LAUNCHES["gather_rows"]
    got = G.gather_rows(tb, torch.from_numpy(rows))
    assert G.LAUNCHES["gather_rows"] == before      # no kernel on the CPU
    return want, got.float().numpy()


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("shape", [(37, 16, 128), (21, 128)])
def test_gather_matches_pallas_kernel(dtype, shape):
    rng = np.random.default_rng(0)
    bank = rng.normal(size=shape).astype(np.float32).astype(dtype)
    rows = rng.integers(0, shape[0], size=9).astype(np.int32)
    want, got = _both(bank, rows)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    np.testing.assert_array_equal(got, bank[rows].astype(np.float32))


def test_gather_repeated_rows_and_sentinel():
    """Duplicate rows read the same bank row independently; the last row
    (the feature bank's NaN sentinel) gathers as NaN."""
    bank = np.arange(6 * 8 * 128, dtype=np.float32).reshape(6, 8, 128)
    bank[-1] = np.nan
    rows = np.array([3, 3, 0, 5, 3, 5], np.int32)
    want, got = _both(bank, rows)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[[3, 5]]).all() and not np.isnan(got[:3]).any()


def test_out_of_range_rows_fill_nan_or_zero():
    """The plain version's contract for rows outside [0, N) (the kernel's
    too): NaN for floating banks, zeros otherwise; never a wrap-around."""
    bank = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    got = G.gather_rows(bank, torch.tensor([1, 4, -1], dtype=torch.int32))
    assert torch.equal(got[0], bank[1]) and torch.isnan(got[1:]).all()
    ints = G.gather_rows(bank.to(torch.uint8)[:, None],
                         torch.tensor([-1, 2], dtype=torch.int32))
    assert (ints[0] == 0).all() and torch.equal(ints[1, 0],
                                                bank[2].to(torch.uint8))


def test_wrapper_rejects_what_it_does_not_take():
    bank = torch.zeros(4, 2, 3)
    with pytest.raises(ValueError, match="int32"):
        G.gather_rows(bank, torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="bank must be"):
        G.gather_rows(torch.zeros(4), torch.tensor([0], dtype=torch.int32))
    with pytest.raises(ValueError, match="bank on cpu and rows on meta"):
        G.gather_rows(bank, torch.empty(2, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("row_bytes,bank_ptr,out_ptr,want", [
    (1370 * 768 * 2, 0x7F0000000000, 0x7F0000200000, "bulk"),   # patch bank
    (768 * 2, 0x7F0000000000, 0x7F0000000600, "bulk"),          # CLS bank
    (1370 * 768 * 4, 16, 4096, "bulk"),                         # float32
    (3 * 2, 0x7F0000000000, 0x7F0000000000, "vector"),          # [N, 3] bf16
    (1536, 0x7F0000000008, 0x7F0000000000, "vector"),           # bank offset
    (1536, 0x7F0000000000, 0x7F0000000004, "vector"),           # out offset
    (24, 0, 0, "vector"),                                       # 8-byte rows
])
def test_route_follows_alignment(row_bytes, bank_ptr, out_ptr, want):
    """The kernel a CUDA gather takes depends on alignment alone: TMA bulk
    copies need the row size and both base addresses on 16 bytes."""
    assert G.route(row_bytes, bank_ptr, out_ptr) == want


def test_feature_bank_sentinel_poisons_invalid_rows():
    rng = np.random.default_rng(3)
    n, p, d = 7, 5, 16
    ids = np.arange(100, 100 + n, dtype=np.int64)
    cls = rng.normal(size=(n, d)).astype(np.float32)
    patches = rng.normal(size=(n, p, d)).astype(np.float32)
    nan = np.full((1,), np.nan, np.float32)
    bank = F.CXRFeatureBank(
        ids, torch.from_numpy(np.concatenate([cls, nan[:, None] + cls[:1]])),
        torch.from_numpy(np.concatenate([patches,
                                         nan[:, None, None] + patches[:1]])))
    jbank = JF.CXRFeatureBank(ids, cls, patches)
    keys = np.array([0, n - 1, n, -1, 3], np.int32)
    got_c, got_p = bank.feature_source()(
        {"image_ids": torch.from_numpy(keys)})
    want_c, want_p = jbank.feature_source(keyed_by_row=True)(
        {"image_ids": jnp.asarray(keys)})
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_c[0].numpy(), cls[0])
    np.testing.assert_array_equal(got_p[1].numpy(), patches[n - 1])
    assert torch.isnan(got_c[2:4]).all() and torch.isnan(got_p[2:4]).all()
    # host hook: raw ids → rows, unknown ids raise
    np.testing.assert_array_equal(
        bank.host_fn()({"image_ids": np.array([103, 100])})["image_ids"],
        jbank.host_fn()({"image_ids": np.array([103, 100])})["image_ids"])
    with pytest.raises(KeyError):
        bank.rows_for(np.array([55555]))


def test_feature_bank_nbytes_counts_sentinel():
    assert F.CXRFeatureBank.nbytes(0) == JF.CXRFeatureBank.nbytes(0) == \
        1370 * 768 * 2
    assert F.CXRFeatureBank.nbytes(404) == JF.CXRFeatureBank.nbytes(404)


def test_build_feature_arrays_fixed_chunks():
    """Chunks of 16 with the last one padded, ids sorted and unique, stored
    in the requested dtype, with the NaN sentinel as the last row."""
    calls = []

    def encode(px):
        calls.append(px.shape[0])
        x = torch.as_tensor(px)
        return x[:, 0, 0], x[:, 0]

    ids = np.array([7, 3, 3, 40] + list(range(100, 120)))
    pixels = lambda i: np.stack(  # noqa: E731
        [np.full((2, 2, 3), float(v), np.float32) for v in i])
    sid, c, p = F.build_feature_arrays(encode, pixels, ids,
                                       out_dtype=torch.bfloat16)
    jid, jc, jp = JF.build_feature_arrays(
        lambda px: (px[:, 0, 0], px[:, 0]), pixels, ids)
    assert calls == [16, 16]
    np.testing.assert_array_equal(sid, jid)
    assert c.dtype == torch.bfloat16
    assert tuple(p.shape) == (jp.shape[0] + 1,) + jp.shape[1:]
    np.testing.assert_array_equal(c[:-1].float().numpy(),
                                  np.asarray(jc, np.float32))
    np.testing.assert_array_equal(p[:-1].float().numpy(),
                                  np.asarray(jp, np.float32))
    assert torch.isnan(c[-1].float()).all() and torch.isnan(p[-1].float()).all()
    with pytest.raises(ValueError, match="sentinel"):
        F.CXRFeatureBank(sid, c[:-1], p[:-1])
