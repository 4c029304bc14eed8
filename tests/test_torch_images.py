"""The port's decode-once image tiers (``data/images.py``) against the JAX
package's on the CPU: the rows of ``DecodedU8Cache``, ``HostU8Bank`` and
``HBMImageBank`` (a CPU tensor here) and their ``rows_for`` errors; the
``U8MemmapStore`` files byte-equal to JAX's, each package opening the
other's store, a fingerprint mismatch refused; the bank's image source
and ``make_bank_image_source`` on ids outside the bank."""
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_edema_prediction_tpu.data import images as JI
from multimodal_edema_prediction_tpu_torch.data import images as I
from multimodal_edema_prediction_tpu_torch.models.vit import (IMAGE_MEAN,
                                                              IMAGE_STD)

SIDE = 28
IDS = np.array([70, 12, 45, 3, 99, 12])      # unsorted, one repeat


def _blobs(ids):
    rng = np.random.default_rng(3)
    out = {}
    for i in np.unique(ids):
        shape = (40, 52, 3) if i % 2 else (33, 33)
        buf = io.BytesIO()
        Image.fromarray((rng.random(shape) * 255).astype(np.uint8)).save(
            buf, format="JPEG")
        out[int(i)] = buf.getvalue()
    return out


@pytest.fixture(scope="module")
def stores():
    b = _blobs(IDS)
    return I.JpegStore(blobs=b), JI.JpegStore(blobs=b)


def test_store_needs_a_root_or_blobs(tmp_path):
    with pytest.raises(ValueError):
        I.JpegStore()
    (tmp_path / "5.jpg").write_bytes(b"xyz")
    assert I.JpegStore(root=str(tmp_path)).get(np.int64(5)) == b"xyz"


def test_jpeg_host_fn_matches_jax(stores):
    batch = {"image_ids": IDS[:4].astype(np.int32), "y": np.zeros(4)}
    got = I.make_jpeg_host_fn(stores[0], SIDE)(batch)
    want = JI.make_jpeg_host_fn(stores[1], SIDE)(batch)
    np.testing.assert_array_equal(got["pixel_values"], want["pixel_values"])
    assert set(got) == set(want) == {"image_ids", "y", "pixel_values"}


def test_u8_cache_rows_match_jax(stores):
    ours = I.DecodedU8Cache(stores[0], SIDE, max_images=3)
    theirs = JI.DecodedU8Cache(stores[1], SIDE, max_images=3)
    for ids in (IDS[:3], IDS[2:], IDS):
        np.testing.assert_array_equal(ours.get_batch(ids),
                                      theirs.get_batch(ids))
        assert sorted(ours._cache) == sorted(theirs._cache)
    hook = I.make_u8_cache_host_fn(ours)({"image_ids": IDS})
    np.testing.assert_array_equal(hook["pixel_u8"],
                                  JI.decode_batch_u8([stores[1].get(i)
                                                      for i in IDS], SIDE))


def test_host_bank_rows_match_jax(stores):
    ours = I.HostU8Bank(stores[0], IDS, SIDE, chunk=2)
    theirs = JI.HostU8Bank(stores[1], IDS, SIDE, chunk=2)
    np.testing.assert_array_equal(ours.ids, theirs.ids)
    np.testing.assert_array_equal(ours.bank, theirs.bank)
    assert ours.nbytes == theirs.nbytes == 5 * SIDE * SIDE * 3
    got = ours.host_fn()({"image_ids": IDS})["pixel_u8"]
    np.testing.assert_array_equal(
        got, theirs.host_fn()({"image_ids": IDS})["pixel_u8"])
    with pytest.raises(KeyError, match="not in host bank"):
        ours.rows_for(np.array([3, 4]))


def test_hbm_bank_rows_and_source_match_jax(stores):
    """The bank (a CPU tensor here), its hook's rows and its image source
    (rows normalized in float32) against the JAX bank's."""
    ours = I.HBMImageBank(stores[0], IDS, SIDE, chunk=2, device="cpu")
    theirs = JI.HBMImageBank(stores[1], IDS, SIDE, chunk=2)
    assert ours.bank.dtype == torch.uint8 and ours.bank.device.type == "cpu"
    np.testing.assert_array_equal(ours.bank.numpy(), np.asarray(theirs.bank))
    assert I.HBMImageBank.nbytes(405, 518) == 326_013_660
    batch = ours.host_fn()({"image_ids": IDS})
    jbatch = theirs.host_fn()({"image_ids": IDS})
    np.testing.assert_array_equal(batch["image_ids"], jbatch["image_ids"])
    assert batch["image_ids"].dtype == np.int32
    got = ours.image_source()(
        {"image_ids": torch.from_numpy(batch["image_ids"])})
    want = np.asarray(theirs.image_source()(jbatch))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    with pytest.raises(KeyError, match="not in HBM bank"):
        ours.rows_for(np.array([70, 71]))


def test_bank_sources_poison_ids_outside_the_bank():
    bank = torch.arange(4 * 2 * 2 * 3, dtype=torch.uint8).reshape(4, 2, 2, 3)
    ids = torch.tensor([1, -1, 4, 3], dtype=torch.int32)
    rows = I.make_bank_image_source(bank)({"image_ids": ids})
    assert rows.dtype == torch.float32
    assert torch.isnan(rows[1]).all() and torch.isnan(rows[2]).all()
    np.testing.assert_array_equal(rows[[0, 3]].numpy(),
                                  bank[[1, 3]].float().numpy())


def test_hbm_bank_source_normalizes_as_the_step_does(stores):
    """The bank's pixels equal the u8 stores' after the step's own
    normalization (``engine.default_image_source``) bit for bit."""
    from multimodal_edema_prediction_tpu_torch.train.engine import \
        default_image_source
    bank = I.HBMImageBank(stores[0], IDS, SIDE, device="cpu")
    rows = torch.from_numpy(bank.rows_for(IDS))
    got = bank.image_source()({"image_ids": rows})
    u8 = torch.from_numpy(I.decode_batch_u8([stores[0].get(i)
                                             for i in IDS], SIDE))
    want = default_image_source({"pixel_u8": u8})
    assert torch.equal(got, want)
    mean = torch.tensor(IMAGE_MEAN)
    std = torch.tensor(IMAGE_STD)
    torch.testing.assert_close(got, (u8.float() / 255.0 - mean) / std)


def _files(path):
    return [f"{path}.meta.json", f"{path}.ids.npy", f"{path}.u8"]


def test_u8_store_files_byte_equal_to_jax(stores, tmp_path):
    ours = I.U8MemmapStore.build(stores[0], IDS, SIDE, str(tmp_path / "a"),
                                 chunk=2)
    JI.U8MemmapStore.build(stores[1], IDS, SIDE, str(tmp_path / "b"),
                           chunk=2)
    for fa, fb in zip(_files(tmp_path / "a"), _files(tmp_path / "b")):
        with open(fa, "rb") as a, open(fb, "rb") as b:
            assert a.read() == b.read(), fa
    assert json.load(open(f"{tmp_path / 'a'}.meta.json"))["complete"]
    np.testing.assert_array_equal(
        ours.get_batch(IDS), JI.decode_batch_u8([stores[1].get(i)
                                                 for i in IDS], SIDE))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_u8_store_opens_across_packages(stores, tmp_path, writer):
    """A store either package built is reopened by the other's ``build``
    (same fingerprint, no decode) and ``open``, with the same rows."""
    path = str(tmp_path / "s")
    w, r = (JI, I) if writer == "jax" else (I, JI)
    store = stores[1] if writer == "jax" else stores[0]
    built = w.U8MemmapStore.build(store, IDS, SIDE, path)
    empty = (I if r is I else JI).JpegStore(blobs={})   # nothing to decode
    again = r.U8MemmapStore.build(empty, IDS, SIDE, path)
    opened = r.U8MemmapStore.open(path, n_threads=3)
    for s in (again, opened):
        assert s.side == SIDE
        np.testing.assert_array_equal(s.get_batch(IDS),
                                      built.get_batch(IDS))
    got = opened.host_fn()({"image_ids": IDS[:2]})["pixel_u8"]
    np.testing.assert_array_equal(got, built.get_batch(IDS[:2]))


def test_u8_store_refuses_another_image_set(stores, tmp_path):
    path = str(tmp_path / "s")
    I.U8MemmapStore.build(stores[0], IDS, SIDE, path)
    with pytest.raises(ValueError, match="different image set"):
        I.U8MemmapStore.build(stores[0], IDS[:3], SIDE, path)
    with pytest.raises(ValueError, match="different image set"):
        JI.U8MemmapStore.build(stores[1], IDS, SIDE + 1, path)
    with pytest.raises(KeyError, match="not in u8 store"):
        I.U8MemmapStore.open(path).rows_for(np.array([1000]))


def test_u8_store_rebuilds_an_incomplete_one(stores, tmp_path):
    path = str(tmp_path / "s")
    I.U8MemmapStore.build(stores[0], IDS, SIDE, path)
    meta = json.load(open(f"{path}.meta.json"))
    json.dump({**meta, "complete": False}, open(f"{path}.meta.json", "w"))
    with pytest.raises(ValueError, match="incomplete"):
        I.U8MemmapStore.open(path)
    again = I.U8MemmapStore.build(stores[0], IDS, SIDE, path)
    assert json.load(open(f"{path}.meta.json"))["complete"]
    assert again.get_batch(IDS[:1]).any()


def test_u8_store_threads_give_the_same_rows(stores, tmp_path):
    path = str(tmp_path / "s")
    one = I.U8MemmapStore.build(stores[0], IDS, SIDE, path, n_threads=1)
    ids = np.resize(IDS, 20)
    np.testing.assert_array_equal(I.U8MemmapStore.open(path, 4)
                                  .get_batch(ids), one.get_batch(ids))
    assert not os.path.exists(path)                # three files, no bare one
