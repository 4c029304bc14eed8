"""The port's JPEG decoder (``data/native_loader.py`` on the libjpeg route,
``data/images.py::decode_batch``/``decode_batch_u8``) against the JAX
package's, bit for bit, on JPEGs PIL writes here (RGB, grayscale,
non-square, MIMIC-CXR-JPG's 3056 × 2544) and on the fixture writer's
(``scripts/jpeg_fixtures.py``, which PIL reads as the port does); a file
that does not decode raises ``ValueError`` naming its batch item; the
decoder's build; the card route's resize kernel's plain version
(``ops/jpeg.py::jpeg_resize_reference``) against the host decoder's
resize."""
import io
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_edema_prediction_tpu.data import images as JI
from multimodal_edema_prediction_tpu_torch.data import images as I
from multimodal_edema_prediction_tpu_torch.data import native_loader as NL
from multimodal_edema_prediction_tpu_torch.models.vit import (IMAGE_MEAN,
                                                              IMAGE_STD)
from multimodal_edema_prediction_tpu_torch.ops import jpeg as OJ

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import jpeg_fixtures as J  # noqa: E402


def _pil_jpeg(arr: np.ndarray, quality: int = 75) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


SHAPES = {"rgb_square": (64, 64, 3), "gray_square": (64, 64),
          "rgb_wide": (600, 700, 3), "gray_tall": (1000, 800),
          "rgb_518": (518, 518, 3), "mimic_gray": J.MIMIC_CXR_SHAPE}


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(0)
    return {name: _pil_jpeg((rng.random(shape) * 255).astype(np.uint8))
            for name, shape in SHAPES.items()}


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("side", [518, 56])
def test_decode_is_bit_equal_to_jax(blobs, name, side):
    """float32 (normalized) and u8 pixels equal the JAX package's
    ``decode_batch`` / ``decode_batch_u8`` bit for bit."""
    b = [blobs[name], blobs["gray_square"]]
    np.testing.assert_array_equal(I.decode_batch(b, side),
                                  JI.decode_batch(b, side))
    np.testing.assert_array_equal(I.decode_batch_u8(b, side),
                                  JI.decode_batch_u8(b, side))


@pytest.mark.parametrize("threads", [1, 3])
def test_decode_threads_do_not_change_pixels(blobs, threads):
    b = [blobs[n] for n in sorted(SHAPES) if n != "mimic_gray"]
    np.testing.assert_array_equal(I.decode_batch_u8(b, 56, n_threads=threads),
                                  I.decode_batch_u8(b, 56, n_threads=4))


@pytest.mark.parametrize("fn", [I.decode_batch, I.decode_batch_u8])
def test_a_bad_jpeg_raises_naming_its_items(blobs, fn):
    """JAX ``images.py:50-52``: a file that does not decode raises
    ``ValueError`` naming the batch items, never zeros in the batch."""
    b = [blobs["gray_square"], b"\xff\xd8 not a jpeg", blobs["rgb_square"],
         b""]
    with pytest.raises(ValueError, match=r"batch items \[1 3\]"):
        fn(b, 56)


def test_the_native_status_marks_the_bad_item(blobs):
    px, status = NL.decode_jpeg_batch_u8_native(
        [b"junk", blobs["gray_square"]], 28)
    assert status.tolist() == [1, 0]
    assert not px[0].any() and px[1].any()


@pytest.mark.parametrize("shape", [(64, 64), (61, 77), (300, 232)])
def test_fixture_writer_reads_the_same_in_pil_and_the_port(shape):
    """The numpy writer's baseline grayscale files: PIL and the port's
    decoder read the same pixels (the port at the file's own side is an
    identity resize), close to what was drawn."""
    img = J.cxr_like(7, *shape)
    blob = J.encode_gray(img, 90)
    pil = np.asarray(Image.open(io.BytesIO(blob)))
    assert pil.shape == shape
    assert np.abs(pil.astype(int) - img).mean() < 4.0
    if shape[0] == shape[1]:
        ours = I.decode_batch_u8([blob], shape[0])[0]
        for c in range(3):
            np.testing.assert_array_equal(ours[..., c], pil)
    np.testing.assert_array_equal(I.decode_batch_u8([blob], 56),
                                  JI.decode_batch_u8([blob], 56))


def test_fixture_images_differ_by_id():
    a, b = J.cxr_like(50000, 96, 80), J.cxr_like(50001, 96, 80)
    assert np.abs(a.astype(int) - b).mean() > 5.0
    np.testing.assert_array_equal(a, J.cxr_like(50000, 96, 80))


@pytest.mark.parametrize("processes", [0, 2])
def test_fixture_writer_writes_files(tmp_path, processes):
    """In this process or split over subprocesses, the same files."""
    sizes = J.write_jpegs(str(tmp_path), [3, 4, 9], 40, 48,
                          processes=processes)
    assert sorted(os.listdir(tmp_path)) == ["3.jpg", "4.jpg", "9.jpg"]
    store = I.JpegStore(root=str(tmp_path))
    for i in (3, 4, 9):
        assert store.get(i) == J.encode_gray(J.cxr_like(i, 40, 48), 90)
        assert len(store.get(i)) == sizes[i]
    assert Image.open(io.BytesIO(store.get(4))).size == (48, 40)


def test_build_is_keyed_by_source_and_flags():
    """The library lands under build/torch_host/ with a hash of the source
    and the flags in its name; the flags are the ISA-neutral ones."""
    path = NL.build()
    assert os.path.dirname(path) == NL.BUILD_DIR
    assert os.path.basename(path).startswith("libjpeg_decode-")
    assert "-march=native" not in NL.CXX_FLAGS
    assert {"-mavx2", "-mfma"} <= set(NL.CXX_FLAGS)
    assert NL.build() == path == NL.lib_path()
    assert NL.route() == "libjpeg"


@pytest.mark.parametrize("side", [56, 100])
@pytest.mark.parametrize("gray", [True, False])
def test_card_resize_plain_version_matches_the_host_decoder(gray, side):
    """``jpeg_resize_reference`` (the card kernel's oracle) applied to the
    full decoded image gives the host decoder's resized pixels: u8 within
    one level (float contraction may move a half), float32 within 1e-5."""
    rng = np.random.default_rng(1)
    shape = (90, 90) if gray else (90, 90, 3)
    blob = _pil_jpeg((rng.random(shape) * 255).astype(np.uint8))
    full = I.decode_batch_u8([blob], 90)[0]
    src = torch.from_numpy(full[..., :1] if gray else full)
    u8 = OJ.jpeg_resize(src, side).numpy()
    assert np.abs(u8.astype(int) - I.decode_batch_u8([blob], side)[0]
                  ).max() <= 1
    f32 = OJ.jpeg_resize(src, side, IMAGE_MEAN, IMAGE_STD).numpy()
    np.testing.assert_allclose(f32, I.decode_batch([blob], side)[0],
                               atol=1e-5)


def test_card_decode_golden_rows_are_the_host_decoders():
    """``tests/goldens/jpeg_rows_56.npz`` (the rows the card route is held
    against) are what the libjpeg route decodes here."""
    g = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                             "jpeg_rows_56.npz"))
    b = [g["blob"][s:e].tobytes()
         for s, e in zip(g["offsets"][:-1], g["offsets"][1:])]
    np.testing.assert_array_equal(I.decode_batch_u8(b, 56), g["u8"])
    np.testing.assert_array_equal(I.decode_batch(b, 56), g["f32"])
