"""The port's raw-layout generator (``data/synthetic_raw.py``, no pandas,
no PIL) against the JAX package's: the CSVs byte for byte, and the
rehearsal JPEGs by decoded content (the port writes grayscale baseline
JPEGs with its numpy writer where JAX has PIL's)."""
import os

import numpy as np
import pytest

from multimodal_edema_prediction_tpu.data import synthetic_raw as J
from multimodal_edema_prediction_tpu_torch.data import synthetic_raw as P


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


@pytest.mark.parametrize("n,seed,hours", [(24, 0, 40), (24, 1, 40),
                                          (120, 0, 40), (3, 5, 7),
                                          (1, 0, 40)])
def test_csvs_are_byte_equal_to_jax(tmp_path, n, seed, hours):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    J.make_raw_layout(a, n, hours, seed)
    P.make_raw_layout(b, n, hours, seed)
    assert _files(a) == _files(b) and len(_files(a)) == 10
    for rel in _files(a):
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), rel


def test_the_cli_writes_the_layout(tmp_path, capsys):
    out = str(tmp_path / "raw")
    P.main(["--out", out, "--n_subjects", "3", "--seed", "2"])
    assert "raw MIMIC-style layout" in capsys.readouterr().out
    ref = str(tmp_path / "jax")
    J.make_raw_layout(ref, 3, 40, 2)
    for rel in _files(ref):
        with open(os.path.join(ref, rel), "rb") as fa, \
                open(os.path.join(out, rel), "rb") as fb:
            assert fa.read() == fb.read(), rel


def test_jpegs_decode_to_the_drawn_pixels(tmp_path, capsys):
    """One JPEG per catalog and anchor image id of a port-made cohort; each
    decodes through the port's own decoder to ``side × side``, close to
    the pixels JAX's generator draws for it (q 90), nearer its own drawing
    than any other id's, and no two ids give the same pixels."""
    from multimodal_edema_prediction_tpu_torch.data import images, ingest
    from multimodal_edema_prediction_tpu_torch.data import raw_mimic
    raw, art = str(tmp_path / "raw"), str(tmp_path / "art")
    P.make_raw_layout(raw, n_subjects=6)
    raw_mimic.run_l0(raw, art)
    jpegs = str(tmp_path / "jpegs")
    side = 96
    P.main(["--out", jpegs, "--jpegs_for", art])
    ds = ingest.load_npz(os.path.join(art, "cohort.npz"))
    ids = np.unique(np.concatenate([ds.cxr_catalog.image_ids,
                                    ds.anchors.image_ids]))
    assert len(os.listdir(jpegs)) == len(ids)
    assert f"wrote {len(ids)} JPEGs" in capsys.readouterr().out
    blobs = []
    for i in ids:
        with open(os.path.join(jpegs, f"{int(i)}.jpg"), "rb") as f:
            blobs.append(f.read())
    px = images.host_pixels(images.decode_batch_u8(blobs, side))
    assert px.shape == (len(ids), side, side, 3)
    gray = px[..., 0].astype(np.float64)
    assert (px[..., 0] == px[..., 1]).all() and (px[..., 0]
                                                 == px[..., 2]).all()
    rng = np.random.default_rng(7)         # JAX's draws, in id order
    drawn = np.stack([(rng.random((side, side)) * 255).astype(np.uint8)
                      for _ in ids]).astype(np.float64)
    err = np.abs(gray[:, None] - drawn[None]).mean(axis=(2, 3))
    assert (np.diag(err) < 12.0).all(), np.diag(err).max()
    assert (err.argmin(axis=1) == np.arange(len(ids))).all()
    flat = px.reshape(len(ids), -1)
    assert len(np.unique(flat, axis=0)) == len(ids)
