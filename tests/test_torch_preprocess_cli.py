"""The port's ``cli.preprocess`` end to end on the CPU: the same cohort as
the JAX CLI from the same raw layout, the per-array digests that
``chip_smoke.py``'s ``l0`` phase checks on the card's host (both
packages' output, computed on the CPU), the same digests from the
committed feather fixtures (LZ4 and ZSTD, as pyarrow wrote them), the
``l0`` phase's own csv → feather conversion (``l0_to_feather``) giving
the CSV route's cohort in both packages, and the produced cohort through
``load_artifacts`` → ``build_anchor_dataset`` → the teacher CLI at a tiny
width, one train step with a finite loss, the steps the ``l0`` phase
predicts."""
import os
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_edema_prediction_tpu.cli import preprocess as jax_cli
from multimodal_edema_prediction_tpu_torch.cli import preprocess as cli
from multimodal_edema_prediction_tpu_torch.data import synthetic_raw


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    """The 24-subject layout (seed 0) as the port writes it, preprocessed
    by both packages' CLIs."""
    root = str(tmp_path_factory.mktemp("raw"))
    synthetic_raw.make_raw_layout(root, n_subjects=24, seed=0)
    jout = str(tmp_path_factory.mktemp("jax"))
    pout = str(tmp_path_factory.mktemp("port"))
    jax_cli.main(["--raw_root", root, "--out_dir", jout])
    paths = cli.main(["--raw_root", root, "--out_dir", pout])
    return root, jout, pout, paths


def test_the_cli_writes_what_jax_writes(cohorts, capsys, tmp_path):
    root, jout, pout, paths = cohorts
    assert sorted(paths) == ["cohort", "final_cxr_df", "final_df", "meta",
                             "static_full"]
    for k, p in paths.items():
        assert os.path.dirname(p) == pout and os.path.exists(p), k
    a = np.load(os.path.join(jout, "cohort.npz"))
    b = np.load(paths["cohort"])
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    again = cli.main(["--raw_root", root, "--out_dir", str(tmp_path),
                      "--label_policy", "keep", "--count_clip", "9"])
    out = capsys.readouterr().out
    assert all(f"[l0] {k}: {v}" in out for k, v in again.items())


def test_chip_smoke_digests_are_both_packages(cohorts):
    """``L0_DIGESTS`` (pinned in ``chip_smoke.py``) are the digests of
    the JAX package's ``cohort.npz`` and of the port's, every array."""
    _, jout, _, paths = cohorts
    want = chip_smoke.L0_DIGESTS
    assert chip_smoke.cohort_digests(os.path.join(jout, "cohort.npz")) \
        == want
    assert chip_smoke.cohort_digests(paths["cohort"]) == want
    assert len(want) == 22


@pytest.mark.parametrize("codec", ["lz4", "zstd"])
def test_feather_fixtures_hash_to_the_pinned_digests(codec, tmp_path):
    """``tests/goldens/feather_l0/<codec>`` (pyarrow's files of the same
    24 subjects) through both packages' CLIs: ``L0_DIGESTS``."""
    raw = str(tmp_path / "raw")
    shutil.copytree(os.path.join(chip_smoke.L0_GOLDENS, codec), raw)
    assert not any(n.endswith(".csv") for _, _, ns in os.walk(raw)
                   for n in ns)
    paths = cli.main(["--raw_root", raw, "--out_dir", str(tmp_path / "p")])
    assert chip_smoke.cohort_digests(paths["cohort"]) == \
        chip_smoke.L0_DIGESTS
    jax_cli.main(["--raw_root", raw, "--out_dir", str(tmp_path / "j")])
    assert chip_smoke.cohort_digests(str(tmp_path / "j" / "cohort.npz")) \
        == chip_smoke.L0_DIGESTS


def test_the_port_converted_feather_route_equals_the_csv_route(cohorts,
                                                              tmp_path):
    """``chip_smoke.l0_to_feather`` (``read_csv`` → ``write_feather``, LZ4)
    of the raw layout: the port's CLI and JAX's give the CSV route's
    cohort and meta, and the audit files read back equal the frames in
    memory."""
    port = chip_smoke.import_port()
    root, _, pout, paths = cohorts
    ftr = str(tmp_path / "ftr")
    with chip_smoke.CodecTimer(port["lz4"], "compress") as enc:
        conv = chip_smoke.l0_to_feather(port, root, ftr)
    assert conv["tables"] == 10 and enc.summary()["calls"] > 0
    with chip_smoke.CodecTimer(port["lz4"], "decompress") as dec:
        got = cli.main(["--raw_root", ftr, "--out_dir", str(tmp_path / "p")])
    # buffers that LZ4 did not shrink are stored raw and not decoded
    assert 0 < dec.summary()["MB"] <= enc.summary()["MB"]
    assert port["lz4"].decompress is dec.orig        # restored
    want = chip_smoke.cohort_digests(paths["cohort"])
    assert chip_smoke.cohort_digests(got["cohort"]) == want
    with open(paths["meta"], "rb") as a, open(got["meta"], "rb") as b:
        assert a.read() == b.read()
    jax_cli.main(["--raw_root", ftr, "--out_dir", str(tmp_path / "j")])
    assert chip_smoke.cohort_digests(str(tmp_path / "j" / "cohort.npz")) \
        == want
    frames = port["raw_mimic"].build_audit_frames(ftr)
    for name, frame in zip(("static_full", "final_df", "final_cxr_df"),
                           frames):
        back = port["frames"].read_feather(got[name])
        assert chip_smoke.frames_equal(frame, back), name
    other = dict(frames[0])
    other["age_at_intime"] = other["age_at_intime"] + 1.0
    assert not chip_smoke.frames_equal(frames[0], other)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_cohort_trains_a_teacher_step(cohorts, tmp_path):
    """``--data_dir`` on the produced cohort: the teacher CLI (tiny ViT,
    the CPU) takes the train and eval steps that ``chip_smoke.py``'s
    ``l0`` phase predicts from the cohort's splits, with finite losses."""
    from multimodal_edema_prediction_tpu_torch import config
    from multimodal_edema_prediction_tpu_torch.cli import train_teacher
    from multimodal_edema_prediction_tpu_torch.data import ingest, pipeline
    _, _, pout, _ = cohorts
    port = {"ingest": ingest, "pipeline": pipeline, "config": config}
    split, steps, evals = chip_smoke.l0_teacher_steps(port, pout, 8, 2)
    assert sum(split.values()) == 24 and steps == 2
    res = train_teacher.main([
        "--device", "cpu", "--vit_size", "tiny", "--data_dir", pout,
        "--batch_size", "8", "--epochs", "1", "--limit_batches", "2",
        "--warmup_steps", "1", "--no_save_state",
        "--ckpt_dir", str(tmp_path)])
    assert res.extras["n_train_steps"] == steps
    assert res.extras["n_eval_steps"] == evals
    assert all(np.isfinite(h["train_total"]) for h in res.history)
