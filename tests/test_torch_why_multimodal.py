"""The CXR-head ICU-hardness study in the port
(``analysis/why_we_need_multimodal.py``) against the JAX package's:
``evaluate_slices`` and ``write_artifacts`` on the same logits over both
packages' catalogs (the same numpy metrics: every number within 1e-9, the
CSVs and the JSON summary equal, the same figures), and the CLI end to end
on a head the port's ``cli.train_cxr_head`` trained, scored on the
features of the ViT that CLI takes without weights (G1 + G2 + G3 = G0, the
artifacts written).
"""
import argparse
import csv
import json
import os

import numpy as np
import pytest
import torch

from analysis_port_util import assert_report_close
from multimodal_edema_prediction_tpu.analysis import common as JC
from multimodal_edema_prediction_tpu.analysis import \
    why_we_need_multimodal as JW
from multimodal_edema_prediction_tpu_torch.analysis import common as C
from multimodal_edema_prediction_tpu_torch.analysis import \
    why_we_need_multimodal as W
from multimodal_edema_prediction_tpu_torch.cli import train_cxr_head
from multimodal_edema_prediction_tpu_torch.train.cxr_head_loop import \
    split_catalog_subjects

STAYS = "200"
FILES = {"icu_hardness_summary.json", "icu_hardness_table_main.csv",
         "icu_hardness_table_7label.csv", "icu_hardness_macro.png",
         "icu_hardness_per_label_main.png",
         "icu_hardness_per_label_7label.png"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cohort(pkg):
    p = argparse.ArgumentParser()
    pkg.add_analysis_flags(p, needs_ckpt=False)
    ds, _, _, dcfg = pkg.load_analysis_data(p.parse_args(
        ["--synthetic_stays", STAYS]))
    return ds, dcfg


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("full_catalog", [False, True])
def test_slices_and_artifacts_match_jax(full_catalog, tmp_path):
    (jds, dcfg), (ds, _) = _cohort(JC), _cohort(C)
    cat = ds.cxr_catalog
    np.testing.assert_array_equal(cat.image_ids, jds.cxr_catalog.image_ids)
    labels = list(dcfg.pathology_labels)
    logits = np.random.default_rng(0).normal(
        size=(len(cat.image_ids), len(labels))).astype(np.float32)
    sel = None
    if not full_catalog:
        sel = np.zeros(len(cat.image_ids), bool)
        sel[split_catalog_subjects(cat.subject_ids, cat.labels,
                                   seed=dcfg.split_seed)["test"]] = True
    want = JW.evaluate_slices(jds.cxr_catalog, jds.anchors, logits, labels,
                              test_sel=sel)
    got = W.evaluate_slices(cat, ds.anchors, logits, labels, test_sel=sel)
    assert_report_close(got, want, 1e-9)
    assert got["G0_all"]["n"] == sum(got[g]["n"] for g in W.GROUP_ORDER[1:])
    JW.write_artifacts(want, labels, str(tmp_path / "jax"),
                       main_labels=labels[:3])
    assert W.write_artifacts(got, labels, str(tmp_path / "port"),
                             main_labels=labels[:3]) == []
    assert set(os.listdir(tmp_path / "port")) == \
        set(os.listdir(tmp_path / "jax")) == FILES
    for name in ("icu_hardness_table_main.csv",
                 "icu_hardness_table_7label.csv"):
        assert _rows(tmp_path / "port" / name) == \
            _rows(tmp_path / "jax" / name)
    with open(tmp_path / "port" / "icu_hardness_summary.json") as f, \
            open(tmp_path / "jax" / "icu_hardness_summary.json") as g:
        assert_report_close(json.load(f), json.load(g), 1e-9)


def test_cli_end_to_end(tmp_path):
    head = train_cxr_head.main([
        "--device", "cpu", "--vit_size", "tiny", "--synthetic_stays",
        STAYS, "--batch_size", "32", "--epochs", "2",
        "--ckpt_dir", str(tmp_path / "head")])["ckpt_path"]
    r = W.main(["--device", "cpu", "--head_ckpt", head, "--vit_size",
                "tiny", "--synthetic_stays", STAYS, "--batch_size", "32",
                "--out_dir", str(tmp_path / "out")])
    assert set(r) == set(W.GROUP_ORDER)
    assert r["G0_all"]["n"] == sum(r[g]["n"] for g in W.GROUP_ORDER[1:])
    assert r["G0_all"]["n"] > 0 and np.isfinite(r["G0_all"]["macro_auroc"])
    assert set(os.listdir(tmp_path / "out")) == \
        FILES | {"why_we_need_multimodal.json"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            W.main(["--head_ckpt", head, "--out_dir", str(tmp_path / "x")])
