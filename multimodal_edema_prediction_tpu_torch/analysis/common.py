"""Shared analysis machinery: the part of
``multimodal_edema_prediction_tpu/analysis/common.py`` that the inference
CLI (``cli/predict.py``) takes: the flags, the image and feature sources,
the data and the teacher. The config rides in the checkpoint's sidecar, so
the teacher is rebuilt in one call (the reference's ``load_teacher``,
analysis/visualize_pathology.py:94-192); the data from the flags the
trainers take. The rest of that module (``gather_host_windows``,
``different_subject_permutation``, ``subject_cluster_bootstrap``,
``attention_entropy``) goes with the analysis scripts, ROADMAP P19.
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional, Tuple

import torch

from ..config import DataConfig
from ..data import pipeline as P
from ..data import synthetic as S


def add_analysis_flags(p: argparse.ArgumentParser, needs_ckpt: bool = True
                       ) -> None:
    """The JAX analysis CLIs' flags, and ``--device``."""
    if needs_ckpt:
        p.add_argument("--ckpt", type=str, required=True,
                       help="teacher best checkpoint (.msgpack), written by "
                            "either package")
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--synthetic_stays", type=int, default=400)
    p.add_argument("--n_variables", type=int, default=34)
    p.add_argument("--split", type=str, default="test",
                   choices=["train", "val", "test"])
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_boot", type=int, default=200)
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--out_dir", type=str, default="analysis_out")
    p.add_argument("--cxr_jpeg_root", type=str, default="",
                   help="directory of {image_id}.jpg files: run on real "
                        "CXRs instead of procedural images")
    p.add_argument("--cxr_feature_cache", type=str, default="none",
                   choices=["none", "hbm"],
                   help="encode-once tier: every unique image of the cohort "
                        "through the frozen ViT once, into a token bank on "
                        "the device; each forward then gathers its tokens "
                        "(K2) instead of running the ViT")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")


def make_image_source(args, anchor_ds, vit_cfg) -> Callable:
    """The eval steps' image source. With ``--cxr_jpeg_root`` the JPEG
    decode hook goes onto the dataset, so that every batch carries real
    ``pixel_values``, and the pass-through source is returned; otherwise
    the device-side procedural source (JAX's procedural images)."""
    from ..train import engine
    root = getattr(args, "cxr_jpeg_root", "")
    if root:
        from ..data.images import JpegStore, make_jpeg_host_fn
        anchor_ds.batch_hook = make_jpeg_host_fn(JpegStore(root=root),
                                                 vit_cfg.image_size)
        return engine.default_image_source
    from ..train.teacher_loop import make_synthetic_image_source
    return make_synthetic_image_source(vit_cfg.image_size)


def make_sources(args, anchor_ds, model, cfg, dtype=torch.bfloat16
                 ) -> Tuple[Callable, Optional[Callable]]:
    """(image_source, feature_source) after ``--cxr_feature_cache`` (JAX
    ``common.py:69-101``). With ``hbm``, every unique image of the cohort
    is encoded once through the checkpoint's frozen ViT (K1) into a
    ``CXRFeatureBank`` on the model's device, each image with its first
    anchor's labels, and batches gather their tokens by raw image id
    (``keyed_by_row=False``: analysis batches are not rewritten by a hook);
    then the pixel hook is detached, so no batch decodes a JPEG."""
    from ..data import features as F
    from ..train.engine import to_device
    from ..train.teacher_loop import pixels_for_ids_fn
    image_source = make_image_source(args, anchor_ds, cfg.vit)
    if getattr(args, "cxr_feature_cache", "none") == "none":
        return image_source, None
    base_hook = anchor_ds.batch_hook
    device = next(model.parameters()).device

    def hook(b: dict) -> dict:
        if base_hook is not None:
            b = base_hook(b)
        return {**b, "pixel_values": image_source(to_device(b, device))}

    all_ids, pixels_for_ids = pixels_for_ids_fn(anchor_ds, hook)
    bank = F.CXRFeatureBank.build(
        F.encode_fn_for_teacher(model, dtype), pixels_for_ids, all_ids,
        out_dtype=torch.float32 if dtype == torch.float32
        else torch.bfloat16)
    anchor_ds.batch_hook = None      # pixels no longer needed per batch
    return image_source, bank.feature_source(keyed_by_row=False)


def load_analysis_data(args, n_variables: Optional[int] = None) -> tuple:
    """(cohort, meta, AnchorDataset on the CPU, DataConfig) from
    ``--data_dir`` or the synthetic cohort of ``--synthetic_stays``."""
    dcfg = DataConfig(data_dir=getattr(args, "data_dir", ""))
    if getattr(args, "data_dir", ""):
        from ..data.ingest import load_artifacts
        ds, meta = load_artifacts(args.data_dir)
    else:
        ds = S.make_synthetic(
            seed=0, n_stays=args.synthetic_stays,
            n_subjects=max(args.synthetic_stays // 3, 10),
            n_variables=n_variables or args.n_variables)
        meta = P.meta_from_events(ds, dcfg)
    anchor_ds = P.build_anchor_dataset(ds, meta, dcfg)
    return ds, meta, anchor_ds, dcfg


def load_teacher(ckpt_path: str, device="cuda") -> tuple:
    """(model in eval mode on ``device``, TeacherConfig, raw checkpoint)
    from one checkpoint of either package."""
    from ..train.checkpoint import load_teacher_from_ckpt
    return load_teacher_from_ckpt(ckpt_path, device)
