"""CXR linear-head training CLI on the card (the counterpart of
``multimodal_edema_prediction_tpu/cli/train_cxr_head.py``; reference
``cxr_linear_training.ipynb``), with the same flags and defaults:

    python -m multimodal_edema_prediction_tpu_torch.cli.train_cxr_head \\
        --device cuda --vit_params rad_dino_flax.msgpack

Extracts the frozen ViT's CLS token for every image of the CXR catalog
(``--feature_cache`` keeps them in a ``.npz``), trains the masked-BCE linear
head and writes ``cxr_linear_head.msgpack`` under ``--ckpt_dir``: the
artifact ``cli.train_teacher --perceiver_type dual
--pretrained_cxr_head_ckpt`` loads. The catalog is ``--data_dir``'s or the
synthetic cohort's, its images the procedural ones or, with
``--cxr_jpeg_root DIR``, the real chest X-rays ``DIR/{image_id}.jpg``
(decoded by the port's own decoder a chunk ahead of the card).
``--vit_params`` is the RAD-DINO checkpoint that ``cli/convert_rad_dino.py``
(or the JAX package's ``scripts/convert_rad_dino.py``) writes.
"""
from __future__ import annotations

import argparse
import os
import time

from ..config import DEFAULT_PATHOLOGY_LABELS, ViTConfig
from ..data import synthetic as S
from ..data.images import JpegStore
from ..models.layers import init_like_flax
from ..models.vit import DinoViT, load_vit_params
from ..train.cxr_head_loop import (extract_cls_features,
                                   split_catalog_subjects, train_cxr_head)
from ..train.teacher_loop import make_synthetic_pixel_hook
from ..utils import resolve_device
from ..utils.logging import Logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("CXR linear head training (PyTorch/CUDA)")
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--synthetic_stays", type=int, default=400)
    p.add_argument("--vit_size", type=str, default="base",
                   choices=["tiny", "base"])
    p.add_argument("--vit_params", type=str, default="",
                   help="converted RAD-DINO weights (msgpack, from python -m "
                        "multimodal_edema_prediction_tpu_torch.cli."
                        "convert_rad_dino); random if empty")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--ckpt_dir", type=str, default="runs/cxr_head")
    p.add_argument("--feature_cache", type=str, default="")
    p.add_argument("--head_batch_size", type=int, default=0,
                   help="mini-batch size for head training (0 = full batch)")
    p.add_argument("--uncertain_policy", type=str, default="to_positive",
                   choices=["to_positive", "to_zero", "keep"],
                   help="U(-1) label mapping at the CXR-head level "
                        "(reference: U->1, cxr_db.ipynb cell 24)")
    p.add_argument("--cxr_jpeg_root", type=str, default="",
                   help="directory of {image_id}.jpg catalog images (real "
                        "CXRs); the procedural images when empty")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    log = Logger("cxr_head").info
    dev = resolve_device(args.device)
    vit_cfg = ViTConfig() if args.vit_size == "base" else ViTConfig(
        image_size=56, patch_size=14, d_model=64, n_layers=2, n_heads=2,
        d_feedforward=128)
    if args.data_dir:
        from ..data.ingest import load_artifacts
        ds, _ = load_artifacts(args.data_dir)
    else:
        ds = S.make_synthetic(seed=0, n_stays=args.synthetic_stays,
                              n_subjects=max(args.synthetic_stays // 3, 10))
    catalog = ds.cxr_catalog

    vit = DinoViT(vit_cfg)
    if args.vit_params:
        vit.load_state_dict(load_vit_params(args.vit_params, vit_cfg))
    else:
        init_like_flax(vit, 0, vit_cfg.layerscale_init)
        log("using a randomly initialized ViT (no weights provided)")
    jpeg_store = None
    if args.cxr_jpeg_root:
        jpeg_store = JpegStore(root=args.cxr_jpeg_root)
        log(f"extracting features from real JPEGs: {args.cxr_jpeg_root}")
    t0 = time.perf_counter()
    cls = extract_cls_features(
        vit.to(dev), make_synthetic_pixel_hook(vit_cfg.image_size),
        catalog.image_ids, catalog.labels, args.batch_size,
        args.feature_cache or None, jpeg_store=jpeg_store)
    extract_s = time.perf_counter() - t0
    log(f"CLS features of {len(cls)} catalog images in {extract_s:.1f}s")
    splits = split_catalog_subjects(catalog.subject_ids, catalog.labels,
                                    args.seed)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    result = train_cxr_head(
        cls, catalog.labels, splits, DEFAULT_PATHOLOGY_LABELS,
        os.path.join(args.ckpt_dir, "cxr_linear_head.msgpack"),
        batch_size=args.head_batch_size,
        uncertain_policy=args.uncertain_policy, lr=args.lr,
        epochs=args.epochs, dropout=args.dropout, seed=args.seed,
        device=dev, log=log)
    log(f"saved → {result['ckpt_path']}")
    return {**result, "feature_extract_s": extract_s,
            "n_images": len(cls)}


if __name__ == "__main__":
    main()
