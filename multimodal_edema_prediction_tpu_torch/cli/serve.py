"""Online serving CLI: JAX-package checkpoint → warmed micro-batching HTTP
endpoint on the card (the counterpart of
``multimodal_edema_prediction_tpu/cli/serve.py``).

    python -m multimodal_edema_prediction_tpu_torch.cli.serve \\
        --ckpt runs/teacher/best.msgpack --device cuda

``--image_mode pixel``: clients send ``pixel_u8_b64`` (raw uint8 bytes of the
[S, S, 3] resized CXR; normalization runs on the device).
``--image_mode jpeg_root --cxr_jpeg_root DIR``: at startup every
``DIR/{image_id}.jpg`` is decoded and encoded once through the frozen ViT
into a ``CXRFeatureBank`` on the card; requests name an ``image_id``, and
each batch gathers its tokens through K2 instead of running the ViT (an
id not in the bank answers NaN, as in JAX).
``--image_mode synthetic``: requests name an ``image_id`` and each batch's
images are the JAX package's procedural ones for those ids, drawn on the
device with the labels fixed to zeros, through the ViT (demos, load tests;
no image payloads). ``--data_parallel N`` serves N replicas of the model on
cards 0..N-1 (``serve/predictor.py``: buckets of multiples of N, each batch
split across the replicas; more than the cards there are raises);
``--aot_dir`` is not ported yet (ROADMAP P10b) and raises when given. Every
bucket runs once before the port opens, so the first request never pays a
kernel build.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable

import numpy as np
import torch

from .common import add_queued_flags, refuse_queued_flags

# JAX flags whose feature is not ported yet → their ROADMAP item
QUEUED_FLAGS = {"--aot_dir": "P10b"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("teacher online serving (PyTorch/CUDA)")
    p.add_argument("--ckpt", type=str, required=True,
                   help="teacher checkpoint written by the JAX package "
                        "(.msgpack + .config.json sidecar)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8389)
    p.add_argument("--image_mode", type=str, default="pixel",
                   choices=["pixel", "jpeg_root", "synthetic"])
    p.add_argument("--cxr_jpeg_root", type=str, default="",
                   help="directory of {image_id}.jpg files (jpeg_root mode)")
    p.add_argument("--max_batch", type=int, default=32)
    p.add_argument("--max_wait_ms", type=float, default=4.0)
    p.add_argument("--max_queue", type=int, default=1024)
    p.add_argument("--data_parallel", type=int, default=1,
                   help="serve N replicas on cards 0..N-1: buckets snap to "
                        "multiples of N and each batch splits across them")
    p.add_argument("--labels", type=str, default="",
                   help="comma-separated label names (default: the "
                        "DataConfig pathology set)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")
    add_queued_flags(p, QUEUED_FLAGS)
    return p


def jpeg_feature_source(model, root: str, dtype=torch.bfloat16,
                        devices=None) -> tuple:
    """``--image_mode jpeg_root``'s startup (JAX ``cli/serve.py:90-110``):
    every ``{image_id}.jpg`` under ``root`` decoded and encoded once
    through ``model``'s frozen ViT into a ``CXRFeatureBank`` on the model's
    device. Returns (the feature source over raw image ids, {"n_images",
    "encode_s"}); with ``devices`` (data-parallel replicas) a list of
    sources, each over a copy of the bank on its device."""
    from ..data import features as F
    from ..data.images import JpegStore, decode_batch
    ids = sorted(int(f[:-4]) for f in os.listdir(root) if f.endswith(".jpg"))
    if not ids:
        raise ValueError(f"no {{id}}.jpg files under {root}")
    store = JpegStore(root=root)
    side = model.cfg.vit.image_size
    n_threads = os.cpu_count() or 1

    def pixels_for_ids(batch_ids):
        blobs = [store.get(i) for i in np.asarray(batch_ids)]
        return decode_batch(blobs, side, n_threads=n_threads)

    print(f"encoding {len(ids)} images once (frozen ViT) ...", flush=True)
    t0 = time.perf_counter()
    bank = F.CXRFeatureBank.build(
        F.encode_fn_for_teacher(model, dtype), pixels_for_ids,
        np.asarray(ids, np.int64),
        out_dtype=torch.float32 if dtype == torch.float32
        else torch.bfloat16)
    if bank.cls.device.type == "cuda":
        torch.cuda.synchronize(bank.cls.device)
    info = {"n_images": len(ids), "encode_s": time.perf_counter() - t0}
    if devices is None:
        return bank.feature_source(keyed_by_row=False), info
    return [F.CXRFeatureBank(bank.ids, bank.cls.to(d), bank.patches.to(d))
            .feature_source(keyed_by_row=False) for d in devices], info


def synthetic_image_source(cfg) -> Callable[[dict], torch.Tensor]:
    """``--image_mode synthetic``'s image source (JAX ``cli/serve.py:79-89``):
    the procedural images of the batch's ``image_ids``, with the labels,
    which a request does not carry, fixed to zeros."""
    from ..train.teacher_loop import make_synthetic_image_source
    base = make_synthetic_image_source(cfg.vit.image_size)
    K = cfg.perceiver.n_pathologies

    def source(batch: dict) -> torch.Tensor:
        ids = batch["image_ids"]
        return base({**batch, "y_multi": torch.zeros(
            ids.shape[0], K, dtype=torch.float32, device=ids.device)})

    return source


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    refuse_queued_flags(args, QUEUED_FLAGS)
    if args.image_mode == "jpeg_root" and not args.cxr_jpeg_root:
        p.error("--image_mode jpeg_root requires --cxr_jpeg_root")

    from ..config import DataConfig
    from ..serve import BatchingPredictor, make_server, serve_forever
    from ..serve.predictor import replica_devices
    from ..train.checkpoint import load_teacher_from_ckpt
    from ..utils import resolve_device

    # N replicas on N cards: more than there are raises before any load
    devices = replica_devices(resolve_device(args.device),
                              args.data_parallel)
    model, cfg, _ = load_teacher_from_ckpt(args.ckpt, device=devices[0])
    labels = (args.labels.split(",") if args.labels
              else list(DataConfig().pathology_labels))
    S = cfg.vit.image_size
    image_source = feature_source = None
    if args.image_mode == "synthetic":
        image_source = synthetic_image_source(cfg)
    elif args.image_mode == "jpeg_root":
        feature_source, _ = jpeg_feature_source(
            model.eval(), args.cxr_jpeg_root,
            devices=devices if len(devices) > 1 else None)
    pred = BatchingPredictor(
        model, image_source=image_source, feature_source=feature_source,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, max_queue=args.max_queue,
        dtype=torch.bfloat16, labels=labels, device=args.device,
        data_parallel=args.data_parallel).start()

    T, V = cfg.duett.n_timesteps, cfg.duett.n_variables
    example = {"x_ts": np.zeros((T, 2 * V), np.float32),
               "static": np.zeros(cfg.duett.d_static, np.float32)}
    if args.image_mode == "pixel":
        example["pixel_u8"] = np.zeros((S, S, 3), np.uint8)
    try:
        # a single/legacy teacher fails here, before the port opens
        print("warming buckets ...", flush=True)
        print(f"warm: {pred.warmup(example)}", flush=True)
        meta = {"n_timesteps": T, "n_variables": V,
                "d_static": cfg.duett.d_static, "image_size": S,
                "image_mode": args.image_mode,
                "perceiver": cfg.perceiver_type}
        server = make_server(pred, args.host, args.port, meta=meta)
        print(f"serving on http://{args.host}:{server.server_address[1]} "
              f"(mode={args.image_mode}, device={args.device}, "
              f"replicas={len(devices)})", flush=True)
        try:
            serve_forever(server)
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
    finally:
        pred.close()


if __name__ == "__main__":
    main()
