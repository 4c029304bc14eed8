"""Online serving CLI: JAX-package checkpoint → warmed micro-batching HTTP
endpoint on the card (the counterpart of
``multimodal_edema_prediction_tpu/cli/serve.py``).

    python -m multimodal_edema_prediction_tpu_torch.cli.serve \\
        --ckpt runs/teacher/best.msgpack --device cuda

``--image_mode pixel``: clients send ``pixel_u8_b64`` (raw uint8 bytes of the
[S, S, 3] resized CXR; normalization runs on the device). The JAX CLI's
``jpeg_root`` (encode-once feature bank, ROADMAP P17 with P15) and
``synthetic`` (procedural images, P17) modes are not ported yet, nor are
``--cxr_jpeg_root``, ``--data_parallel`` and ``--aot_dir`` (P17), which
raise when given. Every bucket runs once before the port opens, so the
first request never pays a kernel build.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .common import add_queued_flags, refuse_queued_flags

_QUEUED = {"jpeg_root": "ROADMAP P17, with P15",
           "synthetic": "ROADMAP P17"}
# JAX flags whose feature is not ported yet → their ROADMAP item
QUEUED_FLAGS = {"--cxr_jpeg_root": "P17", "--data_parallel": "P17",
                "--aot_dir": "P17"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("teacher online serving (PyTorch/CUDA)")
    p.add_argument("--ckpt", type=str, required=True,
                   help="teacher checkpoint written by the JAX package "
                        "(.msgpack + .config.json sidecar)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8389)
    p.add_argument("--image_mode", type=str, default="pixel",
                   choices=["pixel", "jpeg_root", "synthetic"])
    p.add_argument("--max_batch", type=int, default=32)
    p.add_argument("--max_wait_ms", type=float, default=4.0)
    p.add_argument("--max_queue", type=int, default=1024)
    p.add_argument("--labels", type=str, default="",
                   help="comma-separated label names (default: the "
                        "DataConfig pathology set)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' only when asked for")
    add_queued_flags(p, QUEUED_FLAGS)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    refuse_queued_flags(args, QUEUED_FLAGS)
    if args.image_mode in _QUEUED:
        raise NotImplementedError(
            f"--image_mode {args.image_mode} is not ported yet "
            f"({_QUEUED[args.image_mode]}); use --image_mode pixel")

    from ..config import DataConfig
    from ..serve import BatchingPredictor, make_server, serve_forever
    from ..train.checkpoint import load_teacher_from_ckpt

    model, cfg, _ = load_teacher_from_ckpt(args.ckpt, device=args.device)
    labels = (args.labels.split(",") if args.labels
              else list(DataConfig().pathology_labels))
    S = cfg.vit.image_size
    pred = BatchingPredictor(
        model, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue, dtype=torch.bfloat16, labels=labels,
        device=args.device).start()

    T, V = cfg.duett.n_timesteps, cfg.duett.n_variables
    example = {"x_ts": np.zeros((T, 2 * V), np.float32),
               "static": np.zeros(cfg.duett.d_static, np.float32),
               "pixel_u8": np.zeros((S, S, 3), np.uint8)}
    print("warming buckets ...", flush=True)
    print(f"warm: {pred.warmup(example)}", flush=True)

    meta = {"n_timesteps": T, "n_variables": V,
            "d_static": cfg.duett.d_static, "image_size": S,
            "image_mode": args.image_mode, "perceiver": cfg.perceiver_type}
    server = make_server(pred, args.host, args.port, meta=meta)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(mode={args.image_mode}, device={args.device})", flush=True)
    try:
        serve_forever(server)
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        pred.close()


if __name__ == "__main__":
    main()
