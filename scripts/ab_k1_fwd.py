#!/usr/bin/env python3
"""Same-call A/B of K1's bf16 forward between repo trees, timed in turns on
one card.

    git archive <parent> | tar -x -C build/ab/parent
    python3 scripts/ab_k1_fwd.py --tree parent=build/ab/parent --tree new=.

Each slot of ``--order`` (letters: the trees in the order given; default
``abba``) runs one worker process on the card that builds its tree's
kernels (cached in the tree's ``build/torch_kernels/``), checks the forward
against ``flash_mha_reference`` and times it with and without lse, its
repetitions alternating with SDPA's forward on the same inputs (this
checkout's ``chip_smoke.paired_ms``), at [32, 12, 1370, 64] bf16 unless
``--shape`` says otherwise. Prints one JSON line per slot (also written to
``--out``, by default ``build/ab_k1_fwd.jsonl``), then the medians of each
tree's slots with the card's name and power limit. Needs a CUDA card;
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(tree: str, B: int, H: int, N: int) -> dict:
    import importlib.util

    import torch
    import torch.nn.functional as F

    # this checkout's timing helpers, the tree's package
    spec = importlib.util.spec_from_file_location(
        "ab_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    sys.path.insert(0, tree)
    from multimodal_edema_prediction_tpu_torch.ops import attention as att
    from multimodal_edema_prediction_tpu_torch.ops import build
    assert att.__file__.startswith(tree), att.__file__
    device = torch.device("cuda")
    build.build_all()
    usage = [u for fn, u in build.ptxas_usage(
        build.build_log("flash_attention")).items() if "fwd_bf16" in fn]
    q, k, v = chip_smoke._qkv(B, H, N, torch.bfloat16, device, seed=0)
    scale = 64 ** -0.5
    err = (att.flash_mha(q, k, v, scale).float()
           - att.flash_mha_reference(q, k, v, scale).float()).abs().max()
    fwd, sdpa = chip_smoke.paired_ms([
        lambda: att.forward_kernel(q, k, v, scale, N, False)[0],
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)],
        device)
    lse_ms = chip_smoke.device_ms(
        lambda: att.forward_kernel(q, k, v, scale, N, True), device)
    return {"tree": tree, "shape": [B, H, N, 64], "max_abs_err": float(err),
            "fwd_ms": fwd, "fwd_lse_ms": lse_ms, "sdpa_ms": sdpa,
            "fwd_vs_library": fwd / sdpa, "ptxas": usage}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", action="append", metavar="NAME=DIR",
                   help="a repo tree to time; repeatable")
    p.add_argument("--order", default="abba",
                   help="one letter per slot: a = the first tree, ...")
    p.add_argument("--shape", type=int, nargs=3, default=[32, 12, 1370],
                   metavar=("B", "H", "N"))
    p.add_argument("--out", default=os.path.join(REPO, "build",
                                                 "ab_k1_fwd.jsonl"))
    p.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("ab_k1_fwd: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_k1_fwd: no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        print(json.dumps(worker(args.worker, *args.shape)), flush=True)
        return 0

    if not args.tree:
        p.error("give at least one --tree NAME=DIR")
    trees = []
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees.append((name, os.path.abspath(path or ".")))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    readings = {name: [] for name, _ in trees}
    with open(args.out, "w") as out:
        for slot in args.order:
            name, tree = trees[ord(slot) - ord("a")]
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", tree,
                 "--shape", *map(str, args.shape)],
                capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                print(run.stdout + run.stderr, file=sys.stderr)
                return run.returncode or 1
            res = {"name": name, **json.loads(run.stdout.splitlines()[-1])}
            readings[name].append(res)
            out.write(json.dumps(res) + "\n")
            print(json.dumps(res), flush=True)
        summary = {"card": smi, "order": args.order, "medians": {
            name: {key: statistics.median(r[key] for r in rs)
                   for key in ("fwd_ms", "fwd_lse_ms", "sdpa_ms",
                               "fwd_vs_library", "max_abs_err")}
            for name, rs in readings.items() if rs}}
        out.write(json.dumps(summary) + "\n")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
