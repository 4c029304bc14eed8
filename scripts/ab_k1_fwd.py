#!/usr/bin/env python3
"""Same-call A/B of one kernel between repo trees, timed in turns on one
card: K1's forward (the default), K1's backward, K2's row gather, K3's
DuETT block or K4's LayerNorm → QKV; K1, K3 and K4 in bf16 (the default)
or, with ``--dtype float32``, on their float32 routes.

    git archive <parent> | tar -x -C build/ab/parent
    python3 scripts/ab_k1_fwd.py --tree parent=build/ab/parent --tree new=.
    python3 scripts/ab_k1_fwd.py --kernel k4 --tree parent=... --tree new=.
    python3 scripts/ab_k1_fwd.py --kernel k3 --tree parent=... --tree new=.
    python3 scripts/ab_k1_fwd.py --kernel k3 --dtype float32 --tree ...
    python3 scripts/ab_k1_fwd.py --dtype float32 --tree parent=... --tree new=.
    python3 scripts/ab_k1_fwd.py --kernel k1_bwd --dtype float32 --tree ...

Each slot of ``--order`` (letters: the trees in the order given; default
``abba``) runs one worker process on the card that builds its tree's
kernels (cached in the tree's ``build/torch_kernels/``), checks the kernel
against its plain version and times it, its repetitions alternating with a
PyTorch yardstick on the same inputs (this checkout's
``chip_smoke.paired_ms``):

- ``k1_fwd``: ``flash_mha`` at [32, 12, 1370, 64] unless ``--shape``
  says otherwise, with and without lse, against SDPA's forward (float32:
  TF32 off, as everywhere in the port's float32 checks);
- ``k1_bwd``: K1's backward at the same shape: the D, dkv and dq
  kernels, the autograd Function's whole backward as training runs it (dO
  made ready, D, dkv, dq) and SDPA's backward, the five timed in turns
  (``paired_ms``); the Function's gradients against
  ``flash_mha_backward_reference`` (``max_rel_err``, of each gradient's
  max abs);
- ``k2``: ``gather_rows`` of 32 rows (a repeat and the NaN sentinel among
  them) from a [401, 1370, 768] bf16 bank, bit for bit, against
  ``torch.index_select``; besides the paired times, which hold the
  wrapper's host dispatch, the device time of each under ``torch.profiler``
  (``device_ms``, ``library_device_ms``: chip_smoke's ``_profile``);
- ``k3``: ``fused_encoder_block`` at DuETT's two axes, event [32, 35,
  600] and time [32, 25, 840] (2 heads × 12, FF 512; chip_smoke's
  weights), bf16 or float32, against the plain version
  ``encoder_block_reference`` (no PyTorch call computes the block;
  float32: TF32 off); besides the paired times, each one's device time
  under ``torch.profiler`` (``*_device_ms``: the kernel alone;
  ``*_plain_device_ms``), and the route each tree's ``route`` gives
  (``simt`` where the tree has none);
- ``k4``: ``fused_ln_qkv`` at [32, 1536, 768], 12 × 64, against
  ``F.layer_norm`` + ``F.linear`` + the head-major copy (chip_smoke's
  yardstick; float32: TF32 off).

Prints one JSON line per slot (also written to ``--out``, by default
``build/ab_<kernel>.jsonl``), then the medians of each tree's slots with
the card's name and power limit. Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's chip_smoke.py (its timing helpers and inputs)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "ab_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def _no_tf32():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def worker(tree: str, dtype: str, B: int, H: int, N: int) -> dict:
    import torch
    import torch.nn.functional as F

    chip_smoke = _chip_smoke()
    sys.path.insert(0, tree)
    from multimodal_edema_prediction_tpu_torch.ops import attention as att
    from multimodal_edema_prediction_tpu_torch.ops import build
    assert att.__file__.startswith(tree), att.__file__
    _no_tf32()
    device = torch.device("cuda")
    build.build_all()
    kernel = {"bfloat16": "fwd_bf16", "float32": "fwd_f32"}[dtype]
    usage = [u for fn, u in build.ptxas_usage(
        build.build_log("flash_attention")).items() if kernel in fn]
    q, k, v = chip_smoke._qkv(B, H, N, getattr(torch, dtype), device, seed=0)
    scale = 64 ** -0.5
    err = (att.flash_mha(q, k, v, scale).float()
           - att.flash_mha_reference(q, k, v, scale).float()).abs().max()
    fwd, sdpa = chip_smoke.paired_ms([
        lambda: att.forward_kernel(q, k, v, scale, N, False)[0],
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)],
        device)
    lse_ms = chip_smoke.device_ms(
        lambda: att.forward_kernel(q, k, v, scale, N, True), device)
    return {"tree": tree, "dtype": dtype, "shape": [B, H, N, 64],
            "max_abs_err": float(err),
            "fwd_ms": fwd, "fwd_lse_ms": lse_ms, "sdpa_ms": sdpa,
            "fwd_vs_library": fwd / sdpa, "ptxas": usage}


def worker_k1_bwd(tree: str, dtype: str, B: int, H: int, N: int) -> dict:
    import torch
    import torch.nn.functional as F

    chip_smoke = _chip_smoke()
    sys.path.insert(0, tree)
    from multimodal_edema_prediction_tpu_torch.ops import attention as att
    from multimodal_edema_prediction_tpu_torch.ops import build
    assert att.__file__.startswith(tree), att.__file__
    _no_tf32()
    device = torch.device("cuda")
    build.build_all()
    suffix = {"bfloat16": "bf16", "float32": "f32"}[dtype]
    usage = {fn: u for fn, u in build.ptxas_usage(
        build.build_log("flash_attention_bwd")).items()
        if f"dkv_{suffix}" in fn or f"dq_{suffix}" in fn}
    dt = getattr(torch, dtype)
    q, k, v = chip_smoke._qkv(B, H, N, dt, device, seed=10)
    do = chip_smoke._qkv(B, H, N, dt, device, seed=20)[0]
    scale = 64 ** -0.5
    o, lse = att.forward_kernel(q, k, v, scale, N, True)
    dlt = att.delta(o, do)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    fn_out = att.flash_mha(*leaves, scale)
    sdpa_out = F.scaled_dot_product_attention(*leaves, scale=scale)
    got = torch.autograd.grad(fn_out, leaves, do, retain_graph=True)
    want = att.flash_mha_backward_reference(q, k, v, o, lse, do, scale)
    rel = max(float((g.float() - w.float()).abs().max()
                    / w.float().abs().max()) for g, w in zip(got, want))
    del got, want
    torch.cuda.empty_cache()
    dkv, dq, delta, backward, library = chip_smoke.paired_ms([
        lambda: att.dkv_kernel(q, k, v, do, lse, dlt, scale, N),
        lambda: att.dq_kernel(q, k, v, do, lse, dlt, scale, N),
        lambda: att.delta(o, do),
        lambda: torch.autograd.grad(fn_out, leaves, do, retain_graph=True),
        lambda: torch.autograd.grad(sdpa_out, leaves, do,
                                    retain_graph=True)], device)
    return {"tree": tree, "dtype": dtype, "shape": [B, H, N, 64],
            "max_rel_err": rel, "dkv_ms": dkv, "dq_ms": dq,
            "delta_ms": delta, "pair_ms": dkv + dq, "backward_ms": backward,
            "library_ms": library, "backward_vs_library": backward / library,
            "ptxas": usage}


def worker_k2(tree: str, dtype: str, n_bank: int = 400,
              batch: int = 32) -> dict:
    import torch

    chip_smoke = _chip_smoke()
    sys.path.insert(0, tree)
    from multimodal_edema_prediction_tpu_torch.ops import build
    from multimodal_edema_prediction_tpu_torch.ops import gather as G
    assert G.__file__.startswith(tree), G.__file__
    device = torch.device("cuda")
    build.build_all()
    g = torch.Generator(device=device).manual_seed(7)
    rows = torch.randint(0, n_bank, (batch,), generator=g, device=device,
                         dtype=torch.int32)
    rows[1] = rows[0]
    rows[-1] = n_bank
    bank = torch.randn(n_bank + 1, 1370, 768, generator=g, device=device,
                       dtype=torch.bfloat16)
    bank[-1] = float("nan")
    got = G.gather_rows(bank, rows)
    exact = torch.equal(chip_smoke._bits(got), chip_smoke._bits(
        G.gather_rows_reference(bank, rows)))
    def kernel():
        return G.gather_rows(bank, rows)

    def library():
        return torch.index_select(bank, 0, rows)
    ms, lib = chip_smoke.paired_ms([kernel, library], device)
    dev, lib_dev = (chip_smoke._profile(fn, 20, t, {}).get(
        "device_busy_ms_per_step") for fn, t in ((kernel, ms),
                                                 (library, lib)))
    return {"tree": tree, "shape": [n_bank + 1, 1370, 768], "rows": batch,
            "bit_exact": exact, "ms": ms, "library_ms": lib,
            "vs_library": ms / lib, "device_ms": dev,
            "library_device_ms": lib_dev,
            "route": G.route(2 * 1370 * 768, bank.data_ptr(), got.data_ptr())
            if hasattr(G, "route") else "vector"}


def worker_k4(tree: str, dtype: str, B: int = 32, N: int = 1536,
              D: int = 768, H: int = 12) -> dict:
    import torch
    import torch.nn.functional as F

    chip_smoke = _chip_smoke()
    sys.path.insert(0, tree)
    from multimodal_edema_prediction_tpu_torch.ops import build
    from multimodal_edema_prediction_tpu_torch.ops import ln_qkv as LQ
    assert LQ.__file__.startswith(tree), LQ.__file__
    _no_tf32()
    dt = getattr(torch, dtype)
    device = torch.device("cuda")
    build.build_all()
    inner = H * 64
    g = torch.Generator(device=device).manual_seed(60)

    def r(*shape, std):
        return std * torch.randn(*shape, generator=g, device=device)
    params = {"ln_scale": 1.0 + r(D, std=0.1), "ln_bias": r(D, std=0.1),
              **{k: r(D, inner, std=D ** -0.5) for k in ("wq", "wk", "wv")},
              **{k: r(inner, std=0.02) for k in ("bq", "bk", "bv")}}
    x = (2.0 * torch.randn(B, N, D, generator=g, device=device)
         + 0.5).to(dt)

    def library():
        w = torch.cat([params[k] for k in ("wq", "wk", "wv")], 1)
        b = torch.cat([params[k] for k in ("bq", "bk", "bv")])
        h = F.layer_norm(x, (D,), params["ln_scale"].to(dt),
                         params["ln_bias"].to(dt), 1e-6)
        y = F.linear(h, w.t().to(dt), b.to(dt))
        return y.view(B, N, 3, H, 64).permute(2, 0, 3, 1, 4).contiguous()

    got = LQ.fused_ln_qkv(x, params, H, 64)
    want = LQ.ln_qkv_reference(x, params, H, 64)
    rel = max(float((a.float() - w.float()).abs().max()
                    / w.float().abs().max()) for a, w in zip(got, want))
    ms, lib = chip_smoke.paired_ms(
        [lambda: LQ.fused_ln_qkv(x, params, H, 64), library], device)
    return {"tree": tree, "dtype": dtype, "shape": [B, N, D],
            "heads": [H, 64],
            "max_rel_err": rel, "ms": ms, "library_ms": lib,
            "vs_library": ms / lib}


def worker_k3(tree: str, dtype: str, n_heads: int = 2, d_head: int = 12,
              ff: int = 512) -> dict:
    import torch

    chip_smoke = _chip_smoke()
    sys.path.insert(0, tree)
    from multimodal_edema_prediction_tpu_torch.ops import build
    from multimodal_edema_prediction_tpu_torch.ops import dual_axis as DA
    assert DA.__file__.startswith(tree), DA.__file__
    device = torch.device("cuda")
    build.build_all()
    _no_tf32()
    out = {"tree": tree, "dtype": dtype}
    for axis, (B, L, D) in (("event", (32, 35, 600)),
                            ("time", (32, 25, 840))):
        params = chip_smoke._dual_axis_params(D, n_heads * d_head, ff,
                                              device, 30)
        g = torch.Generator(device=device).manual_seed(40)
        x = torch.randn(B, L, D, generator=g, device=device).to(
            getattr(torch, dtype))

        def kernel():
            return DA.fused_encoder_block(x, params, n_heads, d_head)

        def plain():
            return DA.encoder_block_reference(x, params, n_heads, d_head)
        want = plain().float()
        rel = float((kernel().float() - want).abs().max()
                    / want.abs().max())
        ms, plain_ms = chip_smoke.paired_ms([kernel, plain], device)
        dev = chip_smoke._profile(kernel, 20, ms, {"k": "dual_axis_block"})
        plain_dev = chip_smoke._profile(plain, 20, plain_ms, {})
        out.update({
            f"{axis}_shape": [B, L, D], f"{axis}_max_rel_err": rel,
            f"{axis}_ms": ms, f"{axis}_plain_ms": plain_ms,
            f"{axis}_device_ms": dev.get("k_device_ms_per_step"),
            f"{axis}_plain_device_ms": plain_dev.get(
                "device_busy_ms_per_step"),
            f"{axis}_route": DA.route(x.dtype, L, D, ff, n_heads, d_head)
            if hasattr(DA, "route") else "simt"})
    return out


WORKERS = {"k1_fwd": worker, "k1_bwd": worker_k1_bwd, "k2": worker_k2,
           "k3": worker_k3, "k4": worker_k4}
MEDIAN_KEYS = {
    "k1_fwd": ("fwd_ms", "fwd_lse_ms", "sdpa_ms", "fwd_vs_library",
               "max_abs_err"),
    "k1_bwd": ("dkv_ms", "dq_ms", "delta_ms", "pair_ms", "backward_ms",
               "library_ms", "backward_vs_library", "max_rel_err"),
    "k2": ("ms", "library_ms", "vs_library", "device_ms",
           "library_device_ms"),
    "k3": tuple(f"{axis}_{key}" for axis in ("event", "time")
                for key in ("ms", "plain_ms", "device_ms", "plain_device_ms",
                            "max_rel_err")),
    "k4": ("ms", "library_ms", "vs_library", "max_rel_err"),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", action="append", metavar="NAME=DIR",
                   help="a repo tree to time; repeatable")
    p.add_argument("--order", default="abba",
                   help="one letter per slot: a = the first tree, ...")
    p.add_argument("--kernel", choices=sorted(WORKERS), default="k1_fwd")
    p.add_argument("--shape", type=int, nargs=3, default=[32, 12, 1370],
                   metavar=("B", "H", "N"),
                   help="k1_fwd's and k1_bwd's shape")
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16",
                   help="k1_fwd's, k1_bwd's, k3's and k4's dtype (k2: "
                   "bfloat16)")
    p.add_argument("--out", default=None,
                   help="default: build/ab_<kernel>.jsonl")
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
    if args.kernel == "k2" and args.dtype != "bfloat16":
        p.error("--kernel k2 times bfloat16 only")
    if args.worker:
        extra = args.shape if args.kernel in ("k1_fwd", "k1_bwd") else []
        print(json.dumps(WORKERS[args.kernel](args.worker, args.dtype,
                                              *extra)), flush=True)
        return 0
    out_path = args.out or os.path.join(
        REPO, "build", f"ab_{args.kernel}"
        f"{'_f32' if args.dtype == 'float32' else ''}.jsonl")

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
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    readings = {name: [] for name, _ in trees}
    with open(out_path, "w") as out:
        for slot in args.order:
            name, tree = trees[ord(slot) - ord("a")]
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", tree,
                 "--kernel", args.kernel, "--dtype", args.dtype,
                 "--shape", *map(str, args.shape)],
                capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                print(run.stdout + run.stderr, file=sys.stderr)
                return run.returncode or 1
            res = {"name": name, **json.loads(run.stdout.splitlines()[-1])}
            readings[name].append(res)
            out.write(json.dumps(res) + "\n")
            print(json.dumps(res), flush=True)
        summary = {"card": smi, "kernel": args.kernel, "dtype": args.dtype,
                   "order": args.order,
                   "medians": {
                       name: {key: statistics.median(r[key] for r in rs)
                              for key in MEDIAN_KEYS[args.kernel]
                              if all(isinstance(r[key], (int, float))
                                     for r in rs)}
                       for name, rs in readings.items() if rs}}
        out.write(json.dumps(summary) + "\n")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
