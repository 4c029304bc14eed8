#!/usr/bin/env python3
"""Where one of K3's tensor-core kernels spends its time, phase by phase,
on one card.

    python3 scripts/k3_phases.py                    # bf16: dual_axis_block_tc
    python3 scripts/k3_phases.py --dtype float32    # dual_axis_block_tf32

Uses two builds of the route's source (``csrc/dual_axis_block_tc.cu`` or
``csrc/dual_axis_block_tf32.cu``): the kernel as ``ops/build.py`` builds
it, and one that ``nvcc`` builds here into ``build/k3_phases/`` with
``-DK3_STAMPS``, in which thread 0 of every block writes a ``clock64`` /
``%globaltimer`` stamp after each phase (x load and SN1, the QKV product,
scores and softmax, P·V, the out-projection, SN2, FF1, FF2, the arrival
counter, and in the last block of each element the sum of the partials
and SNf). Then, at [32, 35, 600], [32, 25, 840] and [128, 35, 600] in the
dtype (2 heads × 12, FF 512; chip_smoke.py's weights), it calls the bare
C entry point on weights already cast and packed (no wrapper, no casts):
checks each build against
``encoder_block_reference`` (max error relative to the output's max abs,
two launches bit-equal), times the kept build by CUDA events over 50
back-to-back launches (median of 7), and launches the stamped build 7
times. Prints one JSON line per shape: per phase the median and largest
cycles over the blocks of the 7 launches that ran it and how many blocks
of a launch did; per launch the span from the first block's start to the
last block's end (µs) and the spread of the blocks' start times, medians
over the 7; the median block time up to the counter. Needs a CUDA
card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "build", "k3_phases")
REPS = 7                 # launches of the stamped build per shape
PHASES = ("x+SN1", "QKV", "scores+softmax", "PV", "outproj", "SN2", "FF1",
          "FF2", "count", "reduce", "SNf")


def _build_stamped(name: str) -> ctypes.CDLL:
    """The kernel's source built with ``-DK3_STAMPS``."""
    from multimodal_edema_prediction_tpu_torch.ops import build
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, f"{name}_stamped.so")
    run = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-DK3_STAMPS", "-o", so,
         os.path.join(build.CSRC, build.SOURCES[name])],
        capture_output=True, text=True)
    if run.returncode != 0:
        raise SystemExit(f"nvcc failed for the stamped build:\n{run.stderr}")
    usage = build.ptxas_usage(run.stdout + run.stderr)
    print(json.dumps({"build": "stamped", "ptxas": usage}), flush=True)
    return ctypes.CDLL(so)


def _inputs(chip_smoke, DA, B, L, D, device, dtype, ff=512):
    import torch
    params = chip_smoke._dual_axis_params(D, 24, ff, device, 30)
    g = torch.Generator(device=device).manual_seed(40)
    x = torch.randn(B, L, D, generator=g, device=device).to(dtype)
    wqkv, nq, rest = DA._tc_weights(params, D, 24, device, dtype)
    gains = torch.cat([params[k].reshape(1) for k in DA.GAINS]).float()
    way = DA.route(dtype, L, D, ff, 2, 12)
    return {"params": params, "x": x, "wqkv": wqkv, "nq": nq, "rest": rest,
            "g": gains, "out": torch.empty_like(x),
            "ws": torch.empty(DA.workspace_bytes(B, L, D, ff, way) // 4,
                              device=device),
            "count": torch.zeros(B, dtype=torch.int32, device=device),
            "shape": (B, L, D, ff)}


def _caller(DA, lib, name, t):
    import torch
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = DA.ENTRY_POINTS[name][1]
    B, L, D, ff = t["shape"]

    def go():
        err = fn(t["x"].data_ptr(), t["wqkv"].data_ptr(), t["nq"],
                 *(v.data_ptr() for v in t["rest"]), t["g"].data_ptr(),
                 t["out"].data_ptr(), t["ws"].data_ptr(),
                 t["count"].data_ptr(), B, L, D, 2, 12, ff, D ** -0.5,
                 12 ** -0.5, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        return t["out"]
    return go


def _ms(go, n: int = 50, reps: int = 7) -> float:
    import torch
    go()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            go()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k3_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from multimodal_edema_prediction_tpu_torch.ops import build
    from multimodal_edema_prediction_tpu_torch.ops import dual_axis as DA
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    name = DA.ROUTE_KERNELS[DA.route(dtype, 35, 600, 512, 2, 12)]
    kept = build.load(name)
    print(json.dumps({"build": "kept", "ptxas": build.ptxas_usage(
        build.build_log(name))}), flush=True)
    stamped = _build_stamped(name)
    stamped.set_stamps.argtypes = [ctypes.c_void_p]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for B, L, D in ((32, 35, 600), (32, 25, 840), (128, 35, 600)):
        t = _inputs(chip_smoke, DA, B, L, D, device, dtype)
        want = DA.encoder_block_reference(t["x"], t["params"], 2, 12).float()
        res = {"card": smi, "kernel": name, "shape": [B, L, D]}
        stamps = torch.zeros(B * (t["shape"][3] // 128) * 32,
                             dtype=torch.int64, device=device)
        if stamped.set_stamps(stamps.data_ptr()):
            raise RuntimeError("set_stamps failed")
        for build_name, lib in (("kept", kept), ("stamped", stamped)):
            go = _caller(DA, lib, name, t)
            got, again = go().float(), go().float()
            res[f"{build_name}_max_rel_err"] = float(
                (got - want).abs().max() / want.abs().max())
            res[f"{build_name}_bit_equal"] = bool(torch.equal(got, again))
        res["kept_bare_ms"] = _ms(_caller(DA, kept, name, t))
        go = _caller(DA, stamped, name, t)
        launches = []
        for _ in range(REPS):
            stamps.zero_()
            go()
            torch.cuda.synchronize()
            launches.append(stamps.view(-1, 32).cpu().tolist())
        rows = [r for rows in launches for r in rows]
        phases = {}
        for i, phase in enumerate(PHASES):
            d = [r[i + 1] - r[i] for r in rows if r[i] and r[i + 1]]
            if d:
                phases[phase] = [statistics.median(d), max(d),
                                 len(d) // REPS]
        span, spread = [], []
        for rows_ in launches:
            start = [r[16] for r in rows_]
            span.append(max(r[16 + 11] for r in rows_ if r[16 + 11])
                        - min(start))
            spread.append(max(start) - min(start))
        counted = [r[16 + 8] - r[16] for r in rows]
        res.update({
            "phase_cycles_median_max_blocks": phases,
            "span_us": statistics.median(span) / 1e3,
            "start_spread_us": statistics.median(spread) / 1e3,
            "block_us_median": statistics.median(counted) / 1e3})
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
