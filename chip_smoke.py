#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (or any sm_90a card).

    python3 chip_smoke.py        # from the repo root; needs one CUDA card

Phases, each printing one JSON line; any failure exits non-zero and never
prints the final ``ok`` line:

1. device   card name and power limit (``nvidia-smi``), torch/CUDA versions.
2. build    compiles every CUDA kernel of the port from ``csrc/`` (nvcc).
3. kernels  holds K1 (flash attention) against ``flash_mha_reference`` on
            the card: bf16 at the ViT shape, a ragged bf16 case and a
            float32 case; times the kernel, the plain version, PyTorch's
            ``scaled_dot_product_attention`` (a yardstick only) and the
            bound.
4. golden   the full-geometry ViT-B/14 at 518² in float32 (TF32 off),
            through the kernel, against
            ``tests/goldens/rad_dino_full_geometry.npz``.
5. serve    the full-width ``dual_patch`` teacher (seeded weights) behind
            the HTTP server in bf16; concurrent clients; every response
            checked against a direct eval of the batch it was served in;
            K1's launches counted over exactly this run.

Then the kernel summary line and, last, ``{"ok": true, "device": ...}``.
Imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "multimodal_edema_prediction_tpu_torch"
GOLDEN = os.path.join(REPO, "tests", "goldens", "rad_dino_full_geometry.npz")
K1_SOURCE = f"{PKG}/csrc/flash_attention.cu"
K1_REPLACES = ("multimodal_edema_prediction_tpu/ops/attention.py:61 "
               "(flash_mha → jax/experimental/pallas/ops/tpu/"
               "flash_attention.py:140 flash_attention)")
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
# bf16 kernel vs float32 plain version: P is rounded to bf16 before the PV
# product and the output to bf16 (2^-8 relative on outputs of |x| ≲ 1)
TOL_BF16 = 2e-2
# float32 kernel vs float32 plain version (TF32 off): same math, another
# summation order (64-term dot products, online vs direct softmax)
TOL_F32 = 1e-5
# a served batch re-run directly: same kernels on the same shapes, so equal
# up to cuBLAS's choice of algorithm in another thread's handle; responses
# travel as JSON floats (float32 → shortest repr → float32 is exact)
SERVE_TOL = 1e-3


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def import_port():
    """The port's modules this script drives (kept in one place so that a
    test can import exactly this set and check that no JAX comes with it)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from multimodal_edema_prediction_tpu_torch import config
    from multimodal_edema_prediction_tpu_torch.models import teacher, vit
    from multimodal_edema_prediction_tpu_torch.ops import attention, build
    from multimodal_edema_prediction_tpu_torch.serve import predictor, server
    from multimodal_edema_prediction_tpu_torch.train import engine
    return dict(config=config, teacher=teacher, vit=vit, attention=attention,
                build=build, predictor=predictor, server=server,
                engine=engine)


def golden_vit_state(cfg) -> dict:
    """HF ``Dinov2Model`` arrays filled by the golden's rule
    (``tests/test_rad_dino_golden.py::_deterministic_fill``): sha256(name)
    seeds numpy, values ×0.02, ``1+`` for ``.norm`` and
    ``layernorm.weight``. Depends only on name and shape."""
    from multimodal_edema_prediction_tpu_torch.models.vit import \
        hf_dinov2_shapes
    out = {}
    for name, shape in hf_dinov2_shapes(cfg):
        seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4],
                              "little")
        vals = np.random.default_rng(seed).standard_normal(shape).astype(
            np.float32) * 0.02
        if name.endswith("layernorm.weight") or ".norm" in name:
            vals = 1.0 + vals
        out[name] = vals
    return out


def device_ms(fn, device, reps: int = 7, inner: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``inner`` calls: CUDA events
    on the card, the host clock elsewhere (rehearsal only)."""
    import torch
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_device() -> dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(line, flush=True)
    info = {"phase": "device", "nvidia_smi": line,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit(info)
    return info


def phase_build(port) -> dict:
    build = port["build"]
    t0 = time.time()
    built = build.build_all()
    log = build.build_log("flash_attention")
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    info = {"phase": "build", "seconds": round(time.time() - t0, 3),
            "built": sorted(built), "ptxas": ptxas}
    emit(info)
    return info


def _qkv(B, H, N, dtype, device, seed):
    """q, k, v as [B, H, N, 64] strided views of [B, N, H·64] tensors, the
    layout the ViT hands the kernel."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(B, N, H * 64, generator=g, device=device,
                        dtype=torch.float32).to(dtype)
            .view(B, N, H, 64).transpose(1, 2) for _ in range(3)]


def attention_bound_ms(B, H, N, n_keys, D, itemsize, peak_flops) -> tuple:
    flops = 4.0 * B * H * N * n_keys * D
    nbytes = float(itemsize) * B * H * D * (2 * N + 2 * n_keys)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(port, device, cases) -> dict:
    """cases: (label, B, H, N, kv_valid, dtype, tol, timed)."""
    import torch
    import torch.nn.functional as F
    att = port["attention"]
    results = {}
    for label, B, H, N, kv_valid, dtype, tol, timed in cases:
        q, k, v = _qkv(B, H, N, dtype, device, seed=len(results))
        scale = 64 ** -0.5
        got = att.flash_mha(q, k, v, scale, kv_valid=kv_valid)
        want = att.flash_mha_reference(q, k, v, scale, kv_valid=kv_valid)
        if device.type == "cuda":
            torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        res = {"phase": "kernel_check", "kernel": "flash_attention",
               "case": label, "shape": [B, H, N, 64], "kv_valid": kv_valid,
               "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err, "tol": tol}
        if timed:
            n_keys = N if kv_valid is None else kv_valid
            res["ms"] = device_ms(
                lambda: att.flash_mha(q, k, v, scale, kv_valid=kv_valid),
                device)
            res["plain_ms"] = device_ms(
                lambda: att.flash_mha_reference(q, k, v, scale,
                                                kv_valid=kv_valid), device)
            mask = None
            if n_keys < N:
                mask = (torch.arange(N, device=device) < n_keys)[None, :]
            res["library_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale), device)
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 \
                else PEAK_F32_FLOPS
            res["bound_ms"], res["bound_by"] = attention_bound_ms(
                B, H, N, n_keys, 64, got.element_size(), peak)
        emit(res)
        if not finite or not err <= tol:
            raise AssertionError(f"flash_attention {label}: max abs err "
                                 f"{err} > {tol} (finite={finite})")
        results[label] = res
    return results


def phase_golden(port, device, cfg, golden_path) -> dict:
    """The full-geometry ViT in float32 through the kernel against the
    golden tokens (atol 2e-4, rtol 1e-3, the golden test's own bounds)."""
    import torch
    vit, att = port["vit"], port["attention"]
    model = vit.DinoViT(cfg)
    model.load_state_dict(vit.convert_hf_dinov2(golden_vit_state(cfg), cfg),
                          strict=True)
    model = model.to(device).eval()
    S = cfg.image_size
    px = (np.linspace(0, 1, 2 * S * S * 3, dtype=np.float32)
          .reshape(2, S, S, 3) * 0.8 + 0.1)
    before = att.LAUNCHES["flash_attention"]
    with torch.inference_mode():
        cls, patches = model(torch.from_numpy(px).to(device))
    launches = att.LAUNCHES["flash_attention"] - before
    cls = cls.float().cpu().numpy()
    patches = patches.float().cpu().numpy()
    got = {"cls": cls, "patch_slice": patches[:, ::137, ::96],
           "patch_mean": patches.mean(axis=(1, 2)),
           "patch_std": patches.std(axis=(1, 2))}
    ref = np.load(golden_path)
    errs = {k: float(np.abs(v - ref[k]).max()) for k, v in got.items()}
    info = {"phase": "golden_vit", "geometry": [S, cfg.patch_size,
                                                cfg.d_model, cfg.n_layers],
            "dtype": "float32", "kernel_launches": launches,
            "max_abs_err": errs, "atol": 2e-4, "rtol": 1e-3}
    emit(info)
    for k, v in got.items():
        np.testing.assert_allclose(v, ref[k], atol=2e-4, rtol=1e-3,
                                   err_msg=f"golden mismatch: {k}")
    if device.type == "cuda" and launches != cfg.n_layers:
        raise AssertionError(f"golden ViT launched K1 {launches} times, "
                             f"expected {cfg.n_layers}")
    return info


def _instance(req: dict) -> dict:
    return {"x_ts": req["x_ts"].tolist(), "static": req["static"].tolist(),
            "pixel_u8_b64": base64.b64encode(
                req["pixel_u8"].tobytes()).decode()}


def _post(url: str, payload: dict) -> tuple:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        body = json.loads(r.read())
        return r.status, body, (time.perf_counter() - t0) * 1e3


def phase_serve(port, device, cfg, n_clients: int, posts_per_client: int,
                seed: int = 0, card: str = "") -> dict:
    """Serve the teacher over HTTP; check every response against a direct
    eval of the batch it was served in; count K1 launches over the run."""
    import torch
    att, engine = port["attention"], port["engine"]
    pred_mod, srv = port["predictor"], port["server"]
    model = port["teacher"].seeded_init(port["teacher"].TeacherModel(cfg),
                                        seed)
    d, S = cfg.duett, cfg.vit.image_size
    T, V = d.n_timesteps, d.n_variables
    pred = pred_mod.BatchingPredictor(model, max_batch=32, max_wait_ms=20.0,
                                      dtype=torch.bfloat16, device=device)
    # record every batch the batcher runs, to re-run it directly afterwards
    served_batches = []
    step = pred._step

    def recording_step(x_ts, static, batch):
        out = step(x_ts, static, batch)
        served_batches.append((x_ts, static, batch,
                               {k: v.cpu() for k, v in out.items()}))
        return out

    pred._step = recording_step
    pred.start()
    server = None
    try:
        example = {"x_ts": np.zeros((T, 2 * V), np.float32),
                   "static": np.zeros(d.d_static, np.float32),
                   "pixel_u8": np.zeros((S, S, 3), np.uint8)}
        warm = pred.warmup(example)
        served_batches.clear()
        server = srv.make_server(pred, "127.0.0.1", 0,
                                 meta={"image_size": S})
        srv.serve_forever(server, background=True)
        url = f"http://127.0.0.1:{server.server_address[1]}/v1/predict"

        rng = np.random.default_rng(seed)
        n_req = n_clients * posts_per_client
        reqs = [{"x_ts": np.concatenate(
                    [rng.normal(size=(T, V)),
                     rng.integers(-1, 4, size=(T, V))], -1).astype(np.float32),
                 "static": rng.normal(size=d.d_static).astype(np.float32),
                 "pixel_u8": rng.integers(0, 256, (S, S, 3), dtype=np.uint8)}
                for _ in range(n_req)]
        bodies = [{"instances": [_instance(r)]} for r in reqs]
        responses, latencies, errors = [None] * n_req, [], []
        lock = threading.Lock()

        def client(c):
            try:
                for j in range(posts_per_client):
                    i = c * posts_per_client + j
                    code, body, ms = _post(url, bodies[i])
                    if code != 200:
                        raise RuntimeError(f"HTTP {code}: {body}")
                    with lock:
                        responses[i] = body["predictions"][0]
                        latencies.append(ms)
            except Exception as e:      # noqa: BLE001 — reported below
                with lock:
                    errors.append(repr(e))

        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        att.reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = att.LAUNCHES["flash_attention"]
        stats = pred.stats()
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
            else None
        if errors or any(th.is_alive() for th in threads):
            raise RuntimeError(f"clients failed: {errors}")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        pred.close()

    # every served batch re-run directly must give its outputs again, and
    # every response its row of its batch (both within SERVE_TOL)
    direct = engine.make_teacher_eval_from_windows(pred._model,
                                                   torch.bfloat16)
    rows = {}
    max_batch_diff = 0.0
    for x_ts, static, batch, out in served_batches:
        again = {k: v.cpu() for k, v in direct(x_ts, static, batch).items()}
        for k in out:
            max_batch_diff = max(max_batch_diff, float(
                (again[k] - out[k]).abs().max()))
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"non-finite {k} in a served batch")
        for i in range(x_ts.shape[0]):
            rows.setdefault(x_ts[i].tobytes(), again["fusion_logits"][i])
    max_resp_diff = 0.0
    for r, resp in zip(reqs, responses):
        want = rows[r["x_ts"].tobytes()]
        got = torch.tensor(resp["fusion_logits"])
        max_resp_diff = max(max_resp_diff, float((got - want).abs().max()))
        if len(resp["probabilities"]) != cfg.perceiver.n_pathologies:
            raise AssertionError("wrong number of probabilities")
    # where a batch's time goes: the direct step per bucket (host work, the
    # pixel upload and the device, end to end) against K1's share of it
    breakdown = {}
    for b in (1, 8, 32):
        idx = [i % n_req for i in range(b)]
        x_ts = np.stack([reqs[i]["x_ts"] for i in idx])
        static = np.stack([reqs[i]["static"] for i in idx])
        batch = {"bin_ends": np.broadcast_to(
                     (np.arange(1, T + 1) / 24.0).astype(np.float32),
                     (b, T)).copy(),
                 "pixel_u8": np.stack([reqs[i]["pixel_u8"] for i in idx])}
        q, k, v = _qkv(b, cfg.vit.n_heads, cfg.vit.n_patches + 1,
                       torch.bfloat16, device, seed=b)
        k1 = device_ms(lambda: att.flash_mha(q, k, v, 0.125), device)
        step_ms = device_ms(lambda: direct(x_ts, static, batch)
                            ["fusion_logits"].cpu(), device, reps=5, inner=3)
        breakdown[b] = {"step_ms": step_ms,
                        "k1_ms_per_batch": k1 * cfg.vit.n_layers,
                        "k1_share": k1 * cfg.vit.n_layers / step_ms,
                        "step_samples_per_s": b / step_ms * 1e3}
    lat = np.asarray(latencies)
    info = {"phase": "serve", "card": card, "requests": n_req,
            "clients": n_clients,
            "batches": stats["n_batches"],
            "batch_size_hist": stats["batch_size_hist"],
            "k1_launches": launches,
            "k1_launches_per_batch": launches / max(stats["n_batches"], 1),
            "samples_per_s": n_req / wall, "wall_s": wall,
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99)),
            "server_latency_ms_p50": stats["latency_ms_p50"],
            "server_latency_ms_p99": stats["latency_ms_p99"],
            "peak_memory_bytes": peak, "warmup_s": warm,
            "max_abs_diff_direct_vs_served_batch": max_batch_diff,
            "max_abs_diff_response_vs_direct": max_resp_diff,
            "breakdown_by_bucket": breakdown}
    emit(info)
    if stats["n_requests"] != n_req:
        raise AssertionError(f"served {stats['n_requests']} of {n_req}")
    if max(int(b) for b in stats["batch_size_hist"]) < 2:
        raise AssertionError("no coalescing: every batch held one request")
    if device.type == "cuda" and launches != cfg.vit.n_layers * \
            stats["n_batches"]:
        raise AssertionError(f"K1 launched {launches} times over "
                             f"{stats['n_batches']} batches, expected "
                             f"{cfg.vit.n_layers} per batch")
    if max_batch_diff > SERVE_TOL or max_resp_diff > SERVE_TOL:
        raise AssertionError(f"served outputs differ from the direct eval: "
                             f"batch {max_batch_diff}, response "
                             f"{max_resp_diff}")
    return info


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, PKG)) or \
            not os.path.exists(GOLDEN):
        print(f"chip_smoke: run from a checkout of the repo ({PKG}/ and "
              f"{os.path.relpath(GOLDEN, REPO)} not found)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    port = import_port()
    cfgmod = port["config"]

    dev = phase_device()
    phase_build(port)
    bf16, f32 = torch.bfloat16, torch.float32
    checks = phase_kernels(port, device, [
        ("vit_bf16", 8, 12, 1370, None, bf16, TOL_BF16, True),
        ("ragged_bf16", 2, 12, 1000, 900, bf16, TOL_BF16, False),
        ("f32", 2, 12, 1370, 1301, f32, TOL_F32, True),
    ])
    phase_golden(port, device, cfgmod.ViTConfig(), GOLDEN)
    serve = phase_serve(port, device, cfgmod.TeacherConfig(), n_clients=12,
                        posts_per_client=4, card=dev["nvidia_smi"])

    main_case = checks["vit_bf16"]
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": serve["k1_launches"],
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
