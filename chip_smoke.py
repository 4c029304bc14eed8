#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100 (or any sm_90a card).

    python3 chip_smoke.py        # from the repo root; needs one CUDA card

Phases, each printing one JSON line; any failure exits non-zero and never
prints the final ``ok`` line:

1. device   card name and power limit (``nvidia-smi``), torch/CUDA versions.
2. build    compiles every CUDA kernel of the port from ``csrc/`` (nvcc).
3. kernels  holds K1 (flash attention) against ``flash_mha_reference`` on
            the card: bf16 at the ViT shape of each path that launches it
            (a serve bucket of 8, the bank build's chunks of 16, the pixel
            tier's train batch of 32), a ragged bf16 case and a float32
            case; times the kernel, the plain version, PyTorch's
            ``scaled_dot_product_attention`` (a yardstick only) and the
            bound.
4. golden   the full-geometry ViT-B/14 at 518² in float32 (TF32 off),
            through the kernel, against
            ``tests/goldens/rad_dino_full_geometry.npz``.
5. serve    the full-width ``dual_patch`` teacher (seeded weights) behind
            the HTTP server in bf16; concurrent clients; every response
            checked against a direct eval of the batch it was served in;
            K1's launches counted over exactly this run.
6. kernels  holds K2 (row gather) against ``gather_rows_reference`` on the
            card, bit for bit: the bf16 patch bank [401, 1370, 768] with
            32 rows (repeats and the NaN sentinel among them), the CLS bank
            [401, 768] and a float32 patch bank; times the kernel, the plain
            version, ``torch.index_select`` (a yardstick only) and the bound.
7. train    the port's training CLI at full width on the encode-once tier
            (``cli/train_teacher.main``, 240 synthetic stays, batch 32,
            2 epochs, bf16); K1 and K2 launches counted over exactly this
            run; finite losses; K2 twice per train and eval step; the best
            checkpoint reloaded through ``load_teacher_from_ckpt`` evaluates
            the val split as the loop did.
8. tiers    one train step on the same batch from the same weights in the
            pixel tier and the encode-once tier: losses, ``main_logit``,
            gradients and updated parameters agree (TIER_TOL), and a
            step on other images' bank rows does not;
            both steps timed, K2's share of the encode-once step, and a
            ``torch.profiler`` trace of each tier's steps (device busy time
            per step, idle share, time by kernel; "not measured" if the
            trace holds no device time).

Then the least times of the two kernels still to port (K3, K4) at the main
path's shapes, the kernel summary line and, last,
``{"ok": true, "device": ...}``. Imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import base64
import copy
import hashlib
import json
import os
import shutil
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
K2_SOURCE = f"{PKG}/csrc/gather_rows.cu"
K2_REPLACES = ("multimodal_edema_prediction_tpu/ops/pallas_gather.py:60 "
               "gather_rows (:42 _gather_rows_3d, pallas_call :52, "
               ":37 _kernel)")
RUNS = os.path.join(REPO, "build", "chip_smoke_runs")
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
# one bf16 train step in the pixel tier against the encode-once tier, from
# the same weights on the same batch, relative to the larger magnitude (each
# loss; main_logit, each gradient and each updated parameter against the
# leaf's max abs): the bank holds the ViT's own bf16 tokens, encoded in chunks
# of 16 where the pixel step encodes 32 images at once. The runs so far gave
# bit-equal losses, so what is left is the order of atomic adds in the
# backward. The phase's third step, on other images' bank rows, shows how far
# a wrong row moves the same readings.
TIER_TOL = 1e-4


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def import_port():
    """The port's modules this script drives, which bring in every module of
    the port (kept in one place so that a test can import exactly this set
    and check that it covers the port and that no JAX comes with it)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from multimodal_edema_prediction_tpu_torch import config
    from multimodal_edema_prediction_tpu_torch.cli import serve as cli_serve
    from multimodal_edema_prediction_tpu_torch.cli import train_teacher
    from multimodal_edema_prediction_tpu_torch.data import (features, ingest,
                                                            pipeline,
                                                            synthetic)
    from multimodal_edema_prediction_tpu_torch.models import teacher, vit
    from multimodal_edema_prediction_tpu_torch.ops import (attention, build,
                                                           gather)
    from multimodal_edema_prediction_tpu_torch.serve import predictor, server
    from multimodal_edema_prediction_tpu_torch.train import (checkpoint,
                                                             engine, optim,
                                                             state,
                                                             teacher_loop)
    return dict(config=config, teacher=teacher, vit=vit, attention=attention,
                build=build, gather=gather, predictor=predictor,
                server=server, engine=engine, checkpoint=checkpoint,
                optim=optim, state=state, teacher_loop=teacher_loop,
                features=features, pipeline=pipeline, synthetic=synthetic,
                ingest=ingest, cli_serve=cli_serve,
                train_teacher=train_teacher)


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


def _bits(x):
    """A tensor's bit pattern, so that equality holds NaN == NaN."""
    import torch
    return x.view({2: torch.int16, 4: torch.int32}.get(x.element_size(),
                                                       torch.uint8))


def phase_gather(port, device, n_bank: int = 400, batch: int = 32) -> dict:
    """K2 against its plain version, bit for bit, at the main path's shapes:
    bank rows N + 1 (the NaN sentinel last), 32 rows with repeats and the
    sentinel."""
    import torch
    G = port["gather"]
    g = torch.Generator(device=device).manual_seed(7)
    rows = torch.randint(0, n_bank, (batch,), generator=g, device=device,
                         dtype=torch.int32)
    rows[1] = rows[0]
    rows[-1] = n_bank                                  # the sentinel
    results = {}
    for label, shape, dtype in (
            ("patch_bf16", (n_bank + 1, 1370, 768), torch.bfloat16),
            ("cls_bf16", (n_bank + 1, 768), torch.bfloat16),
            ("patch_f32", (n_bank + 1, 1370, 768), torch.float32)):
        bank = torch.randn(shape, generator=g, device=device, dtype=dtype)
        bank[-1] = float("nan")
        got = G.gather_rows(bank, rows)
        want = G.gather_rows_reference(bank, rows)
        torch.cuda.synchronize()
        exact = bool(torch.equal(_bits(got), _bits(want)))
        err = (got.float() - want.float()).nan_to_num(0.0).abs().max().item()
        row_bytes = bank[0].numel() * bank.element_size()
        res = {"phase": "kernel_check", "kernel": "gather_rows",
               "case": label, "bank": list(shape), "rows": batch,
               "dtype": str(dtype).replace("torch.", ""),
               "bit_exact": exact, "max_abs_err": err,
               "ms": device_ms(lambda: G.gather_rows(bank, rows), device),
               "plain_ms": device_ms(
                   lambda: G.gather_rows_reference(bank, rows), device),
               "library_ms": device_ms(
                   lambda: torch.index_select(bank, 0, rows), device),
               "bound_ms": 2.0 * batch * row_bytes / PEAK_BYTES * 1e3,
               "bound_by": "bytes"}
        emit(res)
        if not exact:
            raise AssertionError(f"gather_rows {label}: not bit-exact "
                                 f"(max abs err {err})")
        results[label] = res
        del bank, got, want
    torch.cuda.empty_cache()
    return results


def phase_train(port, device, card: str = "") -> dict:
    """The training CLI at full width on the encode-once tier, with K1's and
    K2's launches counted over exactly this run."""
    import torch
    att, G = port["attention"], port["gather"]
    shutil.rmtree(RUNS, ignore_errors=True)
    argv = ["--device", "cuda", "--cxr_feature_cache", "hbm",
            "--synthetic_stays", "240", "--batch_size", "32", "--epochs", "2",
            "--ckpt_dir", RUNS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    att.reset_launches()
    G.reset_launches()
    t0 = time.perf_counter()
    res = port["train_teacher"].main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = att.LAUNCHES["flash_attention"], G.LAUNCHES["gather_rows"]
    ex = res.extras
    steps, evals = ex["n_train_steps"], ex["n_eval_steps"]
    phase = ex["phase_seconds"]
    # the best checkpoint through the port's own loader, evaluated by the
    # loop's own eval on the val split, against the loop's reading of it
    model, _, _ = port["checkpoint"].load_teacher_from_ckpt(res.best_path,
                                                            device)
    again = ex["evaluate"](model, "val")
    k2_reload = G.LAUNCHES["gather_rows"] - k2
    best = ex["best_val_outputs"]
    reload_diff = max(float(np.abs(again["outputs"][k] - best[k]).max())
                      for k in ("img", "ts", "fus", "corr", "main"))
    info = {"phase": "train", "card": card, "argv": argv,
            "wall_s": wall, "feature_build_s": phase["feature_build"],
            "k1_launches_in_bank_build": k1,
            "k2_launches": k2, "train_steps": steps, "eval_steps": evals,
            "train_s": phase["train"], "eval_s": phase["eval"],
            "train_step_ms": phase["train"] / steps * 1e3,
            "train_samples_per_s": steps * int(argv[argv.index(
                "--batch_size") + 1]) / phase["train"],
            "epoch_losses": [h["train_total"] for h in res.history],
            "val_auroc": [h["val_main_auroc"] for h in res.history],
            "best_val_auroc": res.best_metric,
            "test_auroc": res.test_metrics["main_auroc"],
            "reload_val_auroc": again["main_auroc"],
            "reload_max_abs_diff": reload_diff,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(info)
    shutil.rmtree(RUNS, ignore_errors=True)
    if not all(np.isfinite(x) for x in info["epoch_losses"]):
        raise AssertionError(f"non-finite losses {info['epoch_losses']}")
    if k2 != 2 * (steps + evals):
        raise AssertionError(f"K2 launched {k2} times over {steps} train and "
                             f"{evals} eval steps, expected 2 per step")
    if k1 == 0 or k2 == 0 or k2_reload == 0:
        raise AssertionError("the train path did not launch K1 and K2")
    if reload_diff > SERVE_TOL or again["main_auroc"] != res.best_metric:
        raise AssertionError(f"reloaded best checkpoint evaluates "
                             f"differently: {reload_diff}, "
                             f"{again['main_auroc']} vs {res.best_metric}")
    return info


def _profile(fn, n: int, step_ms: float) -> dict:
    """``n`` calls of ``fn`` under ``torch.profiler``: device busy time per
    call (the sum of every device event's self time), the idle share of the
    unprofiled ``step_ms``, the heaviest kernels, and K2's device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:       # no CUPTI on this machine: say so
        return {"device_time": f"not measured ({e})"}
    # device-side events only (kernels, copies, memsets): an operator's
    # own row repeats the device time of the kernels it launched
    rows = [(e.device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if getattr(e.device_type, "name", "") == "CUDA"
            and e.device_time_total > 0]
    if not rows:
        return {"device_time": "not measured (no device events)"}
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3 / n
    k2 = [r for r in rows if "gather_rows_kernel" in r[1]]
    return {"device_busy_ms_per_step": busy,
            "idle_share": 1.0 - busy / step_ms,
            "k2_device_ms_per_step": sum(r[0] for r in k2) / 1e3 / n,
            "k2_launches_per_step": sum(r[2] for r in k2) / n,
            "top_kernels": [{"name": k[:90], "ms_per_step": us / 1e3 / n,
                             "launches_per_step": c / n}
                            for us, k, c in rows[:8]]}


def _tier_diffs(a: dict, b: dict) -> dict:
    """Relative differences of two steps' readings (``_leaves``): each loss
    against its magnitude, each leaf against its own max abs."""
    if a.keys() != b.keys():
        raise AssertionError(f"tiers trained other leaves: "
                             f"{sorted(a.keys() ^ b.keys())[:5]}")
    return {k: float((a[k] - b[k]).abs().max()
                     / max(float(a[k].abs().max()), 1e-12)) for k in a}


def _worst(diffs: dict) -> dict:
    """Per kind of reading, the largest difference and its leaf (None when
    every leaf of that kind is equal)."""
    out = {}
    for kind in ("loss", "main_logit", "grad", "param"):
        v, k = max(((v, k) for k, v in diffs.items()
                    if k.split(":")[0] == kind), default=(0.0, None))
        out[kind] = (v, k if v > 0 else None)
    return out


def phase_tiers(port, device, cfg, gather_ms: float, reps: int = 5) -> dict:
    """One bf16 train step per tier from the same weights on the same batch:
    losses, ``main_logit``, every gradient and every updated parameter
    compared; then ``reps`` more steps of each, timed on the host clock to a
    device sync (median). A third step gathers each sample's bank row of
    another image, to show that the comparison sees a wrong row."""
    import torch
    tl, eng = port["teacher_loop"], port["engine"]
    cfgmod, P, S = port["config"], port["pipeline"], port["synthetic"]
    dcfg = cfgmod.DataConfig()
    tcfg = cfgmod.TrainConfig(batch_size=32)
    ds = S.make_synthetic(seed=0, n_stays=240, n_subjects=80,
                          n_variables=cfg.duett.n_variables)
    data = P.build_anchor_dataset(ds, P.meta_from_events(ds, dcfg),
                                  dcfg).to(device)
    base = port["teacher"].init_teacher(cfg, 0).to(device)
    hook = tl.make_synthetic_pixel_hook(cfg.vit.image_size)
    bank = tl.build_feature_bank(base, data, hook, torch.bfloat16)
    host = next(data.iter_batches("train", 32, shuffle=True, seed=0))
    host.pop("valid")
    feat_batch = bank.host_fn()(host)
    n_bank = bank.cls.shape[0] - 1
    shifted = {**feat_batch,
               "image_ids": (feat_batch["image_ids"] + 1) % n_bank}
    runs = {"pixels": (None, hook(host), True),
            "features": (bank.feature_source(), feat_batch, True),
            "wrong_rows": (bank.feature_source(), shifted, False)}
    out, after = {}, {}
    for name, (source, batch, timed) in runs.items():
        model = copy.deepcopy(base)
        state = port["state"].TrainState(model, port["optim"].MultiGroupAdamW(
            model, tcfg.optim, 100, frozen_prefixes=("cxr/",)))
        step = eng.make_teacher_step(tcfg, cfg.duett, 24,
                                     np.ones(7, np.float32),
                                     feature_source=source)
        dev_batch = eng.to_device(batch, device)

        def run():
            return step(state, data.grid, data.static, dev_batch,
                        torch.Generator(device=device).manual_seed(1))

        res = run()
        after[name] = {
            **{f"loss:{k}": v.float().reshape(1) for k, v in res.items()
               if v.dim() == 0},
            "main_logit": res["main_logit"].clone(),
            **{f"grad:{n}": p.grad.detach().float().clone()
               for n, p in model.named_parameters() if p.grad is not None},
            **{f"param:{n}": p.detach().float().clone()
               for n, p in model.named_parameters() if p.requires_grad}}
        if timed:
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            step_ms = statistics.median(times)
            out[name] = {"losses": {k[5:]: float(v) for k, v in
                                    after[name].items()
                                    if k.startswith("loss:")},
                         "step_ms": step_ms,
                         "profile": _profile(run, 3, step_ms)}
        del model, state
    diffs = _tier_diffs(after["pixels"], after["features"])
    worst = _worst(diffs)
    wrong = _worst(_tier_diffs(after["pixels"], after["wrong_rows"]))
    n_grads = sum(k.startswith("grad:") for k in diffs)
    feat_ms = out["features"]["step_ms"]
    info = {"phase": "tiers", "batch": 32, "dtype": "bfloat16",
            "pixels": out["pixels"], "features": out["features"],
            **{f"max_rel_{kind}_diff": v[0] for kind, v in worst.items()},
            "worst_grad_leaf": worst["grad"][1],
            "worst_param_leaf": worst["param"][1],
            "grad_leaves": n_grads, "tol": TIER_TOL,
            "wrong_rows_max_rel_diff": {kind: v[0]
                                        for kind, v in wrong.items()},
            "pixels_samples_per_s": 32e3 / out["pixels"]["step_ms"],
            "features_samples_per_s": 32e3 / feat_ms,
            "k2_ms_per_step": gather_ms, "k2_share": gather_ms / feat_ms}
    k2_dev = out["features"]["profile"].get("k2_device_ms_per_step")
    if k2_dev is not None:
        info["k2_share_device_time"] = k2_dev / feat_ms
    emit(info)
    if n_grads == 0:
        raise AssertionError("the tiers' step left no gradient to compare")
    if not max(diffs.values()) <= TIER_TOL:
        raise AssertionError(f"tiers disagree: {worst}")
    if not max(v[0] for v in wrong.values()) > TIER_TOL:
        raise AssertionError(f"the comparison misses a wrong bank row: "
                             f"{wrong}")
    return info


def bounds_to_port(cfg, batch: int = 32) -> dict:
    """The least times of the TPU kernels still to port, at the main path's
    shapes and batch, from the H100's peaks (bf16 operations; inputs read
    once and outputs written once; float32 weights, as the parameters are
    kept):

    - K3 (one DuETT dual-axis block, ``ops/pallas_dual_axis.py``): the event
      axis (L = V+1 tokens of D = et_dim) and the time axis (L = T+1 tokens
      of D = tt_dim), 2 heads × d_head 12, FF d_feedforward; QKV, QKᵀ, PV,
      W_o and the two FF matmuls.
    - K4 (LayerNorm + QKV projection, ``ops/pallas_ln_qkv.py``): x
      [B, 1370, 768] bf16 → q, k, v [B, 12, 1370, 64] bf16, W [768, 2304].
    """
    d, v = cfg.duett, cfg.vit

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        return {"bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "flops": flops, "bytes": nbytes}

    out = {}
    inner = d.n_heads * (d.d_embedding // d.n_heads)
    for axis, L, D in (("event", d.n_variables + 1, d.et_dim),
                       ("time", d.n_timesteps + 1, d.tt_dim)):
        ff = d.d_feedforward
        flops = 2.0 * batch * L * (3 * D * inner + inner * D + 2 * D * ff) \
            + 4.0 * batch * L * L * inner
        weights = 4.0 * (3 * D * inner + inner * D + D + 2 * D * ff + ff + D
                         + 3)
        out[f"K3_{axis}_block"] = {"shape": [batch, L, D],
                                   **bound(flops, 2.0 * 2 * batch * L * D
                                           + weights)}
    N, D = v.n_patches + 1, v.d_model
    flops = 2.0 * batch * N * D * 3 * D
    nbytes = 2.0 * batch * N * D * 4 + 4.0 * (3 * D * D + 3 * D + 2 * D)
    out["K4_ln_qkv"] = {"shape": [batch, N, D], **bound(flops, nbytes)}
    emit({"phase": "bounds_to_port", "batch": batch, **out})
    return out


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
    model = port["teacher"].init_teacher(cfg, seed)
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
        ("bank_build_bf16", 16, 12, 1370, None, bf16, TOL_BF16, True),
        ("pixel_step_bf16", 32, 12, 1370, None, bf16, TOL_BF16, True),
        ("ragged_bf16", 2, 12, 1000, 900, bf16, TOL_BF16, False),
        ("f32", 2, 12, 1370, 1301, f32, TOL_F32, True),
    ])
    phase_golden(port, device, cfgmod.ViTConfig(), GOLDEN)
    serve = phase_serve(port, device, cfgmod.TeacherConfig(), n_clients=12,
                        posts_per_client=4, card=dev["nvidia_smi"])

    gathers = phase_gather(port, device)
    train = phase_train(port, device, card=dev["nvidia_smi"])
    phase_tiers(port, device, cfgmod.TeacherConfig(),
                gathers["patch_bf16"]["ms"] + gathers["cls_bf16"]["ms"])
    bounds_to_port(cfgmod.TeacherConfig())

    # K1's launches are counted on the train run, whose K1 work is the bank
    # build's chunks of 16: its row comes from that case
    k1, k2 = checks["bank_build_bf16"], gathers["patch_bf16"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES,
         "launches": train["k1_launches_in_bank_build"],
         "launches_by_path": {"serve": serve["k1_launches"],
                              "train": train["k1_launches_in_bank_build"]},
         "case": "bank_build_bf16 [16, 12, 1370, 64]",
         **{k: k1[k] for k in keys}},
        {"name": "gather_rows", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": train["k2_launches"],
         "case": "patch_bf16 [401, 1370, 768] x 32 rows",
         "launches_by_path": {"train": train["k2_launches"]},
         **{k: k2[k] for k in keys}}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
