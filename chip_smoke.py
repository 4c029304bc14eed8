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

Training through the ViT (``--unfreeze_cxr``, ROADMAP S3) adds:

3b. backward  holds K1's dkv and dq kernels (through ``flash_mha``'s
            autograd Function) against ``flash_mha_backward_reference``:
            bf16 at the unfrozen pixel step's [32, 12, 1370, 64], a ragged
            bf16 case (N 1001, kv_valid 900) and a float32 case; the
            forward's log-sum-exp against the plain one; two backward
            passes bit-equal; masked keys' dk, dv exactly 0; times the
            forward with and without lse, each backward kernel, the plain
            backward, ``scaled_dot_product_attention``'s backward (a
            yardstick only) and the bounds.
4b. block_grad  one full-width ``DinoBlock`` (N 1370, d 768, batch 2,
            float32, TF32 off): every parameter's and the input's gradient
            through the kernels on the card against a CPU copy running the
            plain versions (BLOCK_TOL).
9.  unfreeze  the training CLI with ``--unfreeze_cxr`` on the pixel tier at
            full width (240 stays, batch 32, 1 epoch of 4 batches); K1's
            launches counted over exactly this run (forward, dkv, dq 12 each
            per train step, the forward 12 per eval step); finite losses;
            the ViT's, DuETT's and the perceiver's weights moved; the
            reloaded best checkpoint evaluates the val split bit-equal.
10. unfreeze_step  the unfrozen step at batch 32: steady time (CUDA
            events), peak memory (and its estimate at batch 128), and a
            ``torch.profiler`` breakdown.

The last two TPU kernels (K3 fused DuETT block, K4 fused LayerNorm → QKV)
and DuETT SSL pretraining (ROADMAP P12) add:

3c. dual_axis  holds K3 against ``encoder_block_reference`` at DuETT's two
            axes, event [32, 35, 600] and time [32, 25, 840] (2 heads × 12,
            FF 512), in bf16 and float32; reruns bit-equal; times the kernel,
            the plain version and the bound; one backward through the
            autograd Function against autograd of the plain version.
3d. ln_qkv  holds K4 against ``ln_qkv_reference`` at the ViT's
            [32, 1536, 768] (12 × 64, bf16) and [2, 512, 256] (4 × 64,
            float32); reruns bit-equal; times the kernel, the plain version,
            the bound and a yardstick of several PyTorch calls.
11. ssl     the SSL CLI (``cli/train_ssl.main``) at the full default DuETT
            width on the 240 synthetic stays, batch 128, 2 epochs; every
            kernel's launches counted over exactly this run (none of the
            six is on this path); finite losses, the train loss falling,
            ``meta_with_stats.pkl`` written, the best checkpoint reloaded
            evaluates the val split as the loop did; then the steady SSL
            step (CUDA events, peak memory, ``torch.profiler``).
12. trained_layer  K3 fed each DuETT axis's first layer's own input (a
            forward hook in a bf16 eval step of the best SSL checkpoint)
            with that layer's weights, against the layer's output.
13. ssl_to_teacher  the teacher CLI with ``--duett_ckpt`` on the
            encode-once tier (1 epoch of 4 batches of 32): its DuETT starts
            equal to the SSL encoder; finite losses; launches counted.

K1's backward redesigned for Hopper (warpgroup MMA, TMA; ROADMAP Queue 2)
adds:

2b. bwd_build  the bf16 dkv and dq kernels as built: registers, spills and
            shared memory (``ptxas -v``) and their HGMMA count (``cuobjdump``
            SASS); fails on a spill or on a kernel without HGMMA.
3b. backward  also the pair (dkv + dq) and the autograd Function's whole
            backward (dO made ready, D, dkv, dq) against SDPA's backward in
            the same run (``pair_ms``, ``pair_vs_library``, ``delta_ms``,
            ``backward_ms``, ``backward_vs_library``); 10. unfreeze_step
            also dkv's and dq's device ms per step at the top level.

Then the kernel summary line (six kernels; the dkv and dq rows with the
build facts, the pair and the whole backward) and, last,
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
K1_BWD_SOURCE = f"{PKG}/csrc/flash_attention_bwd.cu"
K1_DKV_REPLACES = ("jax/experimental/pallas/ops/tpu/flash_attention.py:1121 "
                   "(pallas_call of _flash_attention_bwd_dkv :941, kernel "
                   "_flash_attention_dkv_kernel :796), the gradient of "
                   "multimodal_edema_prediction_tpu/ops/attention.py:127")
K1_DQ_REPLACES = ("jax/experimental/pallas/ops/tpu/flash_attention.py:1456 "
                  "(pallas_call of _flash_attention_bwd_dq :1287, kernel "
                  "_flash_attention_dq_kernel :1146), the gradient of "
                  "multimodal_edema_prediction_tpu/ops/attention.py:127")
K3_SOURCE = f"{PKG}/csrc/dual_axis_block.cu"
K3_REPLACES = ("multimodal_edema_prediction_tpu/ops/pallas_dual_axis.py:192 "
               "fused_encoder_block (pallas_call :171, _fused_forward :136, "
               ":78 _block_kernel)")
K4_SOURCE = f"{PKG}/csrc/ln_qkv.cu"
K4_REPLACES = ("multimodal_edema_prediction_tpu/ops/pallas_ln_qkv.py:126 "
               "fused_ln_qkv (pallas_call :108, _forward :82, :58 _kernel)")
RUNS = os.path.join(REPO, "build", "chip_smoke_runs")
SSL_RUNS = os.path.join(REPO, "build", "chip_smoke_ssl")
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
# bf16 kernel vs float32 plain version: P is rounded to bf16 before the PV
# product and the output to bf16 (2^-8 relative on outputs of |x| ≲ 1)
TOL_BF16 = 2e-2
# float32 kernel vs float32 plain version (TF32 off): same math, another
# summation order (64-term dot products, online vs direct softmax)
TOL_F32 = 1e-5
# K1's backward kernels against the float32 plain backward, each gradient
# relative to its max abs. bf16: P and dS are rounded to bf16 before their
# products (as FA2 does) and o, lse, D come from the bf16 forward.
TOL_BWD_BF16 = 2e-2
# float32 SIMT kernels (TF32 off): the same arithmetic in another order, P
# from exp(S·scale − lse) against the plain softmax
TOL_BWD_F32 = 1e-4
# the forward's log-sum-exp against torch.logsumexp of the same scores,
# absolute: both accumulate in float32, on values ≲ 10
TOL_LSE = 1e-4
# K3 and K4 against their plain versions, relative to each output's max
# abs. Both sides take the same inputs and weights (cast to x's dtype) and
# compute in float32, in other summation orders; at bf16 the output (and
# K4's h) is rounded to bf16, 2^-8 relative.
TOL_FUSED_BF16 = 2e-2
TOL_FUSED_F32 = 1e-4
# K3 fed a trained DuETT layer's own input at bf16, against that layer's
# output: the layer rounds every product to bf16 (both take GELU's tanh form)
TOL_TRAINED_LAYER = 2e-2
# one full-width DinoBlock, float32, TF32 off: every parameter's and the
# input's gradient on the card (K1's float32 kernels, cuBLAS) against a CPU
# copy running the plain versions, relative to each gradient's max abs
# floored at 1e-2 of the largest: the key bias's exact gradient is 0
# (softmax is shift-invariant), and both sides hold only rounding noise
# there, 9e-8 of the largest gradient apart on an H100. Elsewhere
# the same float32 math in other summation orders (~1e-6 relative).
BLOCK_TOL = 1e-4
BLOCK_FLOOR = 1e-2
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
    from multimodal_edema_prediction_tpu_torch import config, convert
    from multimodal_edema_prediction_tpu_torch.cli import serve as cli_serve
    from multimodal_edema_prediction_tpu_torch.cli import (train_ssl,
                                                           train_teacher)
    from multimodal_edema_prediction_tpu_torch.data import (features, ingest,
                                                            pipeline, sliding,
                                                            synthetic)
    from multimodal_edema_prediction_tpu_torch.models import (duett, teacher,
                                                              vit)
    from multimodal_edema_prediction_tpu_torch.ops import (attention, build,
                                                           dual_axis, gather,
                                                           ln_qkv)
    from multimodal_edema_prediction_tpu_torch.serve import predictor, server
    from multimodal_edema_prediction_tpu_torch.train import (checkpoint,
                                                             engine, optim,
                                                             ssl_loop, state,
                                                             teacher_loop)
    return dict(config=config, convert=convert, teacher=teacher, vit=vit,
                duett=duett, attention=attention, build=build, gather=gather,
                dual_axis=dual_axis, ln_qkv=ln_qkv, predictor=predictor,
                server=server, engine=engine, checkpoint=checkpoint,
                optim=optim, state=state, teacher_loop=teacher_loop,
                ssl_loop=ssl_loop, features=features, pipeline=pipeline,
                sliding=sliding, synthetic=synthetic, ingest=ingest,
                cli_serve=cli_serve, train_teacher=train_teacher,
                train_ssl=train_ssl)


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
    ptxas = {name: [ln.strip() for ln in build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln]
             for name in build.SOURCES}
    info = {"phase": "build", "seconds": round(time.time() - t0, 3),
            "built": sorted(built), "ptxas": ptxas}
    emit(info)
    return info


def phase_bwd_build(port) -> dict:
    """K1's bf16 dkv and dq kernels as built: registers, spills (bytes
    stored plus loaded) and static shared memory from the ``ptxas -v`` log,
    the dynamic shared memory a launch asks for, and the warpgroup MMAs
    (HGMMA) in the library's SASS (``cuobjdump``). Fails if either kernel
    spills or holds no HGMMA, or if there is no SASS listing to count."""
    import ctypes
    build = port["build"]
    usage = build.ptxas_usage(build.build_log("flash_attention_bwd"))
    listing = build.sass("flash_attention_bwd")
    if listing is None:
        raise AssertionError("no SASS listing of flash_attention_bwd "
                             "(cuobjdump missing or failed)")
    hgmma = build.sass_opcode_counts(listing, "HGMMA")
    dynamic = build.load("flash_attention_bwd").flash_attention_bwd_smem_bytes
    dynamic.restype, dynamic.argtypes = ctypes.c_int, [ctypes.c_int]
    info = {"phase": "bwd_build"}
    for i, kind in enumerate(("dkv", "dq")):
        name = f"flash_bwd_{kind}_bf16"
        found = [u for fn, u in usage.items() if name in fn]
        if len(found) != 1:
            raise AssertionError(f"{name}: no single ptxas entry: {usage}")
        u = found[0]
        info[kind] = {
            "registers": u["registers"],
            "spills": u["spill_stores"] + u["spill_loads"],
            "smem_bytes": u["smem_bytes"] + dynamic(i),
            "sass_hgmma": sum(n for fn, n in hgmma.items() if name in fn)}
    emit(info)
    for kind in ("dkv", "dq"):
        if info[kind]["spills"] or not info[kind]["sass_hgmma"] > 0:
            raise AssertionError(f"K1 {kind}: {info[kind]}")
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


def _reload_val(port, res, device) -> tuple:
    """The run's best checkpoint through the port's own loader, evaluated
    by the loop's own eval on the val split: (model, TeacherConfig, raw
    checkpoint, the eval, its largest difference from the loop's reading of
    the same split)."""
    model, tcfg, ck = port["checkpoint"].load_teacher_from_ckpt(
        res.best_path, device)
    again = res.extras["evaluate"](model, "val")
    best = res.extras["best_val_outputs"]
    diff = max(float(np.abs(again["outputs"][k] - best[k]).max())
               for k in ("img", "ts", "fus", "corr", "main"))
    return model, tcfg, ck, again, diff


def _train_batch(port, device, cfg) -> tuple:
    """The steady-step phases' data: the synthetic cohort of the train
    phase on ``device``, one shuffled train batch of 32 (host arrays) and
    the procedural pixel hook."""
    cfgmod, P, S = port["config"], port["pipeline"], port["synthetic"]
    dcfg = cfgmod.DataConfig()
    ds = S.make_synthetic(seed=0, n_stays=240, n_subjects=80,
                          n_variables=cfg.duett.n_variables)
    data = P.build_anchor_dataset(ds, P.meta_from_events(ds, dcfg),
                                  dcfg).to(device)
    host = next(data.iter_batches("train", 32, shuffle=True, seed=0))
    host.pop("valid")
    hook = port["teacher_loop"].make_synthetic_pixel_hook(cfg.vit.image_size)
    return data, host, hook


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
    _, _, _, again, reload_diff = _reload_val(port, res, device)
    k2_reload = G.LAUNCHES["gather_rows"] - k2
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


def _profile(fn, n: int, step_ms: float, watch: dict) -> dict:
    """``n`` calls of ``fn`` under ``torch.profiler``: device busy time per
    call (the sum of every device event's self time), the idle share of the
    unprofiled ``step_ms``, the heaviest kernels, and, for each ``watch``
    name, the device time and launches per call of the kernels whose names
    hold its substring."""
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
    out = {"device_busy_ms_per_step": busy,
           "idle_share": 1.0 - busy / step_ms}
    for name, sub in watch.items():
        hit = [r for r in rows if sub in r[1]]
        out[f"{name}_device_ms_per_step"] = sum(r[0] for r in hit) / 1e3 / n
        out[f"{name}_launches_per_step"] = sum(r[2] for r in hit) / n
    out["top_kernels"] = [{"name": k[:90], "ms_per_step": us / 1e3 / n,
                           "launches_per_step": c / n}
                          for us, k, c in rows[:8]]
    return out


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
    tcfg = port["config"].TrainConfig(batch_size=32)
    data, host, hook = _train_batch(port, device, cfg)
    base = port["teacher"].init_teacher(cfg, 0).to(device)
    bank = tl.build_feature_bank(base, data, hook, torch.bfloat16)
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
                         "profile": _profile(run, 3, step_ms,
                                             {"k2": "gather_rows_kernel"})}
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


def backward_bound_ms(kind: str, B, H, N, n_keys, itemsize, peak_flops
                      ) -> tuple:
    """(bound_ms, bound_by) of K1's dkv kernel, dq kernel or their "pair"
    at self-attention [B, H, N, 64]: operations 8, 6 and 10 × B·H·N·n_keys·64
    (the products over the keys that take part; 10 is the pair's least,
    with S and dP shared) against ``peak_flops``; bytes: q, k, v, dO read
    once, lse and D (float32) read once, the gradients written once."""
    D = 64
    units, n_out = {"dkv": (8, 2), "dq": (6, 1), "pair": (10, 3)}[kind]
    flops = float(units) * B * H * N * n_keys * D
    nbytes = float(itemsize) * B * H * N * D * (4 + n_out) + 8.0 * B * H * N
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


def phase_backward(port, device, cases) -> dict:
    """K1's backward (the dkv and dq kernels, through ``flash_mha``'s
    autograd Function) against ``flash_mha_backward_reference``; the
    forward's log-sum-exp against the plain one; two backward passes
    bit-equal; keys past ``kv_valid`` exactly zero. Timed cases: the forward
    with and without ``lse``, each backward kernel, D, the Function's whole
    backward, the plain backward and ``scaled_dot_product_attention``'s
    backward (a yardstick only).
    cases: (label, B, H, N, kv_valid, dtype, tol, timed)."""
    import torch
    import torch.nn.functional as F
    att = port["attention"]
    results = {}
    for label, B, H, N, kv_valid, dtype, tol, timed in cases:
        q, k, v = _qkv(B, H, N, dtype, device, seed=10 + len(results))
        do = _qkv(B, H, N, dtype, device, seed=20 + len(results))[0]
        scale = 64 ** -0.5
        n_keys = N if kv_valid is None else kv_valid

        def grads():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            o = att.flash_mha(*leaves, scale, kv_valid=kv_valid)
            return torch.autograd.grad(o, leaves, do)

        got, again = grads(), grads()
        o, lse = att.forward_kernel(q, k, v, scale, n_keys, True)
        o_ref = att.flash_mha_reference(q, k, v, scale, kv_valid=kv_valid)
        lse_ref = att.flash_mha_lse_reference(q, k, scale, kv_valid)
        want = att.flash_mha_backward_reference(q, k, v, o_ref, lse_ref, do,
                                                scale, kv_valid)
        torch.cuda.synchronize()
        rel, err = {}, {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            diff = (g.float() - w.float()).abs().max().item()
            err[name] = diff
            rel[name] = diff / max(w.float().abs().max().item(), 1e-12)
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        same_bits = all(torch.equal(_bits(a), _bits(b))
                        for a, b in zip(got, again))
        masked_zero = n_keys == N or (not got[1][:, :, n_keys:].any()
                                      and not got[2][:, :, n_keys:].any())
        lse_err = (lse - lse_ref).abs().max().item()
        res = {"phase": "kernel_check", "kernel": "flash_attention_bwd",
               "case": label, "shape": [B, H, N, 64], "kv_valid": kv_valid,
               "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err, "max_rel_err": rel, "tol": tol,
               "lse_max_abs_err": lse_err, "lse_tol": TOL_LSE,
               "bit_equal_rerun": same_bits, "masked_keys_zero": masked_zero}
        if timed:
            dlt = att.delta(o, do)
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 \
                else PEAK_F32_FLOPS
            res["fwd_ms"] = device_ms(
                lambda: att.forward_kernel(q, k, v, scale, n_keys, False),
                device)
            res["fwd_lse_ms"] = device_ms(
                lambda: att.forward_kernel(q, k, v, scale, n_keys, True),
                device)
            res["dkv_ms"] = device_ms(
                lambda: att.dkv_kernel(q, k, v, do, lse, dlt, scale, n_keys),
                device)
            res["dq_ms"] = device_ms(
                lambda: att.dq_kernel(q, k, v, do, lse, dlt, scale, n_keys),
                device)
            res["plain_ms"] = device_ms(
                lambda: att.flash_mha_backward_reference(
                    q, k, v, o_ref, lse_ref, do, scale, kv_valid), device,
                reps=3, inner=2)
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            mask = None
            if n_keys < N:
                mask = (torch.arange(N, device=device) < n_keys)[None, :]
            out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                 scale=scale)
            res["library_ms"] = device_ms(
                lambda: torch.autograd.grad(out, leaves, do,
                                            retain_graph=True), device)
            res["delta_ms"] = device_ms(lambda: att.delta(o, do), device)
            # the Function's whole backward as training runs it (dO made
            # ready, D, dkv, dq), timed the way SDPA's backward is above
            fn_out = att.flash_mha(*leaves, scale, kv_valid=kv_valid)
            res["backward_ms"] = device_ms(
                lambda: torch.autograd.grad(fn_out, leaves, do,
                                            retain_graph=True), device)
            res["pair_ms"] = res["dkv_ms"] + res["dq_ms"]
            res["pair_vs_library"] = res["pair_ms"] / res["library_ms"]
            res["backward_vs_library"] = res["backward_ms"] / \
                res["library_ms"]
            for kind in ("dkv", "dq", "pair"):
                res[f"{kind}_bound_ms"], res[f"{kind}_bound_by"] = \
                    backward_bound_ms(kind, B, H, N, n_keys,
                                      q.element_size(), peak)
            del out, fn_out, leaves
        emit(res)
        if not (finite and max(rel.values()) <= tol and lse_err <= TOL_LSE
                and same_bits and masked_zero):
            raise AssertionError(f"flash_attention backward {label}: {res}")
        results[label] = res
        del q, k, v, do, got, again, o, lse, o_ref, lse_ref, want
        torch.cuda.empty_cache()
    return results


def phase_block_grad(port, device, batch: int = 2) -> dict:
    """The gradient of a fixed loss through one full-width ``DinoBlock``
    (d 768, 12 heads, N 1370, float32, TF32 off) on the card, through K1's
    forward and backward kernels, against a CPU copy of the same block
    running the plain versions: every parameter's and the input's
    gradient within BLOCK_TOL of its max abs. This is the check that the
    ViT's weights receive the kernels' gradients (fault F1's kind)."""
    import torch
    att, vit = port["attention"], port["vit"]
    cfg = port["config"].ViTConfig()
    g = torch.Generator().manual_seed(3)
    block = vit.DinoBlock(cfg)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if p.dim() == 2:                        # lecun-scaled weights
                p.copy_(torch.randn(p.shape, generator=g) / p.shape[1] ** .5)
            elif "norm" in name and name.endswith("weight") or \
                    "layerscale" in name:
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    N = cfg.n_patches + 1
    x = torch.randn(batch, N, cfg.d_model, generator=g)
    w = torch.randn(batch, N, cfg.d_model, generator=g)

    def grads(blk, dev):
        xin = x.to(dev).requires_grad_()
        loss = (blk(xin, train=True) * w.to(dev)).sum()
        loss.backward()
        return {"x": xin.grad, **{n: p.grad for n, p in
                                  blk.named_parameters()}}

    card = copy.deepcopy(block).to(device)
    att.reset_launches()
    got = grads(card, device)
    torch.cuda.synchronize()
    launches = dict(att.LAUNCHES)
    want = grads(block, torch.device("cpu"))
    floor = BLOCK_FLOOR * max(float(t.abs().max()) for t in want.values())
    rel = {n: float((got[n].cpu() - want[n]).abs().max()
                    / max(float(want[n].abs().max()), floor)) for n in want}
    worst = max(rel, key=rel.get)
    info = {"phase": "block_grad", "shape": [batch, N, cfg.d_model],
            "dtype": "float32", "launches": launches, "leaves": len(rel),
            "max_rel_err": rel[worst], "worst_leaf": worst,
            "floor": floor,
            "rel_err": rel,
            "tol": BLOCK_TOL}
    emit(info)
    if launches != {"flash_attention": 1, "flash_attention_bwd_dkv": 1,
                    "flash_attention_bwd_dq": 1}:
        raise AssertionError(f"the block's gradient did not run K1's "
                             f"forward and backward once each: {launches}")
    if not rel[worst] <= BLOCK_TOL:
        raise AssertionError(f"block gradients disagree: {worst} "
                             f"{rel[worst]}")
    return info


def phase_unfreeze(port, device, card: str = "") -> dict:
    """The training CLI with the CXR branch trainable (``--unfreeze_cxr``,
    pixel tier) at full width: K1's launches counted over exactly this run
    (forward, dkv and dq 12 each per train step, the forward alone 12 per
    eval step); finite losses; the ViT's, DuETT's and the perceiver's
    weights moved from ``init_teacher``'s; the best checkpoint, reloaded,
    evaluates the val split bit-equal to the loop."""
    import torch
    att = port["attention"]
    shutil.rmtree(RUNS, ignore_errors=True)
    argv = ["--device", "cuda", "--unfreeze_cxr", "--cxr_feature_cache",
            "none", "--synthetic_stays", "240", "--batch_size", "32",
            "--epochs", "1", "--limit_batches", "4", "--ckpt_dir", RUNS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    att.reset_launches()
    t0 = time.perf_counter()
    res = port["train_teacher"].main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(att.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ex = res.extras
    steps, evals = ex["n_train_steps"], ex["n_eval_steps"]
    model, tcfg, ck, again, reload_diff = _reload_val(port, res, device)
    init = port["teacher"].init_teacher(
        tcfg, ck["config"]["train"]["seed"]).state_dict()
    trained = {k: t.detach().cpu() for k, t in model.named_parameters()}
    moved = {}
    for prefix in ("cxr", "duett", "perceiver"):
        keys = [k for k in trained if k.startswith(prefix + ".")
                and trained[k].dim() >= 2]
        moved[prefix] = {
            "weights": len(keys),
            "moved": sum(not torch.equal(trained[k], init[k]) for k in keys),
            "max_abs_change": max(float((trained[k] - init[k]).abs().max())
                                  for k in keys)}
    n = tcfg.vit.n_layers
    expect = {"flash_attention": n * (steps + evals),
              "flash_attention_bwd_dkv": n * steps,
              "flash_attention_bwd_dq": n * steps}
    info = {"phase": "unfreeze", "card": card, "argv": argv, "wall_s": wall,
            "train_steps": steps, "eval_steps": evals,
            "launches": launches, "expected_launches": expect,
            "train_s": ex["phase_seconds"]["train"],
            "train_step_ms": ex["phase_seconds"]["train"] / steps * 1e3,
            "epoch_losses": [h["train_total"] for h in res.history],
            "val_auroc": [h["val_main_auroc"] for h in res.history],
            "test_auroc": res.test_metrics["main_auroc"],
            "moved": moved, "reload_max_abs_diff": reload_diff,
            "reload_val_auroc": again["main_auroc"],
            "peak_memory_bytes": peak}
    emit(info)
    shutil.rmtree(RUNS, ignore_errors=True)
    if not all(np.isfinite(x) for x in info["epoch_losses"]):
        raise AssertionError(f"non-finite losses {info['epoch_losses']}")
    if launches != expect:
        raise AssertionError(f"K1 launches {launches} over {steps} train and "
                             f"{evals} eval steps, expected {expect}")
    if any(m["moved"] != m["weights"] for m in moved.values()):
        raise AssertionError(f"weights that did not train: {moved}")
    if reload_diff != 0.0 or again["main_auroc"] != res.best_metric:
        raise AssertionError("the reloaded best checkpoint evaluates the val "
                             "split differently from the loop")
    return info


def phase_unfreeze_step(port, device, cfg, reps: int = 5) -> dict:
    """The unfrozen pixel-tier train step at batch 32 on one fixed batch:
    the steady step time (CUDA events, median of ``reps`` after two warm-up
    steps), the peak memory and its estimate at the CLI's default batch of
    128 (the static part plus 4× the activations measured at 32), and a
    ``torch.profiler`` reading (device busy, idle share, time by kernel,
    K1's three kernels)."""
    import torch
    tl, eng = port["teacher_loop"], port["engine"]
    tcfg = port["config"].TrainConfig(batch_size=32)
    ucfg = cfg.replace(freeze_cxr=False)
    data, host, hook = _train_batch(port, device, ucfg)
    model = port["teacher"].init_teacher(ucfg, 0).to(device)
    state = port["state"].TrainState(model, port["optim"].MultiGroupAdamW(
        model, tcfg.optim, 100,
        frozen_prefixes=tl.teacher_frozen_prefixes(ucfg)))
    step = eng.make_teacher_step(tcfg, ucfg.duett, 24, np.ones(7, np.float32))
    batch = eng.to_device(hook(host), device)
    gen = torch.Generator(device=device).manual_seed(1)

    def run():
        return step(state, data.grid, data.static, batch, gen)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        losses = run()
    torch.cuda.synchronize()
    static_bytes = torch.cuda.memory_allocated()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(times)
    prof = _profile(run, 3, step_ms, {"k1_fwd": "flash_fwd_bf16",
                                      "k1_dkv": "flash_bwd_dkv_bf16",
                                      "k1_dq": "flash_bwd_dq_bf16"})
    n_params = sum(p.numel() for p in model.parameters())
    info = {"phase": "unfreeze_step", "batch": 32, "dtype": "bfloat16",
            "params": n_params, "trainable_params": sum(
                p.numel() for p in model.parameters() if p.requires_grad),
            "step_ms": step_ms, "step_ms_all": times,
            "samples_per_s": 32e3 / step_ms,
            "loss": float(losses["total"]),
            "peak_memory_bytes": peak, "static_bytes": static_bytes,
            "est_peak_bytes_at_batch_128": static_bytes
            + 4 * (peak - static_bytes),
            **{f"{kind}_device_ms_per_step":
               prof.get(f"k1_{kind}_device_ms_per_step", "not measured")
               for kind in ("dkv", "dq")},
            "profile": prof}
    emit(info)
    if not np.isfinite(info["loss"]):
        raise AssertionError(f"non-finite unfrozen-step loss {info['loss']}")
    del model, state, data
    torch.cuda.empty_cache()
    return info


def reset_counts(port) -> None:
    for name in ("attention", "gather", "dual_axis", "ln_qkv"):
        port[name].reset_launches()


def read_counts(port) -> dict:
    return {k: v for name in ("attention", "gather", "dual_axis", "ln_qkv")
            for k, v in port[name].LAUNCHES.items()}


def dual_axis_bound_ms(B, L, D, inner, ff, itemsize, peak_flops) -> tuple:
    """(bound_ms, bound_by) of one K3 call: the QKV, QKᵀ, PV, W_o and the two
    FF products against ``peak_flops``; x read and the output written once
    in x's dtype, the float32 parameters read once."""
    flops = 2.0 * B * L * (3 * D * inner + inner * D + 2 * D * ff) \
        + 4.0 * B * L * L * inner
    nbytes = 2.0 * itemsize * B * L * D \
        + 4.0 * (4 * D * inner + 2 * D * ff + 2 * D + ff + 3)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


def _dual_axis_params(D, inner, ff, device, seed) -> dict:
    """K3's parameters at DuETT's scales, float32 as the model keeps them:
    weights N(0, 1/fan_in), biases N(0, 0.02²), gains 1 + N(0, 0.1²)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)

    def r(*shape, std):
        return std * torch.randn(*shape, generator=g, device=device)
    return {**{k: 1.0 + r(1, std=0.1) for k in ("g1", "g2", "gf")},
            **{k: r(D, inner, std=D ** -0.5) for k in ("wq", "wk", "wv")},
            "wo": r(inner, D, std=inner ** -0.5), "bo": r(D, std=0.02),
            "w1": r(D, ff, std=D ** -0.5), "b1": r(ff, std=0.02),
            "w2": r(ff, D, std=ff ** -0.5), "b2": r(D, std=0.02)}


def phase_dual_axis(port, device, cases, n_heads: int = 2, d_head: int = 12,
                    ff: int = 512) -> dict:
    """K3 against ``encoder_block_reference`` at DuETT's two axes (2 heads ×
    12, FF 512): max abs error relative to the output's, two launches
    bit-equal; times the kernel (through its wrapper, weight casts
    included), the plain version and the bound (no single PyTorch call
    computes the block: ``library_ms`` null). Then one backward through the
    autograd Function against autograd of the plain version.
    cases: (label, B, L, D, dtype, tol)."""
    import torch
    DA = port["dual_axis"]
    inner = n_heads * d_head
    results = {}
    for label, B, L, D, dtype, tol in cases:
        params = _dual_axis_params(D, inner, ff, device, 30 + len(results))
        g = torch.Generator(device=device).manual_seed(40 + len(results))
        x = torch.randn(B, L, D, generator=g, device=device).to(dtype)

        def kernel():
            return DA.fused_encoder_block(x, params, n_heads, d_head)

        got, again = kernel(), kernel()
        want = DA.encoder_block_reference(x, params, n_heads, d_head)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = err / max(want.float().abs().max().item(), 1e-12)
        same = torch.equal(_bits(got), _bits(again))
        finite = bool(torch.isfinite(got).all())
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        bound, by = dual_axis_bound_ms(B, L, D, inner, ff, x.element_size(),
                                       peak)
        res = {"phase": "kernel_check", "kernel": "dual_axis_block",
               "case": label, "shape": [B, L, D], "heads": [n_heads, d_head],
               "ff": ff, "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err, "max_rel_err": rel, "tol": tol,
               "bit_equal_rerun": same,
               "smem_bytes": DA.smem_bytes(L, D, n_heads, d_head),
               "ms": device_ms(kernel, device),
               "plain_ms": device_ms(lambda: DA.encoder_block_reference(
                   x, params, n_heads, d_head), device),
               "library_ms": None, "bound_ms": bound, "bound_by": by}
        emit(res)
        if not (finite and rel <= tol and same):
            raise AssertionError(f"dual_axis_block {label}: {res}")
        results[label] = res

    # one backward through the autograd Function (the kernel forward, a
    # recompute of the plain version backward, as JAX's custom VJP)
    B, L, D = 4, 35, 600
    leaves = {k: v.requires_grad_() for k, v in
              _dual_axis_params(D, inner, ff, device, 50).items()}
    x = torch.randn(B, L, D, device=device, requires_grad=True)
    w = torch.randn(B, L, D, device=device)
    before = DA.LAUNCHES["dual_axis_block"]
    (DA.fused_encoder_block(x, leaves, n_heads, d_head) * w).sum().backward()
    launched = DA.LAUNCHES["dual_axis_block"] - before
    got = {"x": x.grad, **{k: v.grad for k, v in leaves.items()}}
    ref = [t.detach().requires_grad_() for t in (x, *leaves.values())]
    out = DA.encoder_block_reference(ref[0], dict(zip(leaves, ref[1:])),
                                     n_heads, d_head)
    want = dict(zip(got, torch.autograd.grad((out * w).sum(), ref)))
    rel = {k: float((got[k] - want[k]).abs().max()
                    / max(float(want[k].abs().max()), 1e-12)) for k in got}
    info = {"phase": "kernel_check", "kernel": "dual_axis_block",
            "case": "backward_f32", "shape": [B, L, D], "launches": launched,
            "max_rel_err": max(rel.values()), "tol": 1e-6}
    emit(info)
    if launched != 1 or not max(rel.values()) <= 1e-6:
        raise AssertionError(f"dual_axis_block backward: {info} {rel}")
    results["backward_f32"] = info
    return results


def ln_qkv_bound_ms(B, N, D, inner, itemsize, peak_flops) -> tuple:
    """(bound_ms, bound_by) of one K4 call: the three projections against
    ``peak_flops``; x read and q, k, v written once in x's dtype, the
    float32 LayerNorm rows, weights and biases read once."""
    flops = 2.0 * B * N * D * 3 * inner
    nbytes = itemsize * B * N * (D + 3.0 * inner) \
        + 4.0 * (3 * D * inner + 3 * inner + 2 * D)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


def phase_ln_qkv(port, device, cases) -> dict:
    """K4 against ``ln_qkv_reference``: each of q, k, v within ``tol`` of its
    max abs, two launches bit-equal; times the kernel (through its wrapper,
    weight casts included), the plain version, the bound and a library
    yardstick of several calls (``F.layer_norm``, one ``F.linear`` on the
    stacked [3·H·64, D] weight, the head-major copy; no single PyTorch call
    computes K4). cases: (label, B, N, D, H, dtype, tol)."""
    import torch
    import torch.nn.functional as F
    LQ = port["ln_qkv"]
    results = {}
    for label, B, N, D, H, dtype, tol in cases:
        inner = H * 64
        g = torch.Generator(device=device).manual_seed(60 + len(results))

        def r(*shape, std):
            return std * torch.randn(*shape, generator=g, device=device)
        params = {"ln_scale": 1.0 + r(D, std=0.1), "ln_bias": r(D, std=0.1),
                  **{k: r(D, inner, std=D ** -0.5) for k in ("wq", "wk",
                                                              "wv")},
                  **{k: r(inner, std=0.02) for k in ("bq", "bk", "bv")}}
        x = (2.0 * torch.randn(B, N, D, generator=g, device=device)
             + 0.5).to(dtype)

        def kernel():
            return LQ.fused_ln_qkv(x, params, H, 64)

        def library():
            dt = x.dtype
            w = torch.cat([params[k] for k in ("wq", "wk", "wv")], 1)
            b = torch.cat([params[k] for k in ("bq", "bk", "bv")])
            h = F.layer_norm(x, (D,), params["ln_scale"].to(dt),
                             params["ln_bias"].to(dt), 1e-6)
            y = F.linear(h, w.t().to(dt), b.to(dt))
            return y.view(B, N, 3, H, 64).permute(2, 0, 3, 1, 4).contiguous()

        got, again = kernel(), kernel()
        want = LQ.ln_qkv_reference(x, params, H, 64)
        torch.cuda.synchronize()
        err, rel = {}, {}
        for name, a, w_ in zip("qkv", got, want):
            err[name] = (a.float() - w_.float()).abs().max().item()
            rel[name] = err[name] / max(w_.float().abs().max().item(), 1e-12)
        same = all(torch.equal(_bits(a), _bits(b_))
                   for a, b_ in zip(got, again))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        shapes = all(tuple(a.shape) == (B, H, N, 64) for a in got)
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        bound, by = ln_qkv_bound_ms(B, N, D, inner, x.element_size(), peak)
        res = {"phase": "kernel_check", "kernel": "ln_qkv", "case": label,
               "shape": [B, N, D], "heads": [H, 64],
               "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": max(err.values()), "max_rel_err": rel,
               "tol": tol, "bit_equal_rerun": same,
               "ms": device_ms(kernel, device),
               "plain_ms": device_ms(lambda: LQ.ln_qkv_reference(
                   x, params, H, 64), device),
               "library_ms": device_ms(library, device),
               "library_calls": "F.layer_norm + F.linear (stacked weight) "
                                "+ head-major copy, weight casts included",
               "bound_ms": bound, "bound_by": by}
        emit(res)
        if not (finite and shapes and max(rel.values()) <= tol and same):
            raise AssertionError(f"ln_qkv {label}: {res}")
        results[label] = res
        del x, got, again, want
    torch.cuda.empty_cache()
    return results


def _ssl_data(port, argv, device) -> tuple:
    """The SSL CLI's DuETT config and sliding-window dataset (on
    ``device``) for ``argv``, built by the CLI's own helpers."""
    cli = port["train_ssl"]
    args = cli.build_parser().parse_args(argv)
    dcfg, duett, _ = cli.configs_from_args(args)
    duett = duett.replace(pretrain_masked_steps=args.pretrain_masked_steps)
    ds, meta, _ = cli.load_data(args, dcfg)
    duett = cli.sync_duett_with_meta(duett, meta)
    data = cli.build_sliding_ssl_dataset(ds, meta, dcfg.n_timesteps,
                                         args.stride, args.max_stay_hours)
    return duett, data.to(device)


def phase_ssl(port, device, card: str = "", reps: int = 5) -> dict:
    """DuETT SSL pretraining through the CLI (``cli/train_ssl.main``) at the
    full default width, on the train phase's 240 synthetic stays, batch 128,
    2 epochs; every kernel's launches counted over exactly this run; finite
    per-epoch losses, the train loss falling, ``meta_with_stats.pkl`` beside
    the best checkpoint, which reloads and evaluates the val split as the
    loop did. Then the steady SSL step at batch 128 on one fixed batch:
    CUDA events (median of ``reps`` after two warm-up steps), peak memory
    and a ``torch.profiler`` reading."""
    import torch
    shutil.rmtree(SSL_RUNS, ignore_errors=True)
    # stride 4 (the CLI's is 12) gives 8 batches of 128 an epoch from the
    # 240 stays, and warmup 8 (the CLI's is 2000) a learning rate that
    # moves the weights within 2 epochs; the widths are the CLI's defaults
    argv = ["--device", "cuda", "--synthetic_stays", "240", "--batch_size",
            "128", "--epochs", "2", "--stride", "4", "--limit_batches", "8",
            "--ssl_warmup", "8", "--ckpt_dir", SSL_RUNS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(port)
    t0 = time.perf_counter()
    res = port["train_ssl"].main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(port)
    peak = torch.cuda.max_memory_allocated()
    run_dir = os.path.dirname(res.best_path)
    meta_ok = os.path.exists(os.path.join(run_dir, "meta_with_stats.pkl"))

    duett_cfg, data = _ssl_data(port, argv, device)
    ck = port["checkpoint"].load_checkpoint(res.best_path)
    cfg = port["config"].DuettConfig.from_dict(ck["config"]["duett"])
    model = port["convert"].load_flax(port["duett"].DuettPretrainModel(cfg),
                                      ck["params"], ck["batch_stats"])
    reload_val = res.extras["evaluate"](model.to(device))
    reload_rel = abs(reload_val - res.best_metric) / abs(res.best_metric)

    # the steady step
    opt = port["optim"]
    fresh = port["duett"].init_pretrain_model(duett_cfg, 0).to(device)
    state = port["state"].TrainState(fresh, opt.MultiGroupAdamW.one_group(
        fresh, opt.invsqrt_warmup(3e-4, 8), 0.1, 1.0))
    eng = port["engine"]
    step = eng.make_ssl_step(duett_cfg, data.n_timesteps, torch.bfloat16)
    batch = eng.to_device(next(data.iter_batches("train", 128, shuffle=True,
                                                 seed=0)), device)
    gen = torch.Generator(device=device).manual_seed(1)

    def run():
        return step(state, data.grid, data.static, batch, gen)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        parts = run()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    step_ms = statistics.median(times)
    step_peak = torch.cuda.max_memory_allocated()
    ex = res.extras
    info = {"phase": "ssl", "card": card, "argv": argv, "wall_s": wall,
            "duett": {k: getattr(duett_cfg, k) for k in (
                "n_variables", "n_timesteps", "d_embedding", "n_layers",
                "n_heads", "d_feedforward", "et_dim", "tt_dim")},
            "params": sum(p.numel() for p in fresh.parameters()),
            "windows": {k: len(v) for k, v in data.samples.items()},
            "launches": launches, "train_steps": ex["n_train_steps"],
            "loop_seconds": ex["train_seconds"],
            "loop_samples_per_s_incl_val_and_ckpt":
                ex["n_train_steps"] * 128 / ex["train_seconds"],
            "history": res.history, "best_val_loss": res.best_metric,
            "meta_with_stats": meta_ok, "reload_val_loss": reload_val,
            "reload_rel_diff": reload_rel, "peak_memory_bytes": peak,
            "step_ms": step_ms, "step_ms_all": times,
            "step_samples_per_s": 128e3 / step_ms,
            "step_loss": float(parts["total"]),
            "step_peak_memory_bytes": step_peak,
            "step_profile": _profile(run, 3, step_ms, {})}
    emit(info)
    losses = [h[k] for h in res.history for k in ("train_loss", "val_loss")]
    if len(res.history) != 2 or not all(np.isfinite(x) for x in losses):
        raise AssertionError(f"SSL history {res.history}")
    if not res.history[1]["train_loss"] < res.history[0]["train_loss"]:
        raise AssertionError(f"the SSL train loss did not fall: "
                             f"{res.history}")
    if not meta_ok:
        raise AssertionError("no meta_with_stats.pkl beside the checkpoints")
    if not reload_rel <= 1e-4:
        raise AssertionError(f"the reloaded SSL checkpoint evaluates to "
                             f"{reload_val}, the loop's best "
                             f"{res.best_metric}")
    if not np.isfinite(info["step_loss"]):
        raise AssertionError(f"non-finite SSL step loss {info['step_loss']}")
    del fresh, state, model
    torch.cuda.empty_cache()
    return {**info, "best_path": res.best_path, "data": data,
            "duett_cfg": cfg}


def phase_trained_layer(port, device, ssl) -> dict:
    """K3 on the SSL run's best checkpoint: each DuETT axis's first layer
    (``event_transformer_0``, ``time_transformer_0``) gets its input
    captured by a forward hook during a bf16 eval step, and K3, fed that
    input with the layer's weights through ``params_from_encoder``, gives
    the layer's own output within TOL_TRAINED_LAYER of its max abs."""
    import torch
    DA, eng = port["dual_axis"], port["engine"]
    cfg, data = ssl["duett_cfg"], ssl["data"]
    ck = port["checkpoint"].load_checkpoint(ssl["best_path"])
    model = port["convert"].load_flax(port["duett"].DuettPretrainModel(cfg),
                                      ck["params"],
                                      ck["batch_stats"]).to(device)
    seen, hooks = {}, []

    def capture(axis):
        def hook(module, args, out):
            seen[axis] = (args[0], out)
        return hook

    for axis in ("event", "time"):
        enc = getattr(model.encoder, f"{axis}_transformer_0")
        hooks.append(enc.register_forward_hook(capture(axis)))
    n_val = min(128, data.split_size("val"))
    batch = eng.to_device(next(data.iter_batches("val", n_val,
                                                 shuffle=False)), device)
    eng.make_ssl_eval(cfg, data.n_timesteps, torch.bfloat16)(
        model, data.grid, data.static, batch,
        torch.Generator(device=device).manual_seed(1000))
    for h in hooks:
        h.remove()
    reset_counts(port)
    out = {}
    with torch.inference_mode():
        for axis, (x, y) in seen.items():
            enc = getattr(model.encoder, f"{axis}_transformer_0")
            got = DA.fused_encoder_block(x, DA.params_from_encoder(enc),
                                         cfg.n_heads,
                                         cfg.d_embedding // cfg.n_heads)
            torch.cuda.synchronize()
            err = (got.float() - y.float()).abs().max().item()
            out[axis] = {"shape": list(x.shape),
                         "dtype": str(x.dtype).replace("torch.", ""),
                         "max_abs_err": err,
                         "max_rel_err": err / y.float().abs().max().item()}
    launches = read_counts(port)["dual_axis_block"]
    info = {"phase": "trained_layer", "checkpoint": ssl["best_path"],
            "axes": out, "launches": launches, "tol": TOL_TRAINED_LAYER}
    emit(info)
    if launches != 2 or len(out) != 2 or \
            not max(a["max_rel_err"] for a in out.values()) \
            <= TOL_TRAINED_LAYER:
        raise AssertionError(f"K3 against a trained DuETT layer: {info}")
    return info


def phase_ssl_to_teacher(port, device, best_path: str, card: str = "") -> dict:
    """The teacher CLI started from the SSL checkpoint (``--duett_ckpt``) on
    the encode-once tier, 1 epoch of 4 batches of 32: before its first step
    the teacher's DuETT weights and BatchNorm statistics equal the SSL
    encoder's; finite losses; every kernel's launches counted over exactly
    this run."""
    import torch
    tt, conv = port["train_teacher"], port["convert"]
    ck = port["checkpoint"].load_checkpoint(best_path)
    want = conv.flax_to_state_dict(ck["params"]["encoder"],
                                   ck["batch_stats"]["encoder"])
    seen = {}
    train = tt.train_teacher

    def spy(*args, model=None, **kw):
        seen.update({k: v.detach().cpu().clone()
                     for k, v in model.duett.state_dict().items()})
        return train(*args, model=model, **kw)

    shutil.rmtree(RUNS, ignore_errors=True)
    argv = ["--device", "cuda", "--duett_ckpt", best_path,
            "--cxr_feature_cache", "hbm", "--synthetic_stays", "240",
            "--batch_size", "32", "--epochs", "1", "--limit_batches", "4",
            "--ckpt_dir", RUNS]
    torch.cuda.synchronize()
    reset_counts(port)
    t0 = time.perf_counter()
    tt.train_teacher = spy
    try:
        res = tt.main(argv)
    finally:
        tt.train_teacher = train
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(port)
    same = seen.keys() == want.keys() and all(
        torch.equal(seen[k], want[k].to(seen[k].dtype)) for k in want)
    info = {"phase": "ssl_to_teacher", "card": card, "argv": argv,
            "wall_s": wall, "launches": launches,
            "duett_tensors": len(want), "duett_equals_ssl_encoder": same,
            "epoch_losses": [h["train_total"] for h in res.history],
            "val_auroc": [h["val_main_auroc"] for h in res.history]}
    emit(info)
    shutil.rmtree(RUNS, ignore_errors=True)
    if not same:
        raise AssertionError("the teacher's DuETT did not start from the SSL "
                             "encoder")
    if not all(np.isfinite(x) for x in info["epoch_losses"]):
        raise AssertionError(f"non-finite losses {info['epoch_losses']}")
    if launches["flash_attention"] == 0 or launches["gather_rows"] == 0:
        raise AssertionError(f"the teacher run did not launch K1 and K2: "
                             f"{launches}")
    return info


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
    built = phase_bwd_build(port)
    bf16, f32 = torch.bfloat16, torch.float32
    checks = phase_kernels(port, device, [
        ("vit_bf16", 8, 12, 1370, None, bf16, TOL_BF16, True),
        ("bank_build_bf16", 16, 12, 1370, None, bf16, TOL_BF16, True),
        ("pixel_step_bf16", 32, 12, 1370, None, bf16, TOL_BF16, True),
        ("ragged_bf16", 2, 12, 1000, 900, bf16, TOL_BF16, False),
        ("f32", 2, 12, 1370, 1301, f32, TOL_F32, True),
    ])
    bwd = phase_backward(port, device, [
        ("pixel_step_bf16", 32, 12, 1370, None, bf16, TOL_BWD_BF16, True),
        ("ragged_bf16", 2, 12, 1001, 900, bf16, TOL_BWD_BF16, False),
        ("f32", 2, 12, 1370, 1301, f32, TOL_BWD_F32, False),
    ])
    k3 = phase_dual_axis(port, device, [
        ("event_bf16", 32, 35, 600, bf16, TOL_FUSED_BF16),
        ("time_bf16", 32, 25, 840, bf16, TOL_FUSED_BF16),
        ("event_f32", 32, 35, 600, f32, TOL_FUSED_F32),
        ("time_f32", 32, 25, 840, f32, TOL_FUSED_F32),
    ])
    k4 = phase_ln_qkv(port, device, [
        ("vit_bf16", 32, 1536, 768, 12, bf16, TOL_FUSED_BF16),
        ("f32", 2, 512, 256, 4, f32, TOL_FUSED_F32),
    ])
    k3_checks, k4_checks = read_counts(port)["dual_axis_block"], \
        read_counts(port)["ln_qkv"]
    phase_golden(port, device, cfgmod.ViTConfig(), GOLDEN)
    phase_block_grad(port, device)
    serve = phase_serve(port, device, cfgmod.TeacherConfig(), n_clients=12,
                        posts_per_client=4, card=dev["nvidia_smi"])

    gathers = phase_gather(port, device)
    train = phase_train(port, device, card=dev["nvidia_smi"])
    phase_tiers(port, device, cfgmod.TeacherConfig(),
                gathers["patch_bf16"]["ms"] + gathers["cls_bf16"]["ms"])
    unfreeze = phase_unfreeze(port, device, card=dev["nvidia_smi"])
    phase_unfreeze_step(port, device, cfgmod.TeacherConfig())
    ssl = phase_ssl(port, device, card=dev["nvidia_smi"])
    trained = phase_trained_layer(port, device, ssl)
    to_teacher = phase_ssl_to_teacher(port, device, ssl["best_path"],
                                      card=dev["nvidia_smi"])

    # K1's three rows take their launches from the unfrozen training run,
    # whose K1 work is the pixel step's batch of 32, and K2's from the
    # encode-once training run. This slice's main path, SSL pretraining,
    # runs none of the six kernels (K3 and K4 have no caller in either
    # package): its counts, and the teacher's start from its checkpoint,
    # stand under launches_by_path; K3's and K4's launches under their
    # checks stand under check_launches.
    k1, k2 = checks["pixel_step_bf16"], gathers["patch_bf16"]
    b = bwd["pixel_step_bf16"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    n_k1 = unfreeze["launches"]
    n_ssl, n_s2t = ssl["launches"], to_teacher["launches"]
    case = "pixel_step_bf16 [32, 12, 1370, 64]"

    def by_path(name, **earlier):
        return {**earlier, "ssl": n_ssl[name], "ssl_to_teacher": n_s2t[name]}

    bwd_rows = [
        {"name": f"flash_attention_bwd_{kind}", "route": "cuda",
         "source": K1_BWD_SOURCE, "replaces": replaces,
         "launches": n_k1[f"flash_attention_bwd_{kind}"],
         "launches_by_path": by_path(
             f"flash_attention_bwd_{kind}",
             unfreeze=n_k1[f"flash_attention_bwd_{kind}"]),
         "case": case,
         "max_abs_err": max(b["max_abs_err"][g] for g in grads),
         "ms": b[f"{kind}_ms"], "plain_ms": b["plain_ms"],
         "bound_ms": b[f"{kind}_bound_ms"], "bound_by": b[f"{kind}_bound_by"],
         "library_ms": b["library_ms"], "pair_ms": b["pair_ms"],
         "pair_vs_library": b["pair_vs_library"], "delta_ms": b["delta_ms"],
         "backward_ms": b["backward_ms"],
         "backward_vs_library": b["backward_vs_library"], **built[kind]}
        for kind, replaces, grads in (("dkv", K1_DKV_REPLACES, ("dk", "dv")),
                                      ("dq", K1_DQ_REPLACES, ("dq",)))]
    emit({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES,
         "launches": n_k1["flash_attention"],
         "launches_by_path": by_path(
             "flash_attention", serve=serve["k1_launches"],
             train=train["k1_launches_in_bank_build"],
             unfreeze=n_k1["flash_attention"]),
         "case": case, "ms_with_lse": b["fwd_lse_ms"],
         **{k: k1[k] for k in keys}},
        *bwd_rows,
        {"name": "gather_rows", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": train["k2_launches"],
         "case": "patch_bf16 [401, 1370, 768] x 32 rows",
         "launches_by_path": by_path("gather_rows",
                                     train=train["k2_launches"]),
         **{k: k2[k] for k in keys}},
        {"name": "dual_axis_block", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": n_ssl["dual_axis_block"],
         "launches_by_path": by_path("dual_axis_block"),
         "check_launches": {"kernel_check": k3_checks,
                            "trained_layer": trained["launches"]},
         "case": "time_bf16 [32, 25, 840]",
         "ms_by_case": {c: k3[c]["ms"] for c in k3 if "ms" in k3[c]},
         **{k: k3["time_bf16"][k] for k in keys}},
        {"name": "ln_qkv", "route": "cuda", "source": K4_SOURCE,
         "replaces": K4_REPLACES, "launches": n_ssl["ln_qkv"],
         "launches_by_path": by_path("ln_qkv"),
         "check_launches": {"kernel_check": k4_checks},
         "case": "vit_bf16 [32, 1536, 768] 12 x 64",
         "library_calls": k4["vit_bf16"]["library_calls"],
         **{k: k4["vit_bf16"][k] for k in keys}}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
