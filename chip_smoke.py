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

2b. build_facts  the bf16 dkv and dq kernels as built: registers, spills and
            shared memory (``ptxas -v``) and their HGMMA count (``cuobjdump``
            SASS); fails on a spill or on a kernel without HGMMA.
3b. backward  also the pair (dkv + dq) and the autograd Function's whole
            backward (dO made ready, D, dkv, dq) against SDPA's backward in
            the same run (``pair_ms``, ``pair_vs_library``, ``delta_ms``,
            ``backward_ms``, ``backward_vs_library``); 10. unfreeze_step
            also dkv's and dq's device ms per step at the top level.

K1's forward redesigned for Hopper (warpgroup MMA, TMA) and the backward's
D in a one-pass kernel add:

2b. build_facts  also the bf16 forward (``flash_fwd_bf16``): registers,
            spills, shared memory, HGMMA count, and each kernel's ``ptxas``
            warnings (C7511 / C7515: wgmma serialised); fails on a spill or
            on a kernel without HGMMA.
3.  kernels  the timed bf16 cases also time the forward against SDPA's
            within one call, their repetitions alternating
            (``fwd_vs_library``).
3b. backward  D (``flash_attention_bwd_delta``) against ``delta_reference``
            in every case (1e-6 of its max abs, reruns bit-equal); its time,
            plain time and bound (``delta_ms``, ``delta_plain_ms``,
            ``delta_bound_ms``); the Function's whole backward and SDPA's
            timed in alternation (``backward_vs_library``). 9. unfreeze
            counts D's launches (12 per train step), 10. unfreeze_step its
            device time and the forward's.

K4's bf16 kernel redesigned on wgmma and TMA, and K2 on TMA bulk copies,
add:

2b. build_facts  also K4's bf16 kernel (registers at entry and, from the
            SASS, the counts setmaxnreg asks for; spills, shared memory,
            HGMMA, ptxas codes); fails on a spill, on a kernel without
            HGMMA or on a serialised wgmma (C7511, C7514, C7515), K1's
            kernels included.
3d. ln_qkv  also a ragged case ([2, 200, 96], 3 × 64, bf16); the kernel
            and the library's calls timed in alternation (``vs_library``,
            ``share_of_bound``).
6.  kernels  K2's route in each case (``bulk`` for the three main-path
            banks, asserted; ``vector`` for a bank of 8,220-byte rows), the
            kernel and ``index_select`` timed in alternation
            (``vs_library``, host dispatch included) and each one's device
            time under ``torch.profiler`` (``device_vs_library``), the
            rate (``gb_per_s``, from the device time) and its share of
            3.35 TB/s. 7. train fails if a gather of the path took the
            vector route.

K3's bf16 route redesigned for Hopper (mma.sync, a grid split by FF
hidden units) adds:

2b. build_facts  also K3's tensor-core kernel (``dual_axis_block_tc``):
            registers, spills, shared memory (against
            ``dual_axis.tc_smem_bytes``), its mma.sync count (HMMA) and
            ``ptxas`` codes; fails on a spill or on a kernel without HMMA.
3c. dual_axis  the route of each case, asserted (``tc`` for DuETT's bf16
            axes, ``simt`` for float32), a bf16 case of each axis at batch
            128 (the SSL CLI's batch); the wrapper and the plain version
            timed in alternation (``ms``, ``plain_ms``), and each one's
            device time under ``torch.profiler`` (``device_ms``: the
            kernel alone; ``device_busy_ms``: the wrapper's casts too;
            ``plain_device_ms``). 12. trained_layer fails unless both
            axes took the tensor-core route.

The float32 routes of K1's forward and K4 redesigned on 3xTF32
tensor-core products (mma.sync m16n8k8, ``csrc/mma_tf32.cuh``) add:

2b. build_facts  also ``flash_fwd_f32`` and ``ln_qkv_f32_kernel``:
            registers, spills, shared memory and their HMMA count of the
            TF32 form; fails on a spill or on a kernel without it.
3.  kernels  timed float32 cases at the bank build's [16, 12, 1370, 64]
            (the float32 training path's shape) and the pixel step's
            [32, 12, 1370, 64] (each against SDPA's float32 forward in
            alternation), and every case's rerun bit-equal.
3b. backward  the float32 backward timed at [32, 12, 1370, 64] (dkv, dq,
            D, the pair and the whole backward against SDPA's float32
            backward); the ragged float32 case kept as a check.
3d. ln_qkv  a timed float32 case at [32, 1536, 768], 12 × 64.
7b. f32_train  the training CLI with ``--mixed_precision no`` on the
            encode-once tier (240 stays, 1 epoch of 4 batches of 32): the
            float32 forward's and K2's launches over exactly this run,
            finite losses. The wrappers count each float32 kernel under
            its own key (``flash_attention_f32``, ``ln_qkv_f32``, ...);
            the golden ViT and the block's gradient must launch the
            float32 kernels and no bf16 one.
K1's float32 backward (D, dkv, dq) redesigned on 3xTF32 tensor-core
products adds:

2b. build_facts  also the float32 dkv and dq (``flash_bwd_dkv_f32``,
            ``flash_bwd_dq_f32``): registers, spills, shared memory and
            their HMMA count of the TF32 form; fails on a spill or on a
            kernel without it.
9b. f32_unfreeze  the training CLI with ``--unfreeze_cxr --mixed_precision
            no`` on the pixel tier (240 stays, 1 epoch of 4 batches of 32):
            K1's float32 launches counted over exactly this run (forward,
            D, dkv and dq 12 each per train step, the forward 12 per eval
            step, no bf16 K1 launch); finite losses; the ViT's, DuETT's and
            the perceiver's weights moved; the reloaded best checkpoint
            evaluates the val split bit-equal; peak memory. The float32 D,
            dkv and dq rows of the summary take their launches from it.
3b. backward  D (both dtypes) and the fastest of two single PyTorch calls
            that compute it (``torch.linalg.vecdot(o, do)``, an einsum),
            timed in alternation (``delta_library_ms``,
            ``delta_vs_library``; the calls give D in O's dtype, so in bf16
            they write half the bytes).
10b. f32_unfreeze_step  the unfrozen step of 10 in float32: steady time,
            peak memory, device busy time, idle share, and the device time
            by kernel family (``by_family``: K1, GEMMs, the rest).

K3's float32 route redesigned on 3xTF32 tensor-core products (mma.sync
m16n8k8 on the bf16 route's grid of batch elements × FF slices,
``csrc/dual_axis_block_tf32.cu``) adds:

2b. build_facts  also ``dual_axis_block_tf32_kernel``'s instances for 3
            and 2 m16 row tiles (the event and the time axis): registers,
            spills, shared memory (against ``dual_axis.tf32_smem_bytes`` at
            each axis), HMMA of the TF32 form; fails on a spill or on an
            instance without it.
3c. dual_axis  the float32 cases at [32, 35, 600], [32, 25, 840],
            [128, 35, 600] and [128, 25, 840] on the ``tf32`` route
            (asserted), within TOL_FUSED_F32, reruns bit-equal; one
            ``simt`` case per dtype at [8, 35, 602] (D % 4 != 0: neither
            tensor-core route takes it); one case per dtype at [8, 35, 96]
            with 4 heads × 12 on its tensor-core route, whose q|k|v (144
            columns) span two of the W ring's 128-column chunks.
12. trained_layer  also a float32 case: the layers' inputs captured in a
            float32 eval step (TF32 off), K3 on the ``tf32`` route against
            each layer's output (TOL_TRAINED_LAYER_F32: the layer takes
            GELU's erf form in float32) and against the plain version on
            the same input (TOL_FUSED_F32).

Student distillation and the host feature store (ROADMAP P11, P8) add:

13. ssl_to_teacher  also keeps its teacher checkpoint for the next phase.
14. kd      the student CLI (``cli/train_student.main``) at full width from
            that teacher and the SSL checkpoint (240 stays, batch 32, 1
            epoch of 4 batches, bf16) on each image tier: ``none``,
            ``hbm``, ``host`` in RAM, ``host`` on disk twice (the second
            run reopens the store); every kernel's launches over exactly
            each run (K1's forward 12 a pixel step, only the bank build's
            on the cached tiers, none on reopening; K2 on the bulk route 2
            an ``hbm`` step, none on ``host``); finite losses; ``host``
            bit-equal to ``hbm`` step by step; each reloaded best
            checkpoint evaluates the val split as its loop did. Then one
            float32 KD step per tier on one batch (``none`` against ``hbm``
            within TIER_TOL, ``host`` bit-equal, a wrong-row control), the
            steady bf16 step of each tier (``step_ms``, the host feed
            ``feed_ms``, peak memory, ``torch.profiler`` on ``none`` and
            ``hbm``), and one float32 KD step at batch 2 on the card against
            a CPU copy (KD_F32_TOL). Every kernel row of the summary has
            the ``kd`` runs' launches under ``launches_by_path``.

Teacher resume and preemption (ROADMAP P16) and the reference's ``dual``
chain (the CXR linear head on the catalog, the ``dual`` teacher, KD and
serving; ROADMAP P13) add:

3.  kernels  a float32 case at [64, 12, 1370, 64], the CXR head's catalog
            sweep (timed against SDPA's float32 forward).
15. cxr_head  ``cli/train_cxr_head.main`` at full width over the synthetic
            catalog of 240 stays: the CLS token of every image in chunks of
            64 in float32 (K1's float32 forward 12 a chunk, counted over
            exactly this run), 50 full-batch epochs of the head;
            ``feature_extract_s``, images/s, the best val macro AUROC.
16. dual_teacher  ``cli/train_teacher.main --perceiver_type dual
            --pretrained_cxr_head_ckpt`` (240 stays, batch 32, 2 epochs) on
            the ``hbm`` tier (K2 once a train and eval step, the CLS bank
            alone) and the pixel tier (4 batches an epoch, K1 12 a step);
            launches over exactly each run, the frozen head bit-equal, the
            reloaded checkpoint; the steady step of each tier (CUDA events,
            one step's launches, peak memory, ``torch.profiler``).
17. dual_kd  the student from that teacher (1 epoch of 4 batches) on
            ``hbm`` (K2 once a step) and ``host``; ``host`` equal to ``hbm``
            bit for bit.
18. dual_serve  that teacher served over HTTP (4 clients x 3 POSTs), every
            response against a direct eval of its batch (SERVE_TOL).
19. resume  the ``dual_patch`` teacher on ``hbm`` (3 epochs of 4 batches):
            an uninterrupted run, a control run, a run paused after one
            epoch and resumed with ``--resume_dir``, and the CLI as a
            subprocess sent SIGTERM after its first step (exit 0, the state
            saved at the boundary), resumed; resumed histories within
            RESUME_SPREAD_FACTOR x the control's difference; the saves'
            seconds and the state file's bytes.

The teacher's other modes and LP mode (ROADMAP P13's second half) add:

20. modes  ``cli/train_teacher.main`` at full width (240 stays, batch 32,
            2 epochs, bf16, ``--no_save_state``): ``single`` and
            ``dual_patch_event`` on ``hbm`` and on pixels (4 batches an
            epoch), ``legacy`` on pixels (``--use_aux_cxr --aux_cxr_alpha
            0.5``) and LP (``--lp_only_correction``) from the
            ``dual_patch_event`` ``hbm`` run's best on ``hbm``; each run's
            launches exactly as its steps make them (K1 12 a pixel train and
            eval step, 12 a bank chunk of 16; K2 2 a ``hbm`` train and eval
            step), finite losses, the reloaded best checkpoint; LP's frozen
            leaves and BatchNorm statistics bit-equal to its start, β
            moved. Then each mode and tier's steady step (CUDA events,
            launches, peak memory, ``torch.profiler``), one ``single``
            pixel step with the ViT trainable (K1's forward, D, dkv and dq
            12 each), the ``dual_patch_event`` teacher served over HTTP
            (``event_serve``), ``cli/serve`` refusing a ``single``
            checkpoint, and two KD steps from the ``single`` teacher on
            ``hbm``. Every kernel row of the summary has these paths under
            ``launches_by_path``.

Then the run's total seconds on a line of their own.

Each float32 row of the summary carries ``tc_bound_ms`` beside
``bound_ms``: the same work as three TF32 products per product at 495
TFLOP/s, or the bytes, whichever is larger (``bound_ms`` stays float32
FMA at 67 TFLOP/s, so a 3xTF32 kernel can go under it), and the share of
each (``tc_share_of_bound``, ``share_of_bound``).

Then the kernel summary line (the forward, dkv, dq, K4 and K3's
tensor-core rows with the build facts; the D row; the pair and the whole
backward; K2 with its routes; K3's bf16 tensor-core and SIMT routes, each
a row; then the float32 rows: K1's forward, D, dkv and dq, K2, K3's
float32 tensor-core route and K4) and, last,
``{"ok": true, "device": ...}``. Imports nothing of JAX or the JAX
package.
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
K1_REPLACES = ("multimodal_edema_prediction_tpu/ops/attention.py:64 "
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
K1_DELTA_REPLACES = ("jax/experimental/pallas/ops/tpu/flash_attention.py:"
                     "273-275 (di = sum(o * do, -1) in the backward of "
                     "flash_attention, outside Pallas: no pallas_call)")
K3_SOURCE = f"{PKG}/csrc/dual_axis_block.cu"
K3_TC_SOURCE = f"{PKG}/csrc/dual_axis_block_tc.cu"
K3_TF32_SOURCE = f"{PKG}/csrc/dual_axis_block_tf32.cu"
K3_REPLACES = ("multimodal_edema_prediction_tpu/ops/pallas_dual_axis.py:192 "
               "fused_encoder_block (pallas_call :171, _fused_forward :136, "
               ":78 _block_kernel)")
K4_SOURCE = f"{PKG}/csrc/ln_qkv.cu"
K4_REPLACES = ("multimodal_edema_prediction_tpu/ops/pallas_ln_qkv.py:126 "
               "fused_ln_qkv (pallas_call :108, _forward :82, :58 _kernel)")
RUNS = os.path.join(REPO, "build", "chip_smoke_runs")
SSL_RUNS = os.path.join(REPO, "build", "chip_smoke_ssl")
KD_RUNS = os.path.join(REPO, "build", "chip_smoke_kd")
DUAL_RUNS = os.path.join(REPO, "build", "chip_smoke_dual")
RESUME_RUNS = os.path.join(REPO, "build", "chip_smoke_resume")
MODES_RUNS = os.path.join(REPO, "build", "chip_smoke_modes")
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12     # H100 SXM dense TF32 (NVIDIA data sheet)
# float32-accurate work on the tensor cores: three TF32 products (3xTF32)
# for each float32 product; the rate behind every float32 row's
# tc_bound_ms, beside its bound_ms at PEAK_F32_FLOPS
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
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
# float32 kernels (3xTF32 tensor-core products, float32 accuracy; TF32 off
# on the plain side): the same arithmetic in another order, P from
# exp(S·scale − lse) against the plain softmax
TOL_BWD_F32 = 1e-4
# the forward's log-sum-exp against torch.logsumexp of the same scores,
# absolute: both accumulate in float32, on values ≲ 10
TOL_LSE = 1e-4
# the backward's D against delta_reference, relative to its max abs: the
# same 64 products per row (exact for bf16 inputs; float32 as 3xTF32, the
# products of the float32 kernels' dP) summed in another order
TOL_DELTA = 1e-6
# K3 and K4 against their plain versions, relative to each output's max
# abs. Both sides take the same inputs and weights (cast to x's dtype) and
# compute in float32, in other summation orders; at bf16 the output (and
# K4's h) is rounded to bf16, 2^-8 relative.
TOL_FUSED_BF16 = 2e-2
TOL_FUSED_F32 = 1e-4
# K3 fed a trained DuETT layer's own input at bf16, against that layer's
# output: the layer rounds every product to bf16 (both take GELU's tanh form)
TOL_TRAINED_LAYER = 2e-2
# the same at float32 (TF32 off): there the layer takes GELU's erf form
# (models/layers.py::gelu_exact, as the JAX package does) and K3 the tanh
# form of the TPU kernel; the two forms move a DuETT layer's output by
# ~1e-4 of its max abs (the phase reports it), so the kernel is held to
# 1e-3 here and to TOL_FUSED_F32 against its own plain version on the
# same input
TOL_TRAINED_LAYER_F32 = 1e-3
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
# one float32 KD step (TF32 off) on the card against a CPU copy of the same
# teacher and student at batch 2: the teacher's ViT through K1's float32
# forward (3xTF32) and cuBLAS against the plain versions, the same float32
# math in other orders; losses relative to their magnitude, each student
# gradient relative to its max abs floored at BLOCK_FLOOR of the largest
# (a float32 sum keeps ~1e-7 of its terms' scale, which a leaf far below
# the largest gradient reads as a larger share of itself)
KD_F32_TOL = 1e-4
# a resumed teacher run against an uninterrupted one, on the card: each
# history (per-epoch mean losses and val AUROC) within this many times the
# difference between two uninterrupted runs of the same tree (the control),
# and equal when those two are equal. The card's float32 sums may run in
# another order from run to run (e.g. the DuETT count embedding's index
# backward), and that noise, amplified by 12 steps, is all a correct resume
# leaves; a resume that lost the optimizer state or the step generator
# moves every epoch's loss by orders of magnitude more.
RESUME_SPREAD_FACTOR = 4.0


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
    from multimodal_edema_prediction_tpu_torch.cli import (train_cxr_head,
                                                           train_ssl,
                                                           train_student,
                                                           train_teacher)
    from multimodal_edema_prediction_tpu_torch.data import (features, ingest,
                                                            pipeline, sliding,
                                                            synthetic)
    from multimodal_edema_prediction_tpu_torch.models import (duett, student,
                                                              teacher, vit)
    from multimodal_edema_prediction_tpu_torch.ops import (attention, build,
                                                           dual_axis, gather,
                                                           ln_qkv)
    from multimodal_edema_prediction_tpu_torch.serve import predictor, server
    from multimodal_edema_prediction_tpu_torch.train import (checkpoint,
                                                             cxr_head_loop,
                                                             engine, kd_loop,
                                                             optim, ssl_loop,
                                                             state,
                                                             teacher_loop)
    from multimodal_edema_prediction_tpu_torch.utils import preemption
    return dict(config=config, convert=convert, teacher=teacher, vit=vit,
                duett=duett, attention=attention, build=build, gather=gather,
                dual_axis=dual_axis, ln_qkv=ln_qkv, predictor=predictor,
                server=server, engine=engine, checkpoint=checkpoint,
                optim=optim, state=state, teacher_loop=teacher_loop,
                ssl_loop=ssl_loop, features=features, pipeline=pipeline,
                sliding=sliding, synthetic=synthetic, ingest=ingest,
                cli_serve=cli_serve, train_teacher=train_teacher,
                train_ssl=train_ssl, student=student, kd_loop=kd_loop,
                train_student=train_student, train_cxr_head=train_cxr_head,
                cxr_head_loop=cxr_head_loop, preemption=preemption)


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


def paired_ms(fns, device, reps: int = 7, inner: int = 5) -> list:
    """The median time of each of ``fns`` (as ``device_ms``), taken within
    one call: each repetition times every function once, in alternating
    order (a b, b a, ...), so that a drift of the card's clocks or of the
    host's pace falls on both sides of a comparison."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for r in range(reps):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fns[i]()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end) / inner)
    return [statistics.median(t) for t in times]


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


def phase_build_facts(port) -> dict:
    """The tensor-core kernels as built: K1's bf16 forward, dkv and dq and
    K4's bf16 kernel (warpgroup MMA), K3's bf16 tensor-core route (mma.sync,
    at DuETT's event axis [35, 600]) and the float32 routes of K1's
    forward, dkv and dq, K3 (its instances for the event axis's 3 and the
    time axis's 2 m16 row tiles) and K4 (3xTF32 mma.sync): registers at
    entry (``ptxas -v``) and the
    counts its warps ask for after launch (``setmaxnreg`` in the SASS:
    ``TRY_ALLOC`` the consumers', ``DEALLOC`` the producer's), spills
    (bytes stored plus loaded), static plus the dynamic shared memory a
    launch asks for, its ``ptxas`` codes (C7511 / C7514 / C7515: wgmma
    serialised) and its matrix instructions in the library's SASS
    (``cuobjdump``; HGMMA for warpgroup MMA, HMMA for mma.sync, HMMA of
    the TF32 form for the float32 kernels). Fails if a kernel spills,
    holds none of its matrix instructions or carries one of those codes,
    if K3's dynamic shared memory differs from
    ``ops/dual_axis.py::tc_smem_bytes`` (bf16) or ``tf32_smem_bytes``
    (float32, both axes), or if there is no SASS listing to count."""
    import ctypes
    build = port["build"]
    info = {"phase": "build_facts"}
    serialised = {"C7511", "C7514", "C7515"}
    # library, its dynamic shared memory query, the query's result and
    # argument types → (key, the kernel's name in the build log, the
    # query's arguments, its matrix opcode and the form required of it)
    for lib, query, restype, argtypes, kernels in (
            ("flash_attention", "flash_attention_fwd_smem_bytes",
             ctypes.c_int, [ctypes.c_int],
             (("fwd", "flash_fwd_bf16", (1,), "HGMMA", None),
              ("fwd_f32", "flash_fwd_f32", (0,), "HMMA", "TF32"))),
            ("flash_attention_bwd", "flash_attention_bwd_smem_bytes",
             ctypes.c_int, [ctypes.c_int],
             (("dkv", "flash_bwd_dkv_bf16", (0,), "HGMMA", None),
              ("dq", "flash_bwd_dq_bf16", (1,), "HGMMA", None),
              ("dkv_f32", "flash_bwd_dkv_f32", (2,), "HMMA", "TF32"),
              ("dq_f32", "flash_bwd_dq_f32", (2,), "HMMA", "TF32"))),
            ("ln_qkv", "ln_qkv_smem_bytes", ctypes.c_longlong,
             [ctypes.c_int] * 2,
             (("k4", "ln_qkv_bf16_kernel", (1, 768), "HGMMA", None),
              ("k4_f32", "ln_qkv_f32_kernel", (0, 768), "HMMA", "TF32"))),
            ("dual_axis_block_tc", "dual_axis_block_tc_smem_bytes",
             ctypes.c_longlong, [ctypes.c_int] * 4,
             (("k3_tc", "dual_axis_block_tc_kernel", (35, 600, 2, 12),
               "HMMA", None),)),
            # a template on the count of m16 row tiles: 3 at the event
            # axis, 2 at the time axis
            ("dual_axis_block_tf32", "dual_axis_block_tf32_smem_bytes",
             ctypes.c_longlong, [ctypes.c_int] * 4,
             (("k3_tf32", "dual_axis_block_tf32_kernelILi3E",
               (35, 600, 2, 12), "HMMA", "TF32"),
              ("k3_tf32_time", "dual_axis_block_tf32_kernelILi2E",
               (25, 840, 2, 12), "HMMA", "TF32")))):
        log = build.build_log(lib)
        usage, warnings = build.ptxas_usage(log), build.ptxas_warnings(log)
        listing = build.sass(lib)
        if listing is None:
            raise AssertionError(f"no SASS listing of {lib} (cuobjdump "
                                 f"missing or failed)")
        maxnreg = build.sass_setmaxnreg(listing)
        dynamic = getattr(build.load(lib), query)
        dynamic.restype = restype
        dynamic.argtypes = argtypes
        for key, name, args, opcode, form in kernels:
            found = [u for fn, u in usage.items() if name in fn]
            if len(found) != 1:
                raise AssertionError(f"{name}: no single ptxas entry: "
                                     f"{usage}")
            u = found[0]
            mma = build.sass_opcode_counts(listing, opcode, form)
            info[key] = {
                "registers": u["registers"],
                "sass_setmaxnreg": {k: v for fn, kinds in maxnreg.items()
                                    if name in fn for k, v in kinds.items()},
                "spills": u["spill_stores"] + u["spill_loads"],
                "smem_bytes": u["smem_bytes"] + dynamic(*args),
                "dynamic_smem_bytes": dynamic(*args),
                "matrix_opcode": opcode + (f".{form}" if form else ""),
                f"sass_{opcode.lower()}": sum(n for fn, n in mma.items()
                                              if name in fn),
                "ptxas_warnings": [w["code"] for w in warnings
                                   if w["function"] is None
                                   or name in w["function"]]}
    emit(info)
    for key, opcode in (("fwd", "hgmma"), ("dkv", "hgmma"), ("dq", "hgmma"),
                        ("k4", "hgmma"), ("k3_tc", "hmma"),
                        ("fwd_f32", "hmma"), ("k4_f32", "hmma"),
                        ("dkv_f32", "hmma"), ("dq_f32", "hmma"),
                        ("k3_tf32", "hmma"), ("k3_tf32_time", "hmma")):
        if info[key]["spills"] or not info[key][f"sass_{opcode}"] > 0 or \
                serialised & set(info[key]["ptxas_warnings"]):
            raise AssertionError(f"{key}: {info[key]}")
    DA = port["dual_axis"]
    for key, mirror, shape in (
            ("k3_tc", DA.tc_smem_bytes, (35, 600)),
            ("k3_tf32", DA.tf32_smem_bytes, (35, 600)),
            ("k3_tf32_time", DA.tf32_smem_bytes, (25, 840))):
        if info[key]["dynamic_smem_bytes"] != mirror(*shape, 2, 12):
            raise AssertionError(f"{key}: the source's shared memory "
                                 f"differs from {mirror.__name__}: "
                                 f"{info[key]}")
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
        again = att.flash_mha(q, k, v, scale, kv_valid=kv_valid)
        want = att.flash_mha_reference(q, k, v, scale, kv_valid=kv_valid)
        if device.type == "cuda":
            torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        same = torch.equal(_bits(got), _bits(again))
        res = {"phase": "kernel_check", "kernel": "flash_attention",
               "case": label, "shape": [B, H, N, 64], "kv_valid": kv_valid,
               "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err, "tol": tol, "bit_equal_rerun": same}
        if timed:
            n_keys = N if kv_valid is None else kv_valid
            res["plain_ms"] = device_ms(
                lambda: att.flash_mha_reference(q, k, v, scale,
                                                kv_valid=kv_valid), device)
            mask = None
            if n_keys < N:
                mask = (torch.arange(N, device=device) < n_keys)[None, :]
            # the kernel and SDPA's forward, their repetitions alternating
            res["ms"], res["library_ms"] = paired_ms([
                lambda: att.flash_mha(q, k, v, scale, kv_valid=kv_valid),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale)], device)
            res["fwd_vs_library"] = res["ms"] / res["library_ms"]
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 \
                else PEAK_F32_FLOPS
            res["bound_ms"], res["bound_by"] = attention_bound_ms(
                B, H, N, n_keys, 64, got.element_size(), peak)
            if dtype == torch.float32:
                res["tc_bound_ms"], res["tc_bound_by"] = attention_bound_ms(
                    B, H, N, n_keys, 64, 4, PEAK_3XTF32_FLOPS)
        emit(res)
        if not finite or not err <= tol or not same:
            raise AssertionError(f"flash_attention {label}: max abs err "
                                 f"{err} > {tol} (finite={finite}, "
                                 f"bit-equal rerun={same})")
        results[label] = res
        del q, k, v, got, again, want
        torch.cuda.empty_cache()
    return results


def _bits(x):
    """A tensor's bit pattern, so that equality holds NaN == NaN."""
    import torch
    return x.view({2: torch.int16, 4: torch.int32}.get(x.element_size(),
                                                       torch.uint8))


def phase_gather(port, device, n_bank: int = 400, batch: int = 32) -> dict:
    """K2 against its plain version, bit for bit, at the main path's shapes:
    bank rows N + 1 (the NaN sentinel last), 32 rows with repeats and the
    sentinel; the route each case took (``bulk``: TMA bulk copies;
    ``vector``: the vector copy kernel, for a bank whose 8,220-byte rows
    are not 16-byte aligned), asserted against ``gather.route``. Times the
    kernel and ``torch.index_select`` (a yardstick only) in alternation
    (``ms``, ``library_ms``, ``vs_library``: CUDA events around 5 calls,
    so each holds its host dispatch, which for K2's wrapper is near the
    copy's own time), then the device time of each over 20 calls under
    ``torch.profiler`` (``device_ms``, ``library_device_ms``,
    ``device_vs_library``: the kernels alone), the plain version and the
    bound; the achieved rate and its share of the HBM peak from the device
    time."""
    import torch
    G = port["gather"]
    g = torch.Generator(device=device).manual_seed(7)
    rows = torch.randint(0, n_bank, (batch,), generator=g, device=device,
                         dtype=torch.int32)
    rows[1] = rows[0]
    rows[-1] = n_bank                                  # the sentinel
    kernels = {"bulk": "gather_rows_bulk", "vector": "gather_rows"}
    results = {}
    for label, shape, dtype, route in (
            ("patch_bf16", (n_bank + 1, 1370, 768), torch.bfloat16, "bulk"),
            ("cls_bf16", (n_bank + 1, 768), torch.bfloat16, "bulk"),
            ("patch_f32", (n_bank + 1, 1370, 768), torch.float32, "bulk"),
            ("vector_bf16", (n_bank + 1, 1370, 3), torch.bfloat16,
             "vector")):
        bank = torch.randn(shape, generator=g, device=device, dtype=dtype)
        bank[-1] = float("nan")
        before = dict(G.LAUNCHES)
        got = G.gather_rows(bank, rows)
        took = [r for r, k in kernels.items()
                if G.LAUNCHES[k] == before[k] + 1]
        want = G.gather_rows_reference(bank, rows)
        torch.cuda.synchronize()
        exact = bool(torch.equal(_bits(got), _bits(want)))
        err = (got.float() - want.float()).nan_to_num(0.0).abs().max().item()
        row_bytes = bank[0].numel() * bank.element_size()

        def kernel():
            return G.gather_rows(bank, rows)

        def library():
            return torch.index_select(bank, 0, rows)
        ms, library_ms = paired_ms([kernel, library], device)
        dev_ms, lib_dev_ms = (
            _profile(fn, 20, t, {}).get("device_busy_ms_per_step",
                                        "not measured")
            for fn, t in ((kernel, ms), (library, library_ms)))
        measured = not isinstance(dev_ms, str)
        nbytes = 2.0 * batch * row_bytes
        res = {"phase": "kernel_check", "kernel": kernels[route],
               "case": label, "bank": list(shape), "rows": batch,
               "dtype": str(dtype).replace("torch.", ""),
               "route": took[0] if len(took) == 1 else took,
               "expected_route": route,
               "bit_exact": exact, "max_abs_err": err,
               "ms": ms, "library_ms": library_ms,
               "vs_library": ms / library_ms,
               "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
               "device_vs_library": dev_ms / lib_dev_ms
               if measured and not isinstance(lib_dev_ms, str)
               else "not measured",
               "plain_ms": device_ms(
                   lambda: G.gather_rows_reference(bank, rows), device),
               "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
               "gb_per_s": nbytes / dev_ms * 1e-6 if measured
               else "not measured",
               "share_of_peak_bytes": nbytes / dev_ms * 1e3 / PEAK_BYTES
               if measured else "not measured"}
        emit(res)
        if not exact:
            raise AssertionError(f"gather_rows {label}: not bit-exact "
                                 f"(max abs err {err})")
        if took != [route] or G.route(row_bytes, bank.data_ptr(),
                                      got.data_ptr()) != route:
            raise AssertionError(f"gather_rows {label}: took {took}, "
                                 f"expected the {route} route")
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
               for k in best)
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
    k1, k2 = att.LAUNCHES["flash_attention"], G.LAUNCHES["gather_rows_bulk"]
    k2_vector = G.LAUNCHES["gather_rows"]
    ex = res.extras
    steps, evals = ex["n_train_steps"], ex["n_eval_steps"]
    phase = ex["phase_seconds"]
    _, _, _, again, reload_diff = _reload_val(port, res, device)
    k2_reload = G.LAUNCHES["gather_rows_bulk"] - k2
    info = {"phase": "train", "card": card, "argv": argv,
            "wall_s": wall, "feature_build_s": phase["feature_build"],
            "k1_launches_in_bank_build": k1,
            "k1_f32_launches": att.LAUNCHES["flash_attention_f32"],
            "k2_launches": k2, "k2_vector_launches": k2_vector,
            "train_steps": steps, "eval_steps": evals,
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
    if k2_vector:
        raise AssertionError(f"the train path's gathers took the vector "
                             f"route {k2_vector} times, not the bulk one")
    if reload_diff > SERVE_TOL or again["main_auroc"] != res.best_metric:
        raise AssertionError(f"reloaded best checkpoint evaluates "
                             f"differently: {reload_diff}, "
                             f"{again['main_auroc']} vs {res.best_metric}")
    return info


def phase_f32_train(port, device, card: str = "") -> dict:
    """The training CLI at full width in float32 (``--mixed_precision
    no``, the reference-precision path) on the encode-once tier, 1 epoch
    of 4 batches of 32 on the 240 synthetic stays: the bank build runs the
    ViT through K1's float32 forward (``flash_fwd_f32``) and each step
    gathers float32 bank rows through K2. K1's and K2's launches counted
    over exactly this run, every K1 launch a float32 one; finite losses;
    K2 twice per train and eval step, on the bulk route."""
    import torch
    shutil.rmtree(RUNS, ignore_errors=True)
    argv = ["--device", "cuda", "--mixed_precision", "no",
            "--cxr_feature_cache", "hbm", "--synthetic_stays", "240",
            "--batch_size", "32", "--epochs", "1", "--limit_batches", "4",
            "--ckpt_dir", RUNS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(port)
    t0 = time.perf_counter()
    res = port["train_teacher"].main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(port)
    k1, k1_bf16 = launches["flash_attention_f32"], launches["flash_attention"]
    k2, k2_vector = launches["gather_rows_bulk"], launches["gather_rows"]
    ex = res.extras
    steps, evals = ex["n_train_steps"], ex["n_eval_steps"]
    phase = ex["phase_seconds"]
    info = {"phase": "f32_train", "card": card, "argv": argv,
            "wall_s": wall, "feature_build_s": phase["feature_build"],
            "k1_launches_in_bank_build": k1, "k1_bf16_launches": k1_bf16,
            "launches": launches,
            "k2_launches": k2, "k2_vector_launches": k2_vector,
            "train_steps": steps, "eval_steps": evals,
            "train_s": phase["train"],
            "train_step_ms": phase["train"] / steps * 1e3,
            "epoch_losses": [h["train_total"] for h in res.history],
            "val_auroc": [h["val_main_auroc"] for h in res.history],
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(info)
    shutil.rmtree(RUNS, ignore_errors=True)
    if not all(np.isfinite(x) for x in info["epoch_losses"]):
        raise AssertionError(f"non-finite losses {info['epoch_losses']}")
    if k1 == 0 or k1_bf16:
        raise AssertionError(f"the float32 bank build launched K1's float32 "
                             f"kernel {k1} times and its bf16 one {k1_bf16}")
    if k2 != 2 * (steps + evals) or k2_vector:
        raise AssertionError(f"K2 launched {k2} times (vector route "
                             f"{k2_vector}) over {steps} train and {evals} "
                             f"eval steps, expected 2 per step, bulk")
    return info


# kernel families of a train step's profile: the first whose substrings a
# kernel's name holds (lower case) takes it, the rest fall to "other"
FAMILIES = {"k1": ("flash_fwd", "flash_bwd"),
            "conv": ("conv", "implicit"),
            "gemm": ("gemm", "xmma", "cutlass", "cublas", "sm90_", "sm80_"),
            "optimizer": ("multi_tensor", "foreach", "adam"),
            "reduce_or_norm": ("reduce", "norm", "softmax"),
            "copy_or_cast": ("copy", "memcpy", "memset", "cast"),
            "elementwise": ("elementwise", "vectorized")}


def _profile(fn, n: int, step_ms: float, watch: dict,
             families: bool = False) -> dict:
    """``n`` calls of ``fn`` under ``torch.profiler``: device busy time per
    call (the sum of every device event's self time), the idle share of the
    unprofiled ``step_ms``, the heaviest kernels, and, for each ``watch``
    name, the device time and launches per call of the kernels whose names
    hold its substring. ``families``: also the device time per call of
    each of ``FAMILIES``."""
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
    if families:
        fam = dict.fromkeys([*FAMILIES, "other"], 0.0)
        for us, k, _ in rows:
            name = next((f for f, subs in FAMILIES.items()
                         if any(x in k.lower() for x in subs)), "other")
            fam[name] += us / 1e3 / n
        out["by_family_ms_per_step"] = fam
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
    """Per kind of reading (``loss``, ``main_logit`` or ``logits``, ``grad``,
    ``param``), the largest difference and its leaf (None when every leaf
    of that kind is equal)."""
    out = {}
    for kind in sorted({k.split(":")[0] for k in diffs}):
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
    F = port["features"]
    ids, pixels_for_ids = tl.pixels_for_ids_fn(data, hook)
    bank = F.CXRFeatureBank.build(
        F.encode_fn_for_teacher(base, torch.bfloat16), pixels_for_ids, ids)
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
                                             {"k2": "gather_rows"})}
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


# D's yardstick in a row of the summary (``delta_<key>`` of phase_backward)
DELTA_LIBRARY_KEYS = ("library_ms", "library_call", "library_ms_by_call",
                      "vs_library")


def delta_bound_ms(B, H, N, itemsize) -> float:
    """D's least time: O and dO read once, D (float32) written once, over
    the memory rate (it does 2·64 operations a row: bound by bytes)."""
    return (2.0 * itemsize * B * H * N * 64 + 4.0 * B * H * N) \
        / PEAK_BYTES * 1e3


def phase_backward(port, device, cases) -> dict:
    """K1's backward (the D, dkv and dq kernels, through ``flash_mha``'s
    autograd Function) against ``flash_mha_backward_reference``; D against
    ``delta_reference``; the forward's log-sum-exp against the plain one;
    two backward passes and two D launches bit-equal; keys past
    ``kv_valid`` exactly zero. Timed cases: the forward with and without
    ``lse``, each backward kernel, D and its plain version, the Function's
    whole backward and ``scaled_dot_product_attention``'s backward (a
    yardstick only; the two timed in alternation), the plain backward.
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
        dlt, dlt_again = att.delta(o, do), att.delta(o, do)
        dlt_ref = att.delta_reference(o, do)
        torch.cuda.synchronize()
        dlt_err = (dlt - dlt_ref).abs().max().item()
        dlt_rel = dlt_err / max(dlt_ref.abs().max().item(), 1e-12)
        dlt_same = torch.equal(_bits(dlt), _bits(dlt_again))
        res = {"phase": "kernel_check", "kernel": "flash_attention_bwd",
               "case": label, "shape": [B, H, N, 64], "kv_valid": kv_valid,
               "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err, "max_rel_err": rel, "tol": tol,
               "lse_max_abs_err": lse_err, "lse_tol": TOL_LSE,
               "delta_max_abs_err": dlt_err, "delta_max_rel_err": dlt_rel,
               "delta_tol": TOL_DELTA, "delta_bit_equal_rerun": dlt_same,
               "bit_equal_rerun": same_bits, "masked_keys_zero": masked_zero}
        if timed:
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
            # D and the two single PyTorch calls that compute it, their
            # repetitions alternating; the faster call is the yardstick
            lib = {"torch.linalg.vecdot": lambda: torch.linalg.vecdot(o, do),
                   "torch.einsum": lambda: torch.einsum("bhnd,bhnd->bhn",
                                                        o, do)}
            res["delta_ms"], *lib_ms = paired_ms(
                [lambda: att.delta(o, do), *lib.values()], device)
            res["delta_library_ms_by_call"] = dict(zip(lib, lib_ms))
            res["delta_library_ms"], res["delta_library_call"] = min(
                zip(lib_ms, lib))
            res["delta_vs_library"] = res["delta_ms"] / \
                res["delta_library_ms"]
            res["delta_plain_ms"] = device_ms(
                lambda: att.delta_reference(o, do), device)
            res["delta_bound_ms"] = delta_bound_ms(B, H, N, o.element_size())
            # the Function's whole backward as training runs it (dO made
            # ready, D, dkv, dq) and SDPA's backward, their repetitions
            # alternating
            fn_out = att.flash_mha(*leaves, scale, kv_valid=kv_valid)
            res["backward_ms"], res["library_ms"] = paired_ms([
                lambda: torch.autograd.grad(fn_out, leaves, do,
                                            retain_graph=True),
                lambda: torch.autograd.grad(out, leaves, do,
                                            retain_graph=True)], device)
            res["pair_ms"] = res["dkv_ms"] + res["dq_ms"]
            res["pair_vs_library"] = res["pair_ms"] / res["library_ms"]
            res["backward_vs_library"] = res["backward_ms"] / \
                res["library_ms"]
            for kind in ("dkv", "dq", "pair"):
                res[f"{kind}_bound_ms"], res[f"{kind}_bound_by"] = \
                    backward_bound_ms(kind, B, H, N, n_keys,
                                      q.element_size(), peak)
                if dtype == torch.float32:
                    res[f"{kind}_tc_bound_ms"] = backward_bound_ms(
                        kind, B, H, N, n_keys, 4, PEAK_3XTF32_FLOPS)[0]
            del out, fn_out, leaves
        emit(res)
        if not (finite and max(rel.values()) <= tol and lse_err <= TOL_LSE
                and same_bits and masked_zero and dlt_rel <= TOL_DELTA
                and dlt_same):
            raise AssertionError(f"flash_attention backward {label}: {res}")
        results[label] = res
        del q, k, v, do, got, again, o, lse, o_ref, lse_ref, want, dlt, \
            dlt_again, dlt_ref
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
    once = {**dict.fromkeys(launches, 0),
            "flash_attention_f32": 1, "flash_attention_bwd_delta_f32": 1,
            "flash_attention_bwd_dkv_f32": 1, "flash_attention_bwd_dq_f32": 1}
    if launches != once:
        raise AssertionError(f"the block's gradient did not run K1's float32 "
                             f"forward and backward once each: {launches}")
    if not rel[worst] <= BLOCK_TOL:
        raise AssertionError(f"block gradients disagree: {worst} "
                             f"{rel[worst]}")
    return info


def phase_unfreeze(port, device, card: str = "", f32: bool = False) -> dict:
    """The training CLI with the CXR branch trainable (``--unfreeze_cxr``,
    pixel tier) at full width: K1's launches counted over exactly this run
    (forward, D, dkv and dq 12 each per train step, the forward alone 12
    per eval step); finite losses; the ViT's, DuETT's and the perceiver's
    weights moved from ``init_teacher``'s; the best checkpoint, reloaded,
    evaluates the val split bit-equal to the loop. ``f32``: the same run in
    float32 (``--mixed_precision no``, the reference-precision path; phase
    ``f32_unfreeze``), whose launches are K1's float32 kernels', each under
    its own key, and none of its bf16 ones."""
    import torch
    att = port["attention"]
    shutil.rmtree(RUNS, ignore_errors=True)
    argv = ["--device", "cuda", "--unfreeze_cxr", "--cxr_feature_cache",
            "none", "--synthetic_stays", "240", "--batch_size", "32",
            "--epochs", "1", "--limit_batches", "4", "--ckpt_dir", RUNS]
    if f32:
        argv[2:2] = ["--mixed_precision", "no"]
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
    key = (lambda name: att.launch_key(name, torch.float32)) if f32 \
        else (lambda name: name)
    expect = {**dict.fromkeys(launches, 0),
              key("flash_attention"): n * (steps + evals),
              key("flash_attention_bwd_delta"): n * steps,
              key("flash_attention_bwd_dkv"): n * steps,
              key("flash_attention_bwd_dq"): n * steps}
    info = {"phase": "f32_unfreeze" if f32 else "unfreeze", "card": card,
            "argv": argv, "wall_s": wall,
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


def phase_unfreeze_step(port, device, cfg, reps: int = 5,
                        dtype: str = "bfloat16") -> dict:
    """The unfrozen pixel-tier train step at batch 32 on one fixed batch:
    the steady step time (CUDA events, median of ``reps`` after two warm-up
    steps), the peak memory and its estimate at the CLI's default batch of
    128 (the static part plus 4× the activations measured at 32), and a
    ``torch.profiler`` reading (device busy, idle share, time by kernel,
    K1's four kernels, the device time by kernel family). ``dtype``
    "float32": the step of ``--mixed_precision no`` (phase
    ``f32_unfreeze_step``), K1's float32 kernels watched."""
    import torch
    tl, eng = port["teacher_loop"], port["engine"]
    tcfg = port["config"].TrainConfig(batch_size=32, dtype=dtype)
    ucfg = cfg.replace(freeze_cxr=False)
    data, host, hook = _train_batch(port, device, ucfg)
    model = port["teacher"].init_teacher(ucfg, 0).to(device)
    state = port["state"].TrainState(model, port["optim"].MultiGroupAdamW(
        model, tcfg.optim, 100,
        frozen_prefixes=tl.teacher_frozen_prefixes(ucfg)))
    step = eng.make_teacher_step(tcfg, ucfg.duett, 24, np.ones(7, np.float32),
                                 dtype=getattr(torch, dtype))
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
    sfx = "f32" if dtype == "float32" else "bf16"
    prof = _profile(run, 3, step_ms, {"k1_fwd": f"flash_fwd_{sfx}",
                                      "k1_delta": f"flash_bwd_delta_{sfx}",
                                      "k1_dkv": f"flash_bwd_dkv_{sfx}",
                                      "k1_dq": f"flash_bwd_dq_{sfx}"},
                    families=True)
    n_params = sum(p.numel() for p in model.parameters())
    info = {"phase": "unfreeze_step" if sfx == "bf16" else
            "f32_unfreeze_step", "batch": 32, "dtype": dtype,
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
               for kind in ("fwd", "delta", "dkv", "dq")},
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
    """Every kernel's launches: by C entry point, and K1's and K4's float32
    kernels under their own keys (``flash_attention_f32``, ...)."""
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
    bit-equal; the route each case took (``tc``: the bf16 tensor-core
    kernel, ``tf32``: the float32 one, ``simt``: the SIMT kernel), asserted
    against the case's and against ``dual_axis.route``. Times the kernel
    through its wrapper (weight casts included) and the plain version in
    alternation (``ms``, ``plain_ms``:
    CUDA events around 5 calls, so each holds its host dispatch), then the
    device time of each over 20 calls under ``torch.profiler``
    (``device_ms``: the kernel alone; ``device_busy_ms``: every device
    event of the wrapper, its casts included; ``plain_device_ms``), and
    the bound (no single PyTorch call computes the block: ``library_ms``
    null). Then one backward through the autograd Function against
    autograd of the plain version.
    cases: (label, B, L, D, dtype, tol, route), or with (heads, d_head)
    after the route for a case of other heads than the phase's."""
    import torch
    DA = port["dual_axis"]
    results = {}
    for label, B, L, D, dtype, tol, way, *hd in cases:
        n_h, d_h = hd[0] if hd else (n_heads, d_head)
        inner = n_h * d_h
        params = _dual_axis_params(D, inner, ff, device, 30 + len(results))
        g = torch.Generator(device=device).manual_seed(40 + len(results))
        x = torch.randn(B, L, D, generator=g, device=device).to(dtype)

        def kernel():
            return DA.fused_encoder_block(x, params, n_h, d_h)

        def plain():
            return DA.encoder_block_reference(x, params, n_h, d_h)

        before = dict(DA.LAUNCHES)
        got, again = kernel(), kernel()
        took = [r for r, k in DA.ROUTE_KERNELS.items()
                if DA.LAUNCHES[k] == before[k] + 2]
        want = plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = err / max(want.float().abs().max().item(), 1e-12)
        same = torch.equal(_bits(got), _bits(again))
        finite = bool(torch.isfinite(got).all())
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        bound, by = dual_axis_bound_ms(B, L, D, inner, ff, x.element_size(),
                                       peak)
        ms, plain_ms = paired_ms([kernel, plain], device)
        prof = _profile(kernel, 20, ms, {"kernel": "dual_axis_block"})
        plain_prof = _profile(plain, 20, plain_ms, {})
        dev_ms = prof.get("kernel_device_ms_per_step", "not measured")
        res = {"phase": "kernel_check", "kernel": DA.ROUTE_KERNELS[way],
               "case": label, "shape": [B, L, D], "heads": [n_h, d_h],
               "ff": ff, "dtype": str(dtype).replace("torch.", ""),
               "route": took[0] if len(took) == 1 else took,
               "expected_route": way,
               "max_abs_err": err, "max_rel_err": rel, "tol": tol,
               "bit_equal_rerun": same,
               "smem_bytes": {"tc": DA.tc_smem_bytes,
                              "tf32": DA.tf32_smem_bytes,
                              "simt": DA.smem_bytes}[way](L, D, n_h, d_h),
               "workspace_bytes": DA.workspace_bytes(B, L, D, ff, way)
               if way != "simt" else 0,
               "ms": ms, "plain_ms": plain_ms,
               **({"tc_bound_ms": dual_axis_bound_ms(
                   B, L, D, inner, ff, 4, PEAK_3XTF32_FLOPS)[0]}
                  if dtype == torch.float32 else {}),
               "device_ms": dev_ms,
               "device_busy_ms": prof.get("device_busy_ms_per_step",
                                          "not measured"),
               "plain_device_ms": plain_prof.get("device_busy_ms_per_step",
                                                 "not measured"),
               "library_ms": None, "bound_ms": bound, "bound_by": by}
        res["device_vs_bound"] = dev_ms / bound \
            if not isinstance(dev_ms, str) else "not measured"
        emit(res)
        if not (finite and rel <= tol and same):
            raise AssertionError(f"dual_axis_block {label}: {res}")
        if took != [way] or DA.route(dtype, L, D, ff, n_h, d_h) != way:
            raise AssertionError(f"dual_axis_block {label}: took {took}, "
                                 f"expected the {way} route")
        results[label] = res
        del x, got, again, want
    torch.cuda.empty_cache()

    # one backward through the autograd Function (the kernel forward, a
    # recompute of the plain version backward, as JAX's custom VJP)
    B, L, D = 4, 35, 600
    inner = n_heads * d_head
    leaves = {k: v.requires_grad_() for k, v in
              _dual_axis_params(D, inner, ff, device, 50).items()}
    x = torch.randn(B, L, D, device=device, requires_grad=True)
    w = torch.randn(B, L, D, device=device)
    before = sum(DA.LAUNCHES.values())
    (DA.fused_encoder_block(x, leaves, n_heads, d_head) * w).sum().backward()
    launched = sum(DA.LAUNCHES.values()) - before
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
    weight casts included) and a library yardstick of several calls
    (``F.layer_norm``, one ``F.linear`` on the stacked [3·H·64, D] weight,
    the head-major copy; no single PyTorch call computes K4) in alternation
    (``vs_library``), the plain version and the bound.
    cases: (label, B, N, D, H, dtype, tol)."""
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
               "plain_ms": device_ms(lambda: LQ.ln_qkv_reference(
                   x, params, H, 64), device),
               "library_calls": "F.layer_norm + F.linear (stacked weight) "
                                "+ head-major copy, weight casts included",
               "bound_ms": bound, "bound_by": by}
        # the kernel and the library's calls, their repetitions alternating
        res["ms"], res["library_ms"] = paired_ms([kernel, library], device)
        res["vs_library"] = res["ms"] / res["library_ms"]
        res["share_of_bound"] = bound / res["ms"]
        if dtype == torch.float32:
            res["tc_bound_ms"], res["tc_bound_by"] = ln_qkv_bound_ms(
                B, N, D, inner, 4, PEAK_3XTF32_FLOPS)
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
    captured by a forward hook during an eval step, once in bf16 and once
    in float32 (TF32 off), and K3, fed that input with the layer's weights
    through ``params_from_encoder``, gives the layer's own output: within
    TOL_TRAINED_LAYER of its max abs at bf16, on the bf16 tensor-core route
    (both axes are bf16 with D % 8 == 0 and F 512); within
    TOL_TRAINED_LAYER_F32 at float32, on the float32 tensor-core route, and
    there within TOL_FUSED_F32 of the plain version on the same input."""
    import torch
    DA, eng = port["dual_axis"], port["engine"]
    cfg, data = ssl["duett_cfg"], ssl["data"]
    ck = port["checkpoint"].load_checkpoint(ssl["best_path"])
    model = port["convert"].load_flax(port["duett"].DuettPretrainModel(cfg),
                                      ck["params"],
                                      ck["batch_stats"]).to(device)
    n_val = min(128, data.split_size("val"))
    batch = eng.to_device(next(data.iter_batches("val", n_val,
                                                 shuffle=False)), device)
    heads = (cfg.n_heads, cfg.d_embedding // cfg.n_heads)
    out = {}
    reset_counts(port)
    for dtype in (torch.bfloat16, torch.float32):
        seen, hooks = {}, []

        def capture(axis):
            def hook(module, args, y):
                seen[axis] = (args[0], y)
            return hook

        for axis in ("event", "time"):
            enc = getattr(model.encoder, f"{axis}_transformer_0")
            hooks.append(enc.register_forward_hook(capture(axis)))
        launched = read_counts(port)
        eng.make_ssl_eval(cfg, data.n_timesteps, dtype)(
            model, data.grid, data.static, batch,
            torch.Generator(device=device).manual_seed(1000))
        for h in hooks:
            h.remove()
        if read_counts(port) != launched:
            raise AssertionError("the SSL eval step launched K3")
        with torch.inference_mode():
            for axis, (x, y) in seen.items():
                enc = getattr(model.encoder, f"{axis}_transformer_0")
                params = DA.params_from_encoder(enc)
                got = DA.fused_encoder_block(x, params, *heads)
                torch.cuda.synchronize()
                err = (got.float() - y.float()).abs().max().item()
                res = {"shape": list(x.shape),
                       "dtype": str(x.dtype).replace("torch.", ""),
                       "route": DA.route(x.dtype, x.shape[1], x.shape[2],
                                         params["w1"].shape[-1], *heads),
                       "max_abs_err": err,
                       "max_rel_err": err / y.float().abs().max().item()}
                if dtype == torch.float32:
                    want = DA.encoder_block_reference(x, params, *heads)
                    res["plain_max_rel_err"] = \
                        (got - want).abs().max().item() \
                        / want.abs().max().item()
                out[f"{axis}_{res['dtype']}"] = res
    counts = read_counts(port)
    launches = sum(counts[k] for k in DA.ROUTE_KERNELS.values())
    info = {"phase": "trained_layer", "checkpoint": ssl["best_path"],
            "axes": out, "launches": launches,
            "tc_launches": counts["dual_axis_block_tc"],
            "tf32_launches": counts["dual_axis_block_tf32"],
            "tol": TOL_TRAINED_LAYER, "tol_f32": TOL_TRAINED_LAYER_F32,
            "tol_f32_plain": TOL_FUSED_F32}
    emit(info)
    bf16 = [a for a in out.values() if a["dtype"] == "bfloat16"]
    f32 = [a for a in out.values() if a["dtype"] == "float32"]
    if launches != 4 or info["tc_launches"] != 2 or \
            info["tf32_launches"] != 2 or len(bf16) != 2 or len(f32) != 2 \
            or not max(a["max_rel_err"] for a in bf16) <= TOL_TRAINED_LAYER \
            or not max(a["max_rel_err"] for a in f32) \
            <= TOL_TRAINED_LAYER_F32 \
            or not max(a["plain_max_rel_err"] for a in f32) <= TOL_FUSED_F32:
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
    # the kd phase distills from this teacher
    shutil.rmtree(KD_RUNS, ignore_errors=True)
    os.makedirs(KD_RUNS)
    kept = os.path.join(KD_RUNS, "teacher.msgpack")
    for suffix in ("", ".config.json"):
        shutil.copy(res.best_path + suffix, kept + suffix)
    info = {"phase": "ssl_to_teacher", "card": card, "argv": argv,
            "wall_s": wall, "launches": launches,
            "duett_tensors": len(want), "duett_equals_ssl_encoder": same,
            "epoch_losses": [h["train_total"] for h in res.history],
            "val_auroc": [h["val_main_auroc"] for h in res.history],
            "teacher_ckpt": kept}
    emit(info)
    shutil.rmtree(RUNS, ignore_errors=True)
    if not same:
        raise AssertionError("the teacher's DuETT did not start from the SSL "
                             "encoder")
    if not all(np.isfinite(x) for x in info["epoch_losses"]):
        raise AssertionError(f"non-finite losses {info['epoch_losses']}")
    if launches["flash_attention"] == 0 or \
            launches["gather_rows_bulk"] == 0:
        raise AssertionError(f"the teacher run did not launch K1 and K2: "
                             f"{launches}")
    return info


def _kd_cli_run(port, device, argv: list, ckpt_dir: str) -> dict:
    """One ``cli/train_student.main`` run with every kernel's launches
    counted over exactly this run; its best checkpoint reloaded through
    ``load_student_from_ckpt`` and evaluated by the loop's own eval."""
    import torch
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(port)
    t0 = time.perf_counter()
    res = port["train_student"].main(argv + ["--ckpt_dir", ckpt_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(port)
    peak = torch.cuda.max_memory_allocated()
    ex = res.extras
    model, _, _ = port["checkpoint"].load_student_from_ckpt(res.best_path,
                                                            device)
    again = ex["evaluate"](model, "val")
    steps, phase = ex["n_train_steps"], ex["phase_seconds"]
    return {"argv": argv, "wall_s": wall, "launches": launches,
            "train_steps": steps, "eval_steps": ex["n_eval_steps"],
            "feature_tier": ex["feature_tier"],
            "feature_build_s": phase.get("feature_build"),
            "train_s": phase["train"], "eval_s": phase["eval"],
            "train_step_ms": phase["train"] / steps * 1e3,
            "train_samples_per_s": steps * 32 / phase["train"],
            "step_losses": ex["step_losses"],
            "val_auroc": [h["auroc"] for h in res.history],
            "best_val_auroc": res.best_metric,
            "reload_val_auroc": again["auroc"],
            "test_auroc": res.test_metrics["auroc"],
            "peak_memory_bytes": peak}


def _kd_leaves(res: dict, model) -> dict:
    """A KD step's readings for ``_tier_diffs``: its losses, the student's
    logits, every gradient and every updated parameter."""
    return {**{f"loss:{k}": res[k].float().reshape(1)
               for k in ("total", "bce", "kd")},
            "logits": res["logits"].clone(),
            **{f"grad:{n}": p.grad.detach().float().clone()
               for n, p in model.named_parameters()},
            **{f"param:{n}": p.detach().float().clone()
               for n, p in model.named_parameters()}}


def _kd_tier_diffs(a: dict, b: dict) -> dict:
    """Relative differences of two KD steps' readings (``_kd_leaves``):
    losses and logits against their magnitude; each gradient against its
    max abs floored at BLOCK_FLOOR of the largest gradient; each updated
    parameter against its max abs, for the leaves whose gradient is above
    that floor (a leaf whose exact gradient is 0, such as a bias before a
    BatchNorm, holds only rounding noise, which Adam's first update turns
    into ±lr whatever its size)."""
    if a.keys() != b.keys():
        raise AssertionError(f"tiers trained other leaves: "
                             f"{sorted(a.keys() ^ b.keys())[:5]}")
    floor = BLOCK_FLOOR * max(float(v.abs().max()) for k, v in a.items()
                              if k.startswith("grad:"))
    out = {}
    for k, v in a.items():
        kind, _, name = k.partition(":")
        if kind == "param" and float(a["grad:" + name].abs().max()) < floor:
            continue
        scale = max(float(v.abs().max()), floor if kind == "grad" else 1e-12)
        out[k] = float((v - b[k]).abs().max()) / scale
    return out


def phase_kd(port, device, teacher_ckpt: str, ssl_ckpt: str,
             card: str = "", reps: int = 5) -> dict:
    """Student distillation (``cli/train_student.main``) at full width from
    the ``ssl_to_teacher`` phase's teacher (ViT-B/14 at 518, the default
    DuETT, perceiver 7 × 256) and the SSL checkpoint for the student's
    backbone: 240 stays, batch 32, 1 epoch of 4 batches, bf16, on each
    image tier: ``none`` (the teacher's ViT in every KD step), ``hbm``,
    ``host`` in RAM, and ``host`` on disk twice (the second run reopens the
    store). Every kernel's launches counted over exactly each run: K1's
    forward 12 per pixel-tier step and none in the cached tiers' steps
    (only their bank build, 12 per chunk of 16 images, none on reopening),
    K2 on the bulk route 2 per ``hbm`` step and none on ``host``; finite
    losses; ``hbm`` and every ``host`` run bit-equal step by step; each
    reloaded best checkpoint evaluates the val split as its loop did.

    Then, outside the CLI, on one fixed batch of 32 from the same weights:
    one float32 KD step per tier compared (TF32 off: ``none`` against
    ``hbm`` within TIER_TOL as ``_kd_tier_diffs`` reads it, ``host``
    against ``hbm`` bit for bit, and a step on other images' bank rows
    outside TIER_TOL; in bf16 the in-step ViT at batch 32 and the bank's
    chunks of 16 round the teacher's logit apart by ~1e-3 of the KD loss,
    so the bf16 steps are reported and only ``host`` against ``hbm`` is
    held, bit for bit); the steady bf16 step of each tier
    (CUDA events, median of ``reps``), the host feed of each (hook and
    copy to the card, host clock), peak memory, and a ``torch.profiler``
    reading of the ``none`` and ``hbm`` steps. Last, one float32 KD step at
    batch 2 (TF32 off) on the card against a CPU copy of the teacher and
    the student (KD_F32_TOL)."""
    import torch
    cfgmod, eng, F = port["config"], port["engine"], port["features"]
    tcfg = cfgmod.TeacherConfig.from_dict(
        port["checkpoint"].load_checkpoint(teacher_ckpt)["config"]["model"])
    n_layers = tcfg.vit.n_layers
    store = os.path.join(KD_RUNS, "store", "feat")
    base = ["--device", "cuda", "--teacher_ckpt", teacher_ckpt,
            "--duett_ckpt", ssl_ckpt, "--synthetic_stays", "240",
            "--batch_size", "32", "--epochs", "1", "--limit_batches", "4"]
    ways = {"none": ["--cxr_feature_cache", "none"],
            "hbm": ["--cxr_feature_cache", "hbm"],
            "host": ["--cxr_feature_cache", "host"],
            "host_disk": ["--cxr_feature_cache", "host",
                          "--cxr_feature_store_path", store],
            "host_reopen": ["--cxr_feature_cache", "host",
                            "--cxr_feature_store_path", store]}
    runs = {way: _kd_cli_run(port, device, base + extra,
                             os.path.join(KD_RUNS, "runs"))
            for way, extra in ways.items()}
    shutil.rmtree(os.path.join(KD_RUNS, "runs"), ignore_errors=True)
    expect = {}
    for way, r in runs.items():
        n_img = r["feature_tier"].get("n_images", 0)
        build = 0 if way in ("none", "host_reopen") else -(-n_img // 16)
        steps = r["train_steps"]
        expect[way] = {**dict.fromkeys(r["launches"], 0),
                       "flash_attention": n_layers * (
                           steps if way == "none" else build),
                       "gather_rows_bulk": 2 * steps if way == "hbm" else 0}

    # one step per tier on one batch from the same weights (float32 to
    # compare the tiers, bf16 to time them), then the steady bf16 steps
    tl, student = port["teacher_loop"], port["student"]
    teacher, _, _ = port["checkpoint"].load_teacher_from_ckpt(teacher_ckpt,
                                                              device)
    teacher.requires_grad_(False)
    data, host, hook = _train_batch(port, device, tcfg)
    scfg = cfgmod.StudentConfig(duett=tcfg.duett, head_dropout=0.2)
    all_ids, pixels_for_ids = tl.pixels_for_ids_fn(data, hook)
    pixels = pixels_for_ids(all_ids)
    bf16, f32 = torch.bfloat16, torch.float32
    banks = {dt: F.CXRFeatureBank.build(
        F.encode_fn_for_teacher(teacher, dt),
        lambda ids: pixels[np.searchsorted(all_ids, ids)], all_ids,
        out_dtype=dt) for dt in (f32, bf16)}
    del pixels

    def tiers_of(dt):
        bank = banks[dt]
        c, p = bank.cls[:-1], bank.patches[:-1]
        if dt == bf16:
            c, p = c.view(torch.int16), p.view(torch.int16)
        store = F.HostFeatureStore(bank.ids, c.cpu().numpy(),
                                   p.cpu().numpy())
        n_bank = bank.cls.shape[0] - 1

        def shifted(b):
            b = bank.host_fn()(b)
            return {**b, "image_ids": (b["image_ids"] + 1) % n_bank}

        return {"none": (None, hook),
                "hbm": (bank.feature_source(), bank.host_fn()),
                "host": (F.features_from_batch, store.host_fn()),
                "wrong_rows": (bank.feature_source(), shifted)}

    base_student = student.init_student(scfg, 0).to(device)
    steady, after = {}, {f32: {}, bf16: {}}
    for dt in (f32, bf16):
        trn = cfgmod.TrainConfig(
            batch_size=32, dtype="float32" if dt == f32 else "bfloat16")
        for name, (source, feed_fn) in tiers_of(dt).items():
            if dt == bf16 and name == "wrong_rows":
                continue
            model = copy.deepcopy(base_student)
            state = port["state"].TrainState(
                model, port["optim"].MultiGroupAdamW(model, trn.optim, 100))
            step = eng.make_kd_step(trn, scfg.duett, 24, dt,
                                    feature_source=source)
            gen = torch.Generator(device=device).manual_seed(1)

            def feed():
                return eng.to_device(feed_fn(host), device)

            dev_batch = feed()

            def run():
                return step(state, teacher, data.grid, data.static,
                            dev_batch, gen)

            after[dt][name] = _kd_leaves(run(), model)
            if dt == f32:
                continue
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            feeds = []
            for _ in range(reps):
                t0 = time.perf_counter()
                feed()
                torch.cuda.synchronize()
                feeds.append((time.perf_counter() - t0) * 1e3)
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
            steady[name] = {
                "step_ms": step_ms, "step_ms_all": times,
                "feed_ms": statistics.median(feeds),
                "samples_per_s": 32e3 / step_ms,
                "peak_memory_bytes": torch.cuda.max_memory_allocated()}
            if name in ("none", "hbm"):
                steady[name]["profile"] = _profile(
                    run, 3, step_ms, {"k1_fwd": "flash_fwd",
                                      "k2": "gather_rows"}, families=True)
            del model, state
    del banks
    diffs = _kd_tier_diffs(after[f32]["none"], after[f32]["hbm"])
    worst = _worst(diffs)
    host_diffs = {str(dt).split(".")[-1]: max(_tier_diffs(
        after[dt]["host"], after[dt]["hbm"]).values()) for dt in (f32, bf16)}
    wrong = _worst(_kd_tier_diffs(after[f32]["hbm"],
                                  after[f32]["wrong_rows"]))
    bf16_diffs = _worst(_kd_tier_diffs(after[bf16]["none"],
                                       after[bf16]["hbm"]))

    # one float32 step on the card against a CPU copy, batch 2
    f32_cfg = cfgmod.TrainConfig(batch_size=2, dtype="float32")
    small = hook({k: v[:2] for k, v in host.items()})
    cpu = torch.device("cpu")
    nodrop = scfg.replace(head_dropout=0.0)
    teacher_cpu = copy.deepcopy(teacher).to(cpu)
    f32_out, f32_grads = {}, {}
    for side, dev, t in (("card", device, teacher), ("cpu", cpu, teacher_cpu)):
        model = student.init_student(nodrop, 0).to(dev)
        state = port["state"].TrainState(model, port["optim"].MultiGroupAdamW(
            model, f32_cfg.optim, 10))
        step = eng.make_kd_step(f32_cfg, nodrop.duett, 24, f32)
        reset_counts(port)
        res = step(state, t, data.grid.to(dev), data.static.to(dev),
                   eng.to_device(small, dev),
                   torch.Generator(device=dev).manual_seed(0))
        if side == "card":
            torch.cuda.synchronize()
            f32_launches = read_counts(port)
        f32_out[side] = {k: float(res[k]) for k in ("total", "bce", "kd")}
        f32_grads[side] = {n: p.grad.detach().cpu()
                           for n, p in model.named_parameters()}
    loss_rel = max(abs(f32_out["card"][k] - v) / max(abs(v), 1e-12)
                   for k, v in f32_out["cpu"].items())
    want = f32_grads["cpu"]
    floor = BLOCK_FLOOR * max(float(g.abs().max()) for g in want.values())
    grad_rel = {n: float((f32_grads["card"][n] - g).abs().max()
                         / max(float(g.abs().max()), 1e-30))
                for n, g in want.items()}
    grad_rel_floored = {n: float((f32_grads["card"][n] - g).abs().max()
                                 / max(float(g.abs().max()), floor))
                        for n, g in want.items()}
    worst_f32 = max(grad_rel_floored, key=grad_rel_floored.get)
    worst_unfloored = max(grad_rel, key=grad_rel.get)
    del teacher_cpu
    torch.cuda.empty_cache()

    info = {"phase": "kd", "card": card, "teacher_ckpt": teacher_ckpt,
            "ssl_ckpt": ssl_ckpt, "vit_layers": n_layers,
            "runs": runs, "expected_launches": expect,
            "steady": steady,
            **{f"max_rel_{kind}_diff": v[0] for kind, v in worst.items()},
            "worst_grad_leaf": worst["grad"][1],
            "worst_param_leaf": worst["param"][1],
            "params_compared": sum(k.startswith("param:") for k in diffs),
            "tol": TIER_TOL,
            "host_vs_hbm_max_diff": host_diffs,
            "wrong_rows_max_rel_diff": {kind: v[0]
                                        for kind, v in wrong.items()},
            "bf16_none_vs_hbm_max_rel_diff": {kind: v[0] for kind, v in
                                              bf16_diffs.items()},
            "f32_step": {"batch": 2, "losses": f32_out,
                         "max_rel_loss_diff": loss_rel,
                         "max_rel_grad_diff": grad_rel_floored[worst_f32],
                         "worst_grad_leaf": worst_f32, "floor": floor,
                         "max_rel_grad_diff_unfloored":
                         grad_rel[worst_unfloored],
                         "worst_unfloored_leaf": worst_unfloored,
                         "launches": f32_launches, "tol": KD_F32_TOL}}
    emit(info)
    shutil.rmtree(KD_RUNS, ignore_errors=True)
    for way, r in runs.items():
        losses = [x for v in r["step_losses"].values() for x in v]
        if not losses or not all(np.isfinite(x) for x in losses):
            raise AssertionError(f"kd {way}: non-finite or no losses")
        if r["launches"] != expect[way]:
            raise AssertionError(f"kd {way}: launches {r['launches']}, "
                                 f"expected {expect[way]}")
        if r["reload_val_auroc"] != r["best_val_auroc"]:
            raise AssertionError(f"kd {way}: the reloaded best checkpoint "
                                 "evaluates the val split differently")
        if way.startswith("host") and \
                r["step_losses"] != runs["hbm"]["step_losses"]:
            raise AssertionError(f"kd {way}: per-step losses differ from "
                                 "the hbm tier's")
    if not max(diffs.values()) <= TIER_TOL:
        raise AssertionError(f"kd tiers none/hbm disagree: {worst}")
    if max(host_diffs.values()) != 0.0:
        raise AssertionError(f"kd tiers host/hbm differ on one step: "
                             f"{host_diffs}")
    if not max(v[0] for v in wrong.values()) > TIER_TOL:
        raise AssertionError(f"the kd comparison misses a wrong bank row: "
                             f"{wrong}")
    if f32_launches.get("flash_attention_f32") != n_layers:
        raise AssertionError(f"the float32 KD step launched {f32_launches}")
    if not (loss_rel <= KD_F32_TOL
            and grad_rel_floored[worst_f32] <= KD_F32_TOL):
        raise AssertionError(f"the float32 KD step on the card disagrees "
                             f"with the CPU: {info['f32_step']}")
    return info


def _steady_step(port, device, run, reps: int, watch: dict) -> dict:
    """One step's launches (counts set to 0 just before it), then ``reps``
    steady steps timed by CUDA events (median), their peak memory, and a
    ``torch.profiler`` reading of 3 more (device busy time, idle share,
    ``watch``'s kernels, time by family)."""
    import torch
    run()
    torch.cuda.synchronize()
    reset_counts(port)
    run()
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts(port).items() if v}
    torch.cuda.reset_peak_memory_stats()
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
    return {"step_ms": step_ms, "step_ms_all": times,
            "samples_per_s": 32e3 / step_ms,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches_per_step": launches,
            "profile": _profile(run, 3, step_ms, watch, families=True)}


def phase_cxr_head(port, device, card: str = "") -> dict:
    """The CXR linear-head CLI (``cli/train_cxr_head.main``) at full width
    (ViT-B/14 at 518, seeded random weights) over the synthetic catalog of
    240 stays (the cohort the only cut): the CLS token of every catalog
    image in chunks of 64, float32 as the JAX package extracts it (K1's
    float32 forward, 12 a chunk), then 50 full-batch epochs of the head.
    Every kernel's launches over exactly this run; finite features; the
    head checkpoint's sidecar."""
    import math

    import torch
    shutil.rmtree(DUAL_RUNS, ignore_errors=True)
    argv = ["--device", "cuda", "--synthetic_stays", "240",
            "--batch_size", "64", "--epochs", "50",
            "--ckpt_dir", os.path.join(DUAL_RUNS, "cxr_head")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(port)
    t0 = time.perf_counter()
    res = port["train_cxr_head"].main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(port)
    n_img, n_layers = res["n_images"], port["config"].ViTConfig().n_layers
    expect = {**dict.fromkeys(launches, 0),
              "flash_attention_f32": n_layers * math.ceil(n_img / 64)}
    ck = port["checkpoint"].load_checkpoint(res["ckpt_path"])
    info = {"phase": "cxr_head", "card": card, "argv": argv, "wall_s": wall,
            "n_images": n_img, "feature_extract_s": res["feature_extract_s"],
            "images_per_s": n_img / res["feature_extract_s"],
            "launches": launches, "expected_launches": expect,
            "best_val_macro_auroc": res["best_val_macro_auroc"],
            "test_macro_auroc": res["test_macro_auroc"],
            "val_macro_auroc_first_last": [res["val_macro_auroc"][0],
                                           res["val_macro_auroc"][-1]],
            "sidecar": ck.get("config"),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "ckpt_path": res["ckpt_path"]}
    emit(info)
    if launches != expect:
        raise AssertionError(f"cxr_head launches {launches}, expected "
                             f"{expect}")
    if not np.isfinite(res["best_val_macro_auroc"]) or \
            not np.isfinite(ck["params"]["linear"]["kernel"]).all():
        raise AssertionError("cxr_head: non-finite head or AUROC")
    if (ck.get("config") or {}).get("kind") != "cxr_linear_head":
        raise AssertionError(f"cxr_head sidecar {ck.get('config')}")
    return info


def _keep_ckpt(path: str, dest: str) -> str:
    """Copy a checkpoint and its config sidecar to ``dest``."""
    for suffix in ("", ".config.json"):
        shutil.copy(path + suffix, dest + suffix)
    return dest


def phase_dual_teacher(port, device, head_ckpt: str, card: str = "",
                       reps: int = 5) -> dict:
    """The ``dual`` teacher through ``cli/train_teacher.main --perceiver_type
    dual --pretrained_cxr_head_ckpt`` at full width (the default
    ``TeacherConfig``, bf16), 240 stays, batch 32, 2 epochs: on the ``hbm``
    tier (K2 once a train and eval step, the CLS bank alone; K1 in the bank
    build only) and on the pixel tier (4 batches an epoch; K1 12 a train and
    eval step). Every kernel's launches over exactly each run; finite
    losses; the frozen head bit-equal to its checkpoint after training; the
    reloaded best checkpoint evaluates the val split as its loop did. Then
    the steady bf16 step of each tier on one batch of 32 (CUDA events,
    median of ``reps``; launches of one step; peak memory;
    ``torch.profiler``). Keeps the ``hbm`` run's best checkpoint for the
    ``dual_kd`` and ``dual_serve`` phases."""
    import math

    import torch
    ck_mod, n_layers = port["checkpoint"], \
        port["config"].ViTConfig().n_layers
    head = ck_mod.load_checkpoint(head_ckpt)["params"]["linear"]
    base = ["--device", "cuda", "--perceiver_type", "dual",
            "--pretrained_cxr_head_ckpt", head_ckpt, "--synthetic_stays",
            "240", "--batch_size", "32", "--epochs", "2"]
    ways = {"hbm": ["--cxr_feature_cache", "hbm"],
            "pixels": ["--cxr_feature_cache", "none", "--limit_batches", "4"]}
    runs, kept = {}, os.path.join(DUAL_RUNS, "teacher.msgpack")
    for way, extra in ways.items():
        argv = base + extra + ["--ckpt_dir", os.path.join(DUAL_RUNS, way)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(port)
        t0 = time.perf_counter()
        res = port["train_teacher"].main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(port)
        peak = torch.cuda.max_memory_allocated()
        ex = res.extras
        steps, evals = ex["n_train_steps"], ex["n_eval_steps"]
        n_img = ex["feature_tier"].get("n_images", 0)
        expect = {**dict.fromkeys(launches, 0),
                  "flash_attention": n_layers * (
                      steps + evals if way == "pixels"
                      else math.ceil(n_img / 16)),
                  "gather_rows_bulk": steps + evals if way == "hbm" else 0}
        _, _, ck, again, reload_diff = _reload_val(port, res, device)
        phase = ex["phase_seconds"]
        runs[way] = {
            "argv": argv, "wall_s": wall, "launches": launches,
            "expected_launches": expect, "train_steps": steps,
            "eval_steps": evals, "feature_build_s": phase.get(
                "feature_build"), "train_s": phase["train"],
            "train_samples_per_s": steps * 32 / phase["train"],
            "state_save_s": ex["state_save_s"],
            "epoch_losses": [h["train_total"] for h in res.history],
            "val_auroc": [h["val_main_auroc"] for h in res.history],
            "best_val_auroc": res.best_metric,
            "test_auroc": res.test_metrics["main_auroc"],
            "reload_max_abs_diff": reload_diff,
            "sidecar": {k: ck["config"].get(k) for k in (
                "n_pretrained_labels", "static_keep_idx")},
            "head_bit_equal": all(np.array_equal(
                ck["params"]["pretrained_cxr_head"]["linear"][k], head[k])
                for k in ("kernel", "bias")),
            "peak_memory_bytes": peak}
        if way == "hbm":
            _keep_ckpt(res.best_path, kept)
        shutil.rmtree(os.path.join(DUAL_RUNS, way), ignore_errors=True)

    # the steady step of each tier, from the kept teacher, on one batch
    tl, eng, F = port["teacher_loop"], port["engine"], port["features"]
    model, tcfg, _ = ck_mod.load_teacher_from_ckpt(kept, device)
    data, host, hook = _train_batch(port, device, tcfg)
    ids, pixels_for_ids = tl.pixels_for_ids_fn(data, hook)
    bank = F.CXRFeatureBank.build(
        F.encode_fn_for_teacher(model, torch.bfloat16), pixels_for_ids, ids)
    trn = port["config"].TrainConfig(batch_size=32)
    tiers = {"pixels": (None, hook(host)),
             "hbm": (bank.feature_source(cls_only=True),
                     bank.host_fn()(host))}
    steady = {}
    for name, (source, batch) in tiers.items():
        m = copy.deepcopy(model)
        state = port["state"].TrainState(m, port["optim"].MultiGroupAdamW(
            m, trn.optim, 100,
            frozen_prefixes=tl.teacher_frozen_prefixes(tcfg)))
        step = eng.make_teacher_step(trn, tcfg.duett, 24,
                                     np.ones(7, np.float32),
                                     feature_source=source)
        dev_batch = eng.to_device(batch, device)
        gen = torch.Generator(device=device).manual_seed(1)
        steady[name] = _steady_step(
            port, device,
            lambda: step(state, data.grid, data.static, dev_batch, gen),
            reps, {"k1_fwd": "flash_fwd", "k2": "gather_rows"})
        del m, state, dev_batch
    del bank, model
    torch.cuda.empty_cache()
    info = {"phase": "dual_teacher", "card": card, "head_ckpt": head_ckpt,
            "runs": runs, "steady": steady, "teacher_ckpt": kept}
    emit(info)
    for way, r in runs.items():
        if not all(np.isfinite(x) for x in r["epoch_losses"]):
            raise AssertionError(f"dual {way}: non-finite losses")
        if r["launches"] != r["expected_launches"]:
            raise AssertionError(f"dual {way}: launches {r['launches']}, "
                                 f"expected {r['expected_launches']}")
        if not r["head_bit_equal"]:
            raise AssertionError(f"dual {way}: the frozen head moved")
        if r["reload_max_abs_diff"] > SERVE_TOL:
            raise AssertionError(f"dual {way}: the reloaded best checkpoint "
                                 "evaluates the val split differently")
    if steady["pixels"]["launches_per_step"] != {"flash_attention":
                                                 n_layers} or \
            steady["hbm"]["launches_per_step"] != {"gather_rows_bulk": 1}:
        raise AssertionError(f"dual steady steps launched "
                             f"{ {k: v['launches_per_step'] for k, v in steady.items()} }")
    return info


def phase_dual_kd(port, device, teacher_ckpt: str, card: str = "") -> dict:
    """The student distilled from the ``dual`` teacher (``cli/
    train_student.main``, the default ``StudentConfig``, 240 stays, batch
    32, 1 epoch of 4 batches, bf16) on the ``hbm`` and ``host`` tiers:
    every kernel's launches over exactly each run (K1 only in the bank
    build; K2 once a KD step on ``hbm``, the CLS bank alone, none on
    ``host``); finite losses; ``host``'s per-step losses equal ``hbm``'s
    bit for bit; each reloaded best checkpoint evaluates the val split as
    its loop did."""
    import math
    n_layers = port["config"].ViTConfig().n_layers
    base = ["--device", "cuda", "--teacher_ckpt", teacher_ckpt,
            "--synthetic_stays", "240", "--batch_size", "32", "--epochs",
            "1", "--limit_batches", "4"]
    runs = {way: _kd_cli_run(port, device,
                             base + ["--cxr_feature_cache", way],
                             os.path.join(DUAL_RUNS, "kd"))
            for way in ("hbm", "host")}
    shutil.rmtree(os.path.join(DUAL_RUNS, "kd"), ignore_errors=True)
    expect = {way: {**dict.fromkeys(r["launches"], 0),
                    "flash_attention": n_layers * math.ceil(
                        r["feature_tier"]["n_images"] / 16),
                    "gather_rows_bulk": r["train_steps"] if way == "hbm"
                    else 0} for way, r in runs.items()}
    info = {"phase": "dual_kd", "card": card, "teacher_ckpt": teacher_ckpt,
            "runs": runs, "expected_launches": expect,
            "host_equals_hbm": runs["host"]["step_losses"]
            == runs["hbm"]["step_losses"]}
    emit(info)
    for way, r in runs.items():
        losses = [x for v in r["step_losses"].values() for x in v]
        if not losses or not all(np.isfinite(x) for x in losses):
            raise AssertionError(f"dual_kd {way}: non-finite or no losses")
        if r["launches"] != expect[way]:
            raise AssertionError(f"dual_kd {way}: launches {r['launches']}, "
                                 f"expected {expect[way]}")
        if r["reload_val_auroc"] != r["best_val_auroc"]:
            raise AssertionError(f"dual_kd {way}: the reloaded best "
                                 "checkpoint evaluates the val split "
                                 "differently")
    if not info["host_equals_hbm"]:
        raise AssertionError("dual_kd: the host tier's per-step losses "
                             "differ from the hbm tier's")
    return info


def _mode_run(port, device, argv: list, tier: str) -> dict:
    """One ``cli/train_teacher.main`` run of the ``modes`` phase: every
    kernel's launches over exactly this run against the ones its steps and
    tier make (K1 12 a pixel train and eval step, else 12 a bank chunk of
    16 images; K2 twice a train and eval step on ``hbm``, the CLS and the
    patch bank), the epochs' losses, and the best checkpoint reloaded and
    evaluated by the loop's own eval."""
    import math

    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(port)
    t0 = time.perf_counter()
    res = port["train_teacher"].main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(port)
    peak = torch.cuda.max_memory_allocated()
    ex = res.extras
    steps, evals = ex["n_train_steps"], ex["n_eval_steps"]
    n_img = ex["feature_tier"].get("n_images", 0)
    n_layers = port["config"].ViTConfig().n_layers
    expect = {**dict.fromkeys(launches, 0),
              "flash_attention": n_layers * (
                  steps + evals if tier == "pixels"
                  else math.ceil(n_img / 16)),
              "gather_rows_bulk": 2 * (steps + evals) if tier == "hbm"
              else 0}
    _, tcfg, _, again, reload_diff = _reload_val(port, res, device)
    loss = "train_loss" if tcfg.perceiver_type == "legacy" \
        else "train_total"
    phase = ex["phase_seconds"]
    return {"argv": argv, "mode": tcfg.perceiver_type, "wall_s": wall,
            "launches": launches, "expected_launches": expect,
            "train_steps": steps, "eval_steps": evals,
            "feature_build_s": phase.get("feature_build"),
            "train_s": phase["train"],
            "train_samples_per_s": steps * 32 / phase["train"],
            "epoch_losses": [h[loss] for h in res.history],
            "val_auroc": [h["val_main_auroc"] for h in res.history],
            "best_val_auroc": res.best_metric,
            "test_auroc": res.test_metrics["main_auroc"],
            "reload_max_abs_diff": reload_diff,
            "reload_val_auroc": again["main_auroc"],
            "peak_memory_bytes": peak, "best_path": res.best_path,
            "history": res.history}


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def phase_modes(port, device, card: str = "", reps: int = 5) -> dict:
    """The teacher's other modes and LP mode (ROADMAP P13) through
    ``cli/train_teacher.main`` at full width (the default ``TeacherConfig``:
    ViT-B/14 at 518, the default DuETT, the perceiver 256 × 4 heads; bf16;
    240 stays, batch 32, 2 epochs): ``single`` and ``dual_patch_event`` on
    ``hbm`` and on pixels (4 batches an epoch), ``legacy`` on pixels with
    its auxiliary CXR head (``--use_aux_cxr --aux_cxr_alpha 0.5``), and LP
    (``--lp_only_correction --lp_ckpt`` the ``dual_patch_event`` ``hbm``
    run's best) on ``hbm``. Each run: every kernel's launches exactly as
    its steps make them, finite losses, the reloaded best checkpoint
    evaluating the val split as its loop did; LP: every parameter but the
    correction head's and β, and every BatchNorm statistic, bit-equal to
    the checkpoint it started from, and β moved. Then the steady bf16 step
    of each mode and tier (CUDA events, median of ``reps``; one step's
    launches; peak memory; ``torch.profiler``); one ``single`` pixel step
    with the ViT trainable (K1's forward, D, dkv and dq 12 launches each);
    a ``dual_patch_event`` checkpoint served over HTTP; a ``single`` one
    refused by ``cli/serve``; two KD steps from the ``single`` teacher on
    ``hbm`` (``cli/train_student``)."""
    import math

    import torch
    shutil.rmtree(MODES_RUNS, ignore_errors=True)
    os.makedirs(MODES_RUNS)
    seconds = {"start": time.perf_counter()}
    base = ["--device", "cuda", "--synthetic_stays", "240", "--batch_size",
            "32", "--epochs", "2", "--no_save_state"]
    hbm = ["--cxr_feature_cache", "hbm"]
    pixels = ["--cxr_feature_cache", "none", "--limit_batches", "4"]
    kept = {m: os.path.join(MODES_RUNS, f"{m}.msgpack")
            for m in ("single", "dual_patch_event")}
    ways = [("single_hbm", ["--perceiver_type", "single"] + hbm),
            ("single_pixels", ["--perceiver_type", "single"] + pixels),
            ("event_hbm", ["--perceiver_type", "dual_patch_event"] + hbm),
            ("event_pixels", ["--perceiver_type", "dual_patch_event"]
             + pixels),
            ("legacy_pixels", ["--perceiver_type", "legacy", "--use_aux_cxr",
                               "--aux_cxr_alpha", "0.5"] + pixels),
            ("lp_hbm", ["--perceiver_type", "dual_patch_event",
                        "--lp_only_correction", "--lp_ckpt",
                        kept["dual_patch_event"]] + hbm)]
    runs = {}
    for way, extra in ways:
        tier = way.rsplit("_", 1)[1]
        run_dir = os.path.join(MODES_RUNS, way)
        r = _mode_run(port, device, base + extra + ["--ckpt_dir", run_dir],
                      tier)
        if way in ("single_hbm", "event_hbm"):
            _keep_ckpt(r["best_path"], kept[r["mode"]])
        if way == "lp_hbm":
            start = port["checkpoint"].load_checkpoint(
                kept["dual_patch_event"])
            end = port["checkpoint"].load_checkpoint(r["best_path"])
            lp = port["teacher_loop"].LP_TRAINABLE
            a, b = _flat(start["params"]), _flat(end["params"])
            r["lp"] = {
                "frozen_bit_equal": all(np.array_equal(a[k], b[k])
                                        for k in a if not k.startswith(lp)),
                "batch_stats_bit_equal": all(
                    np.array_equal(x, _flat(end["batch_stats"])[k])
                    for k, x in _flat(start["batch_stats"]).items()),
                "beta_max_abs_change": float(np.abs(
                    a["perceiver/beta"] - b["perceiver/beta"]).max()),
                "trained_leaves": sorted(k for k in a if k.startswith(lp)),
                "beta_mean_abs_by_epoch": [h["lp_beta_mean_abs"]
                                           for h in r["history"]]}
        del r["history"]
        runs[way] = r
        shutil.rmtree(run_dir, ignore_errors=True)

    seconds["runs"] = time.perf_counter()
    # the steady bf16 step of each mode and tier on one batch of 32
    cfgmod, tl, eng, F = (port["config"], port["teacher_loop"],
                          port["engine"], port["features"])
    optim, st = port["optim"], port["state"]
    data, host, hook = _train_batch(port, device, cfgmod.TeacherConfig())
    trn = cfgmod.TrainConfig(batch_size=32)
    lw = np.ones(7, np.float32)

    def model_of(mode, **kw):
        return port["teacher"].init_teacher(cfgmod.TeacherConfig(
            perceiver_type=mode, **kw), 0).to(device)

    first = model_of("single")
    ids, pixels_for_ids = tl.pixels_for_ids_fn(data, hook)
    bank = F.CXRFeatureBank.build(
        F.encode_fn_for_teacher(first, torch.bfloat16), pixels_for_ids, ids)
    del first
    batches = {"pixels": (None, hook(host)),
               "hbm": (bank.feature_source(), bank.host_fn()(host))}
    steady = {}
    for way in ("single_hbm", "single_pixels", "event_hbm", "event_pixels",
                "legacy_pixels", "lp_hbm"):
        kind, tier = way.rsplit("_", 1)
        mode = {"event": "dual_patch_event", "lp": "dual_patch_event"}.get(
            kind, kind)
        source, batch = batches[tier]
        m = model_of(mode)
        lp = kind == "lp"
        state = st.TrainState(m, optim.MultiGroupAdamW(
            m, trn.optim, 100,
            frozen_prefixes=() if lp else tl.teacher_frozen_prefixes(m.cfg),
            label_fn=tl.lp_frozen_label_fn if lp
            else optim.default_label_fn))
        if mode == "single":
            step = eng.make_teacher_pathology_step(
                trn, m.cfg.duett, 24, lw, feature_source=source)
        elif mode == "legacy":
            step = eng.make_teacher_legacy_step(trn, m.cfg.duett, 24,
                                                aux_alpha=0.5)
        else:
            step = eng.make_teacher_step(trn, m.cfg.duett, 24, lw,
                                         feature_source=source, lp_mode=lp,
                                         lp_beta_l2=1e-3, lp_corr_l2=1e-2)
        dev_batch = eng.to_device(batch, device)
        gen = torch.Generator(device=device).manual_seed(1)
        steady[way] = _steady_step(
            port, device,
            lambda: step(state, data.grid, data.static, dev_batch, gen),
            reps, {"k1_fwd": "flash_fwd", "k2": "gather_rows"})
        del m, state, dev_batch
        torch.cuda.empty_cache()
    del bank, batches
    torch.cuda.empty_cache()
    seconds["steady"] = time.perf_counter()

    # one single pixel step with the ViT trainable: K1's backward
    m = model_of("single", freeze_cxr=False)
    state = st.TrainState(m, optim.MultiGroupAdamW(
        m, trn.optim, 100, frozen_prefixes=tl.teacher_frozen_prefixes(m.cfg)))
    vit_before = m.cxr.patch_embed.weight.detach().clone()
    step = eng.make_teacher_pathology_step(trn, m.cfg.duett, 24, lw)
    dev_batch = eng.to_device(hook(host), device)
    gen = torch.Generator(device=device).manual_seed(1)
    torch.cuda.synchronize()
    reset_counts(port)
    out = step(state, data.grid, data.static, dev_batch, gen)
    torch.cuda.synchronize()
    unfreeze = {"launches": {k: v for k, v in read_counts(port).items()
                             if v},
                "loss": float(out["total"]),
                "vit_moved": not torch.equal(
                    vit_before, m.cxr.patch_embed.weight.detach())}
    del m, state, dev_batch, vit_before
    torch.cuda.empty_cache()

    # a dual_patch_event checkpoint served; a single one refused
    ck = port["checkpoint"]
    event_model, event_cfg, _ = ck.load_teacher_from_ckpt(
        kept["dual_patch_event"], device)
    serve = phase_serve(port, device, event_cfg, n_clients=4,
                        posts_per_client=3, card=card, model=event_model,
                        name="event_serve", buckets=())
    del event_model
    try:
        port["cli_serve"].main(["--ckpt", kept["single"], "--device",
                                "cuda", "--port", "0"])
        refused = None
    except RuntimeError as e:
        refused = str(e)

    # two KD steps from the single teacher on hbm
    kd = _kd_cli_run(port, device, [
        "--device", "cuda", "--teacher_ckpt", kept["single"],
        "--synthetic_stays", "240", "--batch_size", "32", "--epochs", "1",
        "--limit_batches", "2", "--cxr_feature_cache", "hbm",
        "--no_save_state"], os.path.join(MODES_RUNS, "kd"))
    n_layers = cfgmod.ViTConfig().n_layers
    kd["expected_launches"] = {
        **dict.fromkeys(kd["launches"], 0),
        "flash_attention": n_layers * math.ceil(
            kd["feature_tier"]["n_images"] / 16),
        "gather_rows_bulk": 2 * kd["train_steps"]}
    shutil.rmtree(MODES_RUNS, ignore_errors=True)
    seconds["end"] = time.perf_counter()
    marks = list(seconds.values())
    info = {"phase": "modes", "card": card,
            "seconds": dict(zip(("runs", "steady", "unfreeze_serve_kd"),
                                np.diff(marks).tolist())),
            "runs": runs, "steady": steady,
            "unfreeze_step": unfreeze, "serve_single_refused": refused,
            "event_serve": {k: serve[k] for k in (
                "launches", "batches", "samples_per_s",
                "max_abs_diff_response_vs_direct")},
            "single_kd": kd}
    emit(info)
    for way, r in runs.items():
        if not r["epoch_losses"] or \
                not all(np.isfinite(x) for x in r["epoch_losses"]):
            raise AssertionError(f"modes {way}: non-finite losses")
        if r["launches"] != r["expected_launches"]:
            raise AssertionError(f"modes {way}: launches {r['launches']}, "
                                 f"expected {r['expected_launches']}")
        if r["reload_max_abs_diff"] > SERVE_TOL or \
                r["reload_val_auroc"] != r["best_val_auroc"]:
            raise AssertionError(f"modes {way}: the reloaded best checkpoint "
                                 "evaluates the val split differently")
    lp = runs["lp_hbm"]["lp"]
    if not (lp["frozen_bit_equal"] and lp["batch_stats_bit_equal"]) or \
            lp["beta_max_abs_change"] == 0.0:
        raise AssertionError(f"LP trained more than its leaves, or not "
                             f"beta: {lp}")
    for way, r in steady.items():
        want = {"gather_rows_bulk": 2} if way.endswith("hbm") \
            else {"flash_attention": n_layers}
        if r["launches_per_step"] != want:
            raise AssertionError(f"modes steady {way} launched "
                                 f"{r['launches_per_step']}, expected {want}")
    if unfreeze["launches"] != {k: n_layers for k in (
            "flash_attention", "flash_attention_bwd_delta",
            "flash_attention_bwd_dkv", "flash_attention_bwd_dq")} or \
            not np.isfinite(unfreeze["loss"]) or not unfreeze["vit_moved"]:
        raise AssertionError(f"modes unfrozen single step: {unfreeze}")
    if refused is None or "single/legacy" not in refused:
        raise AssertionError(f"cli/serve did not refuse a single "
                             f"checkpoint: {refused}")
    kd_losses = [x for v in kd["step_losses"].values() for x in v]
    if kd["train_steps"] != 2 or not all(np.isfinite(x) for x in kd_losses) \
            or kd["launches"] != kd["expected_launches"]:
        raise AssertionError(f"modes single KD: {kd['launches']}, expected "
                             f"{kd['expected_launches']}, losses "
                             f"{kd_losses}")
    return info


def _history_diff(a: list, b: list) -> float:
    """The largest absolute difference between two runs' per-epoch
    histories (every numeric key), inf when their epochs differ."""
    if len(a) != len(b) or any(x.keys() != y.keys() for x, y in zip(a, b)):
        return float("inf")
    return max((abs(x[k] - y[k]) for x, y in zip(a, b) for k in x),
               default=0.0)


def phase_resume(port, device, card: str = "") -> dict:
    """Resume and preemption of the ``dual_patch`` teacher at full width on
    the ``hbm`` tier through ``cli/train_teacher.main`` (240 stays, batch
    32, 3 epochs of 4 batches, the full state saved every epoch by
    default): an uninterrupted run and a second one (the control: what two
    runs of the same tree differ by on the card); a run paused after one
    epoch (``stop_after_epochs=1``), then ``--resume_dir`` to 3 epochs; and
    the CLI as a subprocess with ``--no_save_state``, sent SIGTERM after
    its first step's log line, which must save the state at the epoch
    boundary and exit 0, then ``--resume_dir`` to 3 epochs. Each resumed
    history is held to RESUME_SPREAD_FACTOR × the control's difference
    (to equality when the control's is 0). Reports each save's seconds
    and the state file's bytes (the saves fall outside the train window
    that ``train_samples_per_s`` times)."""
    import signal

    import torch
    tt = port["train_teacher"]
    shutil.rmtree(RESUME_RUNS, ignore_errors=True)
    base = ["--device", "cuda", "--cxr_feature_cache", "hbm",
            "--synthetic_stays", "240", "--batch_size", "32", "--epochs",
            "3", "--limit_batches", "4"]

    def cli(name, extra=(), **loop_kw):
        """The CLI; ``loop_kw`` (which it has no flag for) handed to the
        loop."""
        train = tt.train_teacher
        if loop_kw:
            tt.train_teacher = lambda *a, **k: train(*a, **k, **loop_kw)
        try:
            return tt.main(base + list(extra) + [
                "--ckpt_dir", os.path.join(RESUME_RUNS, name)])
        finally:
            tt.train_teacher = train

    torch.cuda.synchronize()
    reset_counts(port)
    whole = cli("whole")
    torch.cuda.synchronize()
    launches = read_counts(port)
    control = cli("control")
    paused = cli("paused", stop_after_epochs=1)
    resumed = cli("paused", ["--resume_dir",
                             os.path.dirname(paused.best_path)])

    # the CLI in a process of its own, sent SIGTERM after its first step
    torch.cuda.empty_cache()
    sig_root = os.path.join(RESUME_RUNS, "sigterm")
    cmd = [sys.executable, "-m", f"{PKG}.cli.train_teacher", *base,
           "--no_save_state", "--ckpt_dir", sig_root]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "PYTHONUNBUFFERED": "1"})
    watchdog = threading.Timer(600, proc.kill)
    watchdog.start()
    lines, t_sent = [], None
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            if t_sent is None and line.startswith("step 1 done"):
                proc.send_signal(signal.SIGTERM)
                t_sent = time.perf_counter()
        rc = proc.wait()
        t_exit = time.perf_counter()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    run_dirs = os.listdir(sig_root) if os.path.isdir(sig_root) else []
    sig_dir = os.path.join(sig_root, run_dirs[0]) if run_dirs else ""
    files = sorted(os.listdir(sig_dir)) if sig_dir else []
    stopped = [ln for ln in lines if ln.startswith("SIGTERM/preemption")]
    sig_resumed = cli("sigterm_resume", ["--resume_dir", sig_dir]) \
        if rc == 0 and "train_state.meta.json" in files else None

    spread = _history_diff(control.history, whole.history)
    diffs = {"resumed": _history_diff(resumed.history, whole.history),
             "sigterm_resumed": (_history_diff(sig_resumed.history,
                                               whole.history)
                                 if sig_resumed else float("inf"))}
    bound = RESUME_SPREAD_FACTOR * spread
    ex = whole.extras
    info = {"phase": "resume", "card": card, "argv": base,
            "launches": launches,
            "epochs_paused_run": len(paused.history),
            "resumed_start_epoch": resumed.extras["start_epoch"],
            "control_max_history_diff": spread,
            "max_history_diff": diffs, "bound": bound,
            "state_save_s": ex["state_save_s"],
            "state_bytes": ex["state_bytes"],
            "train_samples_per_s": ex["n_train_steps"] * 32
            / ex["phase_seconds"]["train"],
            "sigterm": {"exit_code": rc, "files": files,
                        "stopped": stopped,
                        "sigterm_to_exit_s": (t_exit - t_sent
                                              if t_sent else None),
                        "log_tail": lines[-6:]},
            "history_whole": whole.history}
    emit(info)
    shutil.rmtree(RESUME_RUNS, ignore_errors=True)
    if len(paused.history) != 1 or resumed.extras["start_epoch"] != 1:
        raise AssertionError("resume: the paused run did not stop after "
                             "one epoch and resume at the second")
    if t_sent is None or rc != 0 or not stopped or not {
            "train_state.msgpack", "train_state.meta.json"} <= set(files):
        raise AssertionError(f"resume: the SIGTERM run did not save and "
                             f"exit 0: {info['sigterm']}")
    if len(sig_resumed.history) != 3:
        raise AssertionError("resume: the SIGTERM run's resume did not "
                             "reach 3 epochs")
    if not max(diffs.values()) <= bound:
        raise AssertionError(f"resume: resumed histories {diffs} differ from "
                             f"the uninterrupted run by more than "
                             f"{RESUME_SPREAD_FACTOR} x the control's "
                             f"{spread}")
    if not all(np.isfinite(h["train_total"]) for h in whole.history):
        raise AssertionError("resume: non-finite losses")
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
    before = dict(att.LAUNCHES)
    with torch.inference_mode():
        cls, patches = model(torch.from_numpy(px).to(device))
    launches = {k: n - before[k] for k, n in att.LAUNCHES.items()}
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
    if device.type == "cuda" and launches != {
            **dict.fromkeys(launches, 0), "flash_attention_f32": cfg.n_layers}:
        raise AssertionError(f"golden ViT launched K1's kernels {launches}, "
                             f"expected the float32 forward {cfg.n_layers} "
                             f"times")
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
                seed: int = 0, card: str = "", model=None,
                name: str = "serve", buckets: tuple = (1, 8, 32)) -> dict:
    """Serve the teacher over HTTP; check every response against a direct
    eval of the batch it was served in; count K1 launches over the run.
    ``model``: the teacher to serve (default: ``init_teacher(cfg, seed)``);
    ``buckets``: the batch sizes whose direct step is timed afterwards."""
    import torch
    att, engine = port["attention"], port["engine"]
    pred_mod, srv = port["predictor"], port["server"]
    if model is None:
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
        reset_counts(port)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        every = read_counts(port)
        launches = every["flash_attention"]
        launches_f32 = every["flash_attention_f32"]
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
    for b in buckets:
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
    info = {"phase": name, "card": card, "requests": n_req,
            "perceiver_type": cfg.perceiver_type,
            "clients": n_clients,
            "batches": stats["n_batches"],
            "batch_size_hist": stats["batch_size_hist"],
            "launches": every,
            "k1_launches": launches, "k1_f32_launches": launches_f32,
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
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    port = import_port()
    cfgmod = port["config"]

    dev = phase_device()
    phase_build(port)
    built = phase_build_facts(port)
    bf16, f32 = torch.bfloat16, torch.float32
    checks = phase_kernels(port, device, [
        ("vit_bf16", 8, 12, 1370, None, bf16, TOL_BF16, True),
        ("bank_build_bf16", 16, 12, 1370, None, bf16, TOL_BF16, True),
        ("pixel_step_bf16", 32, 12, 1370, None, bf16, TOL_BF16, True),
        ("ragged_bf16", 2, 12, 1000, 900, bf16, TOL_BF16, False),
        ("bank_build_f32", 16, 12, 1370, None, f32, TOL_F32, True),
        ("pixel_step_f32", 32, 12, 1370, None, f32, TOL_F32, True),
        ("f32", 2, 12, 1370, 1301, f32, TOL_F32, True),
        # the CXR head's catalog sweep: chunks of 64, float32
        ("cxr_head_f32", 64, 12, 1370, None, f32, TOL_F32, True),
    ])
    bwd = phase_backward(port, device, [
        ("pixel_step_bf16", 32, 12, 1370, None, bf16, TOL_BWD_BF16, True),
        ("ragged_bf16", 2, 12, 1001, 900, bf16, TOL_BWD_BF16, False),
        ("pixel_step_f32", 32, 12, 1370, None, f32, TOL_BWD_F32, True),
        ("f32", 2, 12, 1370, 1301, f32, TOL_BWD_F32, False),
    ])
    k3 = phase_dual_axis(port, device, [
        ("event_bf16", 32, 35, 600, bf16, TOL_FUSED_BF16, "tc"),
        ("time_bf16", 32, 25, 840, bf16, TOL_FUSED_BF16, "tc"),
        ("event_bf16_b128", 128, 35, 600, bf16, TOL_FUSED_BF16, "tc"),
        ("time_bf16_b128", 128, 25, 840, bf16, TOL_FUSED_BF16, "tc"),
        ("event_f32", 32, 35, 600, f32, TOL_FUSED_F32, "tf32"),
        ("time_f32", 32, 25, 840, f32, TOL_FUSED_F32, "tf32"),
        ("event_f32_b128", 128, 35, 600, f32, TOL_FUSED_F32, "tf32"),
        ("time_f32_b128", 128, 25, 840, f32, TOL_FUSED_F32, "tf32"),
        # D % 4 != 0: neither tensor-core route takes it
        ("simt_bf16", 8, 35, 602, bf16, TOL_FUSED_BF16, "simt"),
        ("simt_f32", 8, 35, 602, f32, TOL_FUSED_F32, "simt"),
        # 4 heads x 12: q|k|v's 144 columns span two of the W ring's
        # 128-column chunks
        ("wide_qkv_bf16", 8, 35, 96, bf16, TOL_FUSED_BF16, "tc", (4, 12)),
        ("wide_qkv_f32", 8, 35, 96, f32, TOL_FUSED_F32, "tf32", (4, 12)),
    ])
    k4 = phase_ln_qkv(port, device, [
        ("vit_bf16", 32, 1536, 768, 12, bf16, TOL_FUSED_BF16),
        ("ragged_bf16", 2, 200, 96, 3, bf16, TOL_FUSED_BF16),
        ("vit_f32", 32, 1536, 768, 12, f32, TOL_FUSED_F32),
        ("f32", 2, 512, 256, 4, f32, TOL_FUSED_F32),
    ])
    k3_checks = {way: read_counts(port)[kernel] for way, kernel in
                 port["dual_axis"].ROUTE_KERNELS.items()}
    k4_checks = read_counts(port)["ln_qkv"]
    k4_f32_checks = read_counts(port)["ln_qkv_f32"]
    golden = phase_golden(port, device, cfgmod.ViTConfig(), GOLDEN)
    block = phase_block_grad(port, device)
    serve = phase_serve(port, device, cfgmod.TeacherConfig(), n_clients=12,
                        posts_per_client=4, card=dev["nvidia_smi"])

    gathers = phase_gather(port, device)
    train = phase_train(port, device, card=dev["nvidia_smi"])
    phase_tiers(port, device, cfgmod.TeacherConfig(),
                gathers["patch_bf16"]["ms"] + gathers["cls_bf16"]["ms"])
    f32_train = phase_f32_train(port, device, card=dev["nvidia_smi"])
    unfreeze = phase_unfreeze(port, device, card=dev["nvidia_smi"])
    phase_unfreeze_step(port, device, cfgmod.TeacherConfig())
    f32_unfreeze = phase_unfreeze(port, device, card=dev["nvidia_smi"],
                                  f32=True)
    phase_unfreeze_step(port, device, cfgmod.TeacherConfig(),
                        dtype="float32")
    ssl = phase_ssl(port, device, card=dev["nvidia_smi"])
    trained = phase_trained_layer(port, device, ssl)
    to_teacher = phase_ssl_to_teacher(port, device, ssl["best_path"],
                                      card=dev["nvidia_smi"])
    kd = phase_kd(port, device, to_teacher["teacher_ckpt"], ssl["best_path"],
                  card=dev["nvidia_smi"])
    cxr = phase_cxr_head(port, device, card=dev["nvidia_smi"])
    dual = phase_dual_teacher(port, device, cxr["ckpt_path"],
                              card=dev["nvidia_smi"])
    dual_kd = phase_dual_kd(port, device, dual["teacher_ckpt"],
                            card=dev["nvidia_smi"])
    dual_model, dual_cfg, _ = port["checkpoint"].load_teacher_from_ckpt(
        dual["teacher_ckpt"], device)
    dual_serve = phase_serve(port, device, dual_cfg, n_clients=4,
                             posts_per_client=3, card=dev["nvidia_smi"],
                             model=dual_model, name="dual_serve", buckets=())
    del dual_model
    shutil.rmtree(DUAL_RUNS, ignore_errors=True)
    modes = phase_modes(port, device, card=dev["nvidia_smi"])
    resume = phase_resume(port, device, card=dev["nvidia_smi"])

    # K1's four rows take their launches from the unfrozen training run,
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
        return {**earlier, "ssl": n_ssl[name], "ssl_to_teacher": n_s2t[name],
                "kd": {way: r["launches"][name]
                       for way, r in kd["runs"].items()},
                "cxr_head": cxr["launches"][name],
                "dual_teacher": {way: r["launches"][name]
                                 for way, r in dual["runs"].items()},
                "dual_kd": {way: r["launches"][name]
                            for way, r in dual_kd["runs"].items()},
                "dual_serve": dual_serve["launches"][name],
                "resume": resume["launches"][name],
                "modes": {way: r["launches"][name]
                          for way, r in modes["runs"].items()},
                "modes_unfreeze_step": modes["unfreeze_step"]["launches"]
                .get(name, 0),
                "event_serve": modes["event_serve"]["launches"][name],
                "single_kd": modes["single_kd"]["launches"][name]}

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
    # the float32 routes (--mixed_precision no, the goldens, the block's
    # gradient), each counted under its own key. K1's forward takes its
    # launches, its case and its times from the float32 training run's
    # bank build, at [16, 12, 1370, 64]; the pixel step's [32, ...] times
    # stand beside them. The backward's float32 kernels (D, dkv, dq) take
    # theirs from the float32 fine-tuning run (f32_unfreeze), whose K1 work
    # is the pixel step's batch of 32; the full-width block's gradient
    # stands under launches_by_path. K3 and K4 have no caller.
    # tc_bound_ms: the same work as 3xTF32 tensor-core products.
    k1f, k1p, bf = checks["bank_build_f32"], checks["pixel_step_f32"], \
        bwd["pixel_step_f32"]
    case_f32 = "pixel_step_f32 [32, 12, 1370, 64]"
    n_f32, n_fu = f32_train["launches"], f32_unfreeze["launches"]

    def f32_by_path(name, **earlier):
        return by_path(name, f32_train=n_f32[name], unfreeze=n_k1[name],
                       f32_unfreeze=n_fu[name],
                       block_grad=block["launches"].get(name, 0), **earlier)

    f32_rows = [
        {"name": "flash_attention_fwd_f32", "route": "cuda",
         "source": K1_SOURCE, "replaces": K1_REPLACES,
         "launches": n_f32["flash_attention_f32"],
         "launches_by_path": f32_by_path(
             "flash_attention_f32", serve=serve["k1_f32_launches"],
             train=train["k1_f32_launches"],
             golden=golden["kernel_launches"]["flash_attention_f32"]),
         "case": "bank_build_f32 [16, 12, 1370, 64]",
         "bit_equal_rerun": k1f["bit_equal_rerun"],
         "fwd_vs_library": k1f["fwd_vs_library"],
         "tc_bound_ms": k1f["tc_bound_ms"], **built["fwd_f32"],
         **{k: k1f[k] for k in keys},
         "pixel_step": {"case": case_f32, "ms_with_lse": bf["fwd_lse_ms"],
                        "max_abs_err": k1p["max_abs_err"],
                        **{k: k1p[k] for k in (
                            "ms", "library_ms", "fwd_vs_library", "bound_ms",
                            "tc_bound_ms", "plain_ms")}},
         "cxr_head": {"case": "cxr_head_f32 [64, 12, 1370, 64]",
                      **{k: checks["cxr_head_f32"][k] for k in (
                          "max_abs_err", "ms", "library_ms",
                          "fwd_vs_library", "bound_ms", "tc_bound_ms",
                          "plain_ms")}}},
        {"name": "flash_attention_bwd_delta_f32", "route": "cuda",
         "source": K1_BWD_SOURCE, "replaces": K1_DELTA_REPLACES,
         "launches": n_fu["flash_attention_bwd_delta_f32"],
         "launches_by_path": f32_by_path("flash_attention_bwd_delta_f32"),
         "case": case_f32, "max_abs_err": bf["delta_max_abs_err"],
         "ms": bf["delta_ms"], "plain_ms": bf["delta_plain_ms"],
         "bound_ms": bf["delta_bound_ms"], "bound_by": "bytes",
         "tc_bound_ms": bf["delta_bound_ms"],
         **{k: bf[f"delta_{k}"] for k in DELTA_LIBRARY_KEYS}},
        *[{"name": f"flash_attention_bwd_{kind}_f32", "route": "cuda",
           "source": K1_BWD_SOURCE, "replaces": replaces,
           "launches": n_fu[f"flash_attention_bwd_{kind}_f32"],
           "launches_by_path": f32_by_path(f"flash_attention_bwd_{kind}_f32"),
           "case": case_f32,
           "max_abs_err": max(bf["max_abs_err"][g] for g in grads),
           "ms": bf[f"{kind}_ms"], "plain_ms": bf["plain_ms"],
           "bound_ms": bf[f"{kind}_bound_ms"],
           "bound_by": bf[f"{kind}_bound_by"],
           "tc_bound_ms": bf[f"{kind}_tc_bound_ms"],
           "library_ms": bf["library_ms"], "pair_ms": bf["pair_ms"],
           "pair_vs_library": bf["pair_vs_library"],
           "delta_ms": bf["delta_ms"], "backward_ms": bf["backward_ms"],
           "backward_vs_library": bf["backward_vs_library"],
           **built[f"{kind}_f32"]}
          for kind, replaces, grads in (
              ("dkv", K1_DKV_REPLACES, ("dk", "dv")),
              ("dq", K1_DQ_REPLACES, ("dq",)))],
        {"name": "gather_rows_bulk_f32", "route": "cuda",
         "source": K2_SOURCE, "replaces": K2_REPLACES,
         "launches": f32_train["k2_launches"],
         "launches_by_path": {"f32_train": f32_train["k2_launches"],
                              "modes": "none: every modes run is bf16, "
                              "its banks bf16"},
         "case": "patch_f32 [401, 1370, 768] x 32 rows",
         "tc_bound_ms": gathers["patch_f32"]["bound_ms"],
         **{k: gathers["patch_f32"][k] for k in keys + (
             "vs_library", "device_ms", "library_device_ms")}},
        {"name": "dual_axis_block_tf32", "route": "cuda",
         "source": K3_TF32_SOURCE, "replaces": K3_REPLACES,
         "launches": n_ssl["dual_axis_block_tf32"],
         "launches_by_path": by_path("dual_axis_block_tf32"),
         "check_launches": {"kernel_check": k3_checks["tf32"],
                            "trained_layer": trained["tf32_launches"]},
         "case": "time_f32 [32, 25, 840]",
         "routes": {c: k3[c]["route"] for c in k3 if "route" in k3[c]},
         "device_ms_by_case": {c: k3[c]["device_ms"] for c in k3
                               if k3[c].get("dtype") == "float32"},
         "build_event": built["k3_tf32"], **built["k3_tf32_time"],
         **{k: k3["time_f32"][k] for k in keys + (
             "tc_bound_ms", "device_ms", "device_busy_ms",
             "plain_device_ms")}},
        {"name": "ln_qkv_f32", "route": "cuda", "source": K4_SOURCE,
         "replaces": K4_REPLACES,
         "launches": n_f32["ln_qkv_f32"],
         "launches_by_path": by_path("ln_qkv_f32",
                                     f32_train=n_f32["ln_qkv_f32"]),
         "check_launches": {"kernel_check": k4_f32_checks},
         "case": "vit_f32 [32, 1536, 768] 12 x 64",
         "library_calls": k4["vit_f32"]["library_calls"],
         "tc_bound_ms": k4["vit_f32"]["tc_bound_ms"], **built["k4_f32"],
         **{k: k4["vit_f32"][k] for k in keys + ("vs_library",)}}]
    # a 3xTF32 kernel can go under bound_ms (float32 FMA), never under
    # tc_bound_ms: each row gives the share of both
    for row in f32_rows:
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["tc_share_of_bound"] = row["tc_bound_ms"] / row["ms"]
    delta_row = {
        "name": "flash_attention_bwd_delta", "route": "cuda",
        "source": K1_BWD_SOURCE, "replaces": K1_DELTA_REPLACES,
        "launches": n_k1["flash_attention_bwd_delta"],
        "launches_by_path": by_path(
            "flash_attention_bwd_delta",
            unfreeze=n_k1["flash_attention_bwd_delta"]),
        "case": case, "max_abs_err": b["delta_max_abs_err"],
        "max_rel_err": b["delta_max_rel_err"], "ms": b["delta_ms"],
        "plain_ms": b["delta_plain_ms"], "bound_ms": b["delta_bound_ms"],
        "bound_by": "bytes",
        **{k: b[f"delta_{k}"] for k in DELTA_LIBRARY_KEYS},
        "backward_ms": b["backward_ms"],
        "backward_vs_library": b["backward_vs_library"]}
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES,
         "launches": n_k1["flash_attention"],
         "launches_by_path": by_path(
             "flash_attention", serve=serve["k1_launches"],
             train=train["k1_launches_in_bank_build"],
             unfreeze=n_k1["flash_attention"]),
         "case": case, "ms_with_lse": b["fwd_lse_ms"],
         "fwd_vs_library": k1["fwd_vs_library"], **built["fwd"],
         **{k: k1[k] for k in keys}},
        delta_row,
        *bwd_rows,
        {"name": "gather_rows_bulk", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": train["k2_launches"],
         "case": "patch_bf16 [401, 1370, 768] x 32 rows",
         "launches_by_path": by_path(
             "gather_rows_bulk", train=train["k2_launches"],
             f32_train=f32_train["k2_launches"]),
         "vector_launches_by_path": by_path(
             "gather_rows", train=train["k2_vector_launches"]),
         "routes": {c: gathers[c]["route"] for c in gathers},
         "ms_by_case": {c: gathers[c]["ms"] for c in gathers},
         "device_ms_by_case": {c: gathers[c]["device_ms"] for c in gathers},
         **{k: k2[k] for k in keys + (
             "vs_library", "device_ms", "library_device_ms",
             "device_vs_library", "gb_per_s", "share_of_peak_bytes")}},
        {"name": "dual_axis_block_tc", "route": "cuda",
         "source": K3_TC_SOURCE, "replaces": K3_REPLACES,
         "launches": n_ssl["dual_axis_block_tc"],
         "launches_by_path": by_path("dual_axis_block_tc"),
         "check_launches": {"kernel_check": k3_checks["tc"],
                            "trained_layer": trained["tc_launches"]},
         "case": "time_bf16 [32, 25, 840]",
         "routes": {c: k3[c]["route"] for c in k3 if "route" in k3[c]},
         "ms_by_case": {c: k3[c]["ms"] for c in k3 if "ms" in k3[c]},
         "device_ms_by_case": {c: k3[c]["device_ms"] for c in k3
                               if "device_ms" in k3[c]},
         **built["k3_tc"],
         **{k: k3["time_bf16"][k] for k in keys + (
             "device_ms", "device_busy_ms", "plain_device_ms")}},
        {"name": "dual_axis_block", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": n_ssl["dual_axis_block"],
         "launches_by_path": by_path("dual_axis_block"),
         "check_launches": {"kernel_check": k3_checks["simt"],
                            "trained_layer": trained["launches"]
                            - trained["tc_launches"]
                            - trained["tf32_launches"]},
         "case": "simt_f32 [8, 35, 602]",
         "tc_share_of_bound": k3["simt_f32"]["tc_bound_ms"]
         / k3["simt_f32"]["ms"],
         "simt_bf16": {k: k3["simt_bf16"][k] for k in keys + (
             "device_ms", "plain_device_ms")},
         **{k: k3["simt_f32"][k] for k in keys + (
             "tc_bound_ms", "device_ms", "device_busy_ms",
             "plain_device_ms")}},
        {"name": "ln_qkv", "route": "cuda", "source": K4_SOURCE,
         "replaces": K4_REPLACES, "launches": n_ssl["ln_qkv"],
         "launches_by_path": by_path("ln_qkv"),
         "check_launches": {"kernel_check": k4_checks},
         "case": "vit_bf16 [32, 1536, 768] 12 x 64",
         "library_calls": k4["vit_bf16"]["library_calls"],
         **built["k4"],
         **{k: k4["vit_bf16"][k] for k in keys + ("vs_library",
                                                  "share_of_bound")}},
        *f32_rows]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
