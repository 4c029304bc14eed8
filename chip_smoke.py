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
            checked against a direct eval of the batch it was served in
            (each batch a replay of its bucket's CUDA graph, recorded at
            the predictor's ``_forward``); K1's launches counted over
            exactly this run, replays included.
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
            With ``--grad_diag_every 1 --grad_diag_batches 1`` the loop
            runs the gradient-flow diagnostics on one val batch of 32 in
            float32 (K1's float32 forward, D, dkv and dq 12 each): the
            logged numbers finite, the image branch's pixel gradient > 0.
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
            that teacher and the SSL checkpoint (SHORT_STAYS stays, batch
            32, 1 epoch of 4 batches, bf16) on each image tier: ``none``,
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
            --pretrained_cxr_head_ckpt`` (SHORT_STAYS stays, batch 32, 2
            epochs) on
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
19. resume  the ``dual_patch`` teacher on ``hbm`` (2 epochs of 4 batches,
            120 stays):
            an uninterrupted run and a control run (both
            ``--no_save_state``), a run paused after one
            epoch and resumed with ``--resume_dir``, the same on
            ``--state_backend orbax`` (K1/K2 launches counted), and the CLI
            as two subprocesses (msgpack, orbax) sent SIGTERM after their
            first step (exit 0, the state saved at the boundary), resumed;
            resumed histories within RESUME_SPREAD_FACTOR x the control's
            difference; the saves' seconds (orbax: host copy and background
            write), both backends' state bytes, the orbax restore's
            seconds; the committed orbax golden
            (``tests/goldens/orbax_state``) read without orbax to its
            recorded arrays.

The teacher's other modes and LP mode (ROADMAP P13's second half) add:

20. modes  ``cli/train_teacher.main`` at full width (SHORT_STAYS stays,
            batch 32,
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

Real chest X-rays (ROADMAP P15: the JPEG decoder, the image feed tiers, the
prefetcher) add:

21. jpeg  SHORT_STAYS stays: the cohort's 205 JPEGs (512 x 416), the
            catalog's 546 (384 x
            320) and 8 at MIMIC-CXR-JPG's 3056 x 2544, grayscale, written
            by ``scripts/jpeg_fixtures.py``; what the host offers a decoder
            and the route the port takes (libjpeg built with g++, or
            nvJPEG and the resize kernel ``csrc/jpeg_resize.cu`` on the
            card, held against its plain version and within JPEG_LEVELS of
            the rows libjpeg decoded, ``tests/goldens/jpeg_rows_56.npz``);
            decode images/s of the MIMIC-size files; the teacher CLI with
            ``--cxr_jpeg_root`` on the card's u8 bank, ``stream`` with
            ``--prefetch_depth`` 2 and 0 (losses bit-equal), the disk u8
            store built and reopened (losses bit-equal to the bank's) and
            the encode-once tier, each run's launches exactly as its steps,
            tier and decoder route make them; the teacher CLI without JPEGs
            (procedural pixels, and the encode-once tier) at
            ``--prefetch_depth`` 0 and 2 (losses bit-equal); each tier's
            steady step and host feed, and a ``stream`` batch's feed at
            MIMIC size; one unfrozen step from the bank; the CXR head's CLI
            over the catalog's JPEGs; ``cli/serve``'s ``jpeg_root`` startup
            serving clients by image id (K2 2 a batch, K1 0), served =
            direct, an unknown id answering NaN. The summary gains the
            resize kernel's two rows (u8, float32) and the ``jpeg`` paths
            under every row's ``launches_by_path``.

The supervised DuETT recipe (ROADMAP P14), the inference CLI and serving's
``synthetic`` mode (P17) add:

3.  kernels  K1 bf16 at ``cli/predict``'s [64, 12, 1370, 64] (timed) and
            at the remainder of its default split, [62, 12, 1370, 64].
22. finetune  ``cli/finetune_mimic.main`` at its defaults from the SSL
            phase's best checkpoint (500 stays, batch 64, seeds 0 1 2,
            top-k 5), the epochs cut to FINETUNE_EPOCHS, in float32 and
            with ``--mixed_precision bf16``: every kernel's launches (0),
            each seed's test AUPRC on the averaged and on the best
            weights, the averaged weights on the card bit-equal to a CPU
            average of the same ``ft-*.msgpack`` files; the steady step
            of each dtype (CUDA events, peak memory, ``torch.profiler``).
23. physionet  ``cli/train_physionet.main`` at its defaults (400 synthetic
            patients), SSL and fine-tuning epochs cut to PHYSIONET_EPOCHS:
            wall seconds, the summary, every kernel's launches (0).
24. predict  ``cli/predict.main`` on the train phase's teacher, on
            procedural pixels and on ``--cxr_feature_cache hbm``, at batch
            64 and 16: launches of the bank's build and of the eval apart
            (K1 12 a pixel batch; 12 a build chunk, then K2 2 and K1 0 a
            batch), samples/s, the NPZ's keys and shapes; the tiers within
            PREDICT_BATCH_TOL at both batches (a shifted bank row beyond
            it), their time series' outputs bit-equal.
25. synthetic_serve  that teacher served over HTTP with the ``synthetic``
            image source: K1 12 a batch, served = direct, the card's
            procedural pixels against the CPU's (SYNTHETIC_PIXEL_TOL).
26. analysis  the analysis suite's first half (ROADMAP P19a), each
            script's ``main``, on 400 synthetic stays: trajectory
            availability; residual by confidence, complementarity, the
            logit-fusion probe, the temporal-usage counterfactuals and the
            unimodal probes on the train phase's teacher (complementarity
            and the counterfactuals also on ``--cxr_feature_cache hbm``,
            complementarity's pair again in float32: its per-label
            floats, and the counterfactuals' per-condition AUROCs, within
            ANALYSIS_TIER_TOL, their per-sample archives within
            PREDICT_BATCH_TOL, a shifted row beyond it);
            the gradient-flow diagnostics on that teacher (pixel gradients
            exactly 0, no K1 backward) and on the unfreeze phase's (K1's
            float32 D, dkv and dq 12 each); the ICU-hardness study on the
            cxr_head phase's head (G1 + G2 + G3 = G0). Each run's launches
            predicted and asserted (``analysis_run`` lines: wall seconds,
            the eval's samples/s, the bank build's seconds).
27. analysis_b  the analysis suite's second half (ROADMAP P19b) on the
            same cohort and teacher: the conditional-information probes
            over the 7 labels on pixels (bf16), and on label 0 on pixels
            and on ``--cxr_feature_cache hbm`` in float32 (the four
            probes' AUROCs within ANALYSIS_TIER_TOL; a bank that hands
            each image the next image's tokens beyond it); the raw
            trajectory probe over the 7 labels (3 folds, 2
            permutations); the figure suite with ``--dim_reduce auto``
            (UMAP) and ``tsne`` (both projections
            and the token t-SNE finite, [N·K, 2] and [N, 2]; the CSVs);
            the trajectory-encoder probe (d_model 128, 3 epochs: finite
            AUROCs, no kernel launched, its checkpoint reloaded into the
            port's probe reads the logged validation AUROC). Each run's
            launches predicted and asserted (``analysis_b_run`` lines:
            wall seconds, eval samples/s, the UMAP's and t-SNE's seconds,
            the probe's steps/s).

The opt-in extras (ROADMAP P20) add:

28. int8  the int8 ops (``ops/int8.py``) at ViT-B's shapes (43,840
            tokens; the q/k/v and output projections, both MLP layers,
            bf16, one float32 case, one of fewer than 17 rows): codes,
            scales and int32 accumulators equal the exact plain product,
            outputs equal the op on that product, and the CPU plain
            version of the first INT8_CPU_ROWS tokens gives the same codes
            and scales (its output's gap reported); one [43,840 × 768] ×
            [768 × 3,072] product, bf16 ``matmul`` against
            ``torch._int_mm`` in alternation, the quantize pass and the
            whole ``int8_dense``, with their bounds; the golden ViT-B/14
            at 518² int8 against unquantized in float32 and bf16 (CLS
            error under INT8_CLS_TOL of its max abs, cosine over
            INT8_MIN_COS; K1 12 and 72 int8 products a forward); both
            forwards at batch 32, timed in alternation and profiled under
            ``utils/profiling.trace``; ``cli/train_teacher --vit_quant
            int8`` on procedural pixels and on ``--cxr_feature_cache
            hbm`` (1 epoch of 4 batches of 32; every kernel's launches and
            the int8 products predicted and asserted, finite losses); the
            pixel run's checkpoint served at buckets 1 and 8 (K1 12 a
            batch), its fusion probabilities against the same weights
            served unquantized beside a shifted-row control.

Data parallelism over processes (ROADMAP P18) adds, right after the
build:

29. parallel  ranks as worker processes of this script (``--parallel-worker
            RANK WORLD PORT DIR``; each loads the built kernels), the
            ``dual_patch`` teacher at the CLI's widths (ViT-B/14 at 518²)
            in float32, 1 epoch of 3 global batches of 32, procedural
            pixels (PARALLEL_ARGV): (a) one rank in an NCCL group, its
            pixel run bit-equal to the same run with no group, an
            all-reduce through NCCL, and the encode-once run with the
            batches composed for 2 partitions; (b), started with (a) and
            run beside it, two ranks sharing the
            card over gloo, 16 rows each, the pixel run and the encode-once
            run (each rank encoding its ``image_id % 2`` share into a host
            store): the ranks agree to PARALLEL_RANKS_TOL, rank 0 equals
            (a) within JAX's two-process tolerances, only rank 0 wrote
            files, each rank's K1 launches as predicted (12 a ViT forward
            of its rows; 12 a build chunk of its share) and K2 none; each
            rank's step time and the phase's seconds; ``--data_parallel
            1`` serving bit-equal to the predictor without it, 2 refused on
            a one-card host. Multi-step dispatch across processes (ROADMAP
            P10b): on each gloo rank the encode-once run again at K =
            PARALLEL_K (a loop, its log line), in the world-1 NCCL group
            the encode-once teacher (PARALLEL_K_ARGV, bf16, 2 epochs of 5
            batches of 16) at K = 1 and K = PARALLEL_K (captured: two
            graphs, the groups' and the remainder's), K = PARALLEL_K
            bit-equal to K = 1 (history, a digest of the weights, moments,
            step count and generator, launches); the encode-once runs
            take 5 batches (a group of 4 and a remainder); an
            all-reduce captured in a ``torch.cuda.CUDAGraph`` in the NCCL
            group, replayed twice ([0]×4 after the capture, [2]×4 after
            the replays), with the NCCL version and any warning. A rank
            that fails, finds no card or runs past PARALLEL_RANK_TIMEOUT
            fails the phase. ``python3 chip_smoke.py --only-parallel``
            runs the device, build and parallel phases alone (no summary,
            no ``ok`` line). The gradient-flow diagnostics over processes
            (ROADMAP P18b): the pixel runs (world 1 with and without its
            group, each gloo rank) take ``--grad_diag_every 1
            --grad_diag_batches 1``; each rank's ``grad_diag/*`` equals the
            other's within PARALLEL_RANKS_TOL and world 1's within the
            loss and metric tolerances (per key: PARALLEL_LOSS_RTOL
            relative or PARALLEL_METRIC_TOL absolute), world 1's with and
            without its group are equal, and K1's predicted launches count
            the diagnostics' val batch (12 a forward, no backward through
            the frozen ViT).

L0 preprocessing without pandas (ROADMAP P21) adds, after ``int8``:

30. l0      the port's ``data/synthetic_raw`` writes a raw MIMIC-IV +
            MIMIC-CXR layout of 24 subjects (seed 0) and one of
            L0_SUBJECTS (seed 1); ``cli/preprocess.main`` turns each into
            ``cohort.npz`` + ``meta_with_stats.pkl`` (seconds, raw rows
            read and rows/s on the card's host CPU, stays, event rows,
            anchors); the 24-subject cohort's arrays hash to L0_DIGESTS
            (the JAX package's ``run_l0`` output on the same layout, held
            in ``tests/test_torch_preprocess_cli.py``; a mismatch names the
            array). Feather without pyarrow (ROADMAP P21c): the same 24
            subjects as pyarrow wrote them (``tests/goldens/feather_l0``,
            LZ4 and ZSTD, ``scripts/make_feather_goldens.py``) go through
            the CLI and hash to L0_DIGESTS too; the large layout is
            converted to feather by the port alone (``read_csv`` →
            ``write_feather``, LZ4: groundwork cell 3) and preprocessed
            again, its 22 arrays and ``meta_with_stats.pkl`` equal to the
            CSV route's, its audit ``.ftr`` files read back equal to
            ``raw_mimic.build_audit_frames`` in memory; each codec's
            encode and decode MB/s on the card's host CPU; ``pandas``,
            ``pyarrow``, ``PIL``, ``zstandard``, ``lz4`` and
            ``flatbuffers`` are not in ``sys.modules``; then
            ``cli/train_teacher`` on the feather route's large cohort
            (``--data_dir``) at full width on procedural pixels in bf16, 1
            epoch of L0_LIMIT_BATCHES batches of 32: finite losses and K1's
            launches as predicted from the cohort's splits before the call
            (12 a train step and an eval step). Before it, the host
            data-path ops (``densify_events_native``,
            ``gather_windows_native``, g++ from ``csrc/host/data_ops.cpp``)
            on that cohort and on the synthetic one at 2,000 stays
            (NATIVE_SYNTHETIC) against the port's main path (numpy
            densify within rtol 1e-6, the card's window gather bit for
            bit, 1 thread and all the host's cores bit-equal), each
            route's host milliseconds and the thread count.

RAD-DINO weights with no JAX on the card's host add, after ``golden``:

32. rad_dino  a seeded ViT-B/14 state dict in Hugging Face's names and
            shapes (``hf_dinov2_shapes``, 518², ~86.6 M float32 values)
            written as ``model.safetensors`` in numpy, with ``config.json``
            and ``preprocessor_config.json``; ``cli/convert_rad_dino.main``
            on that directory with ``transformers`` and ``safetensors``
            hidden from the call (the route of a host without them: it
            must print that the conversion is unverified), and where this
            host has ``transformers``, the file's ViT in float32 on the
            CPU against ``Dinov2Model`` (atol 2e-4, rtol 1e-3; a process
            of its own on 2 host threads beside the later phases, its line
            ``rad_dino_vs_transformers`` after ``multistep``); every
            converted array equal to its source after the mapping's
            transposes (``hf_to_flax``, written apart from the
            converters); the full-width ViT from the file through K1
            against the same ViT through ``flash_mha_reference`` (bf16
            within TOL_BF16 of each output's max abs; float32 within the
            golden phase's atol 2e-4, rtol 1e-3), 12 launches a forward;
            ``cli/train_teacher.main --vit_weights`` at full width on
            procedural pixels (bf16, SHORT_STAYS stays, 1 epoch of
            RAD_DINO_LIMIT batches of RAD_DINO_BATCH): K1 12 a train and
            eval step, finite losses, the best checkpoint's ViT bit-equal
            to the converted file's.

Serving's bucket graphs and ``--aot_dir`` (ROADMAP P10b) add, after
``serve``:

31. aot_serve  two worker processes of this script (``--aot-worker DIR
            cold|warm``), each warming a pixel-mode predictor on the
            full-width teacher (seeded weights, buckets 1..32, bf16) with
            ``aot_dir`` DIR/aot: the cold one on a fresh directory (every
            bucket a miss, every kernel library built into the entry; it
            runs beside the parallel phase's ranks), the warm one after it (every bucket a hit, every library found: no
            nvcc run); each one's warm-up seconds and
            ``torch.cuda.memory_reserved``; then, in the warm one, every
            bucket's replay against the eager step on random inputs (bit
            for bit, K1 12 a batch, replays counted), the direct step at
            buckets 1, 8 and 32 eagerly and as a replay (host ms to the
            outputs on the host, the device ms of back-to-back replays,
            each route's idle share), and ``jpeg_root`` through the graphs
            (AOT_JPEG_IMAGES JPEGs encoded once; a batch of 8 ids bit-equal
            to the eager step, K2 2 launches, an unknown id NaN).

Every phase line carries ``t_s``, the seconds since the script started.
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

import atexit
import base64
import copy
import functools
import hashlib
import importlib.util
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
ORBAX_GOLDEN = os.path.join(REPO, "tests", "goldens", "orbax_state")
MODES_RUNS = os.path.join(REPO, "build", "chip_smoke_modes")
TRAIN_BEST = os.path.join(REPO, "build", "chip_smoke_train_best.msgpack")
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
# the cohort of the kd, dual_teacher, dual_kd, modes, resume and jpeg phases:
# 120 synthetic stays (145 train anchors, 4 batches of 32; 205 images a
# bank build, 546 in the catalog), cut from 240 (405 images, 775) for the
# time limit when the aot_serve phase and the parallel phase's multi-step
# runs were added
SHORT_STAYS = "120"


T_START = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (``t_s``), which say where the run's time goes."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T_START, 3)}
    print(json.dumps(obj), flush=True)


def import_port():
    """The port's modules this script drives, which bring in every module of
    the port (kept in one place so that a test can import exactly this set
    and check that it covers the port and that no JAX comes with it)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from multimodal_edema_prediction_tpu_torch import config, convert
    from multimodal_edema_prediction_tpu_torch.analysis import (
        complementarity, conditional_information_probe,
        diagnose_temporal_usage, grad_flow_diagnostics, logit_fusion_probe,
        raw_trajectory_conditional_probe, residual_by_confidence,
        train_trajectory_probe, trajectory_availability, tsne, umap_impl,
        unimodal_linear_probe, visualize_pathology, why_we_need_multimodal)
    from multimodal_edema_prediction_tpu_torch.analysis import \
        common as analysis_common
    from multimodal_edema_prediction_tpu_torch.cli import serve as cli_serve
    from multimodal_edema_prediction_tpu_torch.cli import (finetune_mimic,
                                                           predict,
                                                           train_cxr_head,
                                                           train_physionet,
                                                           train_ssl,
                                                           train_student,
                                                           train_teacher)
    from multimodal_edema_prediction_tpu_torch.cli import \
        preprocess as cli_preprocess
    from multimodal_edema_prediction_tpu_torch.cli import \
        convert_rad_dino as cli_convert_rad_dino
    from multimodal_edema_prediction_tpu_torch.data import (features, images,
                                                            ingest,
                                                            native_loader,
                                                            physionet,
                                                            pipeline,
                                                            prefetch,
                                                            sliding,
                                                            synthetic)
    from multimodal_edema_prediction_tpu_torch.data import (cxr_catalog,
                                                            demographics,
                                                            frames,
                                                            jpeg_writer,
                                                            preprocess,
                                                            prompts,
                                                            raw_mimic,
                                                            reports,
                                                            static_info,
                                                            subtype,
                                                            synthetic_raw,
                                                            text_embeddings)
    from multimodal_edema_prediction_tpu_torch.models import (duett, student,
                                                              teacher,
                                                              trajectory,
                                                              vit)
    from multimodal_edema_prediction_tpu_torch.ops import (attention, build,
                                                           dual_axis, gather,
                                                           int8, jpeg, ln_qkv,
                                                           lupi_losses)
    from multimodal_edema_prediction_tpu_torch.parallel import (mesh,
                                                                multihost)
    from multimodal_edema_prediction_tpu_torch.serve import predictor, server
    from multimodal_edema_prediction_tpu_torch.train import (checkpoint,
                                                             cxr_head_loop,
                                                             engine,
                                                             finetune_loop,
                                                             kd_loop, loops,
                                                             optim,
                                                             orbax_io,
                                                             ssl_loop,
                                                             state,
                                                             teacher_loop)
    from multimodal_edema_prediction_tpu_torch.utils import (crc32c, logging,
                                                             lz4, ocdbt,
                                                             preemption,
                                                             profiling,
                                                             safetensors_io,
                                                             zarr2, zstd)
    from multimodal_edema_prediction_tpu_torch.data import arrow_ipc
    return dict(int8=int8, lupi_losses=lupi_losses, logging=logging,
                profiling=profiling, config=config, convert=convert,
                teacher=teacher, vit=vit,
                duett=duett, attention=attention, build=build, gather=gather,
                dual_axis=dual_axis, ln_qkv=ln_qkv, predictor=predictor,
                server=server, engine=engine, checkpoint=checkpoint,
                optim=optim, state=state, teacher_loop=teacher_loop,
                ssl_loop=ssl_loop, features=features, pipeline=pipeline,
                sliding=sliding, synthetic=synthetic, ingest=ingest,
                cli_serve=cli_serve, train_teacher=train_teacher,
                train_ssl=train_ssl, student=student, kd_loop=kd_loop,
                train_student=train_student, train_cxr_head=train_cxr_head,
                cxr_head_loop=cxr_head_loop, preemption=preemption,
                orbax_io=orbax_io, crc32c=crc32c, ocdbt=ocdbt, zarr2=zarr2,
                images=images, native_loader=native_loader,
                prefetch=prefetch, jpeg=jpeg, physionet=physionet,
                finetune_loop=finetune_loop, loops=loops,
                finetune_mimic=finetune_mimic,
                train_physionet=train_physionet, predict=predict,
                analysis_common=analysis_common,
                complementarity=complementarity,
                diagnose_temporal_usage=diagnose_temporal_usage,
                grad_flow_diagnostics=grad_flow_diagnostics,
                logit_fusion_probe=logit_fusion_probe,
                residual_by_confidence=residual_by_confidence,
                trajectory_availability=trajectory_availability,
                unimodal_linear_probe=unimodal_linear_probe,
                why_we_need_multimodal=why_we_need_multimodal,
                conditional_information_probe=conditional_information_probe,
                raw_trajectory_conditional_probe=(
                    raw_trajectory_conditional_probe),
                visualize_pathology=visualize_pathology, tsne=tsne,
                umap_impl=umap_impl,
                train_trajectory_probe=train_trajectory_probe,
                trajectory=trajectory, mesh=mesh, multihost=multihost,
                cli_preprocess=cli_preprocess, raw_mimic=raw_mimic,
                synthetic_raw=synthetic_raw, frames=frames,
                static_info=static_info, cxr_catalog=cxr_catalog,
                preprocess=preprocess, demographics=demographics,
                subtype=subtype, prompts=prompts, reports=reports,
                text_embeddings=text_embeddings, jpeg_writer=jpeg_writer,
                arrow_ipc=arrow_ipc, lz4=lz4, zstd=zstd,
                cli_convert_rad_dino=cli_convert_rad_dino,
                safetensors_io=safetensors_io)


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
    from concurrent.futures import ThreadPoolExecutor
    build = port["build"]
    info = {"phase": "build_facts"}
    serialised = {"C7511", "C7514", "C7515"}
    libs = ("flash_attention", "flash_attention_bwd", "ln_qkv",
            "dual_axis_block_tc", "dual_axis_block_tf32")
    for lib in libs:
        build.load(lib)
    # one cuobjdump a library, all started together
    with ThreadPoolExecutor(len(libs)) as pool:
        listings = dict(zip(libs, pool.map(build.sass, libs)))
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
        listing = listings[lib]
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


def _train_batch(port, device, cfg, n_stays: int = 240) -> tuple:
    """The steady-step phases' data: the synthetic cohort of the train
    phase (``n_stays`` stays) on ``device``, one shuffled train batch of 32
    (host arrays) and the procedural pixel hook."""
    cfgmod, P, S = port["config"], port["pipeline"], port["synthetic"]
    dcfg = cfgmod.DataConfig()
    ds = S.make_synthetic(seed=0, n_stays=n_stays, n_subjects=n_stays // 3,
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
    # the predict and synthetic serving phases read this teacher
    info["teacher_ckpt"] = _keep_ckpt(res.best_path, TRAIN_BEST)
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
    # the predict and synthetic serving phases read this teacher
    info["teacher_ckpt"] = _keep_ckpt(res.best_path, TRAIN_BEST)
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
            "gemm": ("gemm", "xmma", "cutlass", "cublas", "sm90_", "sm80_",
                     "nvjet"),
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
        # device activity alone: the readings below take device events
        # only, and tracing the host's operators too made each reading of
        # a training step take ~9 s instead of ~2 on an H100's host
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:       # no CUPTI on this machine: say so
        return {"device_time": f"not measured ({e})"}
    # device-side events only (kernels, copies, memsets)
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
    else:
        # the loop's gradient-flow diagnostics on one val batch, float32
        argv += ["--grad_diag_every", "1", "--grad_diag_batches", "1"]
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
    diag = {k: v for k, v in res.history[-1].items()
            if k.startswith("grad_diag/")}
    if not f32:
        # the diagnostics batch: one float32 ViT forward, and its backward
        # for the image branch's pixel gradient
        for name in ("flash_attention", "flash_attention_bwd_delta",
                     "flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
            expect[att.launch_key(name, torch.float32)] = n
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
            "grad_diag_s": ex["phase_seconds"].get("grad_diag"),
            "grad_diag_keys": len(diag),
            "grad_diag_img_px_input_grad": diag.get(
                "grad_diag/img_px_input_grad"),
            "peak_memory_bytes": peak}
    emit(info)
    if not f32:
        # the analysis phase's unfrozen teacher
        _keep_ckpt(res.best_path, UNFREEZE_BEST)
    shutil.rmtree(RUNS, ignore_errors=True)
    if not f32 and not (diag and all(np.isfinite(v) for v in diag.values())
                        and diag["grad_diag/img_px_input_grad"] > 0):
        raise AssertionError(f"the loop's gradient-flow diagnostics: {diag}")
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


KERNEL_MODULES = ("attention", "gather", "dual_axis", "ln_qkv", "jpeg")


def reset_counts(port) -> None:
    for name in KERNEL_MODULES:
        port[name].reset_launches()
    port["int8"].reset_calls()


def read_counts(port) -> dict:
    """Every kernel's launches: by C entry point, and K1's and K4's float32
    kernels under their own keys (``flash_attention_f32``, ...)."""
    return {k: v for name in KERNEL_MODULES
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
    backbone: SHORT_STAYS stays, batch 32, 1 epoch of 4 batches, bf16, on
    each
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
            "--duett_ckpt", ssl_ckpt, "--synthetic_stays", SHORT_STAYS,
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


def _steady_step(port, device, run, reps: int, watch: dict,
                 batch: int = 32) -> dict:
    """One step's launches (counts set to 0 just before it), then ``reps``
    steady steps timed by CUDA events (median), their peak memory, and a
    ``torch.profiler`` reading of 3 more (device busy time, idle share,
    ``watch``'s kernels, time by family); ``batch`` samples a step."""
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
            "samples_per_s": batch * 1e3 / step_ms,
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
    ``TeacherConfig``, bf16), SHORT_STAYS stays, batch 32: 2 epochs on the
    ``hbm``
    tier (K2 once a train and eval step, the CLS bank alone; K1 in the bank
    build only) and 1 epoch of 4 batches on the pixel tier (K1 12 a train
    and eval step). Every kernel's launches over exactly each run; finite
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
            SHORT_STAYS, "--batch_size", "32", "--epochs", "2"]
    ways = {"hbm": ["--cxr_feature_cache", "hbm"],
            # 1 epoch of 4 batches (cut from 2 for the time limit)
            "pixels": ["--cxr_feature_cache", "none", "--limit_batches", "4",
                       "--epochs", "1"]}
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
    train_student.main``, the default ``StudentConfig``, SHORT_STAYS stays,
    batch
    32, 1 epoch of 4 batches, bf16) on the ``hbm`` and ``host`` tiers:
    every kernel's launches over exactly each run (K1 only in the bank
    build; K2 once a KD step on ``hbm``, the CLS bank alone, none on
    ``host``); finite losses; ``host``'s per-step losses equal ``hbm``'s
    bit for bit; each reloaded best checkpoint evaluates the val split as
    its loop did."""
    import math
    n_layers = port["config"].ViTConfig().n_layers
    base = ["--device", "cuda", "--teacher_ckpt", teacher_ckpt,
            "--synthetic_stays", SHORT_STAYS, "--batch_size", "32",
            "--epochs", "1", "--limit_batches", "4"]
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
    int8_calls = dict(port["int8"].CALLS)
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
            "int8_calls": int8_calls, "history": res.history}


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
    SHORT_STAYS stays, batch 32, 1 epoch, 4 batches of it on pixels):
    ``single``
    and ``dual_patch_event`` on ``hbm`` and on pixels, ``legacy`` on pixels
    with
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
    # 1 epoch a run (cut from 2 to keep the script within its time limit)
    base = ["--device", "cuda", "--synthetic_stays", SHORT_STAYS,
            "--batch_size", "32", "--epochs", "1", "--no_save_state"]
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

    inits = {}

    def model_of(mode, **kw):
        """A fresh copy of the mode's seed-0 teacher on the card (each
        configuration initialized once on the host)."""
        key = (mode, tuple(sorted(kw.items())))
        if key not in inits:
            inits[key] = port["teacher"].init_teacher(cfgmod.TeacherConfig(
                perceiver_type=mode, **kw), 0).to(device)
        return copy.deepcopy(inits[key])

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
    inits.clear()
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
        "--synthetic_stays", SHORT_STAYS, "--batch_size", "32", "--epochs",
        "1",
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


def _orbax_golden(port) -> dict:
    """The committed orbax store that the JAX package's orbax wrote
    (``tests/goldens/orbax_state``, ``scripts/make_orbax_goldens.py``: zstd
    nodes and chunks, its two-level layout), read with the port's reader
    on a host with no orbax, against its recorded arrays."""
    t0 = time.perf_counter()
    got = port["orbax_io"].read_arrays(os.path.join(
        ORBAX_GOLDEN, "1", port["orbax_io"].ITEM))
    seconds = time.perf_counter() - t0
    z = np.load(os.path.join(ORBAX_GOLDEN, "expected.npz"))
    dtypes = json.loads(str(z["__dtypes__"]))
    bad = sorted(set(got) ^ set(dtypes)) + [
        k for k, (a, dt) in got.items() if k in dtypes and (
            dt != dtypes[k] or a.dtype != z[k].dtype
            or not np.array_equal(a, z[k]))]
    return {"arrays": len(got), "dtypes": sorted(set(dtypes.values())),
            "read_s": seconds, "mismatched": bad[:5]}


def phase_resume(port, device, card: str = "") -> dict:
    """Resume and preemption of the ``dual_patch`` teacher at full width on
    the ``hbm`` tier through ``cli/train_teacher.main`` (120 stays, cut
    from 240 for the time limit; batch 32, 2 epochs of 4 batches (cut from
    3 for the time limit), the
    full state saved every epoch by default): an uninterrupted run and a
    second one (the control: what two runs of the same tree differ by on
    the card), both with ``--no_save_state`` (for the time limit: a save
    falls outside what their histories read); a run paused after one epoch
    (``stop_after_epochs=1``), then
    ``--resume_dir`` to 2 epochs; the same pause and resume on
    ``--state_backend orbax`` (K1's and K2's launches counted over those
    two runs); and the CLI as two subprocesses with ``--no_save_state``
    (run beside those six), one on each backend, each sent SIGTERM after
    its first step's log line, which must save the state at the epoch
    boundary (orbax: committed before the exit) and exit 0, then
    ``--resume_dir --no_save_state`` to 2 epochs. Each resumed history is
    held to
    RESUME_SPREAD_FACTOR × the control's difference (to equality when the
    control's is 0). Reports each save's seconds (orbax: the host copy in
    the loop and the background write), the state's bytes on both
    backends, the orbax restore's seconds (the saves fall outside the train
    window that ``train_samples_per_s`` times), and the committed orbax
    golden read without orbax (``_orbax_golden``)."""
    import signal

    import torch
    tt = port["train_teacher"]
    shutil.rmtree(RESUME_RUNS, ignore_errors=True)
    golden = _orbax_golden(port)
    base = ["--device", "cuda", "--cxr_feature_cache", "hbm",
            "--synthetic_stays", SHORT_STAYS, "--batch_size", "32",
            "--epochs", "2", "--limit_batches", "4"]
    orbax = ["--state_backend", "orbax"]

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

    def sigterm_cli(root, extra=()):
        """The CLI in a process of its own, sent SIGTERM after its first
        step; it runs beside the in-process runs (for the script's time
        limit)."""
        cmd = [sys.executable, "-m", f"{PKG}.cli.train_teacher", *base,
               *extra, "--no_save_state", "--ckpt_dir", root]
        run = {"root": root, "lines": [], "sent": {},
               "proc": subprocess.Popen(
                   cmd, cwd=REPO, stdout=subprocess.PIPE,
                   stderr=subprocess.STDOUT, text=True,
                   env={**os.environ, "PYTHONUNBUFFERED": "1"})}
        run["watchdog"] = threading.Timer(600, run["proc"].kill)
        run["watchdog"].start()

        def read():
            proc, sent = run["proc"], run["sent"]
            for line in proc.stdout:
                run["lines"].append(line.rstrip())
                # the CLI's Logger prefixes each line with "[teacher +s] "
                if "t" not in sent and "] step 1 done" in line:
                    proc.send_signal(signal.SIGTERM)
                    sent["t"] = time.perf_counter()
            proc.wait()
            sent["exit"] = time.perf_counter()

        run["reader"] = threading.Thread(target=read, daemon=True)
        run["reader"].start()
        return run

    def sigterm_end(run) -> dict:
        run["watchdog"].cancel()
        if run["proc"].poll() is None:
            run["proc"].kill()
            run["proc"].wait()
        run["reader"].join()
        root, sent = run["root"], run["sent"]
        dirs = os.listdir(root) if os.path.isdir(root) else []
        d = os.path.join(root, dirs[0]) if dirs else ""
        t_sent, t_exit = sent.get("t"), sent.get("exit")
        return {"exit_code": run["proc"].returncode, "dir": d,
                "files": sorted(os.listdir(d)) if d else [],
                "stopped": [ln for ln in run["lines"]
                            if "] SIGTERM/preemption" in ln],
                "sent": t_sent is not None,
                "sigterm_to_exit_s": (t_exit - t_sent if t_sent else None),
                "log_tail": run["lines"][-6:]}

    sig_runs = {"msgpack": sigterm_cli(os.path.join(RESUME_RUNS, "sigterm")),
                "orbax": sigterm_cli(os.path.join(RESUME_RUNS,
                                                  "sigterm_orbax"), orbax)}
    try:
        torch.cuda.synchronize()
        reset_counts(port)
        whole = cli("whole", ["--no_save_state"])
        torch.cuda.synchronize()
        launches = read_counts(port)
        control = cli("control", ["--no_save_state"])
        paused = cli("paused", stop_after_epochs=1)
        resumed = cli("paused", ["--resume_dir",
                                 os.path.dirname(paused.best_path)])
        torch.cuda.synchronize()
        reset_counts(port)
        ob_paused = cli("orbax", orbax, stop_after_epochs=1)
        ob_resumed = cli("orbax", orbax + [
            "--resume_dir", os.path.dirname(ob_paused.best_path)])
        torch.cuda.synchronize()
        ob_launches = read_counts(port)
        for run in sig_runs.values():
            run["reader"].join()
    finally:
        sig = {way: sigterm_end(run) for way, run in sig_runs.items()}
    torch.cuda.empty_cache()
    ob_dir = os.path.dirname(ob_paused.best_path)
    ob_steps = port["orbax_io"].make_manager(
        os.path.join(ob_dir, "orbax_state")).all_steps()
    sig_state = {"msgpack": {"train_state.msgpack"}, "orbax": {"orbax_state"}}
    for way, r in sig.items():
        r["saved"] = r["exit_code"] == 0 and (
            sig_state[way] | {"train_state.meta.json"}) <= set(r["files"])
        if way == "orbax" and r["saved"]:
            r["orbax_steps"] = port["orbax_io"].make_manager(os.path.join(
                r["dir"], "orbax_state")).all_steps()
            r["saved"] = r["orbax_steps"] == [0]
    sig_resumed = {way: cli(f"sigterm_{way}_resume", (
        orbax if way == "orbax" else []) + ["--resume_dir", r["dir"],
                                            "--no_save_state"])
        if r["saved"] else None for way, r in sig.items()}

    spread = _history_diff(control.history, whole.history)
    diffs = {"resumed": _history_diff(resumed.history, whole.history),
             "orbax_resumed": _history_diff(ob_resumed.history,
                                            whole.history),
             **{f"sigterm_{way}_resumed": (
                 _history_diff(r.history, whole.history) if r
                 else float("inf")) for way, r in sig_resumed.items()}}
    bound = RESUME_SPREAD_FACTOR * spread
    ex, ob = whole.extras, ob_paused.extras
    info = {"phase": "resume", "card": card, "argv": base,
            "launches": launches, "orbax_launches": ob_launches,
            "epochs_paused_run": len(paused.history),
            "resumed_start_epoch": resumed.extras["start_epoch"],
            "control_max_history_diff": spread,
            "max_history_diff": diffs, "bound": bound,
            # the paused run's save (epoch 0) and its resume's (epoch 1)
            "state_save_s": paused.extras["state_save_s"]
            + resumed.extras["state_save_s"],
            "state_bytes": paused.extras["state_bytes"],
            "orbax": {"epochs_paused_run": len(ob_paused.history),
                      "resumed_start_epoch": ob_resumed.extras[
                          "start_epoch"],
                      "save_copy_s": ob["state_save_s"],
                      "save_write_s": ob["state_write_s"],
                      "resumed_save_copy_s": ob_resumed.extras[
                          "state_save_s"],
                      "resumed_save_write_s": ob_resumed.extras[
                          "state_write_s"],
                      "state_bytes": ob["state_bytes"],
                      "restore_s": ob_resumed.extras["state_restore_s"],
                      "steps_kept": ob_steps, "golden": golden},
            "train_samples_per_s": ex["n_train_steps"] * 32
            / ex["phase_seconds"]["train"],
            "sigterm": sig["msgpack"], "sigterm_orbax": sig["orbax"],
            "history_whole": whole.history}
    emit(info)
    shutil.rmtree(RESUME_RUNS, ignore_errors=True)
    if golden["mismatched"] or golden["dtypes"] != ["<f4", "<i4",
                                                    "bfloat16"]:
        raise AssertionError(f"resume: the orbax golden read {golden}")
    for runs, what in (((paused, resumed), "msgpack"),
                       ((ob_paused, ob_resumed), "orbax")):
        if len(runs[0].history) != 1 or runs[1].extras["start_epoch"] != 1:
            raise AssertionError(f"resume: the paused {what} run did not "
                                 "stop after one epoch and resume at the "
                                 "second")
    if ob_steps != [0, 1] or not ob["state_bytes"]:
        raise AssertionError(f"resume: orbax steps {ob_steps}, "
                             f"{ob['state_bytes']} bytes")
    for k in ("flash_attention", "gather_rows_bulk"):
        if not ob_launches.get(k):
            raise AssertionError(f"resume: no {k} launch on the orbax runs "
                                 f"({ob_launches})")
    for way, r in sig.items():
        if not (r["sent"] and r["stopped"] and r["saved"]):
            raise AssertionError(f"resume: the {way} SIGTERM run did not "
                                 f"save and exit 0: {r}")
        if len(sig_resumed[way].history) != 2:
            raise AssertionError(f"resume: the {way} SIGTERM run's resume "
                                 "did not reach 2 epochs")
    if not max(diffs.values()) <= bound:
        raise AssertionError(f"resume: resumed histories {diffs} differ from "
                             f"the uninterrupted run by more than "
                             f"{RESUME_SPREAD_FACTOR} x the control's "
                             f"{spread}")
    if not all(np.isfinite(h["train_total"]) for h in whole.history):
        raise AssertionError("resume: non-finite losses")
    return info


JPEG_RUNS = os.path.join(REPO, "build", "chip_smoke_jpeg")
# the cohort's files (one per anchor image), the catalog's, and the decode
# timing's MIMIC-CXR-JPG-size ones: grayscale, quality 90
JPEG_COHORT_SHAPE = (512, 416)
JPEG_CATALOG_SHAPE = (384, 320)
JPEG_N_FULL = 8
# the card route (nvJPEG + the resize kernel) against the rows libjpeg
# decoded (tests/goldens/jpeg_rows_56.npz), grayscale files, in levels:
# another inverse DCT, then the same bilinear resize
JPEG_LEVELS = 2
# the resize kernel against its plain version, the same float32 bilinear
# sample whose position (y + 0.5)·sy − 0.5 the kernel contracts into one
# FMA: the weights may move by an ulp of a coordinate (≤ 2^-11 for a side
# ≤ 4096), times a neighbour step ≤ 255 levels, ≤ 0.125 levels. u8: the
# one level a rounding half may move; float32: 0.125 / 255 / the smallest
# std (0.224) ≈ 2.2e-3 of the normalized scale
TOL_RESIZE_U8 = 1.0
TOL_RESIZE_F32 = 3e-3
JPEG_RESIZE_SOURCE = f"{PKG}/csrc/jpeg_resize.cu"
JPEG_RESIZE_REPLACES = (
    "native/mmedema_native.cpp:130 bilinear_at, :152 "
    "decode_jpeg_resize_normalize, :173 decode_jpeg_resize_u8 (host C++; "
    "no TPU kernel: the card's decode where the host has no libjpeg)")


def _write_fixtures(ids, shape, out_dir, J) -> dict:
    """``{id}.jpg`` for each id from ``scripts/jpeg_fixtures.py``, split
    over 8 runs of that script as subprocesses; {"files", "bytes",
    "shape", "seconds"}."""
    t0 = time.perf_counter()
    sizes = J.write_jpegs(out_dir, ids, *shape, processes=8)
    return {"files": len(sizes), "bytes": int(sum(sizes.values())),
            "shape": list(shape), "seconds": time.perf_counter() - t0}


def _decoder_probe(port) -> dict:
    """What the host offers a JPEG decoder, and the route the port takes."""
    nl = port["native_loader"]
    flags = ""
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("flags"):
                flags = line
                break
    try:
        ld = subprocess.run(["ldconfig", "-p"], capture_output=True,
                            text=True).stdout
        libs = sorted({ln.split()[0] for ln in ld.splitlines()
                       if "jpeg" in ln})
    except OSError as e:
        libs = [f"ldconfig: {e}"]
    gxx = shutil.which("g++")
    return {"route": nl.route(),
            "gxx": subprocess.run([gxx, "--version"], capture_output=True,
                                  text=True).stdout.splitlines()[0]
            if gxx else None,
            "jpeglib_h": [p for p in nl.JPEG_HEADERS if os.path.exists(p)],
            "shared_libraries": libs,
            "nvjpeg": port["jpeg"].nvjpeg_available(),
            "cpu_avx2": " avx2 " in flags, "cpu_fma": " fma " in flags}


def _resize_source_rows(H: int, side: int) -> int:
    """How many of an ``H``-row source's rows the resize to ``side`` rows
    reads: rows y0 and y0 + 1 of each output row, the position computed in
    float32 as the kernel computes it."""
    sy = np.float32(H) / np.float32(side)
    fy = (np.arange(side, dtype=np.float32) + np.float32(0.5)) * sy \
        - np.float32(0.5)
    y0 = np.clip(np.floor(fy), 0, H - 1).astype(np.int64)
    return len(np.union1d(y0, np.minimum(y0 + 1, H - 1)))


def _resize_check(port, device, full_blob: bytes) -> dict:
    """The resize kernel at the main path's shapes (a MIMIC-size grayscale
    file decoded on the card → 518², uint8 and float32) against its plain
    version, timed with the plain version, a PyTorch yardstick
    (``F.interpolate``, bilinear, on the float image) and the bound."""
    import torch
    import torch.nn.functional as F
    jp, vit = port["jpeg"], port["vit"]
    mean, std = vit.IMAGE_MEAN, vit.IMAGE_STD
    if port["native_loader"].route() == "nvjpeg":
        dec = jp.decoder(device)
        src = dec.decode(full_blob)
        dec.stream.synchronize()
    else:       # the libjpeg route's full-size image, copied to the card
        import sys as _sys
        _sys.path.insert(0, os.path.join(REPO, "scripts"))
        import jpeg_fixtures as J
        src = torch.from_numpy(J.cxr_like(7, *J.MIMIC_CXR_SHAPE)[..., None])
        src = src.to(device)
    H, W, C = src.shape
    rows = _resize_source_rows(H, 518)
    out = {}
    for kind, m, s in (("u8", None, None), ("f32", mean, std)):
        got = jp.jpeg_resize(src, 518, m, s)
        want = jp.jpeg_resize_reference(src, 518, m, s)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        rerun = torch.equal(got, jp.jpeg_resize(src, 518, m, s))
        out_bytes = 518 * 518 * 3 * (1 if m is None else 4)
        # the source rows bilinear_at reads, each whole: a row's 2 · 518
        # sampled columns, ~4.9 apart, touch every 32-byte sector of it
        nbytes = rows * W * C + out_bytes
        # ~15 float operations an output value (two lerps of two, the
        # weights, and for float32 the scale and normalization)
        ops = 15 * 518 * 518 * 3
        bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, \
            ops / PEAK_F32_FLOPS * 1e3
        x = src.permute(2, 0, 1)[None]
        ms, plain_ms, lib_ms = paired_ms([
            lambda: jp.jpeg_resize(src, 518, m, s),
            lambda: jp.jpeg_resize_reference(src, 518, m, s),
            lambda: F.interpolate(x.float(), size=(518, 518),
                                  mode="bilinear", align_corners=False)],
            device)
        out[kind] = {"case": f"[{H}, {W}, {C}] uint8 → [518, 518, 3] "
                             f"{'uint8' if m is None else 'float32'}",
                     "source_rows_read": rows, "bytes_moved": nbytes,
                     "max_abs_err": err, "bit_equal_rerun": rerun,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "library_call": "F.interpolate(bilinear, "
                                     "align_corners=False) of the float "
                                     "image, the cast included",
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations"}
        tol = TOL_RESIZE_U8 if m is None else TOL_RESIZE_F32
        if err > tol or not rerun:
            raise AssertionError(f"jpeg_resize {kind}: max abs err {err} "
                                 f"(tolerance {tol}), rerun {rerun}")
    return out


def _golden_check(port) -> dict:
    """The route's rows of ``tests/goldens/jpeg_rows_56.npz`` against the
    rows libjpeg decoded there: per file, the max level difference and its
    distribution (u8) and the float32 max abs difference."""
    images = port["images"]
    g = np.load(os.path.join(REPO, "tests", "goldens", "jpeg_rows_56.npz"))
    blobs = [g["blob"][a:b].tobytes()
             for a, b in zip(g["offsets"][:-1], g["offsets"][1:])]
    vit = port["vit"]
    u8 = images.host_pixels(images.decode_batch_u8(blobs, 56))
    f32 = images.host_pixels(images.decode_batch(blobs, 56, vit.IMAGE_MEAN,
                                                 vit.IMAGE_STD))
    files = []
    for i in range(len(blobs)):
        d = u8[i].astype(int) - g["u8"][i].astype(int)
        vals, counts = np.unique(d, return_counts=True)
        files.append({"gray": bool(g["gray"][i]),
                      "u8_max_levels": int(np.abs(d).max()),
                      "u8_level_counts": dict(zip(map(str, vals.tolist()),
                                                  counts.tolist())),
                      "f32_max_abs": float(np.abs(f32[i] - g["f32"][i])
                                           .max())})
    return {"files": files,
            "gray_max_levels": max(f["u8_max_levels"] for f in files
                                   if f["gray"])}


def _decode_under_load(port, device, blobs: list, reps: int = 4) -> dict:
    """Fault F5's check: ``decode_batch`` of ``blobs`` while a thread keeps
    the default stream busy with products (as the training step does while
    the prefetch worker decodes) against the same decode on an idle card;
    the number of files that differ in each repetition (0 on either
    route)."""
    import torch
    images, vit = port["images"], port["vit"]

    def decode():
        return images.host_pixels(images.decode_batch(
            blobs, 518, vit.IMAGE_MEAN, vit.IMAGE_STD))

    idle = decode()
    x = torch.randn(8192, 8192, device=device)
    stop = threading.Event()

    def busy():
        y = x
        while not stop.is_set():
            for _ in range(20):
                y = (y @ x) * 1e-4
            torch.cuda.synchronize()

    th = threading.Thread(target=busy)
    th.start()
    try:
        differing = [int((np.abs(decode() - idle).reshape(len(blobs), -1)
                          .max(1) > 0).sum()) for _ in range(reps)]
    finally:
        stop.set()
        th.join()
    del x
    return {"files": len(blobs), "differing_files": differing}


def _decode_rates(port, blobs: list) -> dict:
    """Images/s of ``decode_batch_u8`` and ``decode_batch`` over the
    MIMIC-size files at 518, with 1 and 4 threads (median of 3)."""
    images, vit = port["images"], port["vit"]
    out = {}
    for threads in (1, 4):
        for kind in ("u8", "f32"):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                if kind == "u8":
                    images.decode_batch_u8(blobs, 518, n_threads=threads)
                else:
                    images.decode_batch(blobs, 518, vit.IMAGE_MEAN,
                                        vit.IMAGE_STD, n_threads=threads)
                times.append(time.perf_counter() - t0)
            out[f"{kind}_threads{threads}_images_per_s"] = \
                len(blobs) / statistics.median(times)
    return out


def _jpeg_cli_run(port, device, argv: list, way: str, route: str) -> dict:
    """One ``cli/train_teacher.main`` run, from the cohort's JPEGs or (with
    no ``--cxr_jpeg_root``) procedural pixels: every kernel's launches over
    exactly this run against the ones its steps, its tier and the decoder
    route make; the losses; the train window's samples/s."""
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
    ex = res.extras
    steps, evals = ex["n_train_steps"], ex["n_eval_steps"]
    itier = ex["image_tier"]
    n_layers = port["config"].ViTConfig().n_layers
    features = way == "features"
    n_img = ex["feature_tier"]["n_images"] if features else \
        itier.get("n_images", 0)
    card = route == "nvjpeg" and "--cxr_jpeg_root" in argv
    # the card route's resize launches: one a decoded file. The bank and
    # a new u8 store decode every image once (u8); a stream run every
    # train and eval batch, padded to 32 (float32); the encode-once build
    # every image once (float32); a reopened store none
    decoded_u8 = n_img if way in ("hbm", "u8_store") else 0
    decoded_f32 = 32 * (steps + evals) if way.startswith("stream") else (
        n_img if features else 0)
    expect = {**dict.fromkeys(launches, 0),
              "flash_attention": n_layers * (
                  math.ceil(n_img / 16) if features else steps + evals),
              "gather_rows_bulk": 2 * (steps + evals) if features else 0,
              "jpeg_resize_u8": decoded_u8 if card else 0,
              "jpeg_resize_f32": decoded_f32 if card else 0}
    phase = ex["phase_seconds"]
    return {"argv": [a for a in argv[argv.index("--no_save_state") + 1:]
                     if not a.startswith(JPEG_RUNS)],
            "wall_s": wall, "launches": launches,
            "expected_launches": expect, "train_steps": steps,
            "eval_steps": evals, "image_tier": itier,
            "feature_build_s": phase.get("feature_build"),
            "train_s": phase["train"],
            "train_samples_per_s": steps * 32 / phase["train"],
            "history": res.history,
            "epoch_losses": [h["train_total"] for h in res.history],
            "val_auroc": [h["val_main_auroc"] for h in res.history],
            "test_auroc": res.test_metrics["main_auroc"],
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "best_path": res.best_path}


def _losses(history: list) -> list:
    """Each epoch's mean train losses (every ``train_`` key)."""
    return [{k: v for k, v in h.items() if k.startswith("train_")}
            for h in history]


def _feed_ms(hook, host: dict, device, reps: int = 3) -> float:
    """Median ms of one batch's host feed: the hook, then the copy to the
    card (``engine.to_device``), host clock to a sync."""
    import torch
    from multimodal_edema_prediction_tpu_torch.train import engine
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.to_device(hook(dict(host)), device)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_jpeg(port, device, card: str = "", reps: int = 5) -> dict:
    """Real chest X-rays (ROADMAP P15) at full width: the default
    ``TeacherConfig`` (ViT-B/14 at 518, DuETT over 34 variables, bf16),
    SHORT_STAYS synthetic stays (205 images), batch 32, their JPEGs written
    by
    ``scripts/jpeg_fixtures.py``.

    The host's decoder facts and the route taken; on the card route
    (nvJPEG + ``csrc/jpeg_resize.cu``) the golden rows within JPEG_LEVELS
    of libjpeg's and the resize kernel against its plain version; decode
    images/s of MIMIC-size files (1 and 4 threads, u8 and float32). The
    teacher CLI with ``--cxr_jpeg_root`` on each tier (the card's u8 bank,
    ``stream`` with prefetch depth 2 and 0, the disk u8 store built then
    reopened: 4 batches; the encode-once tier: a whole epoch; 1 epoch a
    run), each
    run's launches exactly as its steps, tier and route make them, the
    stream runs' losses bit-equal, the store's and the bank's too; the
    prefetcher's A/B without JPEGs (procedural pixels, the encode-once
    tier: depth 0 and 2, losses bit-equal); each tier's steady step
    (CUDA events, peak memory, ``torch.profiler``) and host feed, and the
    ``stream`` feed of 32 MIMIC-size files; one unfrozen step from the bank (K1's forward, D, dkv, dq
    12 each); the CXR head's CLI over the catalog's 546 JPEGs (K1's float32
    forward 108 launches); ``cli/serve``'s ``jpeg_root`` startup (every
    file encoded once) serving clients by image id (K2 2 a batch, K1 0),
    served = direct within SERVE_TOL, an unknown id NaN."""
    import math

    import torch
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import jpeg_fixtures as J
    shutil.rmtree(JPEG_RUNS, ignore_errors=True)
    os.makedirs(JPEG_RUNS)
    seconds = {"start": time.perf_counter()}
    cfgmod, P, S = port["config"], port["pipeline"], port["synthetic"]
    dcfg = cfgmod.DataConfig()
    ds = S.make_synthetic(seed=0, n_stays=int(SHORT_STAYS),
                          n_subjects=int(SHORT_STAYS) // 3, n_variables=34)
    anchor_ids = np.unique(P.build_anchor_dataset(
        ds, P.meta_from_events(ds, dcfg), dcfg).anchor["image_ids"])
    cohort = os.path.join(JPEG_RUNS, "cohort")
    catalog = os.path.join(JPEG_RUNS, "catalog")
    fixtures = {
        "cohort": _write_fixtures(anchor_ids, JPEG_COHORT_SHAPE, cohort, J),
        "catalog": _write_fixtures(ds.cxr_catalog.image_ids,
                                   JPEG_CATALOG_SHAPE, catalog, J)}
    mimic = os.path.join(JPEG_RUNS, "mimic_size")
    fixtures["mimic_size"] = _write_fixtures(range(JPEG_N_FULL),
                                             J.MIMIC_CXR_SHAPE, mimic, J)
    full = [port["images"].JpegStore(root=mimic).get(i)
            for i in range(JPEG_N_FULL)]
    seconds["fixtures"] = time.perf_counter()

    probe = _decoder_probe(port)
    route = probe["route"]
    t0 = time.perf_counter()
    if route == "libjpeg":
        port["native_loader"].build()
    probe["build_s"] = time.perf_counter() - t0
    golden = _golden_check(port)
    resize = _resize_check(port, device, full[0])
    rates = _decode_rates(port, full)
    jstore = port["images"].JpegStore(root=cohort)
    under_load = _decode_under_load(
        port, device, [jstore.get(i) for i in anchor_ids[:32]])
    seconds["decoder"] = time.perf_counter()

    # 1 epoch a run (cut from 2 to keep the script within its time limit)
    base = ["--device", "cuda", "--synthetic_stays", SHORT_STAYS,
            "--batch_size", "32", "--epochs", "1", "--no_save_state",
            "--cxr_jpeg_root", cohort]
    pixels = ["--limit_batches", "4"]
    store = os.path.join(JPEG_RUNS, "store", "u8")
    ways = [("hbm", pixels + ["--image_bank", "hbm"]),
            ("stream", pixels + ["--image_bank", "stream"]),
            ("stream_inline", pixels + ["--image_bank", "stream",
                                        "--prefetch_depth", "0"]),
            ("u8_store", pixels + ["--image_bank", "stream",
                                   "--u8_store_path", store]),
            ("u8_store_reopened", pixels + ["--image_bank", "stream",
                                            "--u8_store_path", store]),
            ("features", ["--cxr_feature_cache", "hbm"])]
    runs = {}
    for way, extra in ways:
        run_dir = os.path.join(JPEG_RUNS, way)
        runs[way] = _jpeg_cli_run(port, device, base + extra
                                  + ["--ckpt_dir", run_dir], way, route)
    served_ckpt = _keep_ckpt(runs["hbm"]["best_path"],
                             os.path.join(JPEG_RUNS, "teacher.msgpack"))
    for way, _ in ways:
        shutil.rmtree(os.path.join(JPEG_RUNS, way), ignore_errors=True)
    histories = {w: r.pop("history") for w, r in runs.items()}
    # the prefetcher where the pixels are not JPEGs: procedural pixels (a
    # numpy hook of ~0.5 s a batch) and the encode-once tier (host
    # dispatch), each at depth 0 and 2 (cut from 0, 2, 2, 0 to keep the
    # script within its time limit)
    plain = base[:base.index("--cxr_jpeg_root")]
    ab_runs = {}
    for way, extra in (("pixels", pixels),
                       ("features", ["--cxr_feature_cache", "hbm"])):
        for k, depth in enumerate((0, 2)):
            run_dir = os.path.join(JPEG_RUNS, f"ab_{way}_{k}")
            r = _jpeg_cli_run(port, device, plain + extra + [
                "--prefetch_depth", str(depth), "--ckpt_dir", run_dir],
                way, route)
            shutil.rmtree(run_dir, ignore_errors=True)
            ab_runs.setdefault(way, []).append({"depth": depth, **r})
    prefetch_ab = {}
    for way, rs in ab_runs.items():
        hist = [r.pop("history") for r in rs]
        rate = {d: [r["train_samples_per_s"] for r in rs if r["depth"] == d]
                for d in (0, 2)}
        prefetch_ab[way] = {
            "samples_per_s_depth0": rate[0], "samples_per_s_depth2": rate[2],
            "depth2_over_depth0": statistics.mean(rate[2])
            / statistics.mean(rate[0]),
            "losses_bit_equal": all(_losses(h) == _losses(hist[0])
                                    for h in hist),
            "runs": rs}
    seconds["runs"] = time.perf_counter()

    # the steady bf16 step of each tier on one batch of 32, and its feed
    tl, eng, F, images = (port["teacher_loop"], port["engine"],
                          port["features"], port["images"])
    optim, st = port["optim"], port["state"]
    tcfg = cfgmod.TeacherConfig()
    # the JPEG cohort's stays, whose images the files hold
    data, host, _ = _train_batch(port, device, tcfg, int(SHORT_STAYS))
    trn = cfgmod.TrainConfig(batch_size=32)
    lw = np.ones(7, np.float32)
    model = port["teacher"].init_teacher(tcfg, 0).to(device)
    bank = images.HBMImageBank(jstore, anchor_ids, 518, device=device)
    u8 = images.U8MemmapStore.open(store)
    jpeg_hook = images.make_jpeg_host_fn(jstore, 518)
    ids, pixels_for_ids = tl.pixels_for_ids_fn(data, jpeg_hook)
    fbank = F.CXRFeatureBank.build(
        F.encode_fn_for_teacher(model, torch.bfloat16), pixels_for_ids, ids)
    tiers = {"hbm": (bank.image_source(), None, bank.host_fn()),
             "u8_store": (eng.default_image_source, None, u8.host_fn()),
             "stream": (eng.default_image_source, None, jpeg_hook),
             "features": (eng.default_image_source,
                          fbank.feature_source(), fbank.host_fn())}
    steady = {}
    for way, (isrc, fsrc, hook) in tiers.items():
        state = st.TrainState(model, optim.MultiGroupAdamW(
            model, trn.optim, 100,
            frozen_prefixes=tl.teacher_frozen_prefixes(tcfg)))
        step = eng.make_teacher_step(trn, tcfg.duett, 24, lw,
                                     image_source=isrc, feature_source=fsrc)
        dev_batch = eng.to_device(hook(dict(host)), device)
        gen = torch.Generator(device=device).manual_seed(1)
        steady[way] = _steady_step(
            port, device,
            lambda: step(state, data.grid, data.static, dev_batch, gen),
            reps, {"k1_fwd": "flash_fwd", "k2": "gather_rows"})
        steady[way]["feed_ms"] = _feed_ms(hook, host, device)
        del state, dev_batch
    # a stream batch's feed at MIMIC-CXR-JPG's size (the cohort's files are
    # 512 x 416): 32 ids over the 8 full-size files
    mimic_hook = images.make_jpeg_host_fn(images.JpegStore(
        blobs={i: full[i % JPEG_N_FULL] for i in range(32)}), 518)
    feed_mimic_ms = _feed_ms(mimic_hook, {"image_ids": np.arange(32)},
                             device)
    del fbank
    torch.cuda.empty_cache()
    seconds["steady"] = time.perf_counter()

    # one step with the ViT trainable, its pixels from the card's bank
    m = port["teacher"].init_teacher(cfgmod.TeacherConfig(freeze_cxr=False),
                                     0).to(device)
    state = st.TrainState(m, optim.MultiGroupAdamW(
        m, trn.optim, 100, frozen_prefixes=tl.teacher_frozen_prefixes(m.cfg)))
    vit_before = m.cxr.patch_embed.weight.detach().clone()
    step = eng.make_teacher_step(trn, m.cfg.duett, 24, lw,
                                 image_source=bank.image_source())
    dev_batch = eng.to_device(bank.host_fn()(dict(host)), device)
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
    del m, state, dev_batch, vit_before, bank, model
    torch.cuda.empty_cache()
    seconds["unfreeze"] = time.perf_counter()

    # the CXR head over the catalog's JPEGs
    torch.cuda.synchronize()
    reset_counts(port)
    t0 = time.perf_counter()
    head = port["train_cxr_head"].main([
        "--device", "cuda", "--synthetic_stays", SHORT_STAYS, "--batch_size",
        "64", "--epochs", "50", "--ckpt_dir", os.path.join(JPEG_RUNS,
                                                           "cxr_head"),
        "--cxr_jpeg_root", catalog])
    torch.cuda.synchronize()
    n_cat = head["n_images"]
    head_launches = read_counts(port)
    head_expect = {**dict.fromkeys(head_launches, 0),
                   "flash_attention_f32": 12 * math.ceil(n_cat / 64),
                   "jpeg_resize_f32": n_cat if route == "nvjpeg" else 0}
    cxr_head = {"wall_s": time.perf_counter() - t0, "n_images": n_cat,
                "feature_extract_s": head["feature_extract_s"],
                "images_per_s": n_cat / head["feature_extract_s"],
                "best_val_macro_auroc": head["best_val_macro_auroc"],
                "launches": head_launches, "expected_launches": head_expect}
    seconds["cxr_head"] = time.perf_counter()

    serve = _jpeg_serve(port, device, served_ckpt, cohort, route)
    shutil.rmtree(JPEG_RUNS, ignore_errors=True)
    seconds["end"] = time.perf_counter()
    marks = list(seconds.values())
    stream, inline = runs["stream"], runs["stream_inline"]
    steps = stream["train_steps"]
    feed = steady["stream"]["feed_ms"]
    info = {"phase": "jpeg", "card": card,
            "seconds": dict(zip(("fixtures", "decoder", "runs", "steady",
                                 "unfreeze", "cxr_head", "serve"),
                                np.diff(marks).tolist())),
            "fixtures": fixtures, "probe": probe, "golden_56": golden,
            "resize_kernel": resize, "decode_mimic_size": rates,
            "decode_under_load": under_load,
            "runs": runs, "steady": steady,
            "prefetch": {
                "samples_per_s_depth2": stream["train_samples_per_s"],
                "samples_per_s_depth0": inline["train_samples_per_s"],
                "feed_ms": feed, "feed_shape": list(JPEG_COHORT_SHAPE),
                "feed_ms_mimic_size": feed_mimic_ms,
                "without_jpegs": prefetch_ab,
                # the share of the inline feed the worker hid
                "overlap": (inline["train_s"] - stream["train_s"])
                / max(steps * feed / 1e3, 1e-9),
                "losses_bit_equal": _losses(histories["stream"])
                == _losses(histories["stream_inline"]),
                "history_max_abs_diff": _history_diff(
                    histories["stream"], histories["stream_inline"])},
            "store_equals_bank": _losses(histories["u8_store"])
            == _losses(histories["hbm"])
            == _losses(histories["u8_store_reopened"]),
            "store_bank_history_max_abs_diff": max(
                _history_diff(histories["u8_store"], histories["hbm"]),
                _history_diff(histories["u8_store_reopened"],
                              histories["hbm"])),
            "unfreeze_step": unfreeze, "cxr_head": cxr_head,
            "serve": serve, "bank_bytes": runs["hbm"]["image_tier"]["bytes"]}
    emit(info)
    for way, r in runs.items():
        if not all(np.isfinite(x) for x in r["epoch_losses"]):
            raise AssertionError(f"jpeg {way}: non-finite losses")
        if r["launches"] != r["expected_launches"]:
            raise AssertionError(f"jpeg {way}: launches {r['launches']}, "
                                 f"expected {r['expected_launches']}")
    if route == "nvjpeg" and golden["gray_max_levels"] > JPEG_LEVELS:
        raise AssertionError(f"the card's decoder is "
                             f"{golden['gray_max_levels']} levels from "
                             f"libjpeg's rows (tolerance {JPEG_LEVELS})")
    if any(under_load["differing_files"]):
        raise AssertionError(f"files decoded while the card was busy "
                             f"differ from the idle decode: {under_load}")
    if route == "libjpeg" and golden["gray_max_levels"] != 0:
        raise AssertionError("the libjpeg route's rows differ from the "
                             "golden ones")
    if not info["prefetch"]["losses_bit_equal"]:
        raise AssertionError("prefetch depth 2 and 0 gave other losses")
    for way, rs in ab_runs.items():
        for r in rs:
            if r["launches"] != r["expected_launches"] or \
                    not all(np.isfinite(x) for x in r["epoch_losses"]):
                raise AssertionError(f"jpeg prefetch A/B {way}: {r}")
        if not prefetch_ab[way]["losses_bit_equal"]:
            raise AssertionError(f"prefetch depth 2 and 0 gave other "
                                 f"losses on {way}")
    if not info["store_equals_bank"]:
        raise AssertionError("the u8 store's losses differ from the bank's")
    # the u8 bank holds each of the cohort's images at 518 x 518 x 3
    if runs["hbm"]["image_tier"]["bytes"] != len(anchor_ids) * 518 * 518 * 3:
        raise AssertionError(f"bank bytes {runs['hbm']['image_tier']}")
    for way, r in steady.items():
        want = {"gather_rows_bulk": 2} if way == "features" \
            else {"flash_attention": 12}
        if r["launches_per_step"] != want:
            raise AssertionError(f"jpeg steady {way} launched "
                                 f"{r['launches_per_step']}, expected {want}")
    if unfreeze["launches"] != {k: 12 for k in (
            "flash_attention", "flash_attention_bwd_delta",
            "flash_attention_bwd_dkv", "flash_attention_bwd_dq")} or \
            not np.isfinite(unfreeze["loss"]) or not unfreeze["vit_moved"]:
        raise AssertionError(f"jpeg unfrozen step: {unfreeze}")
    if head_launches != head_expect or \
            not np.isfinite(cxr_head["best_val_macro_auroc"]):
        raise AssertionError(f"jpeg cxr_head launches {head_launches}, "
                             f"expected {head_expect}")
    return info


def _recording_forward(pred, served: list):
    """``pred._forward`` that also appends (x_ts, static, batch, outputs) of
    every batch it runs to ``served``: on the card the outputs of the
    bucket graph's replay, which no step wrapper sees."""
    import torch
    forward = pred._forward

    def recording_forward(x_ts, static, batch):
        out = forward(x_ts, static, batch)
        served.append((x_ts, static, batch,
                       {k: torch.from_numpy(v.copy()) for k, v in
                        out.items()}))
        return out

    return recording_forward


def _serve_by_id(port, device, model, source: dict, reqs: list,
                 n_clients: int, posts_per_client: int, probe=None) -> dict:
    """``model`` behind the HTTP server with ``source`` (the predictor's
    ``image_source`` or ``feature_source``): after the warm-up, clients
    post windows that name an ``image_id`` (``reqs``, in order); the
    launches over the clients' window, the batcher's stats and the
    clients' latencies; then every served batch re-run directly and every
    response against its row there (the largest difference).
    ``probe(pred)`` runs on the started predictor before it closes."""
    import torch
    pred_mod, srv, eng = port["predictor"], port["server"], port["engine"]
    pred = pred_mod.BatchingPredictor(model, max_batch=32, max_wait_ms=20.0,
                                      dtype=torch.bfloat16, device=device,
                                      **source)
    served = []
    pred._forward = _recording_forward(pred, served)
    pred.start()
    n_req = n_clients * posts_per_client
    server, probed = None, None
    try:
        t0 = time.perf_counter()
        warm = pred.warmup({"x_ts": reqs[0]["x_ts"],
                            "static": reqs[0]["static"],
                            "image_id": reqs[0]["image_id"]})
        warm_s = time.perf_counter() - t0
        served.clear()
        server = srv.make_server(pred, "127.0.0.1", 0, meta={})
        srv.serve_forever(server, background=True)
        url = f"http://127.0.0.1:{server.server_address[1]}/v1/predict"
        responses, latencies, errors = [None] * n_req, [], []
        lock = threading.Lock()

        def client(c):
            try:
                for j in range(posts_per_client):
                    i = c * posts_per_client + j
                    r = reqs[i]
                    code, body, ms = _post(url, {"instances": [{
                        "x_ts": r["x_ts"].tolist(),
                        "static": r["static"].tolist(),
                        "image_id": r["image_id"]}]})
                    if code != 200:
                        raise RuntimeError(f"HTTP {code}: {body}")
                    with lock:
                        responses[i] = body["predictions"][0]
                        latencies.append(ms)
            except Exception as e:      # noqa: BLE001 — reported below
                with lock:
                    errors.append(repr(e))

        torch.cuda.synchronize()
        reset_counts(port)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in read_counts(port).items() if v}
        stats = pred.stats()
        if errors or any(th.is_alive() for th in threads):
            raise RuntimeError(f"serving clients failed: {errors}")
        checked = list(served)
        if probe is not None:
            probed = probe(pred)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        pred.close()
    direct = eng.make_teacher_eval_from_windows(pred._model, torch.bfloat16,
                                                **source)
    rows, max_diff = {}, 0.0
    for x_ts, static, batch, out in checked:
        again = {k: v.cpu() for k, v in direct(x_ts, static, batch).items()}
        for k in out:
            max_diff = max(max_diff, float((again[k] - out[k]).abs().max()))
        for i in range(x_ts.shape[0]):
            rows.setdefault(x_ts[i].tobytes(), again["fusion_logits"][i])
    for r, resp in zip(reqs, responses):
        max_diff = max(max_diff, float((torch.tensor(resp["fusion_logits"])
                                        - rows[r["x_ts"].tobytes()])
                                       .abs().max()))
    lat = np.asarray(latencies)
    return {"requests": n_req, "batches": stats["n_batches"],
            "n_served": stats["n_requests"],
            "batch_size_hist": stats["batch_size_hist"],
            "launches": launches, "samples_per_s": n_req / wall,
            "wall_s": wall, "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99)),
            "warmup_s": warm_s, "warm_by_bucket": warm,
            "max_abs_diff_response_vs_direct": max_diff, "probe": probed,
            "served_outputs_finite": all(
                bool(torch.isfinite(v).all()) for *_, out in checked
                for v in out.values())}


def _id_requests(cfg, ids: list, seed: int) -> list:
    """Windows with an ``image_id`` each, as a client of the id modes
    sends them."""
    d = cfg.duett
    T, V = d.n_timesteps, d.n_variables
    rng = np.random.default_rng(seed)
    return [{"x_ts": np.concatenate(
                [rng.normal(size=(T, V)), rng.integers(-1, 4, size=(T, V))],
                -1).astype(np.float32),
             "static": rng.normal(size=d.d_static).astype(np.float32),
             "image_id": int(i)} for i in ids]


def _jpeg_serve(port, device, ckpt: str, root: str, route: str,
                n_clients: int = 4, posts_per_client: int = 3) -> dict:
    """``cli/serve``'s ``jpeg_root`` startup (``jpeg_feature_source``:
    every ``{id}.jpg`` decoded and encoded once) behind the HTTP server;
    clients post windows with an ``image_id``; launches over the startup
    and over the clients' window; each served batch re-run directly
    (SERVE_TOL); an id not in the bank answers NaN."""
    import math

    import torch
    model, cfg, _ = port["checkpoint"].load_teacher_from_ckpt(ckpt, device)
    torch.cuda.synchronize()
    reset_counts(port)
    source, startup = port["cli_serve"].jpeg_feature_source(model, root)
    startup["launches"] = {k: v for k, v in read_counts(port).items() if v}
    ids = sorted(int(f[:-4]) for f in os.listdir(root) if f.endswith(".jpg"))
    n_req = n_clients * posts_per_client
    reqs = _id_requests(cfg, [ids[i * 7 % len(ids)] for i in range(n_req)],
                        seed=3)
    run = _serve_by_id(port, device, model, {"feature_source": source},
                       reqs, n_clients, posts_per_client,
                       probe=lambda pred: pred.predict(
                           {**reqs[0], "image_id": -7}))
    n_img = startup["n_images"]
    want_startup = {"flash_attention": 12 * math.ceil(n_img / 16)}
    if route == "nvjpeg":
        want_startup["jpeg_resize_f32"] = n_img
    unknown = run.pop("probe")
    info = {"startup": startup, "expected_startup_launches": want_startup,
            **run, "unknown_id_fusion_logits": unknown["fusion_logits"]}
    if startup["launches"] != want_startup:
        raise AssertionError(f"jpeg serve startup launched "
                             f"{startup['launches']}, expected "
                             f"{want_startup}")
    if run["launches"] != {"gather_rows_bulk": 2 * run["batches"]} or \
            run["n_served"] != n_req:
        raise AssertionError(f"jpeg serve launched {run['launches']} over "
                             f"{run['batches']} batches")
    if run["max_abs_diff_response_vs_direct"] > SERVE_TOL:
        raise AssertionError(f"jpeg serve: served differs from direct by "
                             f"{run['max_abs_diff_response_vs_direct']}")
    if not np.isnan(unknown["fusion_logits"]).all():
        raise AssertionError("an unknown image id did not answer NaN")
    return info


FINETUNE_RUNS = os.path.join(REPO, "build", "chip_smoke_finetune")
PHYSIONET_RUNS = os.path.join(REPO, "build", "chip_smoke_physionet")
PREDICT_RUNS = os.path.join(REPO, "build", "chip_smoke_predict")
# the epochs cut for the supervised phases (the CLIs' default is 10)
FINETUNE_EPOCHS = 3
PHYSIONET_EPOCHS = 2
# the card's procedural images against the CPU's from the same function:
# the same threefry bits; erf_inv's polynomial, log1p and exp in another
# order of rounding (~1 float32 ulp of a value ≲ 5 before the 0.1 scale)
SYNTHETIC_PIXEL_TOL = 1e-6
# cli/predict's two image tiers, each output relative to the array's max
# abs: the bank holds the ViT's bf16 tokens of each image encoded in a chunk
# of 16 sorted ids, the pixel tier encodes it among its eval batch, and
# cuBLAS's bf16 GEMMs round an image's rows otherwise in another batch
# (1.46e-2 to 1.65e-2 of the logits' max abs after 12 layers at batch 64 on
# an H100, not bit-equal at batch 16 either); a bank row shifted by one
# moves them by ~0.5, which the phase shows each run
PREDICT_BATCH_TOL = 5e-2


def _finetune_data(port, n_stays: int = 500):
    """``cli/finetune_mimic``'s default cohort and stay-label dataset (the
    CLI's own helpers) and its DuETT config."""
    cfgmod, P, S = port["config"], port["pipeline"], port["synthetic"]
    ds = S.make_synthetic(seed=0, n_stays=n_stays,
                          n_subjects=max(n_stays // 3, 10), n_variables=34)
    meta = P.meta_from_events(ds, cfgmod.DataConfig())
    data = port["sliding"].build_stay_label_dataset(ds, meta, 24)
    duett = cfgmod.DuettConfig(n_variables=meta.n_variables,
                               d_static=meta.d_static, n_timesteps=24,
                               d_embedding=24, n_layers=2)
    return data, duett


def _avg_bit_equal(port, extras: dict) -> dict:
    """Per seed: the averaged weights as the loop loaded them on the card
    against a CPU average (``average_params``, then float32) of the same
    ``ft-*.msgpack`` files with the best one's statistics, bit for bit."""
    import torch
    ck, conv = port["checkpoint"], port["convert"]
    out = {}
    for seed, e in extras.items():
        params = ck.average_params([ck.load_checkpoint(p)["params"]
                                    for _, p in e["entries"]], np.float32)
        stats = ck.load_checkpoint(e["entries"][0][1])["batch_stats"]
        cpu = conv.flax_to_state_dict(params, stats)
        card = e["avg_state"]
        out[seed] = {"k": len(e["entries"]),
                     "bit_equal": cpu.keys() == card.keys() and all(
                         torch.equal(cpu[k], card[k].cpu()) for k in cpu)}
    return out


def phase_finetune(port, device, ssl_ckpt: str, card: str = "",
                   reps: int = 5) -> dict:
    """``cli/finetune_mimic.main`` at its defaults (DuETT V 34, T 24,
    d_embedding 24, 2 layer pairs, FF 512, batch 64, 500 synthetic stays,
    seeds 0 1 2, top-k 5), from the SSL phase's best checkpoint, the epochs
    cut to FINETUNE_EPOCHS: float32 (the default) and ``--mixed_precision
    bf16``; every kernel's launches over exactly each run (none of the six
    is on this path); the summary finite; each seed's averaged weights on
    the card bit-equal to a CPU average of the same files. Then the steady
    supervised step of each dtype at batch 64 (``_steady_step``)."""
    import torch
    shutil.rmtree(FINETUNE_RUNS, ignore_errors=True)
    runs = {}
    for way, extra in (("float32", []),
                       ("bf16", ["--mixed_precision", "bf16"])):
        argv = ["--device", "cuda", "--ssl_ckpt", ssl_ckpt, "--epochs",
                str(FINETUNE_EPOCHS), "--ckpt_dir",
                os.path.join(FINETUNE_RUNS, way)] + extra
        extras = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(port)
        t0 = time.perf_counter()
        summary = port["finetune_mimic"].main(argv, extras=extras)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(port)
        steps = sum(e["train_steps"] for e in extras.values())
        train_s = sum(e["train_s"] for e in extras.values())
        runs[way] = {
            "argv": argv, "wall_s": wall, "launches": launches,
            "summary": {k: v for k, v in summary.items() if k != "per_seed"},
            "per_seed": [{"seed": r["seed"], "val_auprc": r["val_auprc"],
                          "test_auprc_avg": r["test_avg"]["auprc"],
                          "test_auprc_best": r["test_best"]["auprc"],
                          "test_auroc_avg": r["test_avg"]["auroc"],
                          "test_auroc_best": r["test_best"]["auroc"]}
                         for r in summary["per_seed"]],
            "train_steps": steps, "train_s": train_s,
            "train_samples_per_s": steps * 64 / train_s,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "averaged": _avg_bit_equal(port, extras)}
    shutil.rmtree(FINETUNE_RUNS, ignore_errors=True)

    data, duett = _finetune_data(port)
    data.to(device)
    fl, eng = port["finetune_loop"], port["engine"]
    steady = {}
    for way, dtype in (("float32", torch.float32), ("bf16", torch.bfloat16)):
        model = port["duett"].init_classifier(duett, 0)
        port["ssl_loop"].transplant_encoder(ssl_ckpt, model, dest="encoder")
        model = model.to(device)
        state = port["state"].TrainState(model, port["optim"].simple_adamw(
            model, 1e-4, 1e-5, warmup_steps=50, total_steps=15,
            min_lr_ratio=0.01))
        train_step, _ = fl.make_finetune_steps(24, dtype,
                                               data.pos_frac("train"))
        batch = eng.to_device(next(data.iter_batches("train", 64, True,
                                                     seed=0)), device)
        gen = torch.Generator(device=device).manual_seed(100)

        def run():
            return train_step(state, data.grid, data.static, batch, gen)

        steady[way] = _steady_step(port, device, run, reps, {}, batch=64)
        steady[way]["loss"] = float(run())
        del model, state
    info = {"phase": "finetune", "card": card, "epochs": FINETUNE_EPOCHS,
            "duett": {k: getattr(duett, k) for k in (
                "n_variables", "n_timesteps", "d_static", "d_embedding",
                "n_layers", "n_heads", "d_feedforward")},
            "splits": {k: data.split_size(k) for k in ("train", "val",
                                                       "test")},
            "pos_frac": data.pos_frac("train"), "runs": runs,
            "steady": steady}
    emit(info)
    torch.cuda.empty_cache()
    for way, r in runs.items():
        if any(r["launches"].values()) or any(
                steady[w]["launches_per_step"] for w in steady):
            raise AssertionError(f"finetune {way} launched a kernel: "
                                 f"{r['launches']}")
        vals = [v for v in r["summary"].values()] + [
            x for s in r["per_seed"] for x in s.values()]
        if not all(np.isfinite(v) for v in vals):
            raise AssertionError(f"finetune {way}: non-finite summary {r}")
        if not all(a["bit_equal"] for a in r["averaged"].values()):
            raise AssertionError(f"finetune {way}: the card's averaged "
                                 f"weights differ from the CPU average: "
                                 f"{r['averaged']}")
        if len(r["per_seed"]) != 3:
            raise AssertionError(f"finetune {way}: {len(r['per_seed'])} "
                                 "seeds")
    if not all(np.isfinite(s["loss"]) for s in steady.values()):
        raise AssertionError(f"non-finite steady finetune loss {steady}")
    return info


def phase_physionet(port, device, card: str = "") -> dict:
    """``cli/train_physionet.main`` at its defaults (400 synthetic patients,
    36 variables, 8 static features, batch 64, seeds 0 1 2, top-k 5), the
    SSL and fine-tuning epochs cut to PHYSIONET_EPOCHS: wall seconds, the
    SSL history and the summary, all finite; every kernel's launches over
    exactly this run (none of the six is on this path)."""
    import torch
    shutil.rmtree(PHYSIONET_RUNS, ignore_errors=True)
    argv = ["--device", "cuda", "--pretrain_epochs", str(PHYSIONET_EPOCHS),
            "--finetune_epochs", str(PHYSIONET_EPOCHS), "--ckpt_dir",
            PHYSIONET_RUNS]
    extras = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(port)
    t0 = time.perf_counter()
    summary = port["train_physionet"].main(argv, extras=extras)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(port)
    ssl = extras["ssl"]
    info = {"phase": "physionet", "card": card, "argv": argv,
            "wall_s": wall, "launches": launches,
            "ssl_history": ssl.history, "ssl_best_val_loss": ssl.best_metric,
            "ssl_train_steps": ssl.extras["n_train_steps"],
            "finetune_train_steps": sum(
                e["train_steps"] for e in extras["finetune"].values()),
            "summary": {k: v for k, v in summary.items() if k != "per_seed"},
            "per_seed": [{"seed": r["seed"], "val_auprc": r["val_auprc"],
                          "test_auprc_avg": r["test_avg"]["auprc"],
                          "test_auprc_best": r["test_best"]["auprc"]}
                         for r in summary["per_seed"]],
            "averaged": _avg_bit_equal(port, extras["finetune"]),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(info)
    shutil.rmtree(PHYSIONET_RUNS, ignore_errors=True)
    vals = [h[k] for h in ssl.history for k in ("train_loss", "val_loss")] \
        + list(info["summary"].values()) \
        + [x for s in info["per_seed"] for x in s.values()]
    if not all(np.isfinite(v) for v in vals):
        raise AssertionError(f"physionet: non-finite readings {info}")
    if any(launches.values()):
        raise AssertionError(f"physionet launched a kernel: {launches}")
    if not all(a["bit_equal"] for a in info["averaged"].values()):
        raise AssertionError(f"physionet: averaged weights differ: "
                             f"{info['averaged']}")
    return info


def phase_predict(port, device, teacher_ckpt: str, card: str = "") -> dict:
    """``cli/predict.main`` at its defaults (bf16, the test split of 400
    synthetic stays, batch 64) on the full-width teacher from the train
    phase's best checkpoint: on procedural pixels (K1 12 a batch, K2 0) and
    with ``--cxr_feature_cache hbm`` (K1 12 a chunk of 16 in the bank's
    build, then K2 2 and K1 0 a batch), the launches of the build and of
    the split's eval counted apart; samples/s of each eval; the NPZ's keys
    and shapes. The same two runs at ``--batch_size 16``, the bank's chunk.
    At either batch the two tiers' NPZs are held within PREDICT_BATCH_TOL
    of each array's max abs, and the same comparison against the bank's
    outputs shifted by one row must exceed it; the time series' outputs
    are equal bit for bit. Labels and masks equal throughout."""
    import math

    import torch
    shutil.rmtree(PREDICT_RUNS, ignore_errors=True)
    os.makedirs(PREDICT_RUNS)
    pred_mod, F = port["predict"], port["features"]
    runs, npz = {}, {}
    for way, extra in (("pixels", []),
                       ("hbm", ["--cxr_feature_cache", "hbm"]),
                       ("pixels_b16", ["--batch_size", "16"]),
                       ("hbm_b16", ["--cxr_feature_cache", "hbm",
                                    "--batch_size", "16"])):
        out = os.path.join(PREDICT_RUNS, f"{way}.npz")
        argv = ["--ckpt", teacher_ckpt, "--device", "cuda", "--out",
                out] + extra
        batch = int(extra[extra.index("--batch_size") + 1]) \
            if "--batch_size" in extra else 64
        seen = {}
        build_attr = F.CXRFeatureBank.__dict__["build"]
        build, evaluate = F.CXRFeatureBank.build, \
            pred_mod.evaluate_dual_pathology

        def timed(name, fn):
            def wrapped(*a, **k):
                torch.cuda.synchronize()
                before = read_counts(port)
                t0 = time.perf_counter()
                r = fn(*a, **k)
                torch.cuda.synchronize()
                seen[name] = {"s": time.perf_counter() - t0, "launches": {
                    k: v - before[k] for k, v in read_counts(port).items()
                    if v - before[k]}}
                return r
            return wrapped

        F.CXRFeatureBank.build = timed("build", build)
        pred_mod.evaluate_dual_pathology = timed("eval", evaluate)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(port)
            t0 = time.perf_counter()
            result = pred_mod.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            F.CXRFeatureBank.build = build_attr
            pred_mod.evaluate_dual_pathology = evaluate
        n = result["n"]
        with np.load(out) as z:
            npz[way] = {k: z[k] for k in z.files}
        runs[way] = {"argv": argv, "batch": batch, "wall_s": wall, "n": n,
                     "batches": math.ceil(n / batch),
                     "launches": read_counts(port),
                     "eval": seen["eval"], "build": seen.get("build"),
                     "samples_per_s": n / seen["eval"]["s"],
                     "main_auroc": result["main_auroc"],
                     "keys": {k: list(v.shape) for k, v in npz[way].items()},
                     "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    shutil.rmtree(PREDICT_RUNS, ignore_errors=True)
    want = {way: ({"gather_rows_bulk": 2 * r["batches"]}
                  if way.startswith("hbm")
                  else {"flash_attention": 12 * r["batches"]})
            for way, r in runs.items()}
    floats = [k for k, v in npz["pixels"].items()
              if v.dtype.kind == "f" and k != "y_multi"]

    def rel(a, b):
        return {k: float(np.abs(a[k] - b[k]).max()
                         / max(float(np.abs(a[k]).max()), 1e-12))
                for k in floats}

    diffs = {b: rel(npz[f"pixels{b}"], npz[f"hbm{b}"]) for b in ("", "_b16")}
    shifted = rel(npz["pixels"], {k: np.roll(v, 1, axis=0)
                                  for k, v in npz["hbm"].items()})
    ts_equal = {b or "_b64": all(np.array_equal(npz[f"pixels{b}"][k],
                                                npz[f"hbm{b}"][k])
                                 for k in ("ts_logits", "scaled_correction"))
                for b in diffs}
    info = {"phase": "predict", "card": card, "runs": runs,
            "expected_eval_launches": want,
            "pixels_vs_hbm_max_rel_diff": diffs[""],
            "pixels_vs_hbm_max_rel_diff_at_batch_16": diffs["_b16"],
            "pixels_vs_hbm_shifted_row_max_rel_diff": shifted,
            "ts_outputs_bit_equal": ts_equal, "tol": PREDICT_BATCH_TOL}
    emit(info)
    want_keys = {"img_logits", "ts_logits", "fusion_logits",
                 "scaled_correction", "main_logit", "y_multi",
                 "y_multi_mask", "labels", "beta"}
    for way, r in runs.items():
        if set(r["keys"]) != want_keys:
            raise AssertionError(f"predict {way}: NPZ keys {r['keys']}")
        if r["eval"]["launches"] != want[way]:
            raise AssertionError(f"predict {way}: the eval launched "
                                 f"{r['eval']['launches']}, expected "
                                 f"{want[way]}")
        if not all(np.isfinite(npz[way][k]).all() for k in floats):
            raise AssertionError(f"predict {way}: non-finite outputs")
        if way.startswith("pixels") and r["build"] is not None:
            raise AssertionError(f"predict {way} built a feature bank")
        if way.startswith("hbm"):
            chunks = r["build"]["launches"]
            if set(chunks) != {"flash_attention"} or \
                    chunks["flash_attention"] % 12:
                raise AssertionError(f"predict {way}: the build launched "
                                     f"{chunks}")
            if {k: v for k, v in r["launches"].items() if v} != {
                    "flash_attention": chunks["flash_attention"],
                    **want[way]}:
                raise AssertionError(f"predict {way} launched "
                                     f"{r['launches']}")
        for k in ("y_multi", "y_multi_mask", "labels"):
            a, b = npz["pixels"][k], npz[way][k]
            if not (a.shape == b.shape and ((a == b) | (a != a)).all()):
                raise AssertionError(f"predict: {k} differs in {way}")
    if not all(ts_equal.values()):
        raise AssertionError(f"predict: the time series' outputs differ "
                             f"between the tiers: {ts_equal}")
    if max(max(d.values()) for d in diffs.values()) > PREDICT_BATCH_TOL:
        raise AssertionError(f"predict: pixels and hbm differ: {diffs}")
    if not max(shifted.values()) > PREDICT_BATCH_TOL:
        raise AssertionError(f"the predict comparison misses a shifted row: "
                             f"{shifted}")
    return info


def phase_synthetic_serve(port, device, teacher_ckpt: str, card: str = "",
                          n_clients: int = 4, posts_per_client: int = 3
                          ) -> dict:
    """``cli/serve``'s ``--image_mode synthetic`` source behind the HTTP
    server on the full-width teacher: clients post windows with an
    ``image_id``; K1's launches over the clients' window (12 a batch, no
    K2); every served batch re-run directly (SERVE_TOL); and the card's
    procedural images for a few ids against the same function's on the
    CPU (SYNTHETIC_PIXEL_TOL)."""
    import torch
    model, cfg, _ = port["checkpoint"].load_teacher_from_ckpt(teacher_ckpt,
                                                              device)
    source = port["cli_serve"].synthetic_image_source(cfg)
    n_req = n_clients * posts_per_client
    reqs = _id_requests(cfg, [1000 + 37 * i for i in range(n_req)], seed=5)
    run = _serve_by_id(port, device, model, {"image_source": source}, reqs,
                       n_clients, posts_per_client)
    run.pop("probe")
    ids = torch.tensor([r["image_id"] for r in reqs[:4]], dtype=torch.int32)
    px = {dev: source({"image_ids": ids.to(dev)}).cpu()
          for dev in (device, torch.device("cpu"))}
    pixel_diff = float((px[device] - px[torch.device("cpu")]).abs().max())
    info = {"phase": "synthetic_serve", "card": card, **run,
            "k1_launches_per_batch": run["launches"].get("flash_attention", 0)
            / max(run["batches"], 1),
            "pixels_card_vs_cpu_max_abs_diff": pixel_diff}
    emit(info)
    if run["launches"] != {"flash_attention": cfg.vit.n_layers
                           * run["batches"]} or run["n_served"] != n_req:
        raise AssertionError(f"synthetic serve launched {run['launches']} "
                             f"over {run['batches']} batches")
    if not run["served_outputs_finite"]:
        raise AssertionError("non-finite outputs in a served batch")
    if run["max_abs_diff_response_vs_direct"] > SERVE_TOL:
        raise AssertionError(f"synthetic serve: served differs from direct "
                             f"by {run['max_abs_diff_response_vs_direct']}")
    if pixel_diff > SYNTHETIC_PIXEL_TOL:
        raise AssertionError(f"the card's procedural images differ from the "
                             f"CPU's by {pixel_diff}")
    return info


ANALYSIS_RUNS = os.path.join(REPO, "build", "chip_smoke_analysis")
UNFREEZE_BEST = os.path.join(REPO, "build", "chip_smoke_unfreeze_best.msgpack")
CXR_HEAD_BEST = os.path.join(REPO, "build", "chip_smoke_cxr_head.msgpack")
# the cohort of the tier-compared runs: the JAX test's (400 stays, its
# val and test splits 102 and 126 anchors, 670 images), so that one
# flipped sample moves an accuracy by ~1e-2; why_we_need_multimodal's:
# the cxr_head phase's 240 stays, whose catalog (775 images) the head was
# trained on, so that G0 is the head's own test split
ANALYSIS_STAYS = "400"
WHY_STAYS = "240"
# the pixel and hbm tiers' reports: complementarity's every per-label
# float in float32, and the counterfactuals' per-condition AUROCs and
# attention entropies (JAX tests/test_analysis.py's bound)
ANALYSIS_TIER_TOL = 0.02


def _timed_main(port, main, argv: list, parts: dict) -> dict:
    """``main(argv)`` with every kernel's launches counted over exactly
    this run, and each function of ``parts`` ({(module key, attribute):
    (name, count of samples from its result or None)}) timed and its
    launches counted on its own."""
    import torch
    seen = {}
    saved = []

    def timed(name, fn, count):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            before = read_counts(port)
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            s = seen.setdefault(name, {"s": 0.0, "calls": 0, "samples": 0,
                                       "launches": {}})
            s["s"] += time.perf_counter() - t0
            s["calls"] += 1
            s["samples"] += count(r) if count else 0
            for k2, v in read_counts(port).items():
                if v - before[k2]:
                    s["launches"][k2] = s["launches"].get(k2, 0) \
                        + v - before[k2]
            return r
        return wrapped

    for (mod, attr), (name, count) in parts.items():
        obj = port[mod] if isinstance(mod, str) else mod
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, timed(name, getattr(obj, attr), count))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(port)
        t0 = time.perf_counter()
        result = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    launches = {k: v for k, v in read_counts(port).items() if v}
    return {"result": result, "wall_s": wall, "launches": launches,
            "parts": seen,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def _finite_floats(tree) -> bool:
    if isinstance(tree, dict):
        return all(_finite_floats(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_finite_floats(v) for v in tree)
    if isinstance(tree, float):
        return bool(np.isfinite(tree))
    return True


def phase_analysis(port, device, frozen_ckpt: str, unfrozen_ckpt: str,
                   head_ckpt: str, card: str = "") -> dict:
    """The analysis suite's first half (ROADMAP P19a) at full width: each
    script's ``main`` as a user runs it (bf16 evals, the flags' defaults
    but the cohort and the batch counts) on the frozen ``dual_patch``
    teacher of the train phases, on procedural pixels (K1's bf16 forward,
    12 a batch), ``complementarity`` and ``diagnose_temporal_usage`` also
    on ``--cxr_feature_cache hbm`` (K1 12 a chunk of 16 in the bank's
    build, then K2 2 a forward); ``unimodal_linear_probe``'s float32 ViT
    pass (K1's float32 forward); ``grad_flow_diagnostics`` on that teacher
    (float32: 12 forwards a batch, no backward, pixel gradients exactly 0)
    and on the unfreeze phase's (12 forwards and 12 of each of D, dkv and
    dq a batch: the image branch's pixel gradient); and
    ``why_we_need_multimodal`` on the CXR-head phase's head over that
    phase's catalog (its float32 CLS sweep, 12 a chunk of 64; G1 + G2 +
    G3 = G0). Every run's launches
    are predicted from its splits and asserted; its wall seconds, its
    eval's seconds and samples/s, and the bank builds' seconds are
    printed. The pixel and hbm tiers: complementarity's per-label counts
    and time-series accuracy equal in bf16 (its other floats read) and,
    run again in float32 (the scripts' ``dtype``; K1's float32 forward),
    every per-label float within ANALYSIS_TIER_TOL; the counterfactuals'
    per-condition AUROCs and attention entropies within it, their
    per-sample archives within PREDICT_BATCH_TOL of each array's max abs
    (the time series' outputs bit-equal) and a one-row shift of the hbm
    archive beyond it."""
    import math
    cm = port["analysis_common"]
    shutil.rmtree(ANALYSIS_RUNS, ignore_errors=True)
    os.makedirs(ANALYSIS_RUNS)
    args = argparse_args(port, ANALYSIS_STAYS)
    _, _, data, _ = cm.load_analysis_data(args)
    split = {k: len(v) for k, v in data.splits.items()}
    n_images = len(np.unique(data.anchor["image_ids"]))
    n_anchors = len(data.anchor["y"])
    why_args = argparse_args(port, WHY_STAYS)
    n_catalog = len(cm.load_analysis_data(why_args)[0].cxr_catalog.image_ids)
    L = port["config"].ViTConfig().n_layers
    bank_chunks = math.ceil(n_images / 16)
    diag_batches = 2                       # --batch_size 32 --max_batches 2

    def batches(name, bs=64):
        return math.ceil(split[name] / bs)

    def n_out(r):
        return len(r["y"])

    evals = {("complementarity", "collect_dual_outputs"): ("eval", n_out),
             ("residual_by_confidence", "collect_dual_outputs"):
                 ("eval", n_out),
             ("logit_fusion_probe", "collect_dual_outputs"): ("eval", n_out),
             ("diagnose_temporal_usage", "collect_predictions"):
                 ("eval", lambda r: 5 * len(r["y"])),
             ("unimodal_linear_probe", "extract_features"):
                 ("eval", lambda r: len(r["cxr_cls"])),
             ("grad_flow_diagnostics", "run_diagnostics"):
                 ("eval", lambda r: r["samples"]),
             ("cxr_head_loop", "extract_cls_features"):
                 ("eval", lambda r: len(r)),
             ("analysis_common", "load_teacher"): ("load", None),
             ("grad_flow_diagnostics", "load_teacher"): ("load", None)}
    build = {(port["features"].CXRFeatureBank, "build"): ("build", None)}
    base = ["--device", "cuda", "--synthetic_stays", ANALYSIS_STAYS,
            "--n_boot", "20"]
    f32 = port["attention"].launch_key
    import torch
    k1, k1f = "flash_attention", f32("flash_attention", torch.float32)
    bwd = [f32(f"flash_attention_bwd_{k}", torch.float32)
           for k in ("delta", "dkv", "dq")]
    plan = [
        # (run, module, extra flags, predicted launches)
        ("trajectory_availability", "trajectory_availability", [], {}),
        ("residual_by_confidence", "residual_by_confidence", [],
         {k1: L * batches("test")}),
        ("complementarity", "complementarity", [],
         {k1: L * (batches("val") + batches("test"))}),
        ("complementarity_hbm", "complementarity",
         ["--cxr_feature_cache", "hbm"],
         {k1: L * bank_chunks,
          "gather_rows_bulk": 2 * (batches("val") + batches("test"))}),
        # the same two runs in float32 (the scripts' ``dtype``): the tiers'
        # comparison where the bf16 rounding of a logit cannot flip it
        ("complementarity_f32", "complementarity", [],
         {k1f: L * (batches("val") + batches("test"))}),
        ("complementarity_hbm_f32", "complementarity",
         ["--cxr_feature_cache", "hbm"],
         {k1f: L * bank_chunks,
          "gather_rows_bulk": 2 * (batches("val") + batches("test"))}),
        ("logit_fusion_probe", "logit_fusion_probe", [],
         {k1: L * (batches("train") + batches("test"))}),
        ("diagnose_temporal_usage", "diagnose_temporal_usage",
         ["--batch_size", "32", "--max_batches", str(diag_batches)],
         {k1: L * 5 * diag_batches}),
        ("diagnose_temporal_usage_hbm", "diagnose_temporal_usage",
         ["--batch_size", "32", "--max_batches", str(diag_batches),
          "--cxr_feature_cache", "hbm"],
         {k1: L * bank_chunks, "gather_rows_bulk": 2 * 5 * diag_batches}),
        ("unimodal_linear_probe", "unimodal_linear_probe", [],
         {k1f: L * math.ceil(n_anchors / 64)}),
        ("grad_flow_frozen", "grad_flow_diagnostics",
         ["--batch_size", "16", "--n_batches", "1"], {k1f: L}),
        ("grad_flow_unfrozen", "grad_flow_diagnostics",
         ["--batch_size", "16", "--n_batches", "1"],
         {k1f: L, **dict.fromkeys(bwd, L)}),
        ("why_we_need_multimodal", "why_we_need_multimodal", [],
         {k1f: L * math.ceil(n_catalog / 64)}),
    ]
    runs, results = {}, {}
    for run, mod, extra, want in plan:
        out = os.path.join(ANALYSIS_RUNS, run)
        if mod == "why_we_need_multimodal":
            argv = ["--device", "cuda", "--head_ckpt", head_ckpt,
                    "--vit_size", "base", "--synthetic_stays", WHY_STAYS,
                    "--out_dir", out]
        else:
            ckpt = unfrozen_ckpt if run == "grad_flow_unfrozen" \
                else frozen_ckpt
            argv = base + ["--out_dir", out] + extra + (
                [] if mod == "trajectory_availability" else ["--ckpt", ckpt])
        parts = {**{k: v for k, v in evals.items() if k[0] in (
            mod, "analysis_common", "cxr_head_loop")}, **build}
        main = port[mod].main
        if run.endswith("_f32"):
            main = functools.partial(main, dtype=torch.float32)
        r = _timed_main(port, main, argv, parts)
        ev = r["parts"].get("eval", {"s": 0.0, "samples": 0})
        runs[run] = {
            "argv": argv, "wall_s": r["wall_s"],
            "load_s": r["parts"].get("load", {}).get("s", 0.0),
            "build_s": r["parts"].get("build", {}).get("s"),
            "build_launches": r["parts"].get("build", {}).get("launches"),
            "eval_s": ev["s"], "eval_samples": ev["samples"],
            "eval_samples_per_s": ev["samples"] / ev["s"] if ev["s"] else
            None,
            "launches": r["launches"], "expected_launches": want,
            "files": sorted(os.listdir(out)),
            "peak_memory_bytes": r["peak_memory_bytes"]}
        results[run] = r["result"]
        emit({"phase": "analysis_run", "run": run, "card": card,
              **{k: v for k, v in runs[run].items() if k != "argv"}})
    # the tiers: complementarity's per-label report (bf16 and float32),
    # diagnose's per-condition report and its per-sample archive
    def tiers(px, ft):
        pairs = list(zip(px["per_label"], ft["per_label"]))
        floats = [(a[k], b.get(k)) for a, b in pairs for k in a
                  if isinstance(a[k], float)]
        return {"counts_equal": all(a["n"] == b["n"] for a, b in pairs),
                "ts_acc_equal": all(a.get("ts_acc") == b.get("ts_acc")
                                    for a, b in pairs),
                "nan_equal": all(np.isnan(x) == np.isnan(y)
                                 for x, y in floats),
                "max_abs_diff_acc": max(abs(a[k] - b[k]) for a, b in pairs
                                        if a["n"] for k in (
                                            "img_acc", "ts_acc", "fus_acc")),
                "max_abs_diff": max((abs(x - y) for x, y in floats
                                     if np.isfinite(x) and np.isfinite(y)),
                                    default=0.0)}

    comp = {"bf16": tiers(results["complementarity"],
                          results["complementarity_hbm"]),
            "float32": tiers(results["complementarity_f32"],
                             results["complementarity_hbm_f32"])}
    px = results["complementarity"]
    dpx, dft = results["diagnose_temporal_usage"], \
        results["diagnose_temporal_usage_hbm"]
    cond_diff = max(abs(dpx["conditions"][c][k] - dft["conditions"][c][k])
                    for c in dpx["conditions"]
                    for k in ("fus_macro_auroc", "ts_macro_auroc"))
    ent_diff = float(np.max(np.abs(
        np.asarray(dpx["attention_entropy_per_label"])
        - np.asarray(dft["attention_entropy_per_label"]))))
    npz = {}
    for run in ("diagnose_temporal_usage", "diagnose_temporal_usage_hbm"):
        with np.load(os.path.join(ANALYSIS_RUNS, run,
                                  "temporal_usage_predictions.npz")) as z:
            npz[run] = {k: z[k] for k in z.files}
    a, b = npz["diagnose_temporal_usage"], npz["diagnose_temporal_usage_hbm"]
    floats = [k for k, v in a.items() if v.dtype.kind == "f"
              and k not in ("y", "mask")]

    def rel(x, y):
        return max(float(np.abs(x[k] - y[k]).max())
                   / max(float(np.abs(x[k]).max()), 1e-12)
                   for k in floats if not k.startswith("ts_"))

    archive = {"max_rel_diff": rel(a, b),
               "shifted_row_max_rel_diff": rel(
                   a, {k: np.roll(v, 1, axis=0) for k, v in b.items()}),
               "ts_bit_equal": all(np.array_equal(a[k], b[k])
                                   for k in floats if k.startswith("ts_"))}
    gf, gu = results["grad_flow_frozen"], results["grad_flow_unfrozen"]
    log_f = port["grad_flow_diagnostics"].diagnostics_to_log_dict(gf)
    log_u = port["grad_flow_diagnostics"].diagnostics_to_log_dict(gu)
    why = results["why_we_need_multimodal"]
    info = {"phase": "analysis", "card": card, "stays": ANALYSIS_STAYS,
            "splits": split, "n_images": n_images, "n_catalog": n_catalog,
            "seconds": sum(r["wall_s"] for r in runs.values()),
            "wall_s_by_run": {k: r["wall_s"] for k, r in runs.items()},
            "eval_samples_per_s_by_run": {
                k: r["eval_samples_per_s"] for k, r in runs.items()},
            "build_s_by_run": {k: r["build_s"] for k, r in runs.items()
                               if r["build_s"] is not None},
            "launches_by_run": {k: r["launches"] for k, r in runs.items()},
            "complementarity_tiers": comp,
            "diagnose_tiers": {"max_condition_auroc_diff": cond_diff,
                               "max_attention_entropy_diff": ent_diff,
                               "archive": archive},
            "tol": ANALYSIS_TIER_TOL, "archive_tol": PREDICT_BATCH_TOL,
            "grad_flow": {k: {f"{b}_px_input_grad": r[f"{b}_px_input_grad"]
                              for b in ("img", "ts", "fus")}
                          for k, r in (("frozen", gf), ("unfrozen", gu))},
            "why_groups": {g: why[g]["n"] for g in why},
            "verdict": results["trajectory_availability"]["verdict"],
            "logit_probe_macro_auroc": {
                k: results["logit_fusion_probe"][k]["macro_auroc"]
                for k in ("per_label", "linear", "mlp")},
            "unimodal_macro_auroc": {
                k: v["macro_auroc"]
                for k, v in results["unimodal_linear_probe"].items()}}
    emit(info)
    info["runs"] = runs
    shutil.rmtree(ANALYSIS_RUNS, ignore_errors=True)
    for run, r in runs.items():
        want = {k: v for k, v in r["expected_launches"].items() if v}
        if r["launches"] != want:
            raise AssertionError(f"analysis {run} launched {r['launches']}, "
                                 f"expected {want}")
    # bf16: the counts and the time series' branch equal (a logit's bf16
    # rounding flips a few samples at the thresholds: read, not held);
    # float32: every per-label float within the bound
    if not all(c["counts_equal"] and c["ts_acc_equal"]
               for c in comp.values()) or not (
            comp["float32"]["nan_equal"]
            and comp["float32"]["max_abs_diff"] <= ANALYSIS_TIER_TOL):
        raise AssertionError(f"complementarity: the tiers differ: {comp}")
    if not (cond_diff <= ANALYSIS_TIER_TOL and ent_diff <= ANALYSIS_TIER_TOL
            and archive["max_rel_diff"] <= PREDICT_BATCH_TOL
            and archive["ts_bit_equal"]):
        raise AssertionError(f"diagnose_temporal_usage: the tiers differ: "
                             f"{info['diagnose_tiers']}")
    if not archive["shifted_row_max_rel_diff"] > PREDICT_BATCH_TOL:
        raise AssertionError(f"the tier comparison misses a shifted row: "
                             f"{archive}")
    if any(gf[f"{b}_px_input_grad"] != 0.0 for b in ("img", "ts", "fus")):
        raise AssertionError(f"grad_flow on a frozen ViT: pixel gradients "
                             f"{info['grad_flow']['frozen']}")
    if not (gu["img_px_input_grad"] > 0 and gu["ts_px_input_grad"] == 0
            and gu["fus_px_input_grad"] == 0):
        raise AssertionError(f"grad_flow on a trainable ViT: pixel "
                             f"gradients {info['grad_flow']['unfrozen']}")
    for name, logged in (("frozen", log_f), ("unfrozen", log_u)):
        if not all(np.isfinite(v) for v in logged.values()):
            raise AssertionError(f"grad_flow {name}: non-finite numbers")
    if why["G0_all"]["n"] != sum(why[g]["n"] for g in why if g != "G0_all") \
            or why["G0_all"]["n"] == 0:
        raise AssertionError(f"why_we_need_multimodal groups {why}")
    if not any(r.get("n", 0) for r in px["per_label"]):
        raise AssertionError("complementarity analyzed no label")
    if not _finite_floats(info["logit_probe_macro_auroc"]) or \
            not _finite_floats(info["unimodal_macro_auroc"]):
        raise AssertionError("non-finite probe AUROCs")
    return info


def _next_image_rows(fs, ids_sorted):
    """A feature source that hands each image the tokens of the next image
    id of the bank (a wrong row that still names an image)."""
    import torch
    ids_dev = None

    def source(batch: dict):
        nonlocal ids_dev
        ids = batch["image_ids"].long()
        if ids_dev is None:
            ids_dev = torch.as_tensor(ids_sorted, device=ids.device)
        pos = torch.searchsorted(ids_dev, ids)
        return fs({**batch, "image_ids": ids_dev[(pos + 1) % len(ids_dev)]})

    return source


def phase_analysis_b(port, device, frozen_ckpt: str, card: str = "") -> dict:
    """The analysis suite's second half (ROADMAP P19b) at full width, each
    script's ``main`` as a user runs it on the frozen ``dual_patch``
    teacher of the train phases and ``phase_analysis``'s 400-stay cohort,
    ``--n_perm 5 --n_boot 20``: ``conditional_information_probe`` over the
    7 labels on pixels (bf16; both splits collected anew for each label,
    as in JAX: K1 12 a batch of 64, 7 batches a label), then on label 0
    in float32 on pixels, on ``--cxr_feature_cache hbm`` (K1's float32
    forward 12 a chunk of 16 in the bank's build, then K2 2 a forward) and
    on an ``hbm`` bank that hands each image the next image's tokens: the
    four probes' AUROCs of the two tiers within ANALYSIS_TIER_TOL, the
    wrong rows' beyond it; ``raw_trajectory_conditional_probe`` over the
    7 labels (one collection of both splits); ``visualize_pathology``
    with ``--dim_reduce auto`` (the port's UMAP: the kNN on the card, the
    layout on the host) and ``tsne`` (the exact t-SNE on the card), its
    projections finite and [N·K, 2], its token t-SNE [N, 2], its two CSVs
    written (the card's host has no matplotlib); and
    ``train_trajectory_probe`` at ``--d_model 128 --epochs 3`` (no kernel:
    4 heads of 32 stay off the flash route), its AUROCs finite and its
    checkpoint, reloaded into the port's probe, reading the logged
    validation AUROC on the validation split (1e-6). Every run's launches
    are predicted from the splits and asserted; each run prints its wall
    seconds, its eval's samples/s, the bank build's seconds, the UMAP's
    and t-SNE's seconds and the probe's steps/s."""
    import math
    import torch
    from multimodal_edema_prediction_tpu_torch.ops import metrics as M
    cm = port["analysis_common"]
    out_root = os.path.join(REPO, "build", "chip_smoke_analysis_b")
    shutil.rmtree(out_root, ignore_errors=True)
    os.makedirs(out_root)
    args = argparse_args(port, ANALYSIS_STAYS)
    _, meta, data, _ = cm.load_analysis_data(args)
    split = {k: len(v) for k, v in data.splits.items()}
    ids_sorted = np.unique(data.anchor["image_ids"])
    L = port["config"].ViTConfig().n_layers
    K = len(port["config"].DataConfig().pathology_labels)
    bank_chunks = math.ceil(len(ids_sorted) / 16)

    def full_batches(name, bs=64):
        n = split[name]
        return 1 if 0 < n < bs else n // bs

    per_label = full_batches("train") + full_batches("test")
    viz_batches = min(full_batches("test"), 8)
    f32 = port["attention"].launch_key
    k1, k1f = "flash_attention", f32("flash_attention", torch.float32)
    vz, ttp = port["visualize_pathology"], port["train_trajectory_probe"]
    parts = {("conditional_information_probe", "collect_with_tokens"):
             ("eval", lambda r: len(r["y"])),
             ("raw_trajectory_conditional_probe", "collect"):
             ("eval", lambda r: len(r[0])),
             ("visualize_pathology", "_collect"):
             ("eval", lambda r: len(r["y"])),
             (port["umap_impl"].UMAP, "fit_transform"): ("umap", None),
             (port["tsne"].TSNE, "fit_transform"): ("tsne", None),
             ("train_trajectory_probe", "train_step"): ("step", None),
             ("analysis_common", "load_teacher"): ("load", None),
             (port["features"].CXRFeatureBank, "build"): ("build", None)}
    base = ["--device", "cuda", "--synthetic_stays", ANALYSIS_STAYS,
            "--n_boot", "20"]
    cond = base + ["--ckpt", frozen_ckpt, "--n_perm", "5"]
    hbm = ["--cxr_feature_cache", "hbm"]
    plan = [
        # (run, module, flags, float32, predicted launches)
        ("conditional", "conditional_information_probe", cond, False,
         {k1: L * K * per_label}),
        ("conditional_f32", "conditional_information_probe",
         cond + ["--label_idx", "0"], True, {k1f: L * per_label}),
        ("conditional_hbm_f32", "conditional_information_probe",
         cond + ["--label_idx", "0"] + hbm, True,
         {k1f: L * bank_chunks, "gather_rows_bulk": 2 * per_label}),
        ("conditional_hbm_f32_wrong_rows", "conditional_information_probe",
         cond + ["--label_idx", "0"] + hbm, True,
         {k1f: L * bank_chunks, "gather_rows_bulk": 2 * per_label}),
        # 3 folds of its host L-BFGS fits (the CLI's default 5) and 2
        # permutations (each a 5-fold refit; the other runs' 5): cut for
        # the script's time limit
        ("raw_trajectory", "raw_trajectory_conditional_probe",
         cond + ["--cv_folds", "3", "--n_perm", "2"], False,
         {k1: L * per_label}),
        ("visualize_umap", "visualize_pathology",
         base + ["--ckpt", frozen_ckpt, "--dim_reduce", "auto"], False,
         {k1: L * viz_batches}),
        ("visualize_tsne", "visualize_pathology",
         base + ["--ckpt", frozen_ckpt, "--dim_reduce", "tsne"], False,
         {k1: L * viz_batches}),
        ("trajectory_probe", "train_trajectory_probe",
         base + ["--d_model", "128", "--epochs", "3"], False, {}),
    ]
    runs, results = {}, {}
    for run, mod, argv, fp32, want in plan:
        out = os.path.join(out_root, run)
        argv = argv + ["--out_dir", out]
        main = port[mod].main
        if fp32:
            main = functools.partial(main, dtype=torch.float32)
        orig = cm.make_sources
        if run.endswith("_wrong_rows"):
            def shifted_sources(*a, **k):
                src, fs = orig(*a, **k)
                return src, _next_image_rows(fs, ids_sorted)
            cm.make_sources = shifted_sources
        try:
            r = _timed_main(port, main, argv, {
                k: v for k, v in parts.items() if not isinstance(k[0], str)
                or k[0] in (mod, "analysis_common")})
        finally:
            cm.make_sources = orig
        p = r["parts"]
        ev = p.get("eval", {"s": 0.0, "samples": 0})
        step = p.get("step", {"s": 0.0, "calls": 0})
        runs[run] = {
            "wall_s": r["wall_s"], "load_s": p.get("load", {}).get("s", 0.0),
            "build_s": p.get("build", {}).get("s"),
            "eval_s": ev["s"], "eval_samples": ev["samples"],
            "eval_samples_per_s": ev["samples"] / ev["s"] if ev["s"] else
            None,
            "umap_s": p.get("umap", {}).get("s"),
            "umap_calls": p.get("umap", {}).get("calls", 0),
            "tsne_s": p.get("tsne", {}).get("s"),
            "tsne_calls": p.get("tsne", {}).get("calls", 0),
            "steps": step["calls"],
            "steps_per_s": step["calls"] / step["s"] if step["s"] else None,
            "launches": r["launches"], "expected_launches": want,
            "files": sorted(os.listdir(out)),
            "peak_memory_bytes": r["peak_memory_bytes"]}
        results[run] = r["result"]
        emit({"phase": "analysis_b_run", "run": run, "card": card,
              **runs[run]})
    # the tiers: each probe's AUROC on label 0, float32
    label0 = port["config"].DataConfig().pathology_labels[0]
    aurocs = {run: {probe: results[run][label0][probe]["auroc"]
                    for probe in port["conditional_information_probe"]
                    .PROBES}
              for run in ("conditional_f32", "conditional_hbm_f32",
                          "conditional_hbm_f32_wrong_rows")}

    def gap(a, b):
        return max(abs(aurocs[a][k] - aurocs[b][k]) for k in aurocs[a])

    tier_gap = gap("conditional_f32", "conditional_hbm_f32")
    wrong_gap = gap("conditional_f32", "conditional_hbm_f32_wrong_rows")
    # the embeddings (N: the samples of the figure suite's full batches),
    # and the trajectory probe's checkpoint reloaded
    bs = min(64, split["test"])
    N = min(split["test"] - split["test"] % bs, 8 * bs)
    shapes = {}
    for run in ("visualize_umap", "visualize_tsne"):
        res = results[run]
        for kind, arrays, n in (("projection", res["projection"], N * K),
                                ("token_embedding", res["token_embedding"],
                                 N)):
            for tag in ("raw", "centered"):
                a = arrays.get(tag)
                shapes[f"{run}:{kind}:{tag}"] = {
                    "shape": None if a is None else list(a.shape),
                    "finite": a is not None and bool(np.isfinite(a).all()),
                    "want": [n, 2]}
    traj = results["trajectory_probe"]
    ck = os.path.join(out_root, "trajectory_probe", "trajectory_probe_best"
                      ".msgpack")
    with open(ck, "rb") as f:
        tree = port["checkpoint"].msgpack_restore(f.read())
    probe = port["convert"].load_flax(ttp.TrajectoryPathologyProbe(
        meta.n_variables, data.n_timesteps, K, 128), tree).to(device)
    idx = data.splits["val"]
    with torch.no_grad():
        logits = np.concatenate([probe(torch.as_tensor(
            cm.gather_host_windows(data, idx[i:i + 64])[0],
            device=device)).cpu().numpy() for i in range(0, len(idx), 64)])
    reloaded_val = M.macro_mean(M.masked_multilabel_metrics(
        data.anchor["y_multi"][idx], data.anchor["y_multi_mask"][idx],
        {"ts": logits}), "ts_auroc")
    info = {"phase": "analysis_b", "card": card, "stays": ANALYSIS_STAYS,
            "splits": split, "n_images": len(ids_sorted),
            "seconds": sum(r["wall_s"] for r in runs.values()),
            "wall_s_by_run": {k: r["wall_s"] for k, r in runs.items()},
            "eval_samples_per_s_by_run": {
                k: r["eval_samples_per_s"] for k, r in runs.items()},
            "build_s_by_run": {k: r["build_s"] for k, r in runs.items()
                               if r["build_s"] is not None},
            "umap_s_by_run": {k: r["umap_s"] for k, r in runs.items()
                              if r["umap_s"] is not None},
            "tsne_s_by_run": {k: r["tsne_s"] for k, r in runs.items()
                              if r["tsne_s"] is not None},
            "probe_steps_per_s": runs["trajectory_probe"]["steps_per_s"],
            "launches_by_run": {k: r["launches"] for k, r in runs.items()},
            "conditional_aurocs_label0": aurocs,
            "conditional_tier_max_auroc_diff": tier_gap,
            "conditional_wrong_rows_max_auroc_diff": wrong_gap,
            "tol": ANALYSIS_TIER_TOL,
            "evidence": {lab: {p: r[p].get("evidence") for p in r}
                         for lab, r in results["conditional"].items()},
            "raw_offset_logistic": {
                lab: None if "skipped" in r else {
                    k: r["offset_logistic"][k] for k in (
                        "auroc", "selected_l2", "p_conditional_perm",
                        "evidence")}
                for lab, r in results["raw_trajectory"].items()},
            "embeddings": shapes,
            "trajectory_probe": {
                "val_macro_auroc": traj["val_macro_auroc"],
                "test_macro_auroc": traj["test_macro_auroc"],
                "reloaded_val_macro_auroc": reloaded_val}}
    emit(info)
    info["runs"] = runs
    shutil.rmtree(out_root, ignore_errors=True)
    for run, r in runs.items():
        want = {k: v for k, v in r["expected_launches"].items() if v}
        if r["launches"] != want:
            raise AssertionError(f"analysis_b {run} launched {r['launches']}"
                                 f", expected {want}")
    if not (tier_gap <= ANALYSIS_TIER_TOL < wrong_gap):
        raise AssertionError(f"conditional probe tiers: {aurocs}")
    if not all(v["finite"] and v["shape"] == v["want"]
               for v in shapes.values()):
        raise AssertionError(f"visualize_pathology embeddings: {shapes}")
    for run in ("visualize_umap", "visualize_tsne"):
        if not {"query_cosine.csv", "gap_summary.csv"} <= set(
                runs[run]["files"]):
            raise AssertionError(f"{run} wrote {runs[run]['files']}")
    if not (np.isfinite(traj["val_macro_auroc"])
            and np.isfinite(traj["test_macro_auroc"])
            and abs(reloaded_val - traj["val_macro_auroc"]) <= 1e-6):
        raise AssertionError(f"trajectory probe: {info['trajectory_probe']}")
    grades = {"supported", "suggestive", "not_detected"}
    main_raw = info["raw_offset_logistic"][label0]
    if not (all(np.isfinite(v) for r in aurocs.values() for v in r.values())
            and all(g in grades for r in info["evidence"].values()
                    for p, g in r.items() if p != "image_cal")
            and main_raw is not None and np.isfinite(main_raw["auroc"])
            and main_raw["evidence"] in grades):
        raise AssertionError(f"conditional probes: {aurocs}, "
                             f"{info['evidence']}, raw {main_raw}")
    return info


INT8_RUNS = os.path.join(REPO, "build", "chip_smoke_int8")
# the JAX package's own bounds for the int8 ViT (tests/test_int8.py:47-70):
# the CLS token's error under 0.05 of its max abs, cosine over 0.999
INT8_CLS_TOL = 0.05
INT8_MIN_COS = 0.999
PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core rate
# the CPU plain version of each op runs on this many token rows of the
# card's input (quantization is per token, so rows are independent)
INT8_CPU_ROWS = 256


def _int8_op_case(port, device, name: str, kind: str, B: int, N: int,
                  K: int, F: int, dtype, H: int = 12) -> dict:
    """One op of ``ops/int8.py`` at a ViT-B shape on the card: its codes,
    scales and int32 accumulators against the plain product on the card
    (exactly), its output against the op with the plain product (exactly)
    and against the CPU plain version of the first INT8_CPU_ROWS tokens
    (codes and scales exactly; the output's gap reported)."""
    import torch
    I = port["int8"]
    g = torch.Generator(device=device).manual_seed(len(name))
    w = torch.randn(F, K, generator=g, device=device) * K ** -0.5
    b = torch.randn(F, generator=g, device=device) * 0.02
    if kind == "out_bhnk":      # [B, H, N, dh], a view of [B, N, H, dh]
        x = torch.randn(B, N, H, K // H, generator=g, device=device) \
            .to(dtype).transpose(1, 2)
        rows = x.transpose(1, 2).reshape(B * N, K)
    else:
        x = torch.randn(B, N, K, generator=g, device=device).to(dtype)
        rows = x.reshape(B * N, K)
    fn = {"dense": lambda x, mm: I.int8_dense(x, w, b, mm=mm),
          "proj_bhnk": lambda x, mm: I.int8_proj_bhnk(x, w, b, H, F // H,
                                                      mm=mm),
          "out_bhnk": lambda x, mm: I.int8_out_bhnk(x, w, b, mm=mm)}[kind]
    xq, sx = I.quantize_rows(rows)
    wq, sw = I.quantize_rows(w)
    acc = I.int_mm(xq, wq.t())
    acc_equal = torch.equal(acc, I.int_mm_reference(xq, wq.t()))
    out = fn(x, I.int_mm)
    out_equal = torch.equal(out, fn(x, I.int_mm_reference))
    # the CPU plain version on the first tokens of the first image
    n = min(INT8_CPU_ROWS, N)
    cpu_x = (x[:1, :, :n] if kind == "out_bhnk" else x[:1, :n]).cpu()
    cpu_w, cpu_b = w.cpu(), b.cpu()
    cpu_fn = {"dense": lambda: I.int8_dense_reference(cpu_x, cpu_w, cpu_b),
              "proj_bhnk": lambda: I.int8_proj_bhnk_reference(
                  cpu_x, cpu_w, cpu_b, H, F // H),
              "out_bhnk": lambda: I.int8_out_bhnk_reference(
                  cpu_x, cpu_w, cpu_b)}[kind]
    cpu_out = cpu_fn()
    card_out = (out[:1, :, :n] if kind == "proj_bhnk" else out[:1, :n]).cpu()
    cq, cs = I.quantize_rows(rows[:n].cpu())
    cwq, cws = I.quantize_rows(cpu_w)
    codes_equal = torch.equal(cq, xq[:n].cpu()) and torch.equal(
        cs, sx[:n].cpu()) and torch.equal(cwq, wq.cpu()) and torch.equal(
        cws, sw.cpu())
    gap = (card_out.float() - cpu_out.float()).abs()
    info = {"case": f"{name} {kind} [{B}, {N}, {K}] -> {F}, "
                    f"{str(dtype).split('.')[-1]}",
            "acc_equal": acc_equal, "out_equal_plain": out_equal,
            "codes_scales_equal_cpu": codes_equal,
            "cpu_bit_equal": bool(torch.equal(card_out, cpu_out)),
            "cpu_max_abs_err": float(gap.max()),
            "cpu_elements_differing": int((gap != 0).sum()),
            "acc_max_abs": int(acc.abs().max())}
    if not (acc_equal and out_equal and codes_equal):
        raise AssertionError(f"int8 op {name} disagrees with its plain "
                             f"version: {info}")
    return info


def _int8_gemm_times(port, device, M: int = 32 * 1370, K: int = 768,
                     N: int = 3072) -> dict:
    """One [M × K] × [K × N] product: bf16 ``torch.matmul`` against
    ``torch._int_mm`` on int8 codes, timed in alternation; the quantize
    pass alone; the whole ``int8_dense`` against ``F.linear`` in bf16; each
    with its bound (989 TFLOP/s bf16, 1,979 TOPS int8, 3.35 TB/s)."""
    import torch
    import torch.nn.functional as F
    I = port["int8"]
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(M, K, generator=g, device=device).bfloat16()
    w = torch.randn(N, K, generator=g, device=device) * K ** -0.5
    wb = w.bfloat16()
    xq, _ = I.quantize_rows(x)
    wq, _ = I.quantize_rows(w)
    wqt = wq.t()
    mm_bf16, mm_int8 = paired_ms([lambda: torch.matmul(x, wb.t()),
                                  lambda: torch._int_mm(xq, wqt)], device)
    dense_bf16, dense_int8 = paired_ms(
        [lambda: F.linear(x, wb), lambda: I.int8_dense(x, w)], device)
    quant = device_ms(lambda: I.quantize_rows(x), device)
    ops = 2.0 * M * K * N
    return {"case": f"[{M} x {K}] x [{K} x {N}]",
            "bf16_matmul_ms": mm_bf16, "int_mm_ms": mm_int8,
            "int_mm_vs_bf16": mm_int8 / mm_bf16,
            "bf16_bound_ms": max(ops / PEAK_BF16_FLOPS,
                                 (M * K + K * N + M * N) * 2 / PEAK_BYTES)
            * 1e3,
            "int_mm_bound_ms": max(ops / PEAK_INT8_OPS,
                                   (M * K + K * N + 4 * M * N) / PEAK_BYTES)
            * 1e3,
            "quantize_ms": quant,
            "quantize_bound_ms": (M * K * 2 + M * K + 4 * M) / PEAK_BYTES
            * 1e3,
            "dense_bf16_ms": dense_bf16, "int8_dense_ms": dense_int8,
            "int8_dense_vs_bf16": dense_int8 / dense_bf16}


def _device_families(prof) -> dict:
    """Device time (ms) of one profiled forward by family (``FAMILIES``),
    and its heaviest kernels."""
    rows = sorted([(e.device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if getattr(e.device_type, "name", "") == "CUDA"
                   and e.device_time_total > 0], reverse=True)
    if not rows:
        return {"device_time": "not measured (no device events)"}
    fam = dict.fromkeys([*FAMILIES, "other"], 0.0)
    for us, k, _ in rows:
        name = next((f for f, subs in FAMILIES.items()
                     if any(x in k.lower() for x in subs)), "other")
        fam[name] += us / 1e3
    return {"device_busy_ms": sum(r[0] for r in rows) / 1e3,
            "by_family_ms": fam,
            "top_kernels": [{"name": k[:90], "ms": us / 1e3, "launches": c}
                            for us, k, c in rows[:10]]}


def vit_forward_bound_ms(cfg, B: int, int8: bool) -> float:
    """The least time of one ViT forward: its products at the card's peak
    rate (the blocks' GEMMs at the int8 rate when quantized, attention and
    the patch embedding at the bf16 rate); the bytes are far below."""
    d, ff, L = cfg.d_model, cfg.d_feedforward, cfg.n_layers
    n = cfg.n_patches + 1
    gemm = 2.0 * B * n * (4 * d * d + 2 * d * ff) * L
    attn = 4.0 * B * cfg.n_heads * n * n * (d // cfg.n_heads) * L
    embed = 2.0 * B * cfg.n_patches * cfg.patch_size ** 2 * 3 * d
    return ((gemm / (PEAK_INT8_OPS if int8 else PEAK_BF16_FLOPS))
            + (attn + embed) / PEAK_BF16_FLOPS) * 1e3


def _int8_vits(port, device, cfg) -> dict:
    """The golden ViT-B/14 at 518² (``golden_vit_state``) with and without
    int8 products, in float32 and bf16: the CLS token within JAX's bounds,
    K1 12 times and 72 int8 products a quantized forward; then both
    forwards at batch 32 in bf16, timed in alternation, and one of each
    under ``utils/profiling.trace``."""
    import torch
    vit, att, I = port["vit"], port["attention"], port["int8"]
    sd = vit.convert_hf_dinov2(golden_vit_state(cfg), cfg)
    models = {}
    for quant in ("none", "int8"):
        m = vit.DinoViT(cfg.replace(quant=quant))
        m.load_state_dict(sd, strict=True)
        models[quant] = m.to(device).eval()
    S = cfg.image_size
    px = torch.from_numpy(np.linspace(0, 1, 2 * S * S * 3, dtype=np.float32)
                          .reshape(2, S, S, 3) * 0.8 + 0.1).to(device)
    out = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            cls_f, _ = models["none"](px.to(dtype))
            att.reset_launches()
            I.reset_calls()
            cls_q, patch_q = models["int8"](px.to(dtype))
            torch.cuda.synchronize()
            k1 = att.LAUNCHES[att.launch_key("flash_attention", dtype)]
            cls_f, cls_q = cls_f.float(), cls_q.float()
            err = float((cls_q - cls_f).abs().max() / cls_f.abs().max())
            cos = float((cls_q * cls_f).sum() / (cls_q.norm() * cls_f.norm()))
            name = str(dtype).split(".")[-1]
            out[name] = {"cls_rel_err": err, "cls_cosine": cos,
                         "k1_launches": k1,
                         "int_mm_calls": I.CALLS["int_mm"],
                         "finite": bool(torch.isfinite(patch_q).all())}
            if not (err < INT8_CLS_TOL and cos > INT8_MIN_COS
                    and out[name]["finite"]):
                raise AssertionError(f"int8 ViT-B ({name}) outside JAX's "
                                     f"bounds: {out[name]}")
            if k1 != cfg.n_layers or I.CALLS["int_mm"] != 6 * cfg.n_layers:
                raise AssertionError(f"int8 ViT-B ({name}) launched K1 {k1} "
                                     f"times and {I.CALLS['int_mm']} int8 "
                                     f"products, expected {cfg.n_layers} "
                                     f"and {6 * cfg.n_layers}")
        B = 32
        g = torch.Generator(device=device).manual_seed(0)
        px32 = torch.randn(B, S, S, 3, generator=g, device=device).bfloat16()
        bf16_ms, int8_ms = paired_ms(
            [lambda: models["none"](px32), lambda: models["int8"](px32)],
            device, reps=5, inner=1)
        profiles = {}
        for quant in ("none", "int8"):
            trace_dir = os.path.join(INT8_RUNS, f"trace_{quant}")
            with port["profiling"].trace(trace_dir) as prof:
                models[quant](px32)
                torch.cuda.synchronize()
            profiles[quant] = _device_families(prof)
    fam_q = profiles["int8"].get("by_family_ms", {})
    fam_f = profiles["none"].get("by_family_ms", {})
    passes = ("elementwise", "reduce_or_norm", "copy_or_cast")
    out["batch32_bf16"] = {
        "bf16_ms": bf16_ms, "int8_ms": int8_ms,
        "int8_vs_bf16": int8_ms / bf16_ms,
        "bf16_bound_ms": vit_forward_bound_ms(cfg, B, False),
        "int8_bound_ms": vit_forward_bound_ms(cfg, B, True),
        "profile_bf16": profiles["none"], "profile_int8": profiles["int8"],
        # what the int8 forward spends outside GEMMs and K1 beyond the bf16
        # one: the quantize and dequantize passes
        "quant_dequant_ms": (sum(fam_q.get(f, 0.0) for f in passes)
                             - sum(fam_f.get(f, 0.0) for f in passes))}
    return out


def _int8_serve(port, device, ckpt: str, seed: int = 0) -> dict:
    """The int8 checkpoint through the predictor: one request (bucket 1),
    then 8 at once (bucket 8), K1 12 a batch; the fusion probabilities
    against the same weights served unquantized, beside a control that
    pairs each with another request's."""
    import torch
    att = port["attention"]
    cfg = None
    preds = {}
    for quant in ("int8", "none"):
        model, cfg, _ = port["checkpoint"].load_teacher_from_ckpt(ckpt,
                                                                  device)
        if quant == "none":
            for m in model.cxr.modules():
                if hasattr(m, "quant"):
                    m.quant = "none"
        pred = port["predictor"].BatchingPredictor(
            model, max_batch=8, max_wait_ms=200.0, dtype=torch.bfloat16,
            device=device)
        d, S = cfg.duett, cfg.vit.image_size
        rng = np.random.default_rng(seed)
        reqs = [{"x_ts": np.concatenate(
                    [rng.normal(size=(d.n_timesteps, d.n_variables)),
                     rng.integers(-1, 4, size=(d.n_timesteps,
                                               d.n_variables))],
                    -1).astype(np.float32),
                 "static": rng.normal(size=d.d_static).astype(np.float32),
                 "pixel_u8": rng.integers(0, 256, (S, S, 3), np.uint8)}
                for _ in range(9)]
        pred.warmup(reqs[0])
        pred.start()
        try:
            torch.cuda.synchronize()
            att.reset_launches()
            first = pred.predict(reqs[0])
            futures = [pred.submit(r) for r in reqs[1:]]
            rest = [f.result(timeout=300) for f in futures]
            torch.cuda.synchronize()
            stats = pred.stats()
        finally:
            pred.close()
        preds[quant] = {
            "probs": np.asarray([r["probabilities"]
                                 for r in [first] + rest], np.float64),
            "k1_launches": att.LAUNCHES["flash_attention"],
            "batches": stats["n_batches"],
            "batch_size_hist": stats["batch_size_hist"]}
        del model, pred
    q, f = preds["int8"]["probs"], preds["none"]["probs"]
    info = {"requests": len(q),
            "batch_size_hist": preds["int8"]["batch_size_hist"],
            "k1_launches": preds["int8"]["k1_launches"],
            "batches": preds["int8"]["batches"],
            "fusion_prob_gap_vs_unquantized": float(np.abs(q - f).max()),
            "shuffled_row_control": float(np.abs(
                q - np.roll(f, 1, axis=0)).max())}
    if not np.isfinite(q).all():
        raise AssertionError(f"int8 serving gave non-finite probabilities")
    if info["k1_launches"] != cfg.vit.n_layers * info["batches"] \
            or info["batch_size_hist"] != {1: 1, 8: 1}:
        raise AssertionError(f"int8 serving: {info}, expected one batch of "
                             f"1 and one of 8, K1 12 a batch")
    return info


def phase_int8(port, device, card: str = "") -> dict:
    """The int8 branch (ROADMAP P20): the ops at ViT-B's shapes against
    their plain versions, the GEMM's and the quantize pass's times, the
    golden ViT-B int8 against unquantized (JAX's bounds, K1 and int8
    launches), both forwards timed and profiled, the teacher CLI with
    ``--vit_quant int8`` on procedural pixels and on the encode-once tier
    (launches as predicted, finite losses), and the int8 checkpoint
    served."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    t0 = time.perf_counter()
    shutil.rmtree(INT8_RUNS, ignore_errors=True)
    B, N = 32, 1370
    ops = [_int8_op_case(port, device, *case) for case in (
        ("qkv", "proj_bhnk", B, N, 768, 768, bf16),
        ("attn_out", "out_bhnk", B, N, 768, 768, bf16),
        ("mlp_in", "dense", B, N, 768, 3072, bf16),
        ("mlp_out", "dense", B, N, 3072, 768, bf16),
        ("mlp_in_f32", "dense", 2, N, 768, 3072, f32),
        # fewer than 17 rows: padded with zero rows on the card
        ("serve_cls", "dense", 1, 5, 768, 768, bf16))]
    gemm = _int8_gemm_times(port, device)
    vits = _int8_vits(port, device, port["config"].ViTConfig())
    torch.cuda.empty_cache()
    base = ["--device", "cuda", "--vit_quant", "int8", "--synthetic_stays",
            "240", "--batch_size", "32", "--epochs", "1", "--limit_batches",
            "4", "--warmup_steps", "2", "--no_save_state"]
    runs = {}
    for tier in ("pixels", "hbm"):
        argv = base + ["--ckpt_dir", os.path.join(INT8_RUNS, tier)] + (
            ["--cxr_feature_cache", "hbm"] if tier == "hbm" else [])
        r = _mode_run(port, device, argv, tier)
        n_vit = r["expected_launches"]["flash_attention"] // 12
        r["expected_int8_calls"] = 6 * 12 * n_vit
        runs[tier] = r
    serve = _int8_serve(port, device, runs["pixels"]["best_path"])
    info = {"phase": "int8", "card": card, "ops": ops, "gemm": gemm,
            "vit": vits, "serve": serve,
            "runs": {t: {k: v for k, v in r.items()
                         if k not in ("history", "best_path")}
                     for t, r in runs.items()},
            "seconds": time.perf_counter() - t0}
    emit(info)
    for tier, r in runs.items():
        if r["launches"] != r["expected_launches"] or \
                r["int8_calls"]["int_mm"] != r["expected_int8_calls"]:
            raise AssertionError(
                f"int8 {tier} run launched {r['launches']} and "
                f"{r['int8_calls']} int8 products, expected "
                f"{r['expected_launches']} and {r['expected_int8_calls']}")
        if not all(np.isfinite(x) for x in r["epoch_losses"]):
            raise AssertionError(f"int8 {tier} run: non-finite losses "
                                 f"{r['epoch_losses']}")
        if r["reload_max_abs_diff"] > SERVE_TOL:
            raise AssertionError(f"int8 {tier} run: the reloaded best "
                                 f"checkpoint evaluates differently "
                                 f"({r['reload_max_abs_diff']})")
    shutil.rmtree(os.path.join(INT8_RUNS, "pixels"), ignore_errors=True)
    shutil.rmtree(os.path.join(INT8_RUNS, "hbm"), ignore_errors=True)
    return info


def argparse_args(port, stays: str):
    """The analysis scripts' parsed default flags at ``stays``."""
    import argparse
    p = argparse.ArgumentParser()
    port["analysis_common"].add_analysis_flags(p, needs_ckpt=False)
    return p.parse_args(["--synthetic_stays", stays])


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


# --- RAD-DINO conversion with no JAX on the card's host --------------------
RAD_DINO_RUNS = os.path.join(REPO, "build", "chip_smoke_rad_dino")
# the teacher CLI from the converted file: 1 epoch of 2 batches
RAD_DINO_BATCH = 16
RAD_DINO_LIMIT = 2


# the converter's check against transformers' Dinov2Model, in a process of
# its own on the CPU: argv the converted file, the Hugging Face directory
# and the ViT's config as JSON
RAD_DINO_VERIFY = """
import json, sys, time
t0 = time.perf_counter()
from multimodal_edema_prediction_tpu_torch.cli import convert_rad_dino as C
from multimodal_edema_prediction_tpu_torch.config import ViTConfig
from multimodal_edema_prediction_tpu_torch.models.vit import (DinoViT,
                                                              load_vit_params)
cfg = ViTConfig.from_dict(json.loads(sys.argv[3]))
vit = DinoViT(cfg)
vit.load_state_dict(load_vit_params(sys.argv[1], cfg), strict=True)
err = C.verify(vit.eval(), sys.argv[2], cfg)
print(json.dumps({"max_abs_err": err, "seconds": time.perf_counter() - t0}))
"""
RAD_DINO_VERIFY_TIMEOUT = 300


def _kill(proc) -> None:
    """Kill ``proc`` (a ``Popen``, or None) if it still runs."""
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.communicate()


def rad_dino_state(shapes: list, seed: int = 0) -> dict:
    """A seeded ``Dinov2Model`` state dict of ``shapes`` (Hugging Face's
    names and shapes, ``models/vit.py::hf_dinov2_shapes``), float32:
    weights and biases N(0, 0.02²), the LayerNorms' weights 1 + N(0,
    0.02²), the layer scales 0.1 + N(0, 0.01²)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes:
        x = rng.standard_normal(shape, dtype=np.float32)
        if "norm" in name and name.endswith(".weight"):
            out[name] = 1.0 + 0.02 * x
        elif "layer_scale" in name:
            out[name] = 0.1 + 0.01 * x
        else:
            out[name] = 0.02 * x
    return out


def hf_to_flax(name: str) -> tuple:
    """A Hugging Face Dinov2 array's flax path (a tuple of keys) and the
    transpose that takes it there, written out apart from the converters
    (JAX ``convert_hf_dinov2``'s layout): linear weights [out, in] become
    kernels [in, out], the patch conv [D, 3, P, P] an HWIO kernel."""
    parts = name.split(".")
    leaf = {"weight": "kernel", "bias": "bias"}
    if name.startswith("embeddings.patch_embeddings.projection."):
        return ("patch_embed", leaf[parts[-1]]), \
            ((2, 3, 1, 0) if parts[-1] == "weight" else None)
    if name == "embeddings.cls_token":
        return ("cls_token",), None
    if name == "embeddings.position_embeddings":
        return ("pos_embed",), None
    if name.startswith("layernorm."):
        return ("final_norm", {"weight": "scale", "bias": "bias"}[
            parts[-1]]), None
    block = f"block_{parts[2]}"
    rest = ".".join(parts[3:])
    if rest.startswith(("norm1.", "norm2.")):
        return (block, parts[3], {"weight": "scale", "bias": "bias"}[
            parts[-1]]), None
    if rest.startswith("layer_scale"):
        return (block, f"layerscale{rest[len('layer_scale')]}"), None
    sub = {"attention.attention.query": ("attn", "q"),
           "attention.attention.key": ("attn", "k"),
           "attention.attention.value": ("attn", "v"),
           "attention.output.dense": ("attn", "out"),
           "mlp.fc1": ("mlp_in",), "mlp.fc2": ("mlp_out",)}[
        ".".join(parts[3:-1])]
    return (block, *sub, leaf[parts[-1]]), \
        ((1, 0) if parts[-1] == "weight" else None)


def _vit_tokens(model, px, dtype) -> tuple:
    import torch
    with torch.inference_mode():
        cls, patches = model(px.to(dtype))
    torch.cuda.synchronize()
    return cls.float().cpu().numpy(), patches.float().cpu().numpy()


def phase_rad_dino(port, device, card: str = "") -> dict:
    """RAD-DINO weights to the port's teacher on a host with no JAX, no
    ``transformers`` and no ``safetensors``: a seeded ViT-B/14 state dict
    in Hugging Face's names and shapes written as ``model.safetensors`` in
    numpy (``utils/safetensors_io.py``) with ``config.json`` and
    ``preprocessor_config.json``; ``cli/convert_rad_dino.main`` on that
    directory with ``transformers`` and ``safetensors`` hidden (it must say
    the conversion is unverified), and where the host has
    ``transformers`` the converter's ``verify`` of the file's ViT on the
    CPU against ``Dinov2Model``, started here and collected by
    ``finish_rad_dino_check``; every converted
    array equal to its source after the mapping's transposes; the
    full-width ViT from the file through K1 against the same ViT through
    ``flash_mha_reference``, in bf16 (TOL_BF16 of each output's max abs)
    and in float32 (the golden phase's atol 2e-4, rtol 1e-3), K1 12 times
    a forward; then ``cli/train_teacher.main --vit_weights`` at full width
    on procedural pixels (bf16, 1 epoch of RAD_DINO_LIMIT batches of
    RAD_DINO_BATCH): K1 12 a train and eval step, finite losses, and the
    best checkpoint's ViT bit-equal to the converted file's."""
    import contextlib
    import io

    import torch
    t_phase = time.perf_counter()
    shutil.rmtree(RAD_DINO_RUNS, ignore_errors=True)
    cfg = port["config"].ViTConfig()
    hf_dir = os.path.join(RAD_DINO_RUNS, "rad-dino")
    os.makedirs(hf_dir)
    t0 = time.perf_counter()
    sd = rad_dino_state(port["vit"].hf_dinov2_shapes(cfg))
    port["safetensors_io"].save_file(sd, os.path.join(
        hf_dir, "model.safetensors"), metadata={"format": "pt"})
    with open(os.path.join(hf_dir, "config.json"), "w") as f:
        json.dump({"model_type": "dinov2", "hidden_size": cfg.d_model,
                   "num_hidden_layers": cfg.n_layers,
                   "num_attention_heads": cfg.n_heads,
                   "mlp_ratio": cfg.d_feedforward // cfg.d_model,
                   "image_size": cfg.image_size,
                   "patch_size": cfg.patch_size}, f)
    with open(os.path.join(hf_dir, "preprocessor_config.json"), "w") as f:
        json.dump({"image_mean": [0.5307] * 3, "image_std": [0.2583] * 3},
                  f)
    write_s = time.perf_counter() - t0
    out = os.path.join(RAD_DINO_RUNS, "rad_dino_flax.msgpack")
    # where this host has transformers, the converter's own check runs too,
    # in a process of its own on 2 host threads beside the phases after
    # this one (``finish_rad_dino_check``), so that transformers, and what
    # it loads, stays out of this process
    checker = None
    printed = io.StringIO()
    # the route of a host with neither transformers nor safetensors, taken
    # whether or not this host has them (each hidden for the call)
    hidden = ("transformers", "safetensors")
    installed = {m: importlib.util.find_spec(m) is not None
                 for m in hidden + ("jax",)}
    saved = {m: sys.modules.get(m) for m in hidden}
    t0 = time.perf_counter()
    try:
        for m in hidden:
            sys.modules[m] = None
        with contextlib.redirect_stdout(printed):
            conv = port["cli_convert_rad_dino"].main(
                ["--source", hf_dir, "--out", out])
    finally:
        for m, mod in saved.items():
            if mod is None:
                del sys.modules[m]
            else:
                sys.modules[m] = mod
    convert_s = time.perf_counter() - t0
    unverified = "UNVERIFIED: transformers is not installed" \
        in printed.getvalue()
    if installed["transformers"]:
        checker = subprocess.Popen(
            [sys.executable, "-c", RAD_DINO_VERIFY, out, hf_dir,
             json.dumps(cfg.to_dict())], cwd=REPO,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                 "OMP_NUM_THREADS": "2"},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        atexit.register(_kill, checker)
    manifest = conv["manifest"]
    params = port["checkpoint"].load_checkpoint(out)["params"]
    mismatched, checked = [], 0
    for name, arr in sd.items():
        if name == "embeddings.mask_token":     # unused by the ViT
            continue
        checked += 1
        path, perm = hf_to_flax(name)
        node = params
        for key in path:
            node = node[key]
        want = arr.transpose(perm) if perm else arr
        if node.dtype != np.float32 or node.shape != want.shape \
                or not np.array_equal(node, want):
            mismatched.append(name)
    n_source = sum(a.size for k, a in sd.items()
                   if k != "embeddings.mask_token")
    del sd

    # the full-width ViT from the file: K1 against the plain attention
    vit, att = port["vit"], port["attention"]
    layers = sys.modules[f"{PKG}.models.layers"]
    model = vit.DinoViT(cfg)
    model.load_state_dict(vit.load_vit_params(out, cfg), strict=True)
    model = model.to(device).eval()
    S = cfg.image_size
    g = torch.Generator(device=device).manual_seed(0)
    px = torch.rand(2, S, S, 3, generator=g, device=device)
    tokens = {}
    for dtype, tol in ((torch.bfloat16, None), (torch.float32, (2e-4, 1e-3))):
        name = str(dtype).split(".")[-1]
        reset_counts(port)
        got = _vit_tokens(model, px, dtype)
        k1_key = att.launch_key("flash_attention", dtype)
        k1 = read_counts(port)[k1_key]
        kernel = layers.flash_mha
        layers.flash_mha = att.flash_mha_reference
        try:
            want = _vit_tokens(model, px, dtype)
        finally:
            layers.flash_mha = kernel
        errs = [float(np.abs(a - b).max()) for a, b in zip(got, want)]
        scale = [float(np.abs(b).max()) for b in want]
        if tol is None:
            ok = all(e <= TOL_BF16 * s for e, s in zip(errs, scale))
        else:
            ok = all(np.allclose(a, b, atol=tol[0], rtol=tol[1])
                     for a, b in zip(got, want))
        tokens[name] = {"k1_key": k1_key, "k1_launches": k1,
                        "max_abs_err_cls": errs[0],
                        "max_abs_err_patches": errs[1],
                        "max_abs_cls": scale[0], "max_abs_patches": scale[1],
                        "within_tol": bool(ok),
                        "finite": bool(all(np.isfinite(a).all()
                                           for a in got))}
    del model
    torch.cuda.empty_cache()

    # the teacher CLI from the file, the CXR branch frozen
    argv = ["--device", "cuda", "--synthetic_stays", SHORT_STAYS,
            "--batch_size", str(RAD_DINO_BATCH), "--epochs", "1",
            "--limit_batches", str(RAD_DINO_LIMIT), "--no_save_state",
            "--vit_weights", out, "--ckpt_dir",
            os.path.join(RAD_DINO_RUNS, "teacher")]
    torch.cuda.synchronize()
    reset_counts(port)
    t0 = time.perf_counter()
    res = port["train_teacher"].main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k: v for k, v in read_counts(port).items() if v}
    ex = res.extras
    expect = {"flash_attention": cfg.n_layers * (ex["n_train_steps"]
                                                 + ex["n_eval_steps"])}
    best = _flat(port["checkpoint"].load_checkpoint(
        res.best_path)["params"]["cxr"])
    src = _flat(params)
    vit_equal = best.keys() == src.keys() and all(
        best[k].dtype == v.dtype and best[k].tobytes() == v.tobytes()
        for k, v in src.items())
    losses = [h["train_total"] for h in res.history]
    info = {"phase": "rad_dino", "card": card,
            "geometry": [S, cfg.patch_size, cfg.d_model, cfg.n_layers],
            "safetensors_MB": os.path.getsize(os.path.join(
                hf_dir, "model.safetensors")) / 1e6,
            "msgpack_MB": os.path.getsize(out) / 1e6,
            "write_s": write_s, "convert_s": convert_s,
            "convert_lines": printed.getvalue().strip().splitlines(),
            "unverified_line": unverified,
            "verified_max_abs_err": manifest["verified_max_abs_err"],
            "host_has": installed,
            "vs_transformers": "running" if checker else "not installed",
            "n_params": manifest["n_params"], "n_source": int(n_source),
            "arrays_checked": checked,
            "arrays_mismatched": mismatched, "tokens": tokens,
            "teacher": {"argv": argv, "wall_s": train_s,
                        "train_steps": ex["n_train_steps"],
                        "eval_steps": ex["n_eval_steps"],
                        "launches": launches, "expected_launches": expect,
                        "epoch_losses": losses,
                        "vit_bit_equal_to_file": vit_equal},
            "modules_loaded": sorted(
                m for m in ("jax", "flax") if sys.modules.get(m) is not None),
            "seconds": time.perf_counter() - t_phase}
    emit(info)
    if checker is None:
        shutil.rmtree(RAD_DINO_RUNS, ignore_errors=True)
    else:
        # the checker reads the file and the directory; the teacher's run
        # directory goes now
        shutil.rmtree(os.path.join(RAD_DINO_RUNS, "teacher"),
                      ignore_errors=True)
    problems = []
    if not unverified or manifest["verified_max_abs_err"] is not None:
        problems.append("the converter did not say it was unverified")
    if mismatched or manifest["n_params"] != n_source:
        problems.append(f"converted arrays differ from the source: "
                        f"{mismatched[:8]}, {manifest['n_params']} params "
                        f"of {n_source}")
    for name, t in tokens.items():
        if not (t["within_tol"] and t["finite"]):
            problems.append(f"the ViT from the file in {name}: {t}")
        if t["k1_launches"] != cfg.n_layers:
            problems.append(f"K1 ({name}) launched {t['k1_launches']} "
                            f"times a forward, expected {cfg.n_layers}")
    if launches != expect:
        problems.append(f"the teacher launched {launches}, expected "
                        f"{expect}")
    if not vit_equal:
        problems.append("the trained teacher's ViT differs from the "
                        "converted file's")
    if not all(np.isfinite(losses)):
        problems.append(f"non-finite losses {losses}")
    if info["modules_loaded"]:
        problems.append(f"loaded {info['modules_loaded']}")
    if problems:
        raise AssertionError("rad_dino: " + "; ".join(problems))
    return {**info, "launches": launches, "checker": checker}


def finish_rad_dino_check(rad_dino: dict, card: str = "") -> dict:
    """Collect ``phase_rad_dino``'s check against transformers'
    ``Dinov2Model`` (the converted full-width ViT in float32 on the CPU,
    atol 2e-4, rtol 1e-3); one line; fails where it failed."""
    checker = rad_dino.pop("checker")
    info = {"phase": "rad_dino_vs_transformers", "card": card,
            "atol": 2e-4, "rtol": 1e-3}
    if checker is None:
        info["skipped"] = "transformers is not installed on this host"
        emit(info)
        return info
    try:
        text, _ = checker.communicate(timeout=RAD_DINO_VERIFY_TIMEOUT)
    finally:
        _kill(checker)
        shutil.rmtree(RAD_DINO_RUNS, ignore_errors=True)
    info["rc"] = checker.returncode
    try:
        info.update(json.loads(text.strip().splitlines()[-1]))
    except (ValueError, IndexError):
        info["output"] = text[-3000:]
    emit(info)
    if checker.returncode != 0 or "max_abs_err" not in info:
        raise AssertionError(f"the converted ViT against Dinov2Model: "
                             f"{info}")
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
    # record every batch the batcher runs (its bucket graph's replay), to
    # re-run it directly afterwards
    served_batches = []
    pred._forward = _recording_forward(pred, served_batches)
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


def _predict_split(port) -> tuple:
    """(the size of ``cli/predict``'s default split, its batch size): the
    CLI's own flags and data."""
    args = port["predict"].build_parser().parse_args(["--ckpt", "-"])
    _, _, data, _ = port["analysis_common"].load_analysis_data(args)
    return data.split_size(args.split), args.batch_size


# --- data parallelism over processes (ROADMAP P18) --------------------------
PARALLEL_RUNS = os.path.join(REPO, "build", "chip_smoke_parallel")
# the dual_patch teacher at the CLI's widths (ViT-B/14 at 518², DuETT at its
# defaults) in float32, one epoch of 3 global batches of 32 on procedural
# pixels; the encode-once tier adds --cxr_feature_cache host
PARALLEL_ARGV = ["--device", "cuda", "--mixed_precision", "no",
                 "--synthetic_stays", "240", "--batch_size", "32",
                 "--epochs", "1", "--limit_batches", "3", "--no_save_state"]
PARALLEL_CACHED = ["--cxr_feature_cache", "host", "--limit_batches", "5"]
# the pixel runs (world 1 with and without its group, each gloo rank) also
# run the gradient-flow diagnostics after their epoch, over one val batch
# (ROADMAP P18b): every rank on the same rows as one process
PARALLEL_DIAG = ["--grad_diag_every", "1", "--grad_diag_batches", "1"]
# multi-step dispatch across processes (ROADMAP P10b), K = 4 over 5
# batches an epoch (a group of 4 and a remainder of 1): on the gloo ranks
# the encode-once run above at K = 4 (a loop) against itself at K = 1; in
# the world-1 NCCL group the encode-once teacher in bf16, 2 epochs of 5
# batches of 16 (the first runs each shape eagerly, the second captures
# it), at K = 1 and K = 4
PARALLEL_K_ARGV = ["--device", "cuda", "--synthetic_stays", "120",
                   "--batch_size", "16", "--epochs", "2", "--limit_batches",
                   "5", "--patience", "10", "--no_save_state",
                   "--cxr_feature_cache", "host"]
PARALLEL_K = 4
# seconds a rank may take before the phase kills it and fails
PARALLEL_RANK_TIMEOUT = 420
# JAX's two-process tolerances (tests/test_multihost_2proc.py): the ranks
# against each other, and rank 0 against one process
PARALLEL_RANKS_TOL = 1e-12
PARALLEL_LOSS_RTOL = 1e-3
PARALLEL_METRIC_TOL = 5e-3
# the chunk of a feature build (data/features.py) and K1's launches per ViT
# forward (one per layer of ViT-B)
BUILD_CHUNK = 16
K1_PER_FORWARD = 12


def _parallel_teacher(port, argv: list, ckpt_dir: str,
                      partition: int = 0) -> dict:
    """One teacher run through the CLI's own helpers (flags → configs, the
    synthetic cohort, the launcher's group joined) and ``train_teacher``,
    its launches counted over exactly this run. ``partition`` composes the
    batches by ``image_id % partition`` in one process, as that many
    processes compose them."""
    import torch
    cli = port["train_teacher"]
    args = cli.build_parser().parse_args(argv)
    cli.join_process_group(args)
    dcfg, duett, tcfg = cli.configs_from_args(args)
    _, meta, ads = cli.load_data(args, dcfg)
    if partition:
        ads.host_partition_count = partition
    teacher_cfg = cli.teacher_config(
        args, dcfg, cli.sync_duett_with_meta(duett, meta),
        cli.vit_config(args))
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.cuda.synchronize()
    reset_counts(port)
    t0 = time.perf_counter()
    lines = []
    res = port["teacher_loop"].train_teacher(
        ads, teacher_cfg, tcfg, ckpt_dir, dcfg.pathology_labels,
        device="cuda", feature_cache=args.cxr_feature_cache,
        save_full_state=args.save_state, log=lines.append,
        grad_diag_every=args.grad_diag_every,
        grad_diag_batches=args.grad_diag_batches, **cli.image_kwargs(args))
    torch.cuda.synchronize()
    ex = res.extras
    every = args.grad_diag_every
    diag_epochs = sum(1 for e in range(len(res.history))
                      if every > 0 and (e + 1) % every == 0)
    digest = hashlib.sha256()
    for k, t in sorted(_train_state_of(res).items()):
        digest.update(k.encode())
        digest.update(t.cpu().contiguous().numpy().tobytes())
    return {"wall_s": time.perf_counter() - t0,
            "multistep_lines": [ln for ln in lines if "[multistep]" in ln],
            "state_digest": digest.hexdigest(),
            "history": res.history, "best_metric": res.best_metric,
            "test_auroc": res.test_metrics["main_auroc"],
            "best_path": res.best_path, "launches": read_counts(port),
            "train_steps": ex["n_train_steps"],
            "eval_steps": ex["n_eval_steps"],
            # the diagnostics' forwards: one a val batch of each diagnosed
            # epoch
            "diag_batches": diag_epochs * args.grad_diag_batches,
            "diag_lines": sum("grad-flow diagnostics" in ln for ln in lines),
            "step_ms": ex["phase_seconds"]["train"]
            / ex["n_train_steps"] * 1e3,
            "feature_tier": {k: v for k, v in ex["feature_tier"].items()
                             if k in ("tier", "n_images", "build_s")},
            "files": sorted(os.listdir(ckpt_dir))}


def _nccl_graph_capture(dist) -> dict:
    """An all-reduce captured in a ``torch.cuda.CUDAGraph`` in the NCCL
    group (after an eager one made the communicator): the capture runs
    nothing, each replay adds 1 and all-reduces. With the torch and NCCL
    versions, the NCCL environment the process group reads, and any
    warning the capture raised."""
    import warnings

    import torch
    t = torch.zeros(4, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.cuda.graph(g):
            t.add_(1.0)
            dist.all_reduce(t)
    torch.cuda.synchronize()
    after_capture = t.tolist()
    g.replay()
    g.replay()
    torch.cuda.synchronize()
    return {"after_capture": after_capture, "after_two_replays": t.tolist(),
            "torch": torch.__version__,
            "nccl": ".".join(map(str, torch.cuda.nccl.version())),
            "env": {k: v for k, v in os.environ.items()
                    if k.startswith(("TORCH_NCCL", "NCCL_"))},
            "warnings": [str(w.message)[:300] for w in caught]}


def parallel_worker(rank: int, world: int, port_no: int, out: str) -> int:
    """``chip_smoke.py --parallel-worker RANK WORLD PORT DIR``: one rank of
    the parallel phase. World 1: the pixel run with no process group, then
    an NCCL group of one, an all-reduce through it, an all-reduce captured
    in a CUDA graph and replayed twice, the pixel run and the encode-once
    run (batches composed for 2 partitions) inside it, and the multi-step
    runs (PARALLEL_K_ARGV at K = 1 and PARALLEL_K: captured). World 2 (the
    launcher's environment, set by the phase): the CLI helpers join a gloo
    group (the ranks share the card), and the pixel, encode-once and
    multi-step runs (a loop over gloo) follow on this rank's rows and
    partition. Writes ``result_{rank}.json`` under ``out``."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: parallel rank without a CUDA device",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    port = import_port()
    port["build"].build_all()
    dist, mh = torch.distributed, port["multihost"]
    res = {"rank": rank, "world": world}
    k_flag = ["--steps_per_call", str(PARALLEL_K)]
    pixel_argv = PARALLEL_ARGV + PARALLEL_DIAG
    if world == 1:
        res["no_group"] = _parallel_teacher(
            port, pixel_argv, os.path.join(out, "no_group"))
        dist.init_process_group(mh.choose_backend(1, "cuda"),
                                init_method=f"tcp://localhost:{port_no}",
                                world_size=1, rank=0)
        t = torch.full((4,), 2.0, device="cuda")
        dist.all_reduce(t)
        res["all_reduce"] = t.tolist()
        res["pixels"] = _parallel_teacher(
            port, pixel_argv, os.path.join(out, "world1_pixels"))
        res["cached"] = _parallel_teacher(
            port, PARALLEL_ARGV + PARALLEL_CACHED,
            os.path.join(out, "world1_cached"), partition=2)
        res["nccl_graph"] = _nccl_graph_capture(dist)
        res["k1"] = _parallel_teacher(port, PARALLEL_K_ARGV,
                                      os.path.join(out, "world1_k1"))
        res[f"k{PARALLEL_K}"] = _parallel_teacher(
            port, PARALLEL_K_ARGV + k_flag,
            os.path.join(out, f"world1_k{PARALLEL_K}"))
    else:
        res["pixels"] = _parallel_teacher(
            port, pixel_argv, os.path.join(out, f"rank{rank}_pixels"))
        res["cached"] = _parallel_teacher(
            port, PARALLEL_ARGV + PARALLEL_CACHED,
            os.path.join(out, f"rank{rank}_cached"))
        res[f"cached_k{PARALLEL_K}"] = _parallel_teacher(
            port, PARALLEL_ARGV + PARALLEL_CACHED + k_flag,
            os.path.join(out, f"rank{rank}_cached_k{PARALLEL_K}"))
    res["backend"] = dist.get_backend()
    res["process_count"] = mh.process_count()
    with open(os.path.join(out, f"result_{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port_no = s.getsockname()[1]
    s.close()
    return port_no


def _start_ranks(world: int, out: str, port_no: int) -> tuple:
    """``world`` worker processes of this script (``--parallel-worker``),
    under a launcher's environment when ``world`` > 1, started and not
    waited for (``_wait_ranks``)."""
    os.makedirs(out, exist_ok=True)
    procs = []
    for r in range(world):
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                            "LOCAL_WORLD_SIZE")}
        if world > 1:
            env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port_no),
                       RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(world))
        log = open(os.path.join(out, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-worker",
             str(r), str(world), str(port_no), out],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return world, out, procs, time.monotonic() + PARALLEL_RANK_TIMEOUT


def _stop_ranks(started: tuple) -> None:
    """Kills what is left of ``_start_ranks``' processes, closes their
    logs."""
    for p, log in started[2]:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def _wait_ranks(started: tuple) -> list:
    """The ranks of ``_start_ranks``: each must end within
    PARALLEL_RANK_TIMEOUT of its start with code 0, else every rank is
    killed and the phase fails. → their results, by rank."""
    world, out, procs, deadline = started
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"a rank of {world} ran past "
                             f"{PARALLEL_RANK_TIMEOUT} s")
    finally:
        _stop_ranks(started)
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out, f"rank{r}.log")) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"rank {r} of {world} exited with "
                                 f"{p.returncode}:\n{tail}")
    results = []
    for r in range(world):
        with open(os.path.join(out, f"result_{r}.json")) as f:
            results.append(json.load(f))
    return results


def _totals(history: list) -> list:
    return [h["train_total"] for h in history]


def _check_rank_vs_world1(got: dict, want: dict, what: str) -> dict:
    """Rank 0 against the one-process run: each epoch's losses within
    PARALLEL_LOSS_RTOL, the best metric and the test AUROC within
    PARALLEL_METRIC_TOL; → the gaps."""
    gaps = {"loss_rel": max(abs(g - w) / abs(w) for g, w in zip(
        _totals(got["history"]), _totals(want["history"]))),
        "best_metric": abs(got["best_metric"] - want["best_metric"]),
        "test_auroc": abs(got["test_auroc"] - want["test_auroc"])}
    if len(got["history"]) != len(want["history"]) \
            or gaps["loss_rel"] > PARALLEL_LOSS_RTOL \
            or gaps["best_metric"] > PARALLEL_METRIC_TOL \
            or gaps["test_auroc"] > PARALLEL_METRIC_TOL:
        raise AssertionError(f"{what}: two ranks against one process "
                             f"{gaps}")
    return gaps


def _check_ranks_agree(r0: dict, r1: dict, what: str) -> float:
    """The two ranks computed the same global losses and metrics."""
    gap = max([abs(a - b) for a, b in zip(_totals(r0["history"]),
                                          _totals(r1["history"]))]
              + [abs(r0["best_metric"] - r1["best_metric"]),
                 abs(r0["test_auroc"] - r1["test_auroc"])])
    if gap > PARALLEL_RANKS_TOL:
        raise AssertionError(f"{what}: the ranks disagree by {gap}")
    return gap


def _diag_rows(run: dict) -> list:
    """Each epoch's ``grad_diag/*`` scalars of a run's history."""
    return [{k: v for k, v in h.items() if k.startswith("grad_diag/")}
            for h in run["history"]]


def _diag_gap(a: dict, b: dict, abs_tol: float = 0.0,
              rel_tol: float = 0.0) -> dict:
    """The largest absolute and relative gaps between two runs'
    ``grad_diag/*``, and the keys outside both ``abs_tol`` and ``rel_tol``
    of ``b``'s value (NaN equal to NaN; a NaN against a number, or a key in
    one run only, is outside)."""
    ra, rb = _diag_rows(a), _diag_rows(b)
    gap = {"abs": 0.0, "rel": 0.0, "n": 0, "outside": []}
    if len(ra) != len(rb) or any(x.keys() != y.keys()
                                 for x, y in zip(ra, rb)):
        return {**gap, "outside": ["the runs' keys or epochs differ"]}
    for epoch, (x, y) in enumerate(zip(ra, rb)):
        for k in x:
            u, v = x[k], y[k]
            gap["n"] += 1
            if np.isnan(u) and np.isnan(v):
                continue
            d = abs(u - v)
            d = float("inf") if np.isnan(d) else d
            gap["abs"] = max(gap["abs"], d)
            gap["rel"] = max(gap["rel"], d / max(abs(v), 1e-30))
            if d > abs_tol and d > rel_tol * abs(v):
                gap["outside"].append(f"{epoch}:{k}")
    return gap


def _predicted_k1(run: dict) -> int:
    """K1's float32 launches a run should make: one per layer of every ViT
    forward, on the rank's rows, and of every val batch of the gradient-flow
    diagnostics (the whole batch on every rank; the frozen ViT takes no
    backward); the encode-once tier runs the ViT only in its build, over
    the rank's images in chunks of BUILD_CHUNK."""
    ft = run["feature_tier"]
    if ft["tier"] == "pixels":
        return K1_PER_FORWARD * (run["train_steps"] + run["eval_steps"]
                                 + run["diag_batches"])
    return K1_PER_FORWARD * -(-ft["n_images"] // BUILD_CHUNK)


def _serve_data_parallel(port, device, ckpt: str) -> dict:
    """``--data_parallel 1`` serves bit for bit as a predictor built
    without it; 2 raises ``create_mesh``'s error on a one-card host."""
    from concurrent.futures import Future

    import torch
    model, cfg, _ = port["checkpoint"].load_teacher_from_ckpt(ckpt, device)
    rng = np.random.default_rng(0)
    T, V, S = cfg.duett.n_timesteps, cfg.duett.n_variables, \
        cfg.vit.image_size
    reqs = [{"x_ts": rng.normal(size=(T, 2 * V)).astype(np.float32),
             "static": rng.normal(size=cfg.duett.d_static).astype(
                 np.float32),
             "pixel_u8": rng.integers(0, 256, (S, S, 3), dtype=np.uint8)}
            for _ in range(3)]
    outs = []
    for kw in ({}, {"data_parallel": 1}):
        pred = port["predictor"].BatchingPredictor(
            model, max_batch=4, max_wait_ms=0.0, dtype=torch.bfloat16,
            device="cuda", **kw)
        items = [pred._parse(r) for r in reqs]
        for it in items:
            it.future = Future()
        pred._run_batch(items)
        outs.append([it.future.result() for it in items])
    same = outs[0] == outs[1]
    refused = None
    try:
        port["predictor"].BatchingPredictor(model, device="cuda",
                                            data_parallel=2)
    except ValueError as e:
        refused = str(e)
    del model
    if not same:
        raise AssertionError("--data_parallel 1 serves differently")
    if torch.cuda.device_count() < 2 and refused is None:
        raise AssertionError("--data_parallel 2 on one card did not raise")
    return {"data_parallel_1_bit_equal": same, "data_parallel_2": refused}


def phase_parallel(port, device, card: str = "") -> dict:
    """Data parallelism over processes (ROADMAP P18), each rank a worker
    process of this script: (a) one rank in an NCCL group, the float32
    pixel run bit-equal to the same run with no group, then the encode-once
    run composed for 2 partitions; (b) two ranks sharing the card over
    gloo, 16 rows each, the pixel run and the encode-once run (each rank
    encoding its ``image_id % 2`` share into a host store): the ranks
    agree to PARALLEL_RANKS_TOL, rank 0 equals (a) within JAX's
    tolerances, only rank 0 wrote files, and each rank's K1 launches are
    as predicted (``_predicted_k1``; K2 none: the host store's tokens come
    with the batch). The pixel runs take the gradient-flow diagnostics
    (PARALLEL_DIAG), held rank against rank and against world 1. Then
    ``--data_parallel`` serving."""
    import torch
    shutil.rmtree(PARALLEL_RUNS, ignore_errors=True)
    t0 = time.perf_counter()
    # the two worlds run side by side on the card (started together to fit
    # the script's time limit): their step times are taken under each
    # other's load
    port_a = _free_port()
    port_b = _free_port()
    while port_b == port_a:
        port_b = _free_port()
    world1 = _start_ranks(1, os.path.join(PARALLEL_RUNS, "world1"), port_a)
    world2 = _start_ranks(2, os.path.join(PARALLEL_RUNS, "world2"), port_b)
    try:
        (a,) = _wait_ranks(world1)
        t_a = time.perf_counter() - t0
        b = _wait_ranks(world2)
        t_b = time.perf_counter() - t0
    finally:
        _stop_ranks(world1)
        _stop_ranks(world2)
    kk = f"k{PARALLEL_K}"
    runs = {"no_group": a["no_group"], "world1_pixels": a["pixels"],
            "world1_cached": a["cached"],
            **{f"rank{r}_{kind}": b[r][kind] for r in range(2)
               for kind in ("pixels", "cached", f"cached_{kk}")}}
    info = {"phase": "parallel", "card": card,
            "backends": {"world1": a["backend"],
                         "world2": [x["backend"] for x in b]},
            "nccl_all_reduce": a["all_reduce"],
            "launches": {k: r["launches"] for k, r in runs.items()},
            "predicted_k1": {k: _predicted_k1(r) for k, r in runs.items()},
            "step_ms": {k: r["step_ms"] for k, r in runs.items()},
            "wall_s": {k: r["wall_s"] for k, r in runs.items()},
            "feature_tier": {k: r["feature_tier"] for k, r in runs.items()
                             if "cached" in k},
            "files": {k: r["files"] for k, r in runs.items()},
            "losses": {k: _totals(r["history"]) for k, r in runs.items()},
            "best_metric": {k: r["best_metric"] for k, r in runs.items()},
            "test_auroc": {k: r["test_auroc"] for k, r in runs.items()},
            "world1_s": t_a, "world2_s": t_b}
    problems = []
    if a["no_group"]["history"] != a["pixels"]["history"] \
            or a["no_group"]["best_metric"] != a["pixels"]["best_metric"] \
            or a["no_group"]["test_auroc"] != a["pixels"]["test_auroc"]:
        problems.append("an NCCL group of one changed the run")
    if a["backend"] != "nccl" or a["all_reduce"] != [2.0] * 4:
        problems.append(f"world 1: backend {a['backend']}, all-reduce "
                        f"{a['all_reduce']}")
    if any(x["backend"] != "gloo" or x["process_count"] != 2 for x in b):
        problems.append("world 2 did not run on a gloo group of 2")
    try:
        info["rank_gaps"] = {kind: _check_ranks_agree(
            b[0][kind], b[1][kind], kind) for kind in ("pixels", "cached")}
        info["vs_world1"] = {kind: _check_rank_vs_world1(
            b[0][kind], a[kind], kind) for kind in ("pixels", "cached")}
    except AssertionError as e:
        problems.append(str(e))
    # the gradient-flow diagnostics over processes (ROADMAP P18b): each
    # rank's grad_diag/* against the other's and against world 1's (the
    # tolerances of each epoch's loss and metric: the weights they read
    # differ by the ranks' summation order)
    diag = {"ranks": _diag_gap(b[0]["pixels"], b[1]["pixels"],
                               PARALLEL_RANKS_TOL),
            **{f"rank{r}_vs_world1": _diag_gap(
                b[r]["pixels"], a["pixels"], PARALLEL_METRIC_TOL,
                PARALLEL_LOSS_RTOL) for r in range(2)},
            "no_group_vs_world1": _diag_gap(a["no_group"], a["pixels"])}
    info["grad_diag"] = {
        "gaps": diag, "keys": diag["ranks"]["n"],
        "diag_batches": {k: runs[k]["diag_batches"] for k in (
            "no_group", "world1_pixels", "rank0_pixels", "rank1_pixels")},
        "world1": {k: v for k, v in _diag_rows(a["pixels"])[-1].items()
                   if "/label/" not in k} if a["pixels"]["history"] else {}}
    if diag["ranks"]["n"] == 0 or any(g["outside"] for g in diag.values()) \
            or any(v != 1 for v in info["grad_diag"]["diag_batches"].values()):
        problems.append(f"grad_diag over processes: {info['grad_diag']}")
    for k, r in runs.items():
        n = r["launches"]
        if n["flash_attention_f32"] != info["predicted_k1"][k] \
                or n["flash_attention"] or n["gather_rows_bulk"] \
                or n["gather_rows"]:
            problems.append(f"{k}: launches {n}, K1 float32 predicted "
                            f"{info['predicted_k1'][k]}, K2 none")
        if not all(np.isfinite(_totals(r["history"]))):
            problems.append(f"{k}: non-finite losses")
    for kind in ("pixels", "cached"):
        if b[1][kind]["files"] or not any(
                f.startswith("best-") for f in b[0][kind]["files"]):
            problems.append(f"{kind}: rank 0 wrote {b[0][kind]['files']}, "
                            f"rank 1 {b[1][kind]['files']}")
    own = [b[r]["cached"]["feature_tier"]["n_images"] for r in range(2)]
    if sum(own) != a["cached"]["feature_tier"]["n_images"]:
        problems.append(f"the ranks' partitions hold {own} images, one "
                        f"process {a['cached']['feature_tier']['n_images']}")
    # multi-step dispatch across processes: K = PARALLEL_K equals K = 1 bit
    # for bit in the world-1 NCCL group (captured: a graph for the groups
    # and one for the remainder) and on each gloo rank (a loop, logged)
    pairs = {"world1_nccl": (a["k1"], a[kk]),
             **{f"rank{r}_gloo": (b[r]["cached"], b[r][f"cached_{kk}"])
                for r in range(2)}}
    info["multistep"] = {
        name: {"k1_s": one["wall_s"], f"{kk}_s": many["wall_s"],
               "lines": many["multistep_lines"],
               "launches": {"k1": one["launches"], kk: many["launches"]},
               "bit_equal": many["history"] == one["history"]
               and many["state_digest"] == one["state_digest"]
               and many["launches"] == one["launches"]}
        for name, (one, many) in pairs.items()}
    info["nccl_graph"] = a["nccl_graph"]
    gloo_line = (f"[multistep] K={PARALLEL_K} as a loop over gloo (a "
                 "host-side collective cannot be captured)")
    for name, m in info["multistep"].items():
        if not m["bit_equal"]:
            problems.append(f"{name}: K={PARALLEL_K} differs from K=1")
        want = [gloo_line] if "gloo" in name else None
        if want is not None and m["lines"] != want or want is None and (
                len(m["lines"]) != 2 or not all(
                    "captured" in ln for ln in m["lines"])):
            problems.append(f"{name}: multistep lines {m['lines']}")
    if b[0][f"cached_{kk}"]["state_digest"] != \
            b[1][f"cached_{kk}"]["state_digest"]:
        problems.append("the gloo ranks' multi-step states differ")
    g = a["nccl_graph"]
    if g["after_capture"] != [0.0] * 4 or \
            g["after_two_replays"] != [2.0] * 4:
        problems.append(f"an NCCL all-reduce in a CUDA graph: {g}")
    info["serve"] = _serve_data_parallel(port, device,
                                         a["pixels"]["best_path"])
    info["seconds"] = time.perf_counter() - t0
    emit(info)
    shutil.rmtree(PARALLEL_RUNS, ignore_errors=True)
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("parallel: " + "; ".join(problems))
    return info


# --- serving's --aot_dir and bucket graphs (ROADMAP P10b) -------------------
AOT_RUNS = os.path.join(REPO, "build", "chip_smoke_aot")
# seconds a worker process may take before the phase kills it and fails
AOT_WORKER_TIMEOUT = 420
# the buckets whose direct step is timed eagerly and as a replay
AOT_TIMED_BUCKETS = (1, 8, 32)
# the jpeg_root run's images (the jpeg phase's cohort shape) and batches
AOT_JPEG_IMAGES = 24


def _aot_example(cfg) -> dict:
    d, S = cfg.duett, cfg.vit.image_size
    return {"x_ts": np.zeros((d.n_timesteps, 2 * d.n_variables), np.float32),
            "static": np.zeros(d.d_static, np.float32),
            "pixel_u8": np.zeros((S, S, 3), np.uint8)}


def _aot_bucket_arrays(pred, cfg, b: int, seed: int, pixels: bool = True
                       ) -> tuple:
    """A bucket's assembled host arrays (x_ts, static, batch) of ``b``
    random requests."""
    from concurrent.futures import Future
    d, S = cfg.duett, cfg.vit.image_size
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(b):
        r = {"x_ts": np.concatenate(
                [rng.normal(size=(d.n_timesteps, d.n_variables)),
                 rng.integers(-1, 4, size=(d.n_timesteps, d.n_variables))],
                -1).astype(np.float32),
             "static": rng.normal(size=d.d_static).astype(np.float32),
             "image_id": int(rng.integers(0, AOT_JPEG_IMAGES + 4))}
        if pixels:
            r["pixel_u8"] = rng.integers(0, 256, (S, S, 3), dtype=np.uint8)
        it = pred._parse(r)
        it.future = Future()
        items.append(it)
    return pred._assemble(items, b)


def _aot_bucket_checks(port, pred, cfg) -> dict:
    """Each bucket of the ladder on random inputs: the replayed outputs
    against the eager step's on the same inputs (bit for bit), K1's
    launches over the replay (12 a batch); at AOT_TIMED_BUCKETS the direct
    step eagerly and as a replay (host ms to the outputs on the host), the
    device time of back-to-back replays (CUDA events over the staging copy
    and the graph) and each route's idle share."""
    import torch
    step = pred._steps[0]
    out = {"bit_equal": {}, "k1_launches": {}, "timed": {}}
    device = pred._step_devices[0]
    for b in pred.buckets:
        x_ts, static, batch = _aot_bucket_arrays(pred, cfg, b, seed=b)
        torch.cuda.synchronize()
        reset_counts(port)
        with torch.inference_mode():
            got = pred._forward(x_ts, static, batch)
        torch.cuda.synchronize()
        out["k1_launches"][b] = read_counts(port)["flash_attention"]
        want = {k: v.cpu().numpy() for k, v in step(x_ts, static,
                                                   batch).items()}
        out["bit_equal"][b] = sorted(got) == sorted(want) and all(
            np.array_equal(got[k], want[k]) for k in want)
        if b not in AOT_TIMED_BUCKETS:
            continue
        parts = pred._parts(x_ts, static, batch)[0]
        graph = pred._graphs[(0, b)]

        def eager():
            return {k: v.cpu() for k, v in step(x_ts, static,
                                                batch).items()}

        def replay():
            with torch.inference_mode():
                return pred._forward(x_ts, static, batch)

        def device_only():
            graph.load(parts)
            graph.replay()

        e = _steady_calls(eager, device, 1)
        r = _steady_calls(replay, device, 1)
        dev = _steady_calls(device_only, device, 1)["device_ms_per_step"]
        out["timed"][b] = {"eager_ms": e["step_ms"], "replay_ms": r["step_ms"],
                           "replay_device_ms": dev,
                           "eager_idle": 1 - dev / e["step_ms"],
                           "replay_idle": 1 - dev / r["step_ms"],
                           "eager_over_replay": e["step_ms"] / r["step_ms"]}
    reset_counts(port)
    return out


def _aot_jpeg_root(port, out_dir: str) -> dict:
    """``jpeg_root`` serving through the bucket graphs: AOT_JPEG_IMAGES
    JPEGs written, ``cli/serve.jpeg_feature_source`` (the bank built
    through the ViT), a predictor warmed, a batch of 8 ids (a few not in
    the bank) replayed against the eager step, K2's launches over it (2 a
    batch) and an unknown id's answer (NaN)."""
    import torch
    from concurrent.futures import Future
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import jpeg_fixtures as J
    root = os.path.join(out_dir, "jpegs")
    J.write_jpegs(root, range(AOT_JPEG_IMAGES), *JPEG_COHORT_SHAPE,
                  processes=4)
    cfg = port["config"].TeacherConfig()
    model = port["teacher"].init_teacher(cfg, 1).to("cuda").eval()
    source, startup = port["cli_serve"].jpeg_feature_source(model, root)
    pred = port["predictor"].BatchingPredictor(
        model, feature_source=source, max_batch=32, max_wait_ms=0.0,
        device="cuda")
    example = _aot_example(cfg)
    example.pop("pixel_u8")
    pred.warmup(example)
    x_ts, static, batch = _aot_bucket_arrays(pred, cfg, 8, seed=3,
                                             pixels=False)
    torch.cuda.synchronize()
    reset_counts(port)
    with torch.inference_mode():
        got = pred._forward(x_ts, static, batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts(port).items() if v}
    want = {k: v.cpu().numpy()
            for k, v in pred._steps[0](x_ts, static, batch).items()}
    it = pred._parse({"x_ts": x_ts[0], "static": static[0],
                      "image_id": 10 ** 6})
    it.future = Future()
    pred._run_batch([it])
    unknown = it.future.result()["fusion_logits"]
    known = batch["image_ids"] < AOT_JPEG_IMAGES
    return {"n_images": startup["n_images"], "encode_s": startup["encode_s"],
            "launches": launches,
            "bit_equal": all(np.array_equal(got[k], want[k], equal_nan=True)
                             for k in want),
            "known_rows_finite": bool(np.isfinite(
                got["fusion_logits"][known]).all()),
            "unknown_id_nan": bool(np.isnan(unknown).all())}


def aot_worker(out: str, kind: str) -> int:
    """``chip_smoke.py --aot-worker DIR cold|warm``: one process of the
    ``aot_serve`` phase. Warms a pixel-mode predictor on the full-width
    teacher (seeded weights, the ladder 1..32) with ``aot_dir`` DIR/aot:
    the warm-up's seconds, ``aot_hits``, which kernel libraries this
    process built and which it found (``ops/build.origins``), the memory
    the graphs hold; the warm process also checks every bucket
    (``_aot_bucket_checks``) and serves ``jpeg_root`` through the graphs.
    Writes ``result_{kind}.json`` under DIR."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: aot worker without a CUDA device",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    port = import_port()
    cfg = port["config"].TeacherConfig()
    model = port["teacher"].init_teacher(cfg, 0)
    torch.cuda.synchronize()
    t_warm = time.perf_counter()
    pred = port["predictor"].BatchingPredictor(
        model, max_batch=32, max_wait_ms=0.0, dtype=torch.bfloat16,
        device="cuda", aot_dir=os.path.join(out, "aot"))
    by_bucket = pred.warmup(_aot_example(cfg))
    torch.cuda.synchronize()
    res = {"kind": kind, "warmup_s": time.perf_counter() - t_warm,
           "warmup_by_bucket_s": by_bucket,
           "aot_hits": {str(b): h for b, h in pred.aot_hits.items()},
           "origins": port["build"].origins(),
           "build_dir": port["build"].build_dir(),
           "memory_reserved_bytes": torch.cuda.memory_reserved(),
           "memory_allocated_bytes": torch.cuda.memory_allocated(),
           "graphs": len(pred._graphs)}
    if kind == "warm":
        res["buckets"] = _aot_bucket_checks(port, pred, cfg)
        del pred, model
        torch.cuda.empty_cache()
        res["jpeg_root"] = _aot_jpeg_root(port, out)
        res["origins_after_jpeg_root"] = port["build"].origins()
    res["process_s"] = time.perf_counter() - t0
    with open(os.path.join(out, f"result_{kind}.json"), "w") as f:
        json.dump(res, f)
    return 0


def _start_aot_worker(out: str, kind: str) -> tuple:
    """An ``--aot-worker`` process of this script, started and not waited
    for (``_finish_aot_worker``)."""
    log = open(os.path.join(out, f"{kind}.log"), "w")
    p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                          "--aot-worker", out, kind], cwd=REPO, stdout=log,
                         stderr=subprocess.STDOUT)
    return out, kind, p, log, time.perf_counter()


def _stop_aot_worker(started: tuple) -> None:
    _, _, p, log, _ = started
    if p.poll() is None:
        p.kill()
        p.wait()
    log.close()


def _finish_aot_worker(started: tuple) -> dict:
    """The worker's result; it must end within AOT_WORKER_TIMEOUT of its
    start with code 0, else it is killed and the phase fails."""
    out, kind, p, log, t0 = started
    try:
        p.wait(timeout=max(t0 + AOT_WORKER_TIMEOUT - time.perf_counter(), 1))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the {kind} aot worker ran past "
                             f"{AOT_WORKER_TIMEOUT} s")
    finally:
        _stop_aot_worker(started)
    if p.returncode != 0:
        with open(log.name) as f:
            raise AssertionError(f"the {kind} aot worker exited with "
                                 f"{p.returncode}:\n{f.read()[-4000:]}")
    with open(os.path.join(out, f"result_{kind}.json")) as f:
        return {**json.load(f), "wall_s": time.perf_counter() - t0}


def start_aot_cold() -> tuple:
    """The ``aot_serve`` phase's cold worker on a fresh AOT_RUNS, started
    and not waited for: ``main`` runs it beside the parallel phase's ranks
    (for the script's time limit), so its warm-up seconds are taken under
    their load."""
    shutil.rmtree(AOT_RUNS, ignore_errors=True)
    os.makedirs(AOT_RUNS)
    return _start_aot_worker(AOT_RUNS, "cold")


def phase_aot_serve(port, device, card: str = "",
                    cold: dict = None) -> dict:
    """Serving's ``--aot_dir`` and bucket graphs (ROADMAP P10b) at full
    width (``TeacherConfig()``, ViT-B/14 at 518, buckets 1..32), each step
    a worker process of this script (``--aot-worker``): a cold start on a
    fresh directory (every bucket a miss, every kernel library built into
    the directory's entry), then a restart in a fresh process on the same
    directory (every bucket a hit, every library found: no nvcc run), whose
    every bucket's replay equals the eager step bit for bit with K1 12 a
    batch, replays counted; the direct steps at AOT_TIMED_BUCKETS eagerly
    and as a replay with the idle share; ``torch.cuda.memory_reserved``
    after each warm-up; and ``jpeg_root`` served through the graphs (K2 2
    a batch, an unknown id NaN). ``cold``: the cold worker's result where
    ``start_aot_cold`` ran it earlier (``seconds`` is the two workers'
    wall seconds)."""
    import torch
    cold = cold or _finish_aot_worker(start_aot_cold())
    warm = _finish_aot_worker(_start_aot_worker(AOT_RUNS, "warm"))
    n_layers = port["config"].TeacherConfig().vit.n_layers
    info = {"phase": "aot_serve", "card": card, "cold": cold, "warm": warm,
            "seconds": cold["wall_s"] + warm["wall_s"]}
    emit(info)
    shutil.rmtree(AOT_RUNS, ignore_errors=True)
    problems = []
    buckets = ["1", "2", "4", "8", "16", "32"]
    if sorted(cold["aot_hits"], key=int) != buckets \
            or any(cold["aot_hits"].values()):
        problems.append(f"cold start hits {cold['aot_hits']}")
    if sorted(warm["aot_hits"], key=int) != buckets \
            or not all(warm["aot_hits"].values()):
        problems.append(f"restart hits {warm['aot_hits']}")
    if set(cold["origins"].values()) != {"built"} or \
            set(cold["origins"]) != set(port["build"].SOURCES):
        problems.append(f"cold start built {cold['origins']}")
    if "built" in warm["origins_after_jpeg_root"].values():
        problems.append(f"the restart ran nvcc: "
                        f"{warm['origins_after_jpeg_root']}")
    if cold["build_dir"] != warm["build_dir"] or \
            not cold["build_dir"].startswith(AOT_RUNS):
        problems.append(f"libraries in {cold['build_dir']} and "
                        f"{warm['build_dir']}")
    b = warm["buckets"]
    if not all(b["bit_equal"].values()):
        problems.append(f"replay differs from the eager step: "
                        f"{b['bit_equal']}")
    if any(n != n_layers for n in b["k1_launches"].values()):
        problems.append(f"K1 launches a replayed batch {b['k1_launches']}")
    j = warm["jpeg_root"]
    if j["launches"] != {"gather_rows_bulk": 2} or not j["bit_equal"] \
            or not j["unknown_id_nan"] or not j["known_rows_finite"]:
        problems.append(f"jpeg_root through the graphs: {j}")
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("aot_serve: " + "; ".join(problems))
    return info


L0_RUNS = os.path.join(REPO, "build", "chip_smoke_l0")
L0_SUBJECTS = 2000
L0_LIMIT_BATCHES = 2
L0_BATCH = 32
# SHA-256 of each array of the cohort.npz that the 24-subject raw layout
# (seed 0) gives: equal to the JAX package's run_l0 output on the same
# layout (tests/test_torch_preprocess_cli.py computes both on the CPU)
L0_DIGESTS = {
    "an_image_ids":
        "4bed7e83ede4af9bb196076f6a5d44814c9cd3c892fb81d437c30559ef6cef6c",
    "an_labels":
        "15117eb186bb23b126531fdec7436bd8e7dff0a3fe532fc4418d3b3254dc4658",
    "an_slot_idx":
        "5cfbc6d7528c8177c4b7182ce71453cac5ab8d03781f6ce5980f91046e2160fe",
    "an_stay_ids":
        "660416940613ed6652d34d22b35a3c708b9e3ecafa7ad6b5ef56ac31a9cefea4",
    "an_subject_ids":
        "0a43e3ebb1b830946099b36df71d58a71193dd17b62341b8fcf51e00e679c9a0",
    "cat_image_ids":
        "4bed7e83ede4af9bb196076f6a5d44814c9cd3c892fb81d437c30559ef6cef6c",
    "cat_labels":
        "158b456e54759541cd64a38f03c9a67200f23a730a1d6f1fa71362ab77e9cd09",
    "cat_subject_ids":
        "0a43e3ebb1b830946099b36df71d58a71193dd17b62341b8fcf51e00e679c9a0",
    "ev_counts":
        "b5980e6b339fba58f7ab05eca92e555495364e8921f44f79f9ece79db3da7ba2",
    "ev_offsets":
        "35d341ef4bfe9ec986e62a44c5874b2cdb7d7f07550bf17e0537b43886762fe6",
    "ev_slot_idx":
        "7318afb872819003f5cac202308e796bbe07ebb93c9a4a472cf446196e9f8908",
    "ev_stay_ids":
        "f6b3b6b1646781ff73a8b6163fac43dd7c4b946f5e3392abc7d839360a25cbf9",
    "ev_stay_len":
        "0a9021d6d0269ffaa9755ca1e6d92c57baf1d1e1d4afa0167dfa0eed57c1b5d4",
    "ev_subject_ids":
        "5a59779b0b85669450b6ad46bc606daa4010e38098a86d43a7f7352caa244f8e",
    "ev_values":
        "b9cafeba99e7295cbbcc0afe9ea8014636c522cccb0e4566125923b425478e32",
    "onehot_names":
        "f1e0b9a98804a23203a5400f99678589b612f015c3ae5ac270c532b0a5a0654b",
    "st_age":
        "778a2231e52db6cbe638a7aad5aab1692c758e69f90caae60ac2d75e7c685507",
    "st_death":
        "e92a622bfc0bc6ca4e41ec5454ca573494b9a25a7ff06d623d0d08acd1f5710f",
    "st_onehot":
        "e3bb4ae5a610cb9608cc3bd3ed4021224dceca80db627770787bd3fcdf59f9ae",
    "st_stay_ids":
        "f6b3b6b1646781ff73a8b6163fac43dd7c4b946f5e3392abc7d839360a25cbf9",
    "st_subject_ids":
        "5a59779b0b85669450b6ad46bc606daa4010e38098a86d43a7f7352caa244f8e",
    "var_names":
        "a6bfa3f7c73c0bbc303074b1d0cf977cd062d26833ba1706b304ac2d9b00e553",
}


def array_digest(a: np.ndarray) -> str:
    """SHA-256 of an array's dtype, shape and bytes (C order)."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def cohort_digests(path: str) -> dict:
    """{array name: ``array_digest``} of a ``cohort.npz``."""
    with np.load(path, allow_pickle=False) as z:
        return {k: array_digest(z[k]) for k in sorted(z.files)}


def _raw_rows(root: str) -> int:
    """The data rows of every raw table under ``root`` (headers not
    counted): what the L0 chain reads."""
    n = 0
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith(".csv"):
                with open(os.path.join(dirpath, name), "rb") as f:
                    n += sum(1 for line in f if line.strip()) - 1
    return n


def l0_teacher_steps(port, data_dir: str, batch: int, limit: int) -> tuple:
    """(split sizes, train steps, eval steps) of one epoch of the teacher
    CLI on a cohort: the shuffled train split drops its ragged tail and
    stops at ``limit`` batches; the val split (once an epoch) and the test
    split (once, after training) pad theirs. K1 launches 12 times a ViT
    forward, one forward a step, on the pixel tier."""
    import math
    ds, meta = port["ingest"].load_artifacts(data_dir)
    ads = port["pipeline"].build_anchor_dataset(
        ds, meta, port["config"].DataConfig())
    split = {k: len(v) for k, v in ads.splits.items()}
    steps = min(limit, split["train"] // batch)
    evals = math.ceil(split["val"] / batch) + math.ceil(split["test"] / batch)
    return split, steps, evals


L0_GOLDENS = os.path.join(REPO, "tests", "goldens", "feather_l0")
L0_FORBIDDEN = ("pandas", "pyarrow", "PIL", "zstandard", "lz4",
                "flatbuffers")


class CodecTimer:
    """Times every call of a codec function (``compress`` or
    ``decompress``) that ``data/arrow_ipc.py`` makes while the ``with``
    block runs: (uncompressed bytes, seconds) a call."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        decode = self.name == "decompress"

        def timed(data):
            t0 = time.perf_counter()
            out = self.orig(data)
            dt = time.perf_counter() - t0
            self.calls.append((len(out) if decode else len(data), dt))
            return out
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def summary(self) -> dict:
        mb = sum(n for n, _ in self.calls) / 1e6
        sec = sum(t for _, t in self.calls)
        return {"calls": len(self.calls), "MB": mb, "seconds": sec,
                "MB_per_s": mb / sec if sec else None}


def l0_to_feather(port, src: str, dst: str,
                  compression: str = "lz4") -> dict:
    """Every raw ``.csv`` table under ``src`` as ``.ftr`` under ``dst``, by
    the port alone (``frames.read_csv`` → ``frames.write_feather``: the
    reference's csv → feather conversion, groundwork cell 3)."""
    frames = port["frames"]
    read_s = write_s = 0.0
    tables = 0
    for dirpath, _, names in os.walk(src):
        for name in sorted(n for n in names if n.endswith(".csv")):
            rel = os.path.relpath(os.path.join(dirpath, name), src)
            out = os.path.join(dst, rel[:-len(".csv")] + ".ftr")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            t0 = time.perf_counter()
            frame = frames.read_csv(os.path.join(dirpath, name))
            t1 = time.perf_counter()
            frames.write_feather(out, frame, compression=compression)
            write_s += time.perf_counter() - t1
            read_s += t1 - t0
            tables += 1
    return {"tables": tables, "read_csv_s": read_s, "write_feather_s": write_s,
            "ftr_MB": sum(os.path.getsize(os.path.join(d, n)) for d, _, ns
                          in os.walk(dst) for n in ns) / 1e6}


def frames_equal(a: dict, b: dict) -> bool:
    """Two frames of ``data/frames.py``: the same columns in order, each of
    the same dtype and values (NaN and NaT equal)."""
    if list(a) != list(b):
        return False
    for c in a:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.dtype == object:
            if x.tolist() != y.tolist():
                return False
        elif x.dtype.kind in "fmM":
            if not np.array_equal(x, y, equal_nan=True):
                return False
        elif not np.array_equal(x, y):
            return False
    return True


# the host data ops' second cohort: the synthetic one at 2,000 stays
NATIVE_SYNTHETIC = dict(seed=0, n_subjects=700, n_stays=2000)


def native_ops(port, device, data_dir: str) -> dict:
    """The host data-path ops (``data/native_loader.py``:
    ``densify_events_native``, ``gather_windows_native``, built from
    ``csrc/host/data_ops.cpp`` with g++) against the port's main path
    (``data/pipeline.py::densify_events`` in numpy,
    ``pipeline.gather_windows`` on the card), on the preprocessed cohort in
    ``data_dir`` and on the synthetic cohort at NATIVE_SYNTHETIC's 2,000
    stays: the grid within rtol 1e-6 (atol 1e-6), every anchor's window
    bit-equal, 1 thread and all the host's cores bit-equal; the host
    milliseconds of each route (best of 3; the card's gather to a
    sync)."""
    nl, P = port["native_loader"], port["pipeline"]
    threads = len(os.sched_getaffinity(0))
    t0 = time.perf_counter()
    nl.build_data_ops()
    out = {"threads": threads, "build_s": time.perf_counter() - t0}
    synth = port["synthetic"].make_synthetic(**NATIVE_SYNTHETIC)
    cfg = port["config"].DataConfig()
    for name, (ds, meta) in (
            ("l0_cohort", port["ingest"].load_artifacts(data_dir)),
            ("synthetic_2000", (synth, P.meta_from_events(synth, cfg)))):
        out[name] = _native_case(port, device, ds, meta, cfg, threads)
        bad = [k for k in ("densify_within_tol", "densify_threads_bit_equal",
                           "gather_bit_equal", "gather_threads_bit_equal")
               if not out[name][k]]
        if bad:
            raise AssertionError(f"the host data ops against the port's "
                                 f"main path on {name}: {bad} ({out})")
    return out


def _native_case(port, device, ds, meta, cfg, threads: int) -> dict:
    import torch
    nl, P = port["native_loader"], port["pipeline"]
    ev = ds.events
    L = int(ev.stay_len.max())

    def timed(fn, reps=3):
        out, best = None, float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            best = min(best, time.perf_counter() - t0)
        return out, best * 1e3

    def native_grid(n):
        return nl.densify_events_native(
            ev.offsets, ev.slot_idx, ev.values, ev.counts, meta.means,
            meta.stds, L, count_clip=cfg.count_clip, n_threads=n)

    plain, plain_ms = timed(lambda: P.densify_events(ev, meta, L,
                                                     cfg.count_clip))
    one, one_ms = timed(lambda: native_grid(1))
    many, many_ms = timed(lambda: native_grid(threads))
    ads = P.build_anchor_dataset(ds, meta, cfg)
    rows, ends = ads.anchor["stay_rows"], ads.anchor["slot_idx"]
    T = cfg.n_timesteps
    grid_dev = torch.from_numpy(plain).to(device)
    rows_dev = torch.from_numpy(rows).to(device)
    ends_dev = torch.from_numpy(ends).to(device)

    def card_gather():
        out = P.gather_windows(grid_dev, rows_dev, ends_dev, T)
        torch.cuda.synchronize()
        return out

    card, card_ms = timed(card_gather)
    w1, w1_ms = timed(lambda: nl.gather_windows_native(plain, rows, ends, T,
                                                       n_threads=1))
    wn, wn_ms = timed(lambda: nl.gather_windows_native(plain, rows, ends, T,
                                                       n_threads=threads))
    card = card.cpu().numpy()
    return {"grid": list(plain.shape), "event_rows": int(len(ev.slot_idx)),
            "windows": [len(rows), T, plain.shape[-1]],
            "densify_ms": {"numpy": plain_ms, "native_1": one_ms,
                           f"native_{threads}": many_ms},
            "gather_ms": {"torch_card": card_ms, "native_1": w1_ms,
                          f"native_{threads}": wn_ms},
            "densify_max_abs_err": float(np.abs(many - plain).max()),
            "densify_within_tol": bool(np.allclose(many, plain, rtol=1e-6,
                                                   atol=1e-6)),
            "densify_threads_bit_equal": one.tobytes() == many.tobytes(),
            "gather_bit_equal": wn.tobytes() == card.tobytes(),
            "gather_threads_bit_equal": w1.tobytes() == wn.tobytes()}


def phase_l0(port, device, card: str = "") -> dict:
    """L0 on the card's host without pandas or pyarrow (ROADMAP P21, P21c):
    raw layouts written and preprocessed by the port's CLI from CSV and
    from feather, the small cohort held to pinned digests, the feather
    route of the large one held to its CSV route, the teacher trained on
    the feather route's cohort at full width."""
    import torch
    t_phase = time.perf_counter()
    shutil.rmtree(L0_RUNS, ignore_errors=True)
    cli = port["cli_preprocess"]
    runs = {}

    def preprocess(name, raw, rows, **extra):
        out = os.path.join(L0_RUNS, name)
        timers = [CodecTimer(port["lz4"], "decompress"),
                  CodecTimer(port["zstd"], "decompress")]
        t0 = time.perf_counter()
        with timers[0], timers[1]:
            paths = cli.main(["--raw_root", raw, "--out_dir", out])
        seconds = time.perf_counter() - t0
        ds = port["ingest"].load_npz(paths["cohort"])
        runs[name] = {**extra, "preprocess_s": seconds, "raw_rows": rows,
                      "rows_per_s": rows / seconds,
                      "stays": len(ds.events.stay_ids),
                      "event_rows": len(ds.events.slot_idx),
                      "anchors": len(ds.anchors.image_ids),
                      "catalog_images": len(ds.cxr_catalog.image_ids),
                      "onehot": len(ds.onehot_names),
                      "lz4_decode": timers[0].summary(),
                      "zstd_decode": timers[1].summary(), "paths": paths}
        return paths

    raws = {}
    for name, n_subjects, seed in (("fixture", 24, 0),
                                   ("cohort", L0_SUBJECTS, 1)):
        raw = raws[name] = os.path.join(L0_RUNS, f"raw_{name}")
        t0 = time.perf_counter()
        port["synthetic_raw"].make_raw_layout(raw, n_subjects=n_subjects,
                                              seed=seed)
        layout_s = time.perf_counter() - t0
        preprocess(name, raw, _raw_rows(raw), subjects=n_subjects, seed=seed,
                   layout_s=layout_s, tables="csv")
    # the fixture as pyarrow wrote it, once a codec
    for codec in ("lz4", "zstd"):
        raw = os.path.join(L0_RUNS, f"raw_fixture_{codec}")
        shutil.copytree(os.path.join(L0_GOLDENS, codec), raw)
        preprocess(f"fixture_{codec}", raw, runs["fixture"]["raw_rows"],
                   subjects=24, seed=0, tables=f"feather ({codec}, pyarrow)")
    # the large layout converted by the port, then preprocessed again
    raw_ftr = os.path.join(L0_RUNS, "raw_cohort_ftr")
    with CodecTimer(port["lz4"], "compress") as enc:
        conversion = l0_to_feather(port, raws["cohort"], raw_ftr, "lz4")
    conversion["lz4_encode"] = enc.summary()
    conversion["write_MB_per_s"] = (conversion["lz4_encode"]["MB"]
                                    / conversion["write_feather_s"])
    ftr_paths = preprocess("cohort_ftr", raw_ftr, runs["cohort"]["raw_rows"],
                           subjects=L0_SUBJECTS, seed=1,
                           tables="feather (lz4, the port)")
    t0 = time.perf_counter()
    in_memory = port["raw_mimic"].build_audit_frames(raw_ftr)
    audit_s = time.perf_counter() - t0
    audit_equal = {
        name: frames_equal(frame, port["frames"].read_feather(
            ftr_paths[name]))
        for name, frame in zip(("static_full", "final_df", "final_cxr_df"),
                               in_memory)}
    loaded = sorted(m for m in L0_FORBIDDEN if m in sys.modules)

    def meta_bytes(run):
        with open(runs[run]["paths"]["meta"], "rb") as f:
            return f.read()

    got = cohort_digests(runs["fixture"]["paths"]["cohort"])
    wrong = sorted(k for k in set(got) | set(L0_DIGESTS)
                   if got.get(k) != L0_DIGESTS.get(k))
    feather_wrong = {}
    for codec in ("lz4", "zstd"):
        g = cohort_digests(runs[f"fixture_{codec}"]["paths"]["cohort"])
        feather_wrong[codec] = sorted(
            k for k in set(g) | set(L0_DIGESTS)
            if g.get(k) != L0_DIGESTS.get(k))
        if meta_bytes(f"fixture_{codec}") != meta_bytes("fixture"):
            feather_wrong[codec].append("meta_with_stats.pkl")
    csv_d = cohort_digests(runs["cohort"]["paths"]["cohort"])
    ftr_d = cohort_digests(ftr_paths["cohort"])
    route_wrong = sorted(k for k in set(csv_d) | set(ftr_d)
                         if csv_d.get(k) != ftr_d.get(k))
    if meta_bytes("cohort_ftr") != meta_bytes("cohort"):
        route_wrong.append("meta_with_stats.pkl")

    # the host data-path ops on the large cohort, then the teacher at full
    # width on the feather route's cohort, K1 predicted first
    data_dir = os.path.dirname(ftr_paths["cohort"])
    native = native_ops(port, device, data_dir)
    split, steps, evals = l0_teacher_steps(port, data_dir, L0_BATCH,
                                           L0_LIMIT_BATCHES)
    n_layers = port["config"].ViTConfig().n_layers
    expect = {"flash_attention": n_layers * (steps + evals)}
    argv = ["--device", "cuda", "--data_dir", data_dir, "--batch_size",
            str(L0_BATCH), "--epochs", "1", "--limit_batches",
            str(L0_LIMIT_BATCHES), "--no_save_state", "--ckpt_dir",
            os.path.join(L0_RUNS, "teacher")]
    torch.cuda.synchronize()
    reset_counts(port)
    t0 = time.perf_counter()
    res = port["train_teacher"].main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_counts(port).items() if v}
    ex = res.extras
    info = {"phase": "l0", "card": card,
            "runs": {k: {x: y for x, y in r.items() if x != "paths"}
                     for k, r in runs.items()},
            "conversion": conversion, "audit_frames_s": audit_s,
            "audit_frames_equal": audit_equal,
            "modules_loaded": loaded, "digests_checked": len(got),
            "digest_mismatch": wrong, "feather_mismatch": feather_wrong,
            "feather_vs_csv_mismatch": route_wrong, "splits": split,
            "native_ops": native,
            "teacher": {"argv": argv, "wall_s": wall,
                        "predicted_train_steps": steps,
                        "predicted_eval_steps": evals,
                        "train_steps": ex["n_train_steps"],
                        "eval_steps": ex["n_eval_steps"],
                        "launches": launches,
                        "expected_launches": expect,
                        "epoch_losses": [h["train_total"]
                                         for h in res.history],
                        "val_auroc": [h["val_main_auroc"]
                                      for h in res.history],
                        "test_auroc": res.test_metrics["main_auroc"]},
            "seconds": time.perf_counter() - t_phase}
    emit(info)
    shutil.rmtree(L0_RUNS, ignore_errors=True)
    if loaded:
        raise AssertionError(f"the L0 chain loaded {loaded}")
    if wrong:
        raise AssertionError(f"cohort.npz arrays differ from the pinned "
                             f"digests: {wrong}")
    if any(feather_wrong.values()):
        raise AssertionError(f"the feather fixtures' cohorts differ from the "
                             f"pinned digests: {feather_wrong}")
    if route_wrong:
        raise AssertionError(f"the feather route's cohort differs from the "
                             f"CSV route's: {route_wrong}")
    if not all(audit_equal.values()):
        raise AssertionError(f"audit frames read back differ from the "
                             f"frames in memory: {audit_equal}")
    if not all(np.isfinite(x) for x in info["teacher"]["epoch_losses"]):
        raise AssertionError(f"non-finite losses "
                             f"{info['teacher']['epoch_losses']}")
    if launches != expect:
        raise AssertionError(f"K1 launched {launches} on the L0 cohort, "
                             f"predicted {expect}")
    return {**info, "launches": launches}


# multi-step dispatch (the multistep phase): each route's K; the runs'
# cohort, batch and batches an epoch (60 stays give 13 train batches of 4;
# 10 = 4 + 4 + 2 at K = 4 and 8 + 2 at K = 8: the first epoch runs the
# groups' graph eagerly, captures it and runs the remainder eagerly, the
# second replays the groups' graph twice and captures the remainder's);
# the steady steps at the CLIs' own batch (32; SSL 128; the unfrozen ViT
# at 8) on the train phase's 240 stays
MULTISTEP_K = {"hbm": 4, "pixels": 4, "unfrozen": 4, "ssl": 8, "kd": 4}
MULTISTEP_LIMIT = 10
MULTISTEP_CLI = {"hbm": (60, 4), "pixels": (60, 4), "unfrozen": (60, 4),
                 "ssl": (240, 128), "kd": (60, 4)}
MULTISTEP_STEADY_BATCH = {"hbm": 32, "pixels": 32, "unfrozen": 8,
                          "ssl": 128, "kd": 32}
MULTISTEP_STEADY_STAYS = 240


class _Tee:
    """Standard output, also kept in ``lines`` (the CLIs' log lines)."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.lines.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def _train_state_of(res) -> dict:
    """A loop's final train state, copied on its device: every parameter
    and buffer, both AdamW moments, the device step count, and the step
    generator's state."""
    state, gen = res.extras["state"], res.extras["generator"]
    snap = {f"model/{n}": t.detach().clone()
            for n, t in state.model.state_dict().items()}
    for m in ("mu", "nu"):
        flat = [t for ts in getattr(state.optimizer, m) for t in ts]
        snap.update({f"{m}/{i}": t.clone() for i, t in enumerate(flat)})
    snap["step_t"] = state.step_t.clone()
    snap["generator"] = gen.get_state()
    return snap


def _multistep_run(port, device, run, batch: int) -> dict:
    """One training run of the ``multistep`` phase (``run()``: a CLI's
    ``main`` or a loop, logging to standard output): its history and final
    train state (``_train_state_of``), every kernel's launches over exactly
    this run, its peak memory, the graphs it captured (its ``[multistep]
    captured`` lines) and the loop's train samples/s."""
    import torch
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts(port)
    tee = _Tee(sys.stdout)
    sys.stdout = tee
    t0 = time.perf_counter()
    try:
        res = run()
        _sync(device)
    finally:
        sys.stdout = tee.out
    wall = time.perf_counter() - t0
    ex = res.extras
    train_s = ex["phase_seconds"]["train"] if "phase_seconds" in ex \
        else ex["train_seconds"]
    out = {"wall_s": wall, "history": res.history,
           "launches": read_counts(port),
           "graphs_captured": sum("[multistep] captured" in s
                                  for s in "".join(tee.lines).splitlines()),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()
           if device.type == "cuda" else None,
           "train_steps": ex["n_train_steps"],
           "host_step": ex["state"].step, "train_s": train_s,
           "train_samples_per_s": ex["n_train_steps"] * batch / train_s}
    out["state"] = _train_state_of(res)
    out["best_path"] = res.best_path
    return out


def _state_diff(a: dict, b: dict) -> list:
    """The entries of two ``_train_state_of`` copies that differ."""
    import torch
    if a.keys() != b.keys():
        return sorted(a.keys() ^ b.keys())
    return [k for k in a if not torch.equal(a[k], b[k])]


def _steady_calls(fn, device, k: int, reps: int = 5) -> dict:
    """``fn`` (one call of ``k`` steps) after 3 warm-up calls (a multi-step
    call's eager first call and its capture among them): the median host
    time of ``reps`` calls, each to a device sync, per step; the peak
    memory of those calls; and the CUDA-event time of ``reps`` more calls
    made back to back (the device's time; for a graph replay, nearly its
    busy time: no host work between its kernels)."""
    import torch
    for _ in range(3):
        fn()
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    call_ms = statistics.median(times)
    out = {"step_ms": call_ms / k, "call_ms_all": times,
           "peak_memory_bytes": None, "device_ms_per_step": None}
    if device.type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out["device_ms_per_step"] = start.elapsed_time(end) / reps / k
    return out


def _steady_teacher_data(port, device, tiny: bool, bases: dict) -> dict:
    """The teacher routes' steady set-up, made once: the train phase's
    240-stay cohort on ``device``, 4 shuffled train batches of 32 with
    their procedural pixels (the hook run once), a full-width frozen
    teacher (seeded), and its bank of those batches' images, encoded from
    the same pixels."""
    import torch
    cfgmod, P, F = port["config"], port["pipeline"], port["features"]
    tl = port["teacher_loop"]
    cfg = _multistep_teacher_cfg(port, tiny)
    ds = port["synthetic"].make_synthetic(
        seed=0, n_stays=MULTISTEP_STEADY_STAYS,
        n_subjects=MULTISTEP_STEADY_STAYS // 3,
        n_variables=cfg.duett.n_variables)
    dcfg = cfgmod.DataConfig()
    data = P.build_anchor_dataset(ds, P.meta_from_events(ds, dcfg),
                                  dcfg).to(device)
    hook = tl.make_synthetic_pixel_hook(cfg.vit.image_size)
    pixels = []
    for b in data.iter_batches("train", 32, shuffle=True, seed=0,
                               limit=max(MULTISTEP_K.values())):
        b.pop("valid")
        pixels.append(hook(b))
    if "pixels" not in bases:
        bases["pixels"] = port["teacher"].init_teacher(cfg, 0).to(device)
    teacher = bases["pixels"]
    first = {}
    for b in pixels:
        for i, image_id in enumerate(b["image_ids"]):
            first.setdefault(int(image_id), b["pixel_values"][i])
    ids = np.array(sorted(first))
    bank = F.CXRFeatureBank.build(
        F.encode_fn_for_teacher(teacher, torch.bfloat16),
        lambda q: np.stack([first[int(i)] for i in q]), ids)
    cached = [bank.host_fn()({n: v for n, v in b.items()
                              if n != "pixel_values"}) for b in pixels]
    return {"cfg": cfg, "data": data, "teacher": teacher, "bank": bank,
            "pixels": pixels, "cached": cached, "bases": bases}


def _steady_route(port, device, route: str, k: int, tiny: bool,
                  shared) -> dict:
    """One route's step at a steady state, K = 1 against K = ``k`` from the
    same weights on the same batches (full width, seeded weights, the
    route's CLI batch): the host time of a step, samples/s, peak memory,
    and the device's idle share: 1 − the device time of a step of
    back-to-back graph replays (its kernels with no host gap) over each
    dispatch's host time of a step."""
    import torch
    cfgmod, eng, st, optim = (port["config"], port["engine"], port["state"],
                              port["optim"])
    bf16 = torch.bfloat16
    batch = MULTISTEP_STEADY_BATCH[route]
    if route == "ssl":
        argv = ["--device", device.type, "--synthetic_stays",
                str(MULTISTEP_CLI["ssl"][0]), "--stride", "2"]
        if tiny:
            argv += ["--n_variables", "6", "--d_embedding", "8"]
        duett, data = _ssl_data(port, argv, device)
        host = list(data.iter_batches("train", batch, shuffle=True, seed=0,
                                      limit=k))
        model = port["duett"].init_pretrain_model(duett, 0).to(device)
        opt = optim.MultiGroupAdamW.one_group(
            model, optim.invsqrt_warmup(3e-4, 8), 0.1, 1.0)
        step = eng.make_ssl_step(duett, data.n_timesteps, bf16)
        fixed = (data.grid, data.static)
    else:
        cfg, data = shared["cfg"], shared["data"]
        trn = cfgmod.TrainConfig(batch_size=batch)
        source = shared["bank"].feature_source() \
            if route in ("hbm", "kd") else None
        host = shared["cached"] if source is not None else \
            [{n: v[:batch] for n, v in b.items()} for b in shared["pixels"]]
        host = host[:k]
        if route == "kd":
            scfg = cfgmod.StudentConfig(duett=cfg.duett)
            model = port["student"].init_student(scfg, 0).to(device)
            shared["teacher"].requires_grad_(False)
            opt = optim.MultiGroupAdamW(model, trn.optim, 100)
            step = eng.make_kd_step(trn, scfg.duett, data.n_timesteps, bf16,
                                    feature_source=source)
            fixed = (shared["teacher"], data.grid, data.static)
        else:
            if route == "unfrozen":
                cfg = cfg.replace(freeze_cxr=False)
                model = shared["bases"].get("unfrozen") or \
                    port["teacher"].init_teacher(cfg, 0).to(device)
            else:
                model = shared["teacher"]
            opt = optim.MultiGroupAdamW(
                model, trn.optim, 100,
                frozen_prefixes=port["teacher_loop"].teacher_frozen_prefixes(
                    cfg))
            step = eng.make_teacher_step(trn, cfg.duett, data.n_timesteps,
                                         np.ones(7, np.float32), None, bf16,
                                         feature_source=source)
            fixed = (data.grid, data.static)
    state = st.TrainState(model, opt)
    gen = torch.Generator(device=device).manual_seed(1)
    one = eng.to_device(host[0], device)
    stacked = eng.to_device(next(port["prefetch"].stack_host_batches(
        host, k)), device)
    multi = eng.scan_steps(step, k)
    out = {"batch": batch, "k": k,
           "k1": _steady_calls(lambda: step(state, *fixed, one, gen),
                               device, 1),
           f"k{k}": _steady_calls(lambda: multi(state, *fixed, stacked, gen),
                                  device, k)}
    busy = out[f"k{k}"]["device_ms_per_step"]
    for n in ("k1", f"k{k}"):
        out[n]["samples_per_s"] = batch * 1e3 / out[n]["step_ms"]
        out[n]["idle_share"] = None if busy is None \
            else 1.0 - busy / out[n]["step_ms"]
    out["speedup"] = out["k1"]["step_ms"] / out[f"k{k}"]["step_ms"]
    del state, opt, multi, step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _multistep_teacher_cfg(port, tiny: bool):
    cfgmod = port["config"]
    if not tiny:
        return cfgmod.TeacherConfig()
    return cfgmod.TeacherConfig(
        duett=cfgmod.DuettConfig(n_variables=34, d_embedding=8, n_layers=1),
        vit=cfgmod.ViTConfig(image_size=56, d_model=32, n_layers=2,
                             n_heads=2, d_feedforward=64),
        perceiver=cfgmod.PerceiverConfig(d_latent=32, n_heads=2))


def _multistep_runs(port, device, route: str, k: int, tiny: bool,
                    root: str, teacher_ckpt: str, bases: dict) -> tuple:
    """One route's two runs, K = 1 and K = ``k``, from the same seed: the
    ``hbm``, SSL and KD routes through their CLIs (``--steps_per_call``),
    the two pixel routes through ``train_teacher`` itself, each run on a
    copy of one seeded full-width teacher made once (``bases``), as its
    CLI would make it; → (the two runs, the CLI's argv or None)."""
    dev = device.type
    stays, batch = MULTISTEP_CLI[route]
    argv = ["--device", dev, "--synthetic_stays", str(stays),
            "--batch_size", str(batch), "--epochs", "2", "--limit_batches",
            str(MULTISTEP_LIMIT), "--no_save_state"]
    if route == "ssl":
        cli = "train_ssl"
        argv += ["--stride", "2", "--ssl_warmup", "8"] + (
            ["--n_variables", "6", "--d_embedding", "8"] if tiny else [])
    elif route == "kd":
        cli = "train_student"
        argv += ["--warmup_steps", "4", "--cxr_feature_cache", "hbm",
                 "--teacher_ckpt", teacher_ckpt]
    elif route == "hbm":
        cli = "train_teacher"
        argv += ["--warmup_steps", "4", "--cxr_feature_cache", "hbm"] + (
            ["--vit_size", "tiny"] if tiny else [])
    else:
        cli = None
    runs = {}
    for kk in (1, k):
        ckpt_dir = os.path.join(root, f"{route}_k{kk}")
        if cli is not None:
            def run(kk=kk, ckpt_dir=ckpt_dir):
                return port[cli].main(argv + ["--steps_per_call", str(kk),
                                              "--ckpt_dir", ckpt_dir])
        else:
            def run(kk=kk, ckpt_dir=ckpt_dir):
                return _pixel_loop(port, device, route, kk, tiny, ckpt_dir,
                                   bases)
        runs[kk] = _multistep_run(port, device, run, batch)
    return runs, argv if cli is not None else None


def _pixel_loop(port, device, route: str, k: int, tiny: bool,
                ckpt_dir: str, bases: dict):
    """``train_teacher`` on procedural pixels as ``cli.train_teacher``
    runs it (``--unfreeze_cxr`` for the unfrozen route), from a copy of
    the route's seeded teacher."""
    cfgmod, P, tl = port["config"], port["pipeline"], port["teacher_loop"]
    stays, batch = MULTISTEP_CLI[route]
    cfg = _multistep_teacher_cfg(port, tiny)
    if route == "unfrozen":
        cfg = cfg.replace(freeze_cxr=False)
    if route not in bases:
        bases[route] = port["teacher"].init_teacher(cfg, 0).to(device)
    dcfg = cfgmod.DataConfig()
    ds = port["synthetic"].make_synthetic(
        seed=0, n_stays=stays, n_subjects=max(stays // 3, 10),
        n_variables=cfg.duett.n_variables)
    data = P.build_anchor_dataset(ds, P.meta_from_events(ds, dcfg), dcfg)
    trn = cfgmod.TrainConfig(
        batch_size=batch, epochs=2, limit_batches=MULTISTEP_LIMIT,
        steps_per_call=k, optim=cfgmod.OptimConfig(warmup_steps=4))
    return tl.train_teacher(data, cfg, trn, ckpt_dir, dcfg.pathology_labels,
                            model=copy.deepcopy(bases[route]),
                            device=device)


def phase_multistep(port, device, card: str = "", tiny: bool = False,
                    routes=None) -> dict:
    """Multi-step dispatch (``--steps_per_call K``, ROADMAP P10) through
    the training CLIs at full width: each route (the teacher on ``hbm``,
    on procedural pixels and with ``--unfreeze_cxr``, SSL, KD on ``hbm``)
    run with K = 1 and with its K (MULTISTEP_K) from the same seed, and
    held bit-equal: the per-epoch history and the final train state (every
    parameter and buffer, both AdamW moments, the device step count, the
    generator's state) and the host step count; every kernel's launches
    equal the K = 1 run's (a replay counts what its graph launches); each
    K run captured two graphs (the groups of K and the remainder group),
    K = 1 none. Then each route's steady step, K = 1 against K from the
    same weights (``_steady_route``). ``tiny`` (a CPU rehearsal) swaps in
    small widths; ``routes`` picks some (``kd`` distills the teacher the
    ``hbm`` route kept)."""
    dev = device.type
    root = os.path.join(REPO, "build", "chip_smoke_multistep")
    # the hbm route's K = 1 teacher, which the kd route distills
    teacher_ckpt = os.path.join(REPO, "build",
                                "chip_smoke_multistep_teacher.msgpack")
    out, fails, bases = {}, [], {}
    wanted = routes or ("hbm", "pixels", "unfrozen", "ssl", "kd")
    for route in wanted:
        k = MULTISTEP_K[route]
        runs, argv = _multistep_runs(port, device, route, k, tiny, root,
                                     teacher_ckpt, bases)
        if route == "hbm":
            _keep_ckpt(runs[1]["best_path"], teacher_ckpt)
        shutil.rmtree(root, ignore_errors=True)
        a, b = runs[1], runs[k]
        differ = _state_diff(a.pop("state"), b.pop("state"))
        r = {"k": k, "argv": argv, "k1": a, f"k{k}": b,
             "equal": {"history": a["history"] == b["history"],
                       "train_state": not differ,
                       "host_step": a["host_step"] == b["host_step"],
                       "launches": a["launches"] == b["launches"]},
             "differing_state": differ[:8]}
        out[route] = r
        if not all(r["equal"].values()):
            fails.append(f"{route}: K={k} differs from K=1: {r['equal']} "
                         f"{differ[:8]}")
        if a["graphs_captured"] != 0 or b["graphs_captured"] != (
                2 if dev == "cuda" else 0):
            fails.append(f"{route}: graphs captured {a['graphs_captured']} "
                         f"(K=1), {b['graphs_captured']} (K={k})")
        kernel = "gather_rows_bulk" if route in ("hbm", "kd") \
            else "flash_attention" if route != "ssl" else None
        if dev == "cuda" and kernel and not b["launches"][kernel]:
            fails.append(f"{route}: no {kernel} launch")
        if not all(np.isfinite(v) for h in a["history"] for v in h.values()
                   if isinstance(v, float)):
            fails.append(f"{route}: non-finite history {a['history']}")
    # the steady steps, after every run: the seeded teachers are theirs now
    shared = _steady_teacher_data(port, device, tiny, bases)
    for route in wanted:
        r = out[route]
        r["steady"] = _steady_route(port, device, route, r["k"], tiny,
                                    shared)
        emit({"phase": "multistep_route", "route": route, "card": card,
              **r})
    del shared, bases
    shutil.rmtree(root, ignore_errors=True)
    info = {"phase": "multistep", "card": card, "routes": {}}
    for route, r in out.items():
        kk = f"k{r['k']}"
        info["routes"][route] = {
            "k": r["k"], "equal": r["equal"],
            "launches": {n: {key: v for key, v in r[n]["launches"].items()
                             if v} for n in ("k1", kk)},
            "graphs_captured": r[kk]["graphs_captured"],
            **{key: {n: r[n][key] for n in ("k1", kk)} for key in (
                "train_samples_per_s", "peak_memory_bytes", "wall_s")},
            **{f"steady_{key}": {n: r["steady"][n][key] for n in ("k1", kk)}
               for key in ("step_ms", "samples_per_s", "idle_share",
                           "peak_memory_bytes")},
            "steady_batch": r["steady"]["batch"],
            "steady_device_ms_per_step": r["steady"][kk][
                "device_ms_per_step"],
            "steady_speedup": r["steady"]["speedup"]}
    emit(info)
    if fails:
        raise AssertionError("; ".join(fails))
    return info


def main() -> int:
    if sys.argv[1:2] == ["--parallel-worker"]:
        rank, world, port_no = (int(a) for a in sys.argv[2:5])
        return parallel_worker(rank, world, port_no, sys.argv[5])
    if sys.argv[1:2] == ["--aot-worker"]:
        return aot_worker(sys.argv[2], sys.argv[3])
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
    if sys.argv[1:2] == ["--only-parallel"]:
        # a short call for the parallel phase alone; no ok line
        phase_parallel(port, device, card=dev["nvidia_smi"])
        emit({"phase": "total", "seconds": time.perf_counter() - t_start})
        return 0
    built = phase_build_facts(port)
    aot_started = start_aot_cold()
    atexit.register(_stop_aot_worker, aot_started)
    parallel = phase_parallel(port, device, card=dev["nvidia_smi"])
    aot_cold = _finish_aot_worker(aot_started)
    bf16, f32 = torch.bfloat16, torch.float32
    n_predict, predict_batch = _predict_split(port)
    checks = phase_kernels(port, device, [
        ("vit_bf16", 8, 12, 1370, None, bf16, TOL_BF16, True),
        ("bank_build_bf16", 16, 12, 1370, None, bf16, TOL_BF16, True),
        ("pixel_step_bf16", 32, 12, 1370, None, bf16, TOL_BF16, True),
        # cli/predict's batch, and the remainder of its split (the CLI
        # pads that batch to the full one; a caller that does not pad
        # hands the kernel this shape)
        ("predict_bf16", predict_batch, 12, 1370, None, bf16, TOL_BF16,
         True),
        ("predict_last_bf16", n_predict % predict_batch or predict_batch,
         12, 1370, None, bf16, TOL_BF16, False),
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
    rad_dino = phase_rad_dino(port, device, card=dev["nvidia_smi"])
    block = phase_block_grad(port, device)
    serve = phase_serve(port, device, cfgmod.TeacherConfig(), n_clients=12,
                        posts_per_client=4, card=dev["nvidia_smi"])
    aot_serve = phase_aot_serve(port, device, card=dev["nvidia_smi"],
                                cold=aot_cold)

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
    _keep_ckpt(cxr["ckpt_path"], CXR_HEAD_BEST)
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
    jpeg = phase_jpeg(port, device, card=dev["nvidia_smi"])
    finetune = phase_finetune(port, device, ssl["best_path"],
                              card=dev["nvidia_smi"])
    physionet = phase_physionet(port, device, card=dev["nvidia_smi"])
    predict = phase_predict(port, device, train["teacher_ckpt"],
                            card=dev["nvidia_smi"])
    synthetic = phase_synthetic_serve(port, device, train["teacher_ckpt"],
                                      card=dev["nvidia_smi"])
    analysis = phase_analysis(port, device, train["teacher_ckpt"],
                              UNFREEZE_BEST, CXR_HEAD_BEST,
                              card=dev["nvidia_smi"])
    analysis_b = phase_analysis_b(port, device, train["teacher_ckpt"],
                                  card=dev["nvidia_smi"])
    int8 = phase_int8(port, device, card=dev["nvidia_smi"])
    l0 = phase_l0(port, device, card=dev["nvidia_smi"])
    multistep = phase_multistep(port, device, card=dev["nvidia_smi"])
    finish_rad_dino_check(rad_dino, card=dev["nvidia_smi"])

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
                "resume_orbax": resume["orbax_launches"][name],
                "modes": {way: r["launches"][name]
                          for way, r in modes["runs"].items()},
                "modes_unfreeze_step": modes["unfreeze_step"]["launches"]
                .get(name, 0),
                "event_serve": modes["event_serve"]["launches"][name],
                "single_kd": modes["single_kd"]["launches"][name],
                **jpeg_by_path(name), **supervised_by_path(name),
                "parallel": {run: n.get(name, 0) for run, n in
                             parallel["launches"].items()},
                "parallel_multistep": {
                    f"{run}_{k}": n.get(name, 0)
                    for run, m in parallel["multistep"].items()
                    for k, n in m["launches"].items()},
                "analysis": {run: r["launches"].get(name, 0)
                             for run, r in analysis["runs"].items()},
                "analysis_b": {run: r["launches"].get(name, 0)
                               for run, r in analysis_b["runs"].items()},
                "int8": {**{run: r["launches"].get(name, 0)
                            for run, r in int8["runs"].items()},
                         "serve": int8["serve"]["k1_launches"]
                         if name == "flash_attention" else 0},
                "l0": l0["launches"].get(name, 0),
                "rad_dino": {
                    "teacher": rad_dino["launches"].get(name, 0),
                    "vit": sum(t["k1_launches"]
                               for t in rad_dino["tokens"].values()
                               if t["k1_key"] == name)},
                "aot_serve": {
                    "buckets": aot_serve["warm"]["buckets"]["k1_launches"]
                    if name == "flash_attention" else 0,
                    "jpeg_root": aot_serve["warm"]["jpeg_root"]["launches"]
                    .get(name, 0)},
                "multistep": {f"{route}_{kk}": n.get(name, 0)
                              for route, r in multistep["routes"].items()
                              for kk, n in r["launches"].items()}}

    def supervised_by_path(name):
        return {"finetune": {way: r["launches"][name]
                             for way, r in finetune["runs"].items()},
                "physionet": physionet["launches"][name],
                "predict": {way: {"total": r["launches"][name],
                                  "eval": r["eval"]["launches"].get(name, 0),
                                  "build": (r["build"] or {}).get(
                                      "launches", {}).get(name, 0)}
                            for way, r in predict["runs"].items()},
                "synthetic_serve": synthetic["launches"].get(name, 0)}

    def jpeg_by_path(name):
        return {"jpeg": {way: r["launches"][name]
                         for way, r in jpeg["runs"].items()},
                "jpeg_unfreeze_step": jpeg["unfreeze_step"]["launches"]
                .get(name, 0),
                "jpeg_cxr_head": jpeg["cxr_head"]["launches"][name],
                "jpeg_serve_startup": jpeg["serve"]["startup"]["launches"]
                .get(name, 0),
                "jpeg_serve": jpeg["serve"]["launches"].get(name, 0)}

    # the card's JPEG decode (nvJPEG, then csrc/jpeg_resize.cu) replaces
    # host C++, not a TPU kernel; it is on the main path where the host
    # has no libjpeg. Its u8 row takes its launches from the bank's run,
    # its float32 row from the stream run.
    jpeg_rows = [
        {"name": name, "route": "cuda", "source": JPEG_RESIZE_SOURCE,
         "replaces": JPEG_RESIZE_REPLACES,
         "launches": jpeg["runs"][way]["launches"][name],
         "launches_by_path": jpeg_by_path(name),
         "decoder_route": jpeg["probe"]["route"],
         **{k: jpeg["resize_kernel"][kind][k] for k in keys + (
             "case", "library_call", "bit_equal_rerun")}}
        for name, kind, way in (("jpeg_resize_u8", "u8", "hbm"),
                                ("jpeg_resize_f32", "f32", "stream"))]

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
         **{k: k1[k] for k in keys},
         "predict": {"case": f"predict_bf16 [{predict_batch}, 12, 1370, "
                             "64]",
                     **{k: checks["predict_bf16"][k] for k in keys + (
                         "fwd_vs_library",)},
                     "last_batch_max_abs_err": checks["predict_last_bf16"]
                     ["max_abs_err"]}},
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
        *f32_rows, *jpeg_rows]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
