// Flash-attention backward for Hopper (sm_90a): the gradients of non-causal
// O = softmax(Q K^T * sm_scale) V per (batch, head), head dim 64.
//
// Replaces the TPU kernels of JAX 0.9.0's Pallas flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py), which
// multimodal_edema_prediction_tpu/ops/attention.py::flash_mha reaches when it
// is differentiated (the ViT trained with --unfreeze_cxr):
//   - dK, dV: _flash_attention_dkv_kernel (:796), _flash_attention_bwd_dkv
//     (:941), pallas_call :1121  ->  flash_bwd_dkv_{bf16,f32} below;
//   - dQ: _flash_attention_dq_kernel (:1146), _flash_attention_bwd_dq
//     (:1287), pallas_call :1456  ->  flash_bwd_dq_{bf16,f32} below.
// Split as JAX splits them, so no block ever adds into another block's
// output: no atomics, and the gradients are bit-reproducible run to run.
// The split stays on purpose: a dq fused into the dkv pass (sharing S and
// dP) would add into dQ from every key block, with atomics (whose order
// changes the bits from run to run) or through per-key-block partial sums
// and a second pass (~1.5 GB more traffic at [32, 12, 1370, 64]).
//
// Inputs: q, k, v and dO as [B, H, N, 64] with arbitrary batch/head/token
// strides and a contiguous head dim (the forward's views); the forward's
// lse = m + log(l) and D = rowsum(dO * O), both float32 [B, H, Nq]
// contiguous. D comes from flash_bwd_delta_* below, a pass of its own ahead of
// the two kernels, as JAX computes di outside Pallas
// (flash_attention.py:273-275).
// Per tile both kernels recompute S = Q K^T * scale and P = exp(S - lse)
// from them, then dP = dO V^T and dS = P * (dP - D):
//   dkv: a block owns keys and streams the query tiles;
//        dV += P^T dO, dK += dS^T Q * scale;
//   dq:  a block owns queries and streams the key tiles;
//        dQ += dS K * scale.
// Keys at or past kv_valid get P = 0, so their dK and dV are exactly 0;
// ragged tiles are zero-filled on load and never written past N. Outputs are
// written through their own strides ([B, N, H, 64] storage from the wrapper).
//
// Bound on an H100 SXM: dkv does 4 products of 2*N^2*D per (b, h)
// (8*B*H*N^2*D operations), dq 3 (6*B*H*N^2*D); the pair's algorithmic least
// is 5 (10*B*H*N^2*D: a fused kernel shares S and dP). At [32, 12, 1370, 64]
// that is 0.373 / 0.280 / 0.466 ms at 989 TFLOP/s bf16, while the bytes
// (q, k, v, dO read, the gradients written, ~0.1 GB) take ~0.04 ms: bound by
// operations, so the bf16 kernels are built around the tensor cores:
//   - Every product is a warpgroup MMA (wgmma m64n64k16, bf16 in, f32
//     accumulate; wgmma_bf16.cuh), Hopper's only path to its full tensor
//     rate, where the previous design issued mma.sync m16n8k16.
//   - A block owns 128 rows (keys in dkv, queries in dq): two consumer
//     warpgroups of 64. Each warp keeps its 16 rows of K and V (dkv) or Q
//     and dO (dq) in registers as A fragments for the whole loop, so the
//     score products read only their B tile from shared memory, once per
//     warpgroup, where each of the previous design's warps re-read the
//     whole streamed tile with ldmatrix for its own 16 rows.
//   - A producer warp streams the tiles with TMA (128-byte swizzle, the
//     layout wgmma reads) into a 3-stage ring guarded by mbarriers (full:
//     the tile and, in dkv, its lse and D landed; empty: every consumer warp
//     is done with it), so loads run under the products, and the two
//     warpgroups never meet at a block-wide barrier: one computes exp while
//     the other's wgmma runs. Within a warpgroup, exp runs under the dP
//     product and dS under dV's. The tensor maps (64, rows, H, B) are
//     encoded per call from the views' strides (ops/attention.py::
//     tma_geometry); rows past the map's count (Nq; n_keys for K and V)
//     load as 0, so no load is masked.
//   - dkv computes S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T come
//     out of the accumulator in the register-A layout of dV += P^T dO and
//     dK += dS^T Q, whose B (the dO and Q tiles) is read MN-major. dq
//     computes S = Q K^T, dP = dO V^T and dQ += dS K, K read MN-major. P and
//     dS are rounded to bf16 before their products, as FA2 does; lse and D
//     stay in f32.
//   - 384 threads: the two consumer warpgroups and a producer warpgroup,
//     whose setmaxnreg hands its registers to the consumers (40 and 232 a
//     thread); at one block per SM the 168 a thread of an even split made
//     dkv spill. (The previous design's 174 registers left 8 warps an SM.)
// Keys at or past n_keys load as 0 but exp(0 - lse) is not 0, so P is masked
// in arithmetic; queries past Nq get lse = +inf, so their P is 0.
//
// The float32 kernels serve the reference-precision path (--unfreeze_cxr
// --mixed_precision no: 12 launches of each a train step). Their bound at
// [32, 12, 1370, 64] is 5.5 (dkv) and 4.1 ms (dq) of float32 FMA (67
// TFLOP/s), where their first design, one thread an owned row with every
// FMA waiting on a shared-memory load, ran at a fifth of that rate. So
// their products go to the tensor cores in float32 accuracy, as 3xTF32
// mma.sync m16n8k8 (mma_tf32.cuh; 2.2 and 1.7 ms of TF32 products at 495
// TFLOP/s), on the float32 forward's model (flash_attention.cu):
//   - A block of 8 warps owns 128 keys (dkv) or queries (dq), 16 a warp,
//     split once into TF32 big and small parts in shared memory. 32-row
//     tiles of Q and dO (dkv) or K and V (dq) come in by cp.async into a
//     double buffer, and each thread splits the chunks it copied, so every
//     value is split once a block.
//   - Per tile, dkv computes S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in
//     registers, then dV += P^T dO and dK += dS^T Q; dq computes S = Q K^T
//     and dP = dO V^T, then dQ += dS K. With mma_tf32.cuh's k order the
//     score accumulators are the A fragments of the second products as
//     they stand. The streamed rows are read in a fixed order within each
//     group of 8 (sigma), so that a tile read both as [n][k] and as [k][n]
//     meets no bank conflict either way.
//   - Each pair of k-steps is summed on the tensor cores from zero, a kind
//     of product at a time over 8 accumulator tiles, and then added in
//     float32 (dK and dV sum over 1370 queries: a chain through the tensor
//     cores' truncating adds would drift).
//   - dP = dO V^T and D = rowsum(dO * O) are one computation (below): dkv
//     takes its transposed products in the swapped order
//     (mma_3xtf32_sweep_d's kSwap), so that its dP^T has the bits of dq's
//     dP.
//
// D = rowsum(dO * O) (flash_bwd_delta_*): float32 [B, H, Nq] from bf16 or
// float32 O and dO read through their strides. Bound by bytes: O and dO read
// once, D written once, 2 B H N 64 itemsize + 4 B H N (0.041 ms at
// [32, 12, 1370, 64] bf16 on 3.35 TB/s), where three float32 passes of
// PyTorch (two upcasts, the product, the sum) moved about 0.94 GB. In bf16
// each row's 64 values are 8 16-byte chunks, one per thread; a thread sums
// its chunk's products in order and the row's threads add their sums in a
// fixed butterfly of shuffles, so reruns are bit-equal. In float32, D is
// the diagonal of dO O^T through the 3xTF32 products of dP (four threads
// a row), so that at one live key, where the forward passes V whole
// (O = V), dP - D is exactly 0.
//
// Entry points: flash_attention_bwd_delta(...), flash_attention_bwd_dkv(...)
// and flash_attention_bwd_dq(...) launch on the given stream, allocate
// nothing and return a CUDA error code as an int (0 = launched).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kD = 64;         // head dim
constexpr int kOwn = 128;      // owned rows per block (bf16): 64 a warpgroup
constexpr int kTile = 64;      // streamed rows per tile (bf16)
constexpr int kStages = 3;     // depth of the TMA ring
constexpr int kThreads = 384;  // two consumer warpgroups + the producer's
constexpr int kProducer = 8;   // the producer's warp (its group's first)
constexpr int kProducerRegs = 40;   // registers a thread after setmaxnreg:
constexpr int kConsumerRegs = 232;  // 128 (40 + 2 x 232) <= 65536
constexpr uint32_t kTileBytes = kTile * kD * 2;
constexpr int kOwnF = 128;     // owned rows per block (f32): 16 a warp
constexpr int kThreadsF = 256;
constexpr int kTileF = 32;     // streamed rows per tile (f32)
constexpr int kLdF = kD + 8;   // padded f32 row: 8 mod 32 words
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Nq]
  const float* delta;  // [B, H, Nq]
  void* dq;
  void* dk;
  void* dv;
  int H, Nq, Nk;
  int n_keys;          // min(Nk, kv_valid): keys that take part
  float scale;         // sm_scale
  float scale_log2;    // sm_scale * log2(e)
  long long sqb, sqh, sqn, skb, skh, skn, svb, svh, svn, sob, soh, son;
  long long sdqb, sdqh, sdqn, sdkb, sdkh, sdkn, sdvb, sdvh, sdvn;
};

using Tile = __nv_bfloat16[kTile * kD];  // one swizzled [64][64] tile, 8 KB

struct DkvSmem {
  Tile q[kStages], o[kStages];  // the ring of query tiles
  float lse[kStages][kTile];    // their lse (log2 units) and D
  float dlt[kStages][kTile];
  uint64_t full[kStages], empty[kStages];
};

struct DqSmem {
  Tile k[kStages], v[kStages];  // the ring of key tiles
  uint64_t full[kStages], empty[kStages];
};

template <typename T>
__device__ __forceinline__ const T* at(const void* base, int b, int h,
                                       long long sb, long long sh) {
  return static_cast<const T*>(base) + b * sb + h * sh;
}

template <typename T>
__device__ __forceinline__ T* at_out(void* base, int b, int h, long long sb,
                                     long long sh) {
  return static_cast<T*>(base) + b * sb + h * sh;
}

// Write a warp's 16 x 64 f32 accumulator (times `mul`) as bf16 rows r0 and
// r0 + 8; rows at or past n are not written.
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           long long stride,
                                           const float (&acc)[8][4], float mul,
                                           int r0, int n, int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(out + r0 * stride + c) =
          pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    if (r1 < n)
      *reinterpret_cast<uint32_t*>(out + r1 * stride + c) =
          pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_bf16(const __grid_constant__ Maps m, const Params p) {
  DkvSmem& s = smem_1024<DkvSmem>();
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (p.Nq + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 33);  // the tx arrive, then each producer lane
      mbar_init(&s.empty[i], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kProducer) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kProducer) return;
    const long long bh = static_cast<long long>(b) * p.H + h;
    const float* lse = p.lse + bh * p.Nq;
    const float* delta = p.delta + bh * p.Nq;
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages, m0 = it * kTile;
      mbar_wait(&s.empty[st], ((it / kStages) & 1) ^ 1);
      if (lane == 0) {  // the tiles first, the row statistics under them
        mbar_arrive_tx(&s.full[st], 2 * kTileBytes);
        tma_load_tile(s.q[st], &m.a, m0, h, b, &s.full[st]);
        tma_load_tile(s.o[st], &m.b, m0, h, b, &s.full[st]);
      }
      for (int r = lane; r < kTile; r += 32) {
        const int row = m0 + r;
        s.lse[st][r] = row < p.Nq ? lse[row] * kLog2e : INFINITY;
        s.dlt[st][r] = row < p.Nq ? delta[row] : 0.f;
      }
      mbar_arrive(&s.full[st]);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    // consumer warpgroup wg owns keys 128 blockIdx.x + 64 wg .. + 63; this
    // thread's rows of the accumulators are keys c0 and c1. The warp's 16
    // keys of K and V stay in registers as A fragments for the whole loop
    // (keys past n_keys read 0).
    const int wg = warp >> 2, wl = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int c0 = blockIdx.x * kOwn + wg * 64 + wl * 16 + g, c1 = c0 + 8;
    const bool live0 = c0 < p.n_keys, live1 = c1 < p.n_keys;
    uint32_t kf[4][4], vf[4][4];
    load_a_rows(kf, at<__nv_bfloat16>(p.k, b, h, p.skb, p.skh), p.skn, c0,
                p.n_keys, t);
    load_a_rows(vf, at<__nv_bfloat16>(p.v, b, h, p.svb, p.svh), p.svn, c0,
                p.n_keys, t);
    float dk[8][4], dv[8][4];
    zero_acc(dk);
    zero_acc(dv);

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      mbar_wait(&s.full[st], (it / kStages) & 1);
      const uint64_t qd = sw128_desc(s.q[st]), od = sw128_desc(s.o[st]);
      // S^T = K Q^T, then dP^T = V dO^T, as two groups: 64 keys x 64
      // queries, Q and dO read K-major (16 of the head dim a step)
      float sc[8][4], dp[8][4];
      wgmma_fence();
      wgmma_rs_first<0>(sc, kf[0], qd);
#pragma unroll
      for (int kk = 1; kk < 4; ++kk) wgmma_rs<0>(sc, kf[kk], qd + 2 * kk);
      wgmma_commit();
      wgmma_rs_first<0>(dp, vf[0], od);
#pragma unroll
      for (int kk = 1; kk < 4; ++kk) wgmma_rs<0>(dp, vf[kk], od + 2 * kk);
      wgmma_commit();
      // P^T = exp(S^T * scale - lse), 0 for keys past n_keys, while dP^T
      // runs
      wgmma_wait<1>();
      fence_acc(sc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l =
            *reinterpret_cast<const float2*>(&s.lse[st][8 * j + 2 * t]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sc[j][e] * p.scale_log2 - ((e & 1) ? l.y : l.x);
          sc[j][e] = (e < 2 ? live0 : live1) ? exp2_fast(x) : 0.f;
        }
      }
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(pa[kk], sc, kk);
      // dV += P^T dO: A from registers, dO read MN-major (16 query rows a
      // step); then dS^T = P^T * (dP^T - D) while it runs
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dv, pa[kk], od + 128 * kk);
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d =
            *reinterpret_cast<const float2*>(&s.dlt[st][8 * j + 2 * t]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = sc[j][e] * (dp[j][e] - ((e & 1) ? d.y : d.x));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(da[kk], dp, kk);
      // dK += dS^T Q, Q read MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dk, da[kk], qd + 128 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dv);
      fence_acc(dk);
      fence_frag(pa);
      fence_frag(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[st]);  // stage st is free
    }

    store_rows(at_out<__nv_bfloat16>(p.dk, b, h, p.sdkb, p.sdkh), p.sdkn, dk,
               p.scale, c0, p.Nk, t);
    store_rows(at_out<__nv_bfloat16>(p.dv, b, h, p.sdvb, p.sdvh), p.sdvn, dv,
               1.f, c0, p.Nk, t);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16(const __grid_constant__ Maps m, const Params p) {
  DqSmem& s = smem_1024<DqSmem>();
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (p.n_keys + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);   // the producer's arrive with the tx
      mbar_init(&s.empty[i], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kProducer) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kProducer) return;
    if (lane == 0) {
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages, n0 = it * kTile;
        mbar_wait(&s.empty[st], ((it / kStages) & 1) ^ 1);
        mbar_arrive_tx(&s.full[st], 2 * kTileBytes);
        tma_load_tile(s.k[st], &m.a, n0, h, b, &s.full[st]);
        tma_load_tile(s.v[st], &m.b, n0, h, b, &s.full[st]);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    // consumer warpgroup wg owns queries 128 blockIdx.x + 64 wg .. + 63;
    // this thread's rows of the accumulators are r0 and r1. The warp's 16
    // rows of Q and dO stay in registers as A fragments (rows past Nq 0).
    const int wg = warp >> 2, wl = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = blockIdx.x * kOwn + wg * 64 + wl * 16 + g, r1 = r0 + 8;
    uint32_t qf[4][4], of[4][4];
    load_a_rows(qf, at<__nv_bfloat16>(p.q, b, h, p.sqb, p.sqh), p.sqn, r0,
                p.Nq, t);
    load_a_rows(of, at<__nv_bfloat16>(p.dout, b, h, p.sob, p.soh), p.son, r0,
                p.Nq, t);
    const long long bh = static_cast<long long>(b) * p.H + h;
    // the rows' lse (log2 units) and D; rows past Nq: lse +inf, so P = 0
    const float L0 = r0 < p.Nq ? p.lse[bh * p.Nq + r0] * kLog2e : INFINITY;
    const float L1 = r1 < p.Nq ? p.lse[bh * p.Nq + r1] * kLog2e : INFINITY;
    const float D0 = r0 < p.Nq ? p.delta[bh * p.Nq + r0] : 0.f;
    const float D1 = r1 < p.Nq ? p.delta[bh * p.Nq + r1] : 0.f;
    float dq[8][4];
    zero_acc(dq);

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages, n0 = it * kTile;
      mbar_wait(&s.full[st], (it / kStages) & 1);
      const uint64_t kd = sw128_desc(s.k[st]), vd = sw128_desc(s.v[st]);
      // S = Q K^T, then dP = dO V^T, as two groups: 64 queries x 64 keys,
      // K and V read K-major
      float sc[8][4], dp[8][4];
      wgmma_fence();
      wgmma_rs_first<0>(sc, qf[0], kd);
#pragma unroll
      for (int kk = 1; kk < 4; ++kk) wgmma_rs<0>(sc, qf[kk], kd + 2 * kk);
      wgmma_commit();
      wgmma_rs_first<0>(dp, of[0], vd);
#pragma unroll
      for (int kk = 1; kk < 4; ++kk) wgmma_rs<0>(dp, of[kk], vd + 2 * kk);
      wgmma_commit();
      // P = exp(S * scale - lse), 0 for keys past n_keys (only the last
      // tile has any), while dP runs
      wgmma_wait<1>();
      fence_acc(sc);
      const bool ragged = n0 + kTile > p.n_keys;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n0 + j * 8 + 2 * t + (e & 1);
          const float pe =
              exp2_fast(sc[j][e] * p.scale_log2 - (e < 2 ? L0 : L1));
          sc[j][e] = ragged && key >= p.n_keys ? 0.f : pe;
        }
      }
      // dS = P * (dP - D)
      wgmma_wait<0>();
      fence_acc(dp);
      uint32_t da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = sc[j][e] * (dp[j][e] - (e < 2 ? D0 : D1));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(da[kk], dp, kk);
      // dQ += dS K: A from registers, K read MN-major (16 key rows a step)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dq, da[kk], kd + 128 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dq);
      fence_frag(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[st]);  // stage st is free
    }

    store_rows(at_out<__nv_bfloat16>(p.dq, b, h, p.sdqb, p.sdqh), p.sdqn, dq,
               p.scale, r0, p.Nq, t);
  }
}

// ---------------------------------------------------------------------------
// float32: mma.sync m16n8k8 on split TF32 operands (3xTF32, mma_tf32.cuh)
// ---------------------------------------------------------------------------
// A block of 8 warps owns 128 rows (keys in dkv, queries in dq), 16 a warp,
// split once into TF32 big and small parts in shared memory, where each
// warp reads its 16 rows as A fragments. 32-row tiles of the other side
// stream in by cp.async into a double buffer and are split in place (big)
// and beside it (small), each thread the chunks it copied. Rows are padded
// to 72 floats (8 mod 32 words), and the rows of a streamed tile are read
// in the order sigma below, so that both of a tile's fragment loads meet no
// bank conflict: as B [n = row][k = head dim] of the score products (one
// 8-byte load a part) and as B [k = row][n = head dim] of dV, dK or dQ (two
// 4-byte loads a part).
struct F32Smem {
  float ab[kOwnF][kLdF], as[kOwnF][kLdF];  // owned K (dkv) or Q (dq), split
  float bb[kOwnF][kLdF], bs[kOwnF][kLdF];  // owned V (dkv) or dO (dq), split
  float xt[2][kTileF][kLdF], xs[kTileF][kLdF];  // Q (dkv) or K (dq) tiles:
  float yt[2][kTileF][kLdF], ys[kTileF][kLdF];  // raw, then big; small
  float lse[2][kTileF], dlt[2][kTileF];  // dkv: the tile's lse (log2) and D
};

// Column c of an 8-wide score tile is streamed row sigma(c) of its 8-row
// group, and so is k slot c / 2 + 4 (c & 1) of a product over those rows
// (mma_tf32.cuh's k order): σ = (0, 1, 2, 3, 5, 4, 7, 6). A warp's score B
// loads then read rows {0, 1, 2, 3} and {5, 4, 7, 6} in its two half-warps,
// and its [k][n] loads rows σ(2t) = {0, 2, 5, 7} and σ(2t + 1) =
// {1, 3, 4, 6}: 8 words apart mod 32 at a row stride of 72 in each case.
__device__ __forceinline__ int sigma(int c) { return c ^ (c >> 2); }

__device__ __forceinline__ void split4(const float4 x, float4& big,
                                       float4& small) {
  const float v[4] = {x.x, x.y, x.z, x.w};
  uint32_t bg[4], sm[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(v[e], bg[e], sm[e]);
  big = make_float4(__uint_as_float(bg[0]), __uint_as_float(bg[1]),
                    __uint_as_float(bg[2]), __uint_as_float(bg[3]));
  small = make_float4(__uint_as_float(sm[0]), __uint_as_float(sm[1]),
                      __uint_as_float(sm[2]), __uint_as_float(sm[3]));
}

// The block's kOwnF own rows [r0, r0 + kOwnF) of a float32 [N, 64] matrix
// (rows at or past n_valid 0), split into padded shared rows
__device__ __forceinline__ void load_split_own(float (*big)[kLdF],
                                               float (*small)[kLdF],
                                               const float* x,
                                               long long stride, int r0,
                                               int n_valid) {
  for (int c = threadIdx.x; c < kOwnF * kD / 4; c += kThreadsF) {
    const int r = c / (kD / 4), col = c % (kD / 4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_valid)
      val = *reinterpret_cast<const float4*>(x + (r0 + r) * stride + col);
    split4(val, *reinterpret_cast<float4*>(&big[r][col]),
           *reinterpret_cast<float4*>(&small[r][col]));
  }
}

// The rows of one [kTileF, 64] tile (rows past n_valid zero-filled) into
// the padded shared rows, 16 bytes a copy: this thread's chunks are rows
// tid / 16 + 16 i, columns 4 (tid % 16) ...
constexpr int kCopyRowsF = kThreadsF / (kD / 4);

__device__ __forceinline__ void load_tile_f32(float (*dst)[kLdF],
                                              const float* src,
                                              long long stride, int n0,
                                              int n_valid) {
  const int r0 = threadIdx.x / (kD / 4), col = threadIdx.x % (kD / 4) * 4;
#pragma unroll
  for (int i = 0; i < kTileF / kCopyRowsF; ++i) {
    const int r = r0 + kCopyRowsF * i;
    const bool ok = n0 + r < n_valid;
    cp_async16(smem_u32(&dst[r][col]),
               src + (ok ? (n0 + r) * stride + col : 0), ok);
  }
}

// ... which it splits once they have landed (no other thread's copies are
// read): big in place, small beside it
__device__ __forceinline__ void split_tile_f32(float (*raw)[kLdF],
                                               float (*small)[kLdF]) {
  const int r0 = threadIdx.x / (kD / 4), col = threadIdx.x % (kD / 4) * 4;
#pragma unroll
  for (int i = 0; i < kTileF / kCopyRowsF; ++i) {
    float4* x = reinterpret_cast<float4*>(&raw[r0 + kCopyRowsF * i][col]);
    split4(*x, *x,
           *reinterpret_cast<float4*>(&small[r0 + kCopyRowsF * i][col]));
  }
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

// dkv: the lse and D of the query tile from m0 (threads 0-31 and 32-63,
// one row each; rows past Nq zero-filled) ...
__device__ __forceinline__ void load_stats_f32(F32Smem& s, int st,
                                               const float* lse,
                                               const float* delta, int m0,
                                               int Nq) {
  const int r = threadIdx.x & (kTileF - 1);
  const bool ok = m0 + r < Nq;
  if (threadIdx.x < kTileF)
    cp_async4(smem_u32(&s.lse[st][r]), lse + (ok ? m0 + r : 0), ok);
  else if (threadIdx.x < 2 * kTileF)
    cp_async4(smem_u32(&s.dlt[st][r]), delta + (ok ? m0 + r : 0), ok);
}

// ... whose lse the same threads scale into log2 units once it has
// landed, +inf past Nq (so that P = 0 there)
__device__ __forceinline__ void scale_lse_f32(F32Smem& s, int st, int m0,
                                              int Nq) {
  if (threadIdx.x < kTileF)
    s.lse[st][threadIdx.x] = m0 + static_cast<int>(threadIdx.x) < Nq
        ? s.lse[st][threadIdx.x] * kLog2e : INFINITY;
}

// One k-step's split B fragments of the 32 x 64 score product against a
// streamed tile (big in `big`, small in `small`): n-tile j's column g is
// the tile's row 8 j + sigma(g), the k-step's 8 head-dim columns from k0.
__device__ __forceinline__ void load_score_b(uint32_t (&bb)[kTileF / 8][2],
                                             uint32_t (&bs)[kTileF / 8][2],
                                             const float (*big)[kLdF],
                                             const float (*small)[kLdF],
                                             int sg, int k0, int t) {
#pragma unroll
  for (int j = 0; j < kTileF / 8; ++j) {
    load_b_nk(bb[j], &big[0][0], kLdF, j * 8 + sg, k0, t);
    load_b_nk(bs[j], &small[0][0], kLdF, j * 8 + sg, k0, t);
  }
}

// 16 rows x 32 streamed rows of scores, sc = A·Bᵀ over the head dim: A the
// warp's 16 owned rows (split), B a streamed tile; each pair of k-steps
// summed on the tensor cores from zero (kT: the transposed product's order,
// mma_3xtf32_sweep_d's kSwap), then added in float32. Two such products at
// once (S and dP), so that each kind of product runs over 8 tiles.
template <bool kT>
__device__ __forceinline__ void score_pair(
    float (&s1)[kTileF / 8][4], float (&s2)[kTileF / 8][4],
    const float (*a1b)[kLdF], const float (*a1s)[kLdF],
    const float (*a2b)[kLdF], const float (*a2s)[kLdF],
    const float (*x1b)[kLdF], const float (*x1s)[kLdF],
    const float (*x2b)[kLdF], const float (*x2s)[kLdF], int g, int t) {
  const int sg = sigma(g);
#pragma unroll
  for (int kp = 0; kp < kD / 16; ++kp) {
    float d1[kTileF / 8][4], d2[kTileF / 8][4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int k0 = (2 * kp + h2) * 8;
      uint32_t ab1[4], as1[4], ab2[4], as2[4];
      uint32_t bb1[kTileF / 8][2], bs1[kTileF / 8][2];
      uint32_t bb2[kTileF / 8][2], bs2[kTileF / 8][2];
      load_a_frag(ab1, &a1b[0][0], kLdF, g, k0, t);
      load_a_frag(as1, &a1s[0][0], kLdF, g, k0, t);
      load_a_frag(ab2, &a2b[0][0], kLdF, g, k0, t);
      load_a_frag(as2, &a2s[0][0], kLdF, g, k0, t);
      load_score_b(bb1, bs1, x1b, x1s, sg, k0, t);
      load_score_b(bb2, bs2, x2b, x2s, sg, k0, t);
      if (h2 == 0) {
        mma_3xtf32_sweep_d<true, kT>(d1, ab1, as1, bb1, bs1);
        mma_3xtf32_sweep_d<true, kT>(d2, ab2, as2, bb2, bs2);
      } else {
        mma_3xtf32_sweep_d<false, kT>(d1, ab1, as1, bb1, bs1);
        mma_3xtf32_sweep_d<false, kT>(d2, ab2, as2, bb2, bs2);
      }
    }
#pragma unroll
    for (int j = 0; j < kTileF / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s1[j][e] = kp ? s1[j][e] + d1[j][e] : d1[j][e];
        s2[j][e] = kp ? s2[j][e] + d2[j][e] : d2[j][e];
      }
  }
}

// acc += W·X over the tile's 32 streamed rows (k): W the 16 x 32 weights in
// score-accumulator layout (P or dS: column tile j is the A fragment of
// k-step j, split here), X the tile [k = row][n = head dim] (big, small),
// its k slots the rows sigma(2t), sigma(2t + 1) of each 8-row group (rk0,
// rk1: their offsets). Each pair of k-steps summed from zero over the 8
// head-dim tiles, then added in float32.
__device__ __forceinline__ void weighted_rows(
    float (&acc)[8][4], const float (&w)[kTileF / 8][4],
    const float (*xb)[kLdF], const float (*xs)[kLdF], int rk0, int rk1,
    int g) {
#pragma unroll
  for (int jp = 0; jp < kTileF / 16; ++jp) {
    float d[8][4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int j = 2 * jp + h2;
      uint32_t ab[4], as[4], bb[8][2], bs[8][2];
      acc_to_a_tf32(ab, as, w[j]);
      const float* b0 = &xb[j * 8][0];
      const float* s0 = &xs[j * 8][0];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = n * 8 + g;
        bb[n][0] = __float_as_uint(b0[rk0 + c]);
        bb[n][1] = __float_as_uint(b0[rk1 + c]);
        bs[n][0] = __float_as_uint(s0[rk0 + c]);
        bs[n][1] = __float_as_uint(s0[rk1 + c]);
      }
      if (h2 == 0)
        mma_3xtf32_sweep_d<true>(d, ab, as, bb, bs);
      else
        mma_3xtf32_sweep_d<false>(d, ab, as, bb, bs);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += d[n][e];
  }
}

// Write a warp's 16 x 64 f32 accumulator (times `mul`) as float32 rows r0
// and r0 + 8; rows at or past n are not written.
__device__ __forceinline__ void store_rows_f32(float* out, long long stride,
                                               const float (&acc)[8][4],
                                               float mul, int r0, int n,
                                               int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < n)
      *reinterpret_cast<float2*>(out + r0 * stride + c) =
          make_float2(acc[j][0] * mul, acc[j][1] * mul);
    if (r0 + 8 < n)
      *reinterpret_cast<float2*>(out + (r0 + 8) * stride + c) =
          make_float2(acc[j][2] * mul, acc[j][3] * mul);
  }
}

__global__ void __launch_bounds__(kThreadsF, 1)
flash_bwd_dkv_f32(const Params p) {
  F32Smem& s = smem_1024<F32Smem>();
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* q = at<float>(p.q, b, h, p.sqb, p.sqh);
  const float* dout = at<float>(p.dout, b, h, p.sob, p.soh);
  const long long bh = static_cast<long long>(b) * p.H + h;
  const float* lse = p.lse + bh * p.Nq;
  const float* delta = p.delta + bh * p.Nq;
  const int n_tiles = (p.Nq + kTileF - 1) / kTileF;
  // the first query tile streams in while the owned keys are split
  load_tile_f32(s.xt[0], q, p.sqn, 0, p.Nq);
  load_tile_f32(s.yt[0], dout, p.son, 0, p.Nq);
  load_stats_f32(s, 0, lse, delta, 0, p.Nq);
  cp_async_commit();
  const int base = blockIdx.x * kOwnF;
  load_split_own(s.ab, s.as, at<float>(p.k, b, h, p.skb, p.skh), p.skn, base,
                 p.n_keys);
  load_split_own(s.bb, s.bs, at<float>(p.v, b, h, p.svb, p.svh), p.svn, base,
                 p.n_keys);

  // this thread's rows of the accumulators are keys c0 and c0 + 8 (keys
  // past n_keys: P = 0, so dK and dV are exactly 0 there); its score
  // columns 2t and 2t + 1 of each n-tile are queries sigma(2t), sigma(2t+1)
  const int w0 = warp * 16, c0 = base + w0 + g;
  const bool live0 = c0 < p.n_keys, live1 = c0 + 8 < p.n_keys;
  const int q0 = sigma(2 * t), q1 = sigma(2 * t + 1);
  const int rk0 = q0 * kLdF, rk1 = q1 * kLdF;
  float dk[8][4], dv[8][4];
  zero_acc(dk);
  zero_acc(dv);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, m0 = it * kTileF;
    if (it + 1 < n_tiles) {  // the next tile streams in under this one
      load_tile_f32(s.xt[st ^ 1], q, p.sqn, m0 + kTileF, p.Nq);
      load_tile_f32(s.yt[st ^ 1], dout, p.son, m0 + kTileF, p.Nq);
      load_stats_f32(s, st ^ 1, lse, delta, m0 + kTileF, p.Nq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    split_tile_f32(s.xt[st], s.xs);
    split_tile_f32(s.yt[st], s.ys);
    scale_lse_f32(s, st, m0, p.Nq);
    __syncthreads();  // the tile is split and in place

    // S^T = K Q^T and dP^T = V dO^T, 16 keys x 32 queries, in the
    // transposed products' order, so that dP^T has the bits of dq's dP
    // and of D's products
    float sc[kTileF / 8][4], dp[kTileF / 8][4];
    score_pair<true>(sc, dp, s.ab + w0, s.as + w0, s.bb + w0, s.bs + w0,
                     s.xt[st], s.xs, s.yt[st], s.ys, g, t);
    // P^T = exp2(S^T scale log2(e) - lse), dS^T = P^T (dP^T - D)
#pragma unroll
    for (int j = 0; j < kTileF / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + ((e & 1) ? q1 : q0);
        const float pe = (e < 2 ? live0 : live1)
            ? exp2_fast(sc[j][e] * p.scale_log2 - s.lse[st][col]) : 0.f;
        sc[j][e] = pe;
        dp[j][e] = pe * (dp[j][e] - s.dlt[st][col]);
      }
    }
    // dV += P^T dO, dK += dS^T Q over the tile's queries
    weighted_rows(dv, sc, s.yt[st], s.ys, rk0, rk1, g);
    weighted_rows(dk, dp, s.xt[st], s.xs, rk0, rk1, g);
    __syncthreads();  // every warp is done with the tile: the next one is
                      // split into xs, ys and its stage refilled
  }

  store_rows_f32(at_out<float>(p.dk, b, h, p.sdkb, p.sdkh), p.sdkn, dk,
                 p.scale, c0, p.Nk, t);
  store_rows_f32(at_out<float>(p.dv, b, h, p.sdvb, p.sdvh), p.sdvn, dv, 1.f,
                 c0, p.Nk, t);
}

__global__ void __launch_bounds__(kThreadsF, 1)
flash_bwd_dq_f32(const Params p) {
  F32Smem& s = smem_1024<F32Smem>();
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* k = at<float>(p.k, b, h, p.skb, p.skh);
  const float* v = at<float>(p.v, b, h, p.svb, p.svh);
  const int n_tiles = (p.n_keys + kTileF - 1) / kTileF;
  load_tile_f32(s.xt[0], k, p.skn, 0, p.n_keys);
  load_tile_f32(s.yt[0], v, p.svn, 0, p.n_keys);
  cp_async_commit();
  const int base = blockIdx.x * kOwnF;
  load_split_own(s.ab, s.as, at<float>(p.q, b, h, p.sqb, p.sqh), p.sqn, base,
                 p.Nq);
  load_split_own(s.bb, s.bs, at<float>(p.dout, b, h, p.sob, p.soh), p.son,
                 base, p.Nq);

  // this thread's rows are queries r0 and r0 + 8: their lse (log2 units;
  // rows past Nq +inf, so P = 0) and D; its score columns 2t and 2t + 1 of
  // each n-tile are keys sigma(2t), sigma(2t + 1)
  const int w0 = warp * 16, r0 = base + w0 + g;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const float L0 = r0 < p.Nq ? p.lse[bh * p.Nq + r0] * kLog2e : INFINITY;
  const float L1 =
      r0 + 8 < p.Nq ? p.lse[bh * p.Nq + r0 + 8] * kLog2e : INFINITY;
  const float D0 = r0 < p.Nq ? p.delta[bh * p.Nq + r0] : 0.f;
  const float D1 = r0 + 8 < p.Nq ? p.delta[bh * p.Nq + r0 + 8] : 0.f;
  const int k0r = sigma(2 * t), k1r = sigma(2 * t + 1);
  const int rk0 = k0r * kLdF, rk1 = k1r * kLdF;
  float dq[8][4];
  zero_acc(dq);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, n0 = it * kTileF;
    if (it + 1 < n_tiles) {
      load_tile_f32(s.xt[st ^ 1], k, p.skn, n0 + kTileF, p.n_keys);
      load_tile_f32(s.yt[st ^ 1], v, p.svn, n0 + kTileF, p.n_keys);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    split_tile_f32(s.xt[st], s.xs);
    split_tile_f32(s.yt[st], s.ys);
    __syncthreads();

    // S = Q K^T and dP = dO V^T, 16 queries x 32 keys
    float sc[kTileF / 8][4], dp[kTileF / 8][4];
    score_pair<false>(sc, dp, s.ab + w0, s.as + w0, s.bb + w0, s.bs + w0,
                      s.xt[st], s.xs, s.yt[st], s.ys, g, t);
    // P = exp2(S scale log2(e) - lse), 0 for keys past n_keys (only the
    // last tile has any); dS = P (dP - D)
    const bool ragged = n0 + kTileF > p.n_keys;
#pragma unroll
    for (int j = 0; j < kTileF / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + j * 8 + ((e & 1) ? k1r : k0r);
        const float pe =
            exp2_fast(sc[j][e] * p.scale_log2 - (e < 2 ? L0 : L1));
        sc[j][e] = ragged && key >= p.n_keys ? 0.f : pe;
        dp[j][e] = sc[j][e] * (dp[j][e] - (e < 2 ? D0 : D1));
      }
    }
    // dQ += dS K over the tile's keys
    weighted_rows(dq, dp, s.xt[st], s.xs, rk0, rk1, g);
    __syncthreads();
  }

  store_rows_f32(at_out<float>(p.dq, b, h, p.sdqb, p.sdqh), p.sdqn, dq,
                 p.scale, r0, p.Nq, t);
}

constexpr int kDeltaThreads = 256;
constexpr int kDeltaLanes = 8;  // bf16: threads a row, 16 bytes each

// bf16: one row of O and dO per kDeltaLanes neighbouring threads of a warp,
// 8 values of each a thread (one 16-byte load); block (Nq tile, h, b)
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_bf16(const __nv_bfloat16* o, const __nv_bfloat16* dout,
                     float* delta, int H, int Nq, long long sob,
                     long long soh, long long son, long long sdb,
                     long long sdh, long long sdn) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int sub = threadIdx.x % kDeltaLanes;
  const int n = blockIdx.x * (kDeltaThreads / kDeltaLanes) +
                threadIdx.x / kDeltaLanes;
  float acc = 0.f;
  if (n < Nq) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + b * sob + h * soh +
                                                    n * son + sub * 8);
    const uint4 c = *reinterpret_cast<const uint4*>(dout + b * sdb + h * sdh +
                                                    n * sdn + sub * 8);
    const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
      acc = fmaf(u.x, w.x, acc);
      acc = fmaf(u.y, w.y, acc);
    }
  }
#pragma unroll
  for (int off = kDeltaLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0 && n < Nq)
    delta[(static_cast<long long>(b) * H + h) * Nq + n] = acc;
}

// float32: D is the diagonal of dO·Oᵀ through the products with which dkv
// and dq compute dP (3xTF32 mma.sync, A = dO and B = O in the roles of dq's
// dO and V, each pair of k-steps summed from zero and then added in
// float32), so that D and dP are the same float computation of the same
// numbers wherever O is a row of V: at one live key (P = 1, O = V to the
// bit) dP - D is exactly 0, as dS should be. A warp takes 16 rows, each
// thread two (g and g + 8): one m16n8k8 tile against the first 8 rows of O
// and one against the other 8 give the 16 diagonal elements. Its loads
// are those of an A and a B fragment: 8 bytes a thread, 4 threads a row,
// every 32-byte sector read whole. Bound by bytes, as above.
__global__ void __launch_bounds__(kThreadsF)
flash_bwd_delta_f32(const float* o, const float* dout, float* delta, int H,
                    int Nq, long long sob, long long soh, long long son,
                    long long sdb, long long sdh, long long sdn) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kOwnF + warp * 16 + g, r1 = r0 + 8;
  const float* o0 = o + b * sob + h * soh + r0 * son;
  const float* o1 = o0 + 8 * son;
  const float* d0 = dout + b * sdb + h * sdh + r0 * sdn;
  const float* d1 = d0 + 8 * sdn;
  const bool ok0 = r0 < Nq, ok1 = r1 < Nq;
  const float2 zero = make_float2(0.f, 0.f);
  float acc0[1][4], acc1[1][4];
#pragma unroll
  for (int kp = 0; kp < kD / 16; ++kp) {
    float s0[1][4], s1[1][4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int c = (2 * kp + h2) * 8 + 2 * t;
      const float2 a0 = ok0 ? *reinterpret_cast<const float2*>(d0 + c) : zero;
      const float2 a1 = ok1 ? *reinterpret_cast<const float2*>(d1 + c) : zero;
      const float2 x0 = ok0 ? *reinterpret_cast<const float2*>(o0 + c) : zero;
      const float2 x1 = ok1 ? *reinterpret_cast<const float2*>(o1 + c) : zero;
      // dO rows g, g + 8 as A (load_a_frag's order); O row g, then row
      // g + 8, as column g of B (load_b_nk's)
      uint32_t ab[4], as[4], bb0[1][2], bs0[1][2], bb1[1][2], bs1[1][2];
      split_tf32(a0.x, ab[0], as[0]);
      split_tf32(a1.x, ab[1], as[1]);
      split_tf32(a0.y, ab[2], as[2]);
      split_tf32(a1.y, ab[3], as[3]);
      split_tf32(x0.x, bb0[0][0], bs0[0][0]);
      split_tf32(x0.y, bb0[0][1], bs0[0][1]);
      split_tf32(x1.x, bb1[0][0], bs1[0][0]);
      split_tf32(x1.y, bb1[0][1], bs1[0][1]);
      if (h2 == 0) {
        mma_3xtf32_sweep_d<true>(s0, ab, as, bb0, bs0);
        mma_3xtf32_sweep_d<true>(s1, ab, as, bb1, bs1);
      } else {
        mma_3xtf32_sweep_d<false>(s0, ab, as, bb0, bs0);
        mma_3xtf32_sweep_d<false>(s1, ab, as, bb1, bs1);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc0[0][e] = kp ? acc0[0][e] + s0[0][e] : s0[0][e];
      acc1[0][e] = kp ? acc1[0][e] + s1[0][e] : s1[0][e];
    }
  }
  // element (g, g) of the first tile and (g + 8, g) of the second are this
  // quad's thread t = g / 2, columns 2t and 2t + 1
  if (t == g >> 1) {
    float* out = delta + (static_cast<long long>(b) * H + h) * Nq;
    if (ok0) out[r0] = acc0[0][g & 1];
    if (ok1) out[r1] = acc1[0][2 + (g & 1)];
  }
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   int H, int Nq, int Nk, int kv_valid, float sm_scale,
                   const long long* s) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.n_keys = kv_valid < Nk ? kv_valid : Nk;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * kLog2e;
  p.sqb = s[0]; p.sqh = s[1]; p.sqn = s[2];
  p.skb = s[3]; p.skh = s[4]; p.skn = s[5];
  p.svb = s[6]; p.svh = s[7]; p.svn = s[8];
  p.sob = s[9]; p.soh = s[10]; p.son = s[11];
  return p;
}

// A float32 kernel's launch with its dynamic shared memory (above the
// 48 KB a launch gets without asking)
int launch_f32(void (*kernel)(const Params), dim3 grid, const Params& p,
               cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<F32Smem>());
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreadsF, smem_bytes<F32Smem>(), s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// D = rowsum(dO * O) into a contiguous float32 [B, H, Nq] `delta`. dtype:
// 0 = float32, 1 = bfloat16. strides: 6 element strides, o (b, h, n) then
// dout (b, h, n); rows 16-byte aligned.
extern "C" int flash_attention_bwd_delta(int dtype, const void* o,
                                         const void* dout, float* delta,
                                         int B, int H, int Nq,
                                         const long long* strides,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* s = strides;
  if (dtype == 1) {
    constexpr int rows = kDeltaThreads / kDeltaLanes;
    flash_bwd_delta_bf16<<<dim3((Nq + rows - 1) / rows, H, B), kDeltaThreads,
                           0, st>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), delta, H, Nq, s[0], s[1],
        s[2], s[3], s[4], s[5]);
  } else if (dtype == 0) {
    flash_bwd_delta_f32<<<dim3((Nq + kOwnF - 1) / kOwnF, H, B), kThreadsF,
                          0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), delta,
        H, Nq, s[0], s[1], s[2], s[3], s[4], s[5]);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. strides: 18 element strides in the order
// q, k, v, dout, dk, dv, each (b, h, n). lse, delta: contiguous float32
// [B, H, Nq]. maps (bfloat16 only, else unread): the tensor-map geometry of
// q and dout, 7 values each (encode_map).
extern "C" int flash_attention_bwd_dkv(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* dout, const float* lse,
                                       const float* delta, void* dk, void* dv,
                                       int B, int H, int Nq, int Nk,
                                       int kv_valid, float sm_scale,
                                       const long long* strides,
                                       const unsigned long long* maps,
                                       void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, H, Nq, Nk, kv_valid,
                         sm_scale, strides);
  p.dk = dk;
  p.dv = dv;
  p.sdkb = strides[12]; p.sdkh = strides[13]; p.sdkn = strides[14];
  p.sdvb = strides[15]; p.sdvh = strides[16]; p.sdvn = strides[17];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bf16(flash_bwd_dkv_bf16, kThreads, smem_bytes<DkvSmem>(),
                       dim3((Nk + kOwn - 1) / kOwn, H, B), p, q, dout, maps,
                       s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch_f32(flash_bwd_dkv_f32, dim3((Nk + kOwnF - 1) / kOwnF, H, B),
                    p, s);
}

// strides: 15 element strides in the order q, k, v, dout, dq, each (b, h, n);
// maps: the geometry of k and v, with n_keys rows.
extern "C" int flash_attention_bwd_dq(int dtype, const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dq, int B, int H, int Nq, int Nk,
                                      int kv_valid, float sm_scale,
                                      const long long* strides,
                                      const unsigned long long* maps,
                                      void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, H, Nq, Nk, kv_valid,
                         sm_scale, strides);
  p.dq = dq;
  p.sdqb = strides[12]; p.sdqh = strides[13]; p.sdqn = strides[14];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bf16(flash_bwd_dq_bf16, kThreads, smem_bytes<DqSmem>(),
                       dim3((Nq + kOwn - 1) / kOwn, H, B), p, k, v, maps,
                       s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch_f32(flash_bwd_dq_f32, dim3((Nq + kOwnF - 1) / kOwnF, H, B),
                    p, s);
}

// Dynamic shared memory of a kernel's block: 0 = dkv bf16, 1 = dq bf16,
// 2 = dkv or dq float32.
extern "C" int flash_attention_bwd_smem_bytes(int kernel) {
  return kernel == 0 ? smem_bytes<DkvSmem>()
       : kernel == 1 ? smem_bytes<DqSmem>() : smem_bytes<F32Smem>();
}
