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
// The float32 kernels are plain SIMT loops (one thread per owned row, f32
// FMA, no TF32) for the reference-precision checks.
//
// D = rowsum(dO * O) (flash_bwd_delta_*): float32 [B, H, Nq] from bf16 or
// float32 O and dO read through their strides. Bound by bytes: O and dO read
// once, D written once, 2 B H N 64 itemsize + 4 B H N (0.041 ms at
// [32, 12, 1370, 64] bf16 on 3.35 TB/s), where three float32 passes of
// PyTorch (two upcasts, the product, the sum) moved about 0.94 GB. In bf16
// each row's 64 values are 8 16-byte chunks, one per thread; a thread sums
// its chunk's products in order and the row's threads add their sums in a
// fixed butterfly of shuffles, so reruns are bit-equal. The float32 kernel
// is a plain loop, one thread a row, for the reference-precision checks.
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
constexpr int kBM = 64;        // owned rows per block (f32)
constexpr int kBNf = 16;       // streamed rows per tile (f32)
constexpr int kRowf = kD + 1;  // padded f32 row of an owned row: thread i
                               // reads row i, conflict-free
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

// Load the block's 64 own rows [r0, r0 + 64) of a float32 [N, 64] matrix into
// padded shared rows (rows at or past n_valid are 0).
__device__ __forceinline__ void load_own_rows(float (*dst)[kRowf],
                                              const float* x,
                                              long long stride, int r0,
                                              int n_valid) {
  for (int c = threadIdx.x; c < kBM * kD; c += blockDim.x) {
    const int r = c / kD, col = c % kD;
    dst[r][col] = r0 + r < n_valid ? x[(r0 + r) * stride + col] : 0.f;
  }
}

// Stage kBNf rows [n0, n0 + kBNf) of a float32 [N, 64] matrix (rows at or
// past n_valid are 0), 16 bytes at a time.
__device__ __forceinline__ void load_f32_tile(float (*dst)[kD], const float* x,
                                              long long stride, int n0,
                                              int n_valid) {
  for (int c = threadIdx.x; c < kBNf * kD / 4; c += blockDim.x) {
    const int r = c / (kD / 4), col = (c % (kD / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n0 + r < n_valid)
      val = *reinterpret_cast<const float4*>(x + (n0 + r) * stride + col);
    *reinterpret_cast<float4*>(&dst[r][col]) = val;
  }
}

__device__ __forceinline__ float dot64(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < kD; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

__global__ void __launch_bounds__(kBM)
flash_bwd_dkv_f32(const Params p) {
  __shared__ float Kown[kBM][kRowf];
  __shared__ float Vown[kBM][kRowf];
  __shared__ __align__(16) float Qs[kBNf][kD];
  __shared__ __align__(16) float Os[kBNf][kD];
  __shared__ float Ls[kBNf];
  __shared__ float Ds[kBNf];

  const int b = blockIdx.z, h = blockIdx.y;
  const float* q = at<float>(p.q, b, h, p.sqb, p.sqh);
  const float* dout = at<float>(p.dout, b, h, p.sob, p.soh);
  const long long bh = static_cast<long long>(b) * p.H + h;
  const int base = blockIdx.x * kBM, key = base + threadIdx.x;
  load_own_rows(Kown, at<float>(p.k, b, h, p.skb, p.skh), p.skn, base,
                p.n_keys);
  load_own_rows(Vown, at<float>(p.v, b, h, p.svb, p.svh), p.svn, base,
                p.n_keys);

  float dk[kD], dv[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) dk[d] = dv[d] = 0.f;

  for (int m0 = 0; m0 < p.Nq; m0 += kBNf) {
    __syncthreads();
    load_f32_tile(Qs, q, p.sqn, m0, p.Nq);
    load_f32_tile(Os, dout, p.son, m0, p.Nq);
    if (threadIdx.x < kBNf) {
      const int r = m0 + threadIdx.x;
      Ls[threadIdx.x] = r < p.Nq ? p.lse[bh * p.Nq + r] : 0.f;
      Ds[threadIdx.x] = r < p.Nq ? p.delta[bh * p.Nq + r] : 0.f;
    }
    __syncthreads();
    const int n = min(kBNf, p.Nq - m0);
    for (int j = 0; j < n; ++j) {
      const float pj = key < p.n_keys
          ? expf(dot64(Kown[threadIdx.x], Qs[j]) * p.scale - Ls[j]) : 0.f;
      const float ds = pj * (dot64(Vown[threadIdx.x], Os[j]) - Ds[j]);
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        dv[d] = fmaf(pj, Os[j][d], dv[d]);
        dk[d] = fmaf(ds, Qs[j][d], dk[d]);
      }
    }
  }

  if (key < p.Nk) {
    float* dko = at_out<float>(p.dk, b, h, p.sdkb, p.sdkh) + key * p.sdkn;
    float* dvo = at_out<float>(p.dv, b, h, p.sdvb, p.sdvh) + key * p.sdvn;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      dko[d] = dk[d] * p.scale;
      dvo[d] = dv[d];
    }
  }
}

__global__ void __launch_bounds__(kBM)
flash_bwd_dq_f32(const Params p) {
  __shared__ float Qown[kBM][kRowf];
  __shared__ float Oown[kBM][kRowf];
  __shared__ __align__(16) float Ks[kBNf][kD];
  __shared__ __align__(16) float Vs[kBNf][kD];

  const int b = blockIdx.z, h = blockIdx.y;
  const float* k = at<float>(p.k, b, h, p.skb, p.skh);
  const float* v = at<float>(p.v, b, h, p.svb, p.svh);
  const long long bh = static_cast<long long>(b) * p.H + h;
  const int base = blockIdx.x * kBM, row = base + threadIdx.x;
  load_own_rows(Qown, at<float>(p.q, b, h, p.sqb, p.sqh), p.sqn, base, p.Nq);
  load_own_rows(Oown, at<float>(p.dout, b, h, p.sob, p.soh), p.son, base,
                p.Nq);
  // rows past Nq: P = 1 against Q = 0, dO = 0, so dS = 0
  const float L = row < p.Nq ? p.lse[bh * p.Nq + row] : 0.f;
  const float D = row < p.Nq ? p.delta[bh * p.Nq + row] : 0.f;

  float dq[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) dq[d] = 0.f;

  for (int n0 = 0; n0 < p.n_keys; n0 += kBNf) {
    __syncthreads();
    load_f32_tile(Ks, k, p.skn, n0, p.n_keys);
    load_f32_tile(Vs, v, p.svn, n0, p.n_keys);
    __syncthreads();
    const int n = min(kBNf, p.n_keys - n0);
    for (int j = 0; j < n; ++j) {
      const float pj = expf(dot64(Qown[threadIdx.x], Ks[j]) * p.scale - L);
      const float ds = pj * (dot64(Oown[threadIdx.x], Vs[j]) - D);
#pragma unroll
      for (int d = 0; d < kD; ++d) dq[d] = fmaf(ds, Ks[j][d], dq[d]);
    }
  }

  if (row < p.Nq) {
    float* o = at_out<float>(p.dq, b, h, p.sdqb, p.sdqh) + row * p.sdqn;
#pragma unroll
    for (int d = 0; d < kD; ++d) o[d] = dq[d] * p.scale;
  }
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

// float32: one thread a row, the 64 products summed in order (dot64), as the
// float32 dkv and dq kernels sum dP, so that dP - D cancels exactly where
// it should (one key: P = 1, O = V)
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_f32(const float* o, const float* dout, float* delta, int H,
                    int Nq, long long sob, long long soh, long long son,
                    long long sdb, long long sdh, long long sdn) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int n = blockIdx.x * kDeltaThreads + threadIdx.x;
  if (n < Nq)
    delta[(static_cast<long long>(b) * H + h) * Nq + n] =
        dot64(o + b * sob + h * soh + n * son,
              dout + b * sdb + h * sdh + n * sdn);
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
    flash_bwd_delta_f32<<<dim3((Nq + kDeltaThreads - 1) / kDeltaThreads, H,
                               B), kDeltaThreads, 0, st>>>(
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
  flash_bwd_dkv_f32<<<dim3((Nk + kBM - 1) / kBM, H, B), kBM, 0, s>>>(p);
  return (int)cudaGetLastError();
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
  flash_bwd_dq_f32<<<dim3((Nq + kBM - 1) / kBM, H, B), kBM, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a bf16 kernel's block: 0 = dkv, 1 = dq.
extern "C" int flash_attention_bwd_smem_bytes(int kernel) {
  return kernel == 0 ? smem_bytes<DkvSmem>() : smem_bytes<DqSmem>();
}
