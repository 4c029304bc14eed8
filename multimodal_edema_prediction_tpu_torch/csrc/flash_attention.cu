// Flash-attention forward for Hopper (sm_90a): non-causal
// softmax(Q K^T * sm_scale) V per (batch, head), head dim 64.
//
// Replaces the TPU kernel behind multimodal_edema_prediction_tpu/ops/
// attention.py::flash_mha, which calls JAX's Pallas TPU flash-attention
// kernel (jax/experimental/pallas/ops/tpu/flash_attention.py: flash_attention
// :140, forward pallas_call :758). Keys at or past `kv_valid` get probability
// 0, as the segment ids do there; query rows past the true length are
// computed like any other row and sliced off by the caller.
//
// Bound on an H100 SXM: the work is 4*B*H*N^2*D operations (0.187 ms at
// [32, 12, 1370, 64] on 989 TFLOP/s bf16), while the bytes (q, k, v read
// once, o written once: 8*B*H*N*D) take 0.027 ms at 3.35 TB/s. So it is
// bound by operations (and, at head dim 64, about as much by the B*H*N^2
// exponentials on the special function units), and the bf16 kernel is built
// around the tensor cores, on the skeleton of the backward's dq kernel
// (flash_attention_bwd.cu):
//   - Both products are warpgroup MMAs (wgmma, bf16 in, f32 accumulate;
//     wgmma_bf16.cuh), Hopper's only path to its full tensor rate, where the
//     previous design issued mma.sync m16n8k16 and lost 1.85x to a library
//     forward.
//   - A block owns 128 query rows: two consumer warpgroups of 64. Each warp
//     keeps its 16 rows of Q in registers as A fragments for the whole loop,
//     so S = Q K^T reads only the K tile from shared memory; the N x N
//     scores never leave registers (online softmax over 128-key tiles: f32
//     running max m and sum l per row, the accumulator O rescaled by
//     exp2(m_old - m_new) once O's last product has been waited for).
//   - Within a warpgroup, the next tile's S = Q K^T (one m64n128 product a
//     k-step) and this tile's O += P V are issued together, and the next
//     tile's softmax runs while P V is on the tensor cores (FA3's
//     intra-warpgroup overlap). The loop holds no wgmma under a condition:
//     with one there, ptxas serialised every wgmma (C7514).
//   - A producer warp streams the K and V tiles with TMA (128-byte swizzle,
//     the layout wgmma reads; two 64-row boxes a tile) into a 3-stage ring
//     guarded by mbarriers, so loads run under the products, and the two
//     warpgroups never meet at a block-wide barrier: one computes while the
//     other's wgmma runs. Its warpgroup hands its registers to the
//     consumers (setmaxnreg 40 and 232 a thread).
//   - P is rounded to bf16 A fragments in registers (the accumulator's
//     layout is the A layout) for O += P V, V read MN-major.
// On an H100 this read faster, within one call, than 64-key tiles (with or
// without the overlap), the same loop without the overlap, and three
// consumer warpgroups (the 128-key tile then spills).
// The K and V maps end at n_keys = min(Nk, kv_valid), so the ragged last
// tile loads zeros; their scores (0, not -inf) would take weight, so they
// are set to -inf before the row max. l sums P before its rounding to bf16,
// as FA2 does.
//
// The float32 kernel is a plain SIMT loop (one thread per query row, f32 FMA,
// no TF32) for the reference-precision paths (checks against float32 goldens).
//
// Layout: every tensor is [B, H, N, 64] with arbitrary batch/head/token strides
// (in elements) and a contiguous head dim, so q/k/v can be strided views of a
// [B, N, H*64] projection and o can be written as [B, N, H, 64]. The bf16
// kernel reads k and v through 4-D tensor maps (64, n_keys, H, B) encoded per
// call from the views' strides (ops/attention.py::tma_geometry).
//
// For training, the kernel also writes each query row's log-sum-exp of the
// scaled scores, lse = m + log(l) (float32 [B, H, Nq]), which the backward
// kernels (flash_attention_bwd.cu) use to recompute P without a second
// softmax pass; JAX's kernel saves l and m separately under save_residuals
// (flash_attention.py:246-251), the same information in two arrays. A null
// lse pointer skips the write (serving, the frozen ViT). No atomics: reruns
// give the same bits.
//
// Entry point: flash_attention_fwd(...) launches on the given stream, allocates
// nothing and returns a CUDA error code as an int (0 = launched).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kD = 64;         // head dim
constexpr int kOwn = 128;      // query rows per block (bf16): 64 a warpgroup
constexpr int kKeys = 128;     // keys per streamed tile (bf16)
constexpr int kTile = 64;      // rows of one TMA box: two a tile
constexpr int kCols = kKeys / 8;  // 8-key column groups of the scores
constexpr int kStages = 3;     // depth of the TMA ring
constexpr int kThreads = 384;  // two consumer warpgroups + the producer's
constexpr int kProducer = 8;   // the producer's warp (its group's first)
constexpr int kProducerRegs = 40;   // registers a thread after setmaxnreg:
constexpr int kConsumerRegs = 232;  // 128 (40 + 2 x 232) <= 65536
constexpr uint32_t kTileBytes = kTile * kD * 2;
constexpr int kBM = 64;        // query rows per block (f32 kernel)
constexpr int kBNf = 32;       // keys per tile (f32 kernel)
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;        // [B, H, Nq] float32, or null: not written
  int Nq, Nk;        // token counts of q and k/v
  int n_keys;        // min(Nk, kv_valid): keys that take part
  float scale_log2;  // sm_scale * log2(e)
  long long sqb, sqh, sqn, skb, skh, skn, svb, svh, svn, sob, soh, son;
};

// one swizzled [128][64] tile: two boxes of 8 KB back to back, which is the
// same 128-byte swizzle over 128 rows
using Tile = __nv_bfloat16[kKeys * kD];

struct FwdSmem {
  Tile k[kStages], v[kStages];  // the ring of key tiles
  uint64_t full[kStages], empty[kStages];
};

// S = Q K^T for the warpgroup's 64 queries and the tile's 128 keys, K read
// K-major (16 of the head dim a k-step); issued, not waited for
__device__ __forceinline__ void scores(float (&sc)[kCols][4],
                                       const uint32_t (&qf)[4][4],
                                       uint64_t kd) {
  wgmma_rs_first_n128(sc, qf[0], kd);
#pragma unroll
  for (int kk = 1; kk < 4; ++kk) wgmma_rs_n128(sc, qf[kk], kd + 2 * kk);
}

// lse = m + log(l) in natural units, from the running max m (log2 units of
// the scaled scores) and sum l of exp2(s - m)
__device__ __forceinline__ void store_lse(const Params& p, int b, int h,
                                          int row, float m, float l) {
  if (p.lse != nullptr && row < p.Nq)
    p.lse[(static_cast<long long>(b) * gridDim.y + h) * p.Nq + row] =
        (m + log2f(l)) * kLn2;
}

// the maximum over the 4 threads of a quad, which hold the same two rows
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One tile's online softmax, rows r0 and r1 of this thread: the scores
// (keys n0 ..) scaled into log2 units, keys past n_keys (only the last tile
// has any) -inf before the row max, then P = exp2(S - m) in place; the
// running max m and this thread's part of the running sum l updated, and
// alpha = exp2(m_old - m_new), by which O has yet to be multiplied. Every
// tile holds key n0 < n_keys, so the maxima are finite.
__device__ __forceinline__ void online_softmax(float (&sc)[kCols][4], int n0,
                                               const Params& p, int t,
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2]) {
  const bool ragged = n0 + kKeys > p.n_keys;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = n0 + j * 8 + 2 * t + (e & 1);
      sc[j][e] = ragged && key >= p.n_keys ? -INFINITY
                                           : sc[j][e] * p.scale_log2;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = exp2_fast(m[r] - mn);
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[j][e] = exp2_fast(sc[j][e] - m[e >> 1]);
      l[e >> 1] += sc[j][e];
    }
  }
}

// O *= alpha per row, then P (f32 scores after online_softmax) rounded to
// the bf16 A fragments of O += P V
__device__ __forceinline__ void rescale_and_round(
    float (&o)[8][4], const float (&alpha)[2], const float (&sc)[kCols][4],
    uint32_t (&pa)[kKeys / 16][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) acc_to_a(pa[kk], sc, kk);
}

// O += P V for one tile: A from registers, V read MN-major (16 key rows a
// k-step); issued, not waited for
__device__ __forceinline__ void pv_product(float (&o)[8][4],
                                           const uint32_t (&pa)[kKeys / 16][4],
                                           uint64_t vd) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    wgmma_rs<1>(o, pa[kk], vd + 128 * kk);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16(const __grid_constant__ Maps m, const Params p) {
  FwdSmem& s = smem_1024<FwdSmem>();
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (p.n_keys + kKeys - 1) / kKeys;
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
        const int st = it % kStages, n0 = it * kKeys;
        mbar_wait(&s.empty[st], ((it / kStages) & 1) ^ 1);
        mbar_arrive_tx(&s.full[st], 2 * (kKeys / kTile) * kTileBytes);
#pragma unroll
        for (int x = 0; x < kKeys / kTile; ++x) {
          tma_load_tile(s.k[st] + x * kTile * kD, &m.a, n0 + x * kTile, h,
                        b, &s.full[st]);
          tma_load_tile(s.v[st] + x * kTile * kD, &m.b, n0 + x * kTile, h,
                        b, &s.full[st]);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    // consumer warpgroup wg owns queries 128 blockIdx.x + 64 wg .. + 63;
    // this thread's rows of the accumulators are r0 and r1. The warp's 16
    // rows of Q stay in registers as A fragments (rows past Nq read 0).
    const int wg = warp >> 2, wl = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = blockIdx.x * kOwn + wg * 64 + wl * 16 + g, r1 = r0 + 8;
    uint32_t qf[4][4];
    load_a_rows(qf,
                static_cast<const __nv_bfloat16*>(p.q) + b * p.sqb + h * p.sqh,
                p.sqn, r0, p.Nq, t);
    float o[8][4];
    zero_acc(o);
    // running max (log2 units of the scaled scores) and this thread's part
    // of the running sum, rows r0 and r1
    float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
    float alpha[2];
    float sc[kCols][4];
    uint32_t pa[kKeys / 16][4];

    // Tile 0's scores and softmax; then per tile it: the scores of it + 1
    // and O += P_it V_it issued as two groups, the softmax of it + 1 once
    // the first completes (wait<1>: groups complete in order) while P V
    // runs, O rescaled and P_it+1 rounded once P V completes. The last
    // tile's P V is peeled off, so that no wgmma sits under a condition.
    mbar_wait(&s.full[0], 0);
    wgmma_fence();
    scores(sc, qf, sw128_desc(s.k[0]));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    online_softmax(sc, 0, p, t, mrow, lrow, alpha);
    rescale_and_round(o, alpha, sc, pa);
    for (int it = 0; it + 1 < n_tiles; ++it) {
      const int st = it % kStages, sn = (it + 1) % kStages;
      mbar_wait(&s.full[sn], ((it + 1) / kStages) & 1);
      wgmma_fence();
      scores(sc, qf, sw128_desc(s.k[sn]));
      wgmma_commit();
      wgmma_fence();
      pv_product(o, pa, sw128_desc(s.v[st]));
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(sc);
      online_softmax(sc, (it + 1) * kKeys, p, t, mrow, lrow, alpha);
      wgmma_wait<0>();
      fence_acc(o);
      fence_frag(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[st]);  // stage st is free
      rescale_and_round(o, alpha, sc, pa);
    }
    wgmma_fence();
    pv_product(o, pa, sw128_desc(s.v[(n_tiles - 1) % kStages]));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);

    float l0 = quad_sum(lrow[0]), l1 = quad_sum(lrow[1]);
    if (t == 0) {
      store_lse(p, b, h, r0, mrow[0], l0);
      store_lse(p, b, h, r1, mrow[1], l1);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.sob +
                         h * p.soh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * t;
      if (r0 < p.Nq)
        *reinterpret_cast<uint32_t*>(out + r0 * p.son + c) =
            pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
      if (r1 < p.Nq)
        *reinterpret_cast<uint32_t*>(out + r1 * p.son + c) =
            pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
    }
  }
}

__global__ void __launch_bounds__(kBM)
flash_fwd_f32(const Params p) {
  __shared__ __align__(16) float Ks[kBNf][kD];
  __shared__ __align__(16) float Vs[kBNf][kD];

  const int b = blockIdx.z, h = blockIdx.y;
  const float* q = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* k = static_cast<const float*>(p.k) + b * p.skb + h * p.skh;
  const float* v = static_cast<const float*>(p.v) + b * p.svb + h * p.svh;
  const int row = blockIdx.x * kBM + threadIdx.x;

  float qr[kD], acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    qr[d] = row < p.Nq ? q[row * p.sqn + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int n0 = 0; n0 < p.n_keys; n0 += kBNf) {
    __syncthreads();
    for (int c = threadIdx.x; c < kBNf * kD / 4; c += blockDim.x) {
      const int r = c / (kD / 4), col = (c % (kD / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (n0 + r < p.n_keys) {
        kv = *reinterpret_cast<const float4*>(k + (n0 + r) * p.skn + col);
        vv = *reinterpret_cast<const float4*>(v + (n0 + r) * p.svn + col);
      }
      *reinterpret_cast<float4*>(&Ks[r][col]) = kv;
      *reinterpret_cast<float4*>(&Vs[r][col]) = vv;
    }
    __syncthreads();

    float s[kBNf];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBNf; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) dot = fmaf(qr[d], Ks[j][d], dot);
      s[j] = n0 + j < p.n_keys ? dot * p.scale_log2 : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float a = exp2f(m - mn);
    m = mn;
    l *= a;
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[d] *= a;
#pragma unroll
    for (int j = 0; j < kBNf; ++j) {
      const float pj = exp2f(s[j] - m);
      l += pj;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] = fmaf(pj, Vs[j][d], acc[d]);
    }
  }

  store_lse(p, b, h, row, m, l);
  if (row < p.Nq) {
    float* o = static_cast<float*>(p.o) + b * p.sob + h * p.soh +
               row * p.son;
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < kD; ++d) o[d] = acc[d] * inv;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides in the order
// q(b, h, n), k(b, h, n), v(b, h, n), o(b, h, n). lse: a contiguous float32
// [B, H, Nq] output, or null. maps (bfloat16 only, else unread): the
// tensor-map geometry of k and v with n_keys rows, 7 values each
// (encode_map).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int B, int H,
                                   int Nq, int Nk, int kv_valid,
                                   float sm_scale, const long long* strides,
                                   const unsigned long long* maps,
                                   void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.Nq = Nq;
  p.Nk = Nk;
  p.n_keys = kv_valid < Nk ? kv_valid : Nk;
  p.scale_log2 = sm_scale * 1.4426950408889634f;
  p.sqb = strides[0]; p.sqh = strides[1]; p.sqn = strides[2];
  p.skb = strides[3]; p.skh = strides[4]; p.skn = strides[5];
  p.svb = strides[6]; p.svh = strides[7]; p.svn = strides[8];
  p.sob = strides[9]; p.soh = strides[10]; p.son = strides[11];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bf16(flash_fwd_bf16, kThreads, smem_bytes<FwdSmem>(),
                       dim3((Nq + kOwn - 1) / kOwn, H, B), p, k, v, maps, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  flash_fwd_f32<<<dim3((Nq + kBM - 1) / kBM, H, B), kBM, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the bf16 kernel's block.
extern "C" int flash_attention_fwd_smem_bytes() {
  return smem_bytes<FwdSmem>();
}
