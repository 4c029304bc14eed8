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
// The float32 kernel (flash_fwd_f32) serves the reference-precision paths
// (--mixed_precision no, the float32 goldens). Its bound at [32, 12, 1370,
// 64] is 2.75 ms of float32 FMA (67 TFLOP/s), where its first design, one
// thread a query row with every FMA waiting on a shared-memory load, ran
// at a fifth of that rate. So its products go to the tensor cores in
// float32 accuracy, as 3xTF32 mma.sync m16n8k8 (mma_tf32.cuh: 1.12 ms of
// TF32 products at 495 TFLOP/s):
//   - A block of 8 warps owns 128 query rows, 16 a warp. Each warp loads
//     its rows of Q once, scaled into log2 units, and keeps them split into
//     TF32 big and small parts in shared memory.
//   - 64-key tiles of K and V come in by cp.async into a double buffer.
//     Once a tile has landed, each thread splits the chunks it copied:
//     K into big (in place) and small parts, V into big, small and tiny
//     ones, so every value is split once a block rather than once a warp
//     (split in each warp, the conversions held the kernel at 1.1x SDPA's
//     float32 forward on an H100). Rows are padded so that the fragment
//     loads meet no bank conflict.
//   - S = Q K^T and O += P V are both 3xTF32 products, V in three parts (a
//     fourth product) so that a key of weight 1 gives its row of V
//     exactly. Each pair of k-steps is summed on the tensor cores from
//     zero, a kind of product at a time over 8 (S) or 4 (P V) accumulator
//     tiles so that no product waits on the one before it, and then added
//     in float32. The online softmax (ex2.approx, running max and sum)
//     stays in registers, and with the k order of mma_tf32.cuh the
//     scores' accumulator is P's A fragment as it stands.
//   - Keys past n_keys are zero-filled by the copies and set to -inf before
//     the row max; lse as for bf16.
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
#include "mma_tf32.cuh"
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
constexpr int kRowsF32 = 128;    // query rows per block (f32): 16 a warp
constexpr int kThreadsF32 = 256;
constexpr int kKeysF32 = 64;     // keys per streamed tile (f32)
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

// ---------------------------------------------------------------------------
// float32: mma.sync m16n8k8 on split TF32 operands (3xTF32, mma_tf32.cuh)
// ---------------------------------------------------------------------------
// the float32 kernel's shared memory. K and V tiles [key][64] land raw in a
// double buffer and are split in place into their TF32 big parts, their
// small (and V's tiny) parts beside them; rows are padded so that the
// fragment loads meet no bank conflict (K read as B [n = key][k = d] by
// 8-byte loads: a row stride of 8 mod 32 words; V as B [k = key][n = d] by
// 4-byte loads: 4 mod 16 words). Q, scaled and split, for the whole loop.
constexpr int kLdK = kD + 8;
constexpr int kLdV = kD + 4;

struct F32Smem {
  float kb[2][kKeysF32][kLdK];
  float vb[2][kKeysF32][kLdV];
  float ks[kKeysF32][kLdK];
  float vs[kKeysF32][kLdV];
  float vt[kKeysF32][kLdV];
  float qb[kRowsF32][kLdK];
  float qs[kRowsF32][kLdK];
};

// The rows of one [kKeysF32, 64] tile from device memory (rows past n_keys
// zero-filled) into the padded shared rows, 16 bytes a copy: this thread's
// chunks are rows tid / 16 + 16 i, columns 4 (tid % 16) ...
constexpr int kCopyStep = kThreadsF32 / (kD / 4);

template <int LD>
__device__ __forceinline__ void load_tile_f32(float (*dst)[LD],
                                              const float* src,
                                              long long stride, int n0,
                                              int n_keys) {
  const int r0 = threadIdx.x / (kD / 4), col = threadIdx.x % (kD / 4) * 4;
#pragma unroll
  for (int i = 0; i < kKeysF32 / kCopyStep; ++i) {
    const int r = r0 + kCopyStep * i;
    const bool ok = n0 + r < n_keys;
    cp_async16(smem_u32(&dst[r][col]),
               src + (ok ? (n0 + r) * stride + col : 0), ok);
  }
}

// ... which it splits once they have landed (no other thread's copies are
// read): K into big (in place) and small, V into big, small and tiny
__device__ __forceinline__ void split_tile_f32(F32Smem& s, int st) {
  const int r0 = threadIdx.x / (kD / 4), col = threadIdx.x % (kD / 4) * 4;
#pragma unroll
  for (int i = 0; i < kKeysF32 / kCopyStep; ++i) {
    const int r = r0 + kCopyStep * i;
    float4* kp = reinterpret_cast<float4*>(&s.kb[st][r][col]);
    float4* vp = reinterpret_cast<float4*>(&s.vb[st][r][col]);
    const float4 kx = *kp, vx = *vp;
    const float kv[4] = {kx.x, kx.y, kx.z, kx.w};
    const float vv[4] = {vx.x, vx.y, vx.z, vx.w};
    float kbig[4], ksm[4], vbig[4], vsm[4], vtn[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t bg, sm;
      split_tf32(kv[e], bg, sm);
      kbig[e] = __uint_as_float(bg);
      ksm[e] = __uint_as_float(sm);
      const uint32_t vbg = to_tf32(vv[e]);
      const float rest = vv[e] - __uint_as_float(vbg);
      const uint32_t vsg = to_tf32(rest);
      vbig[e] = __uint_as_float(vbg);
      vsm[e] = __uint_as_float(vsg);
      vtn[e] = __uint_as_float(to_tf32(rest - vsm[e]));
    }
    *kp = make_float4(kbig[0], kbig[1], kbig[2], kbig[3]);
    *reinterpret_cast<float4*>(&s.ks[r][col]) =
        make_float4(ksm[0], ksm[1], ksm[2], ksm[3]);
    *vp = make_float4(vbig[0], vbig[1], vbig[2], vbig[3]);
    *reinterpret_cast<float4*>(&s.vs[r][col]) =
        make_float4(vsm[0], vsm[1], vsm[2], vsm[3]);
    *reinterpret_cast<float4*>(&s.vt[r][col]) =
        make_float4(vtn[0], vtn[1], vtn[2], vtn[3]);
  }
}

__global__ void __launch_bounds__(kThreadsF32, 1)
flash_fwd_f32(const Params p) {
  F32Smem& s = smem_1024<F32Smem>();
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* k = static_cast<const float*>(p.k) + b * p.skb + h * p.skh;
  const float* v = static_cast<const float*>(p.v) + b * p.svb + h * p.svh;
  const int n_tiles = (p.n_keys + kKeysF32 - 1) / kKeysF32;
  load_tile_f32(s.kb[0], k, p.skn, 0, p.n_keys);
  load_tile_f32(s.vb[0], v, p.svn, 0, p.n_keys);
  cp_async_commit();

  // the warp's 16 query rows (this thread's r0 and r1 = r0 + 8), scaled
  // into log2 units and split once into shared memory, where the warp
  // reads them as the A fragments of the 8 k-steps over the head dim
  // (rows past Nq read 0)
  const int w0 = warp * 16, r0 = blockIdx.x * kRowsF32 + w0 + g, r1 = r0 + 8;
  {
    const float* q = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
    const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int c = kk * 8 + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = hh ? r1 : r0;
        const float2 x = r < p.Nq
            ? *reinterpret_cast<const float2*>(q + r * p.sqn + c) : zero;
        uint32_t big[2], small[2];
        split_tf32(x.x * p.scale_log2, big[0], small[0]);
        split_tf32(x.y * p.scale_log2, big[1], small[1]);
        *reinterpret_cast<uint2*>(&s.qb[w0 + g + 8 * hh][c]) =
            make_uint2(big[0], big[1]);
        *reinterpret_cast<uint2*>(&s.qs[w0 + g + 8 * hh][c]) =
            make_uint2(small[0], small[1]);
      }
    }
    __syncwarp();
  }
  float o[8][4];
  zero_acc(o);
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, n0 = it * kKeysF32;
    if (it + 1 < n_tiles) {  // the next tile streams in under this one
      load_tile_f32(s.kb[st ^ 1], k, p.skn, n0 + kKeysF32, p.n_keys);
      load_tile_f32(s.vb[st ^ 1], v, p.svn, n0 + kKeysF32, p.n_keys);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    split_tile_f32(s, st);
    __syncthreads();  // the tile is split and in place

    // S = (Q scale_log2) K^T: 8 key columns of 8, the head dim in 4 pairs
    // of k-steps, each pair's products summed on the tensor cores and then
    // added to S in float32
    float sc[8][4];
#pragma unroll
    for (int kp = 0; kp < 4; ++kp) {
      float d[8][4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int k0 = (2 * kp + h2) * 8;
        uint32_t ab[4], as[4], bb[8][2], bs[8][2];
        load_a_frag(ab, &s.qb[w0][0], kLdK, g, k0, t);
        load_a_frag(as, &s.qs[w0][0], kLdK, g, k0, t);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          load_b_nk(bb[j], &s.kb[st][0][0], kLdK, j * 8 + g, k0, t);
          load_b_nk(bs[j], &s.ks[0][0], kLdK, j * 8 + g, k0, t);
        }
        if (h2 == 0)
          mma_3xtf32_sweep_d<true>(d, ab, as, bb, bs);
        else
          mma_3xtf32_sweep_d<false>(d, ab, as, bb, bs);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = kp ? sc[j][e] + d[j][e] : d[j][e];
    }

    // online softmax of rows r0 and r1: keys past n_keys (only the last
    // tile has any) -inf before the row max; every tile holds a key below
    // n_keys, so the maxima are finite
    const bool ragged = n0 + kKeysF32 > p.n_keys;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (ragged && n0 + j * 8 + 2 * t + (e & 1) >= p.n_keys)
          sc[j][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(mrow[r], quad_max(mx[r]));
      alpha[r] = exp2_fast(mrow[r] - mn);
      mrow[r] = mn;
      lrow[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = exp2_fast(sc[j][e] - mrow[e >> 1]);
        lrow[e >> 1] += sc[j][e];
        o[j][e] *= alpha[e >> 1];  // O's column tile j (of the head dim)
      }
    }

    // O += P V: P's 8-key column tile j is the A fragment of k-step j;
    // pairs of k-steps summed on the tensor cores, 4 columns of 8 of the
    // head dim at a time, then added to O
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t pb[2][4], ps[2][4];
      acc_to_a_tf32(pb[0], ps[0], sc[2 * jp]);
      acc_to_a_tf32(pb[1], ps[1], sc[2 * jp + 1]);
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        float d[4][4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int k0 = (2 * jp + h2) * 8;
          uint32_t bb[4][2], bs[4][2], bt[4][2];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int n = (nh * 4 + q) * 8 + g;
            load_b_kn(bb[q], &s.vb[st][0][0], kLdV, n, k0, t);
            load_b_kn(bs[q], &s.vs[0][0], kLdV, n, k0, t);
            load_b_kn(bt[q], &s.vt[0][0], kLdV, n, k0, t);
          }
          if (h2 == 0)
            mma_3xtf32_exact_b_sweep_d<true>(d, pb[0], ps[0], bb, bs, bt);
          else
            mma_3xtf32_exact_b_sweep_d<false>(d, pb[1], ps[1], bb, bs, bt);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nh * 4 + q][e] += d[q][e];
      }
    }
    __syncthreads();  // every warp is done with the tile: the next one
                      // is split into ks, vs, vt and its stage refilled
  }

  const float l0 = quad_sum(lrow[0]), l1 = quad_sum(lrow[1]);
  if (t == 0) {
    store_lse(p, b, h, r0, mrow[0], l0);
    store_lse(p, b, h, r1, mrow[1], l1);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  float* out = static_cast<float*>(p.o) + b * p.sob + h * p.soh;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < p.Nq)
      *reinterpret_cast<float2*>(out + r0 * p.son + c) =
          make_float2(o[j][0] * inv0, o[j][1] * inv0);
    if (r1 < p.Nq)
      *reinterpret_cast<float2*>(out + r1 * p.son + c) =
          make_float2(o[j][2] * inv1, o[j][3] * inv1);
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
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<F32Smem>());
  if (err != cudaSuccess) return (int)err;
  flash_fwd_f32<<<dim3((Nq + kRowsF32 - 1) / kRowsF32, H, B), kThreadsF32,
                  smem_bytes<F32Smem>(), s>>>(p);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a block of the kernel of `dtype` (0 = float32,
// 1 = bfloat16).
extern "C" int flash_attention_fwd_smem_bytes(int dtype) {
  return dtype == 1 ? smem_bytes<FwdSmem>() : smem_bytes<F32Smem>();
}
