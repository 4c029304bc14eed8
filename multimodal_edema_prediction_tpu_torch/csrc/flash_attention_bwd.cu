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
//
// Inputs: q, k, v and dO as [B, H, N, 64] with arbitrary batch/head/token
// strides and a contiguous head dim (the forward's views); the forward's
// lse = m + log(l) and D = rowsum(dO * O) (computed outside, as JAX computes
// di at flash_attention.py:273-275), both float32 [B, H, Nq] contiguous.
// Per tile both kernels recompute S = Q K^T * scale and P = exp(S - lse)
// from them, then dP = dO V^T and dS = P * (dP - D):
//   dkv: one block owns 64 keys and streams the query tiles;
//        dV += P^T dO, dK += dS^T Q * scale;
//   dq:  one block owns 64 queries and streams the key tiles;
//        dQ += dS K * scale.
// Keys at or past kv_valid get P = 0, so their dK and dV are exactly 0;
// ragged tiles are zero-filled on load and never written past N. Outputs are
// written through their own strides ([B, N, H, 64] storage from the wrapper).
//
// Bound on an H100 SXM: dkv does 4 products of 2*N^2*D per (b, h)
// (8*B*H*N^2*D operations), dq 3 (6*B*H*N^2*D); the pair's algorithmic least
// is 5 (10*B*H*N^2*D: dq shares S and dP with dkv in a fused kernel). At
// [32, 12, 1370, 64] that is 0.373 / 0.280 / 0.466 ms at 989 TFLOP/s bf16,
// while the bytes (q, k, v, dO read, two gradients written, ~0.1 GB) take
// ~0.04 ms: bound by operations. The bf16 kernels therefore keep every
// N x N tile in registers and run all products on the tensor cores through
// mma.sync m16n8k16 (bf16 in, f32 accumulate): one block of 4 warps, 16 rows
// per warp, the block's own 64 rows held as A fragments for the whole loop,
// the streamed 64-row tiles double-buffered in shared memory with cp.async
// and read with ldmatrix (.trans where the tile is the right-hand side
// k-major). P and dS are rounded to bf16 before their products, as FA2 does;
// row statistics (lse, D) stay in f32. In the dkv kernel the warp computes
// S^T = K Q^T rather than S, so that P^T and dS^T come out of the
// accumulator already in the A-fragment layout of dV += P^T dO and
// dK += dS^T Q. No wgmma, TMA or warp specialisation yet: later work.
//
// The float32 kernels are plain SIMT loops (one thread per owned row, f32
// FMA, no TF32) for the reference-precision checks.
//
// Entry points: flash_attention_bwd_dkv(...) and flash_attention_bwd_dq(...)
// launch on the given stream, allocate nothing and return cudaGetLastError()
// as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kD = 64;         // head dim
constexpr int kBM = 64;        // owned rows per block (keys: dkv, queries: dq)
constexpr int kBN = 64;        // streamed rows per tile (bf16 kernels)
constexpr int kRow = kD + 8;   // padded bf16 shared-memory row (144 B rows:
                               // conflict-free fragment loads)
constexpr int kBNf = 16;       // streamed rows per tile (f32 kernels)
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

// Stage a 64 x 64 bf16 tile of rows [n0, n0 + 64) of x (rows at or past
// n_valid zero-filled): 512 16-byte chunks, 4 per thread.
__device__ __forceinline__ void stage_tile(__nv_bfloat16 (*dst)[kRow],
                                           const __nv_bfloat16* x,
                                           long long stride, int n0,
                                           int n_valid) {
  for (int c = threadIdx.x; c < kBN * kD / 8; c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8;
    const bool ok = n0 + r < n_valid;
    const long long row = ok ? n0 + r : 0;
    cp_async16(smem_u32(&dst[r][col]), x + row * stride + col, ok);
  }
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

__global__ void __launch_bounds__(128)
flash_bwd_dkv_bf16(const Params p) {
  // two stages of the streamed query tile: Q, dO and the rows' lse (in log2
  // units) and D
  __shared__ __align__(128) __nv_bfloat16 Qs[2][kBN][kRow];
  __shared__ __align__(128) __nv_bfloat16 Os[2][kBN][kRow];
  __shared__ float Ls[2][kBN];
  __shared__ float Ds[2][kBN];

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* q = at<__nv_bfloat16>(p.q, b, h, p.sqb, p.sqh);
  const __nv_bfloat16* k = at<__nv_bfloat16>(p.k, b, h, p.skb, p.skh);
  const __nv_bfloat16* v = at<__nv_bfloat16>(p.v, b, h, p.svb, p.svh);
  const __nv_bfloat16* dout = at<__nv_bfloat16>(p.dout, b, h, p.sob, p.soh);
  const long long bh = static_cast<long long>(b) * p.H + h;
  const float* lse = p.lse + bh * p.Nq;
  const float* delta = p.delta + bh * p.Nq;
  const int c0 = blockIdx.x * kBM + warp * 16 + g;  // this thread's keys
  const int c1 = c0 + 8;

  // the warp's 16 keys of K and V as A fragments; keys past n_keys read 0
  uint32_t kf[4][4], vf[4][4];
  load_a_rows(kf, k, p.skn, c0, p.n_keys, t);
  load_a_rows(vf, v, p.svn, c0, p.n_keys, t);

  float dk[8][4], dv[8][4];
  zero_acc(dk);
  zero_acc(dv);

  auto load_tile = [&](int stage, int m0) {
    stage_tile(Qs[stage], q, p.sqn, m0, p.Nq);
    stage_tile(Os[stage], dout, p.son, m0, p.Nq);
    if (threadIdx.x < kBN) {
      const int r = m0 + threadIdx.x;
      Ls[stage][threadIdx.x] = r < p.Nq ? lse[r] * kLog2e : 0.f;
      Ds[stage][threadIdx.x] = r < p.Nq ? delta[r] : 0.f;
    }
  };
  const int n_tiles = (p.Nq + kBN - 1) / kBN;
  load_tile(0, 0);
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, m0 = it * kBN;
    if (it + 1 < n_tiles) {
      load_tile(st ^ 1, m0 + kBN);  // stage st^1 was released below
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T = K Q^T: this warp's 16 keys x 64 queries
    float s[8][4];
    zero_acc(s);
    mma_abt<kRow>(s, kf, Qs[st], lane);
    // P^T = exp(S^T * scale - lse); keys past n_keys and queries past Nq
    // get 0
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t + (e & 1);
        const int key = e < 2 ? c0 : c1;
        s[j][e] = (m0 + qi < p.Nq && key < p.n_keys)
                      ? exp2f(s[j][e] * p.scale_log2 - Ls[st][qi])
                      : 0.f;
      }
    }
    // dV += P^T dO
    mma_cm<kRow>(dv, s, Os[st], lane);
    // dP^T = V dO^T, then dS^T = P^T * (dP^T - D)
    float ds[8][4];
    zero_acc(ds);
    mma_abt<kRow>(ds, vf, Os[st], lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = s[j][e] * (ds[j][e] - Ds[st][j * 8 + 2 * t + (e & 1)]);
    }
    // dK += dS^T Q
    mma_cm<kRow>(dk, ds, Qs[st], lane);
    __syncthreads();  // stage st is free for the load two tiles ahead
  }

  store_rows(at_out<__nv_bfloat16>(p.dk, b, h, p.sdkb, p.sdkh), p.sdkn, dk,
             p.scale, c0, p.Nk, t);
  store_rows(at_out<__nv_bfloat16>(p.dv, b, h, p.sdvb, p.sdvh), p.sdvn, dv,
             1.f, c0, p.Nk, t);
}

__global__ void __launch_bounds__(128)
flash_bwd_dq_bf16(const Params p) {
  // two stages of the streamed K and V tiles
  __shared__ __align__(128) __nv_bfloat16 Ks[2][kBN][kRow];
  __shared__ __align__(128) __nv_bfloat16 Vs[2][kBN][kRow];

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* q = at<__nv_bfloat16>(p.q, b, h, p.sqb, p.sqh);
  const __nv_bfloat16* k = at<__nv_bfloat16>(p.k, b, h, p.skb, p.skh);
  const __nv_bfloat16* v = at<__nv_bfloat16>(p.v, b, h, p.svb, p.svh);
  const __nv_bfloat16* dout = at<__nv_bfloat16>(p.dout, b, h, p.sob, p.soh);
  const long long bh = static_cast<long long>(b) * p.H + h;
  const int r0 = blockIdx.x * kBM + warp * 16 + g;  // this thread's rows
  const int r1 = r0 + 8;

  // the warp's 16 rows of Q and dO as A fragments; rows past Nq read 0
  uint32_t qf[4][4], of[4][4];
  load_a_rows(qf, q, p.sqn, r0, p.Nq, t);
  load_a_rows(of, dout, p.son, r0, p.Nq, t);
  // the rows' lse (log2 units) and D; rows past Nq: P = 1 against Q = 0,
  // dO = 0, so dS = 0 and nothing is written
  const float L0 = r0 < p.Nq ? p.lse[bh * p.Nq + r0] * kLog2e : 0.f;
  const float L1 = r1 < p.Nq ? p.lse[bh * p.Nq + r1] * kLog2e : 0.f;
  const float D0 = r0 < p.Nq ? p.delta[bh * p.Nq + r0] : 0.f;
  const float D1 = r1 < p.Nq ? p.delta[bh * p.Nq + r1] : 0.f;

  float dq[8][4];
  zero_acc(dq);

  auto load_tile = [&](int stage, int n0) {
    stage_tile(Ks[stage], k, p.skn, n0, p.n_keys);
    stage_tile(Vs[stage], v, p.svn, n0, p.n_keys);
  };
  const int n_tiles = (p.n_keys + kBN - 1) / kBN;
  load_tile(0, 0);
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, n0 = it * kBN;
    if (it + 1 < n_tiles) {
      load_tile(st ^ 1, n0 + kBN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T and P = exp(S * scale - lse), keys past n_keys 0
    float s[8][4];
    zero_acc(s);
    mma_abt<kRow>(s, qf, Ks[st], lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = key < p.n_keys
                      ? exp2f(s[j][e] * p.scale_log2 - (e < 2 ? L0 : L1))
                      : 0.f;
      }
    }
    // dP = dO V^T, then dS = P * (dP - D)
    float ds[8][4];
    zero_acc(ds);
    mma_abt<kRow>(ds, of, Vs[st], lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = s[j][e] * (ds[j][e] - (e < 2 ? D0 : D1));
    }
    // dQ += dS K
    mma_cm<kRow>(dq, ds, Ks[st], lane);
    __syncthreads();
  }

  store_rows(at_out<__nv_bfloat16>(p.dq, b, h, p.sdqb, p.sdqh), p.sdqn, dq,
             p.scale, r0, p.Nq, t);
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

// dtype: 0 = float32, 1 = bfloat16. strides: 18 element strides in the order
// q, k, v, dout, dk, dv, each (b, h, n). lse, delta: contiguous float32
// [B, H, Nq].
extern "C" int flash_attention_bwd_dkv(int dtype, const void* q,
                                       const void* k, const void* v,
                                       const void* dout, const float* lse,
                                       const float* delta, void* dk, void* dv,
                                       int B, int H, int Nq, int Nk,
                                       int kv_valid, float sm_scale,
                                       const long long* strides,
                                       void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, H, Nq, Nk, kv_valid,
                         sm_scale, strides);
  p.dk = dk;
  p.dv = dv;
  p.sdkb = strides[12]; p.sdkh = strides[13]; p.sdkn = strides[14];
  p.sdvb = strides[15]; p.sdvh = strides[16]; p.sdvn = strides[17];
  const dim3 grid((Nk + kBM - 1) / kBM, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    flash_bwd_dkv_bf16<<<grid, 128, 0, s>>>(p);
  else if (dtype == 0)
    flash_bwd_dkv_f32<<<grid, kBM, 0, s>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// strides: 15 element strides in the order q, k, v, dout, dq, each (b, h, n).
extern "C" int flash_attention_bwd_dq(int dtype, const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dq, int B, int H, int Nq, int Nk,
                                      int kv_valid, float sm_scale,
                                      const long long* strides,
                                      void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, H, Nq, Nk, kv_valid,
                         sm_scale, strides);
  p.dq = dq;
  p.sdqb = strides[12]; p.sdqh = strides[13]; p.sdqn = strides[14];
  const dim3 grid((Nq + kBM - 1) / kBM, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    flash_bwd_dq_bf16<<<grid, 128, 0, s>>>(p);
  else if (dtype == 0)
    flash_bwd_dq_f32<<<grid, kBM, 0, s>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
