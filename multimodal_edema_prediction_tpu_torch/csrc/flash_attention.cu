// Flash-attention forward for Hopper (sm_90a): non-causal
// softmax(Q K^T * sm_scale) V per (batch, head), head dim 64.
//
// Replaces the TPU kernel behind multimodal_edema_prediction_tpu/ops/
// attention.py::flash_mha, which calls JAX's Pallas TPU flash-attention
// kernel (jax/experimental/pallas/ops/tpu/flash_attention.py: flash_attention,
// forward pallas_call). Keys at or past `kv_valid` get probability 0, as the
// segment ids do there; query rows past the true length are computed like any
// other row and sliced off by the caller.
//
// Bound on an H100 SXM: at the ViT shape (B x 12 heads x 1370 tokens x 64) the
// work is 4*B*H*N^2*D operations against 989 TFLOP/s bf16 (about 47 us at
// B = 8), while the bytes (q, k, v read once, o written once: 8*B*H*N*D) take
// about 20 us at 3.35 TB/s. So it is bound by operations: the bf16 kernel keeps
// the N x N scores out of device memory (online softmax over 64-key tiles held
// in registers, f32 running max, sum and accumulator) and runs both products
// on the tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate).
// One block of 4 warps owns 64 query rows of one (b, h); each warp owns 16
// rows. K and V tiles stream through two shared-memory stages with cp.async,
// the next tile landing while this one is used, and the mma fragments of K and
// of V (transposed) are read with ldmatrix. No wgmma, TMA or warp
// specialisation yet: those are later work.
//
// The float32 kernel is a plain SIMT loop (one thread per query row, f32 FMA,
// no TF32) for the reference-precision paths (checks against float32 goldens).
//
// Layout: every tensor is [B, H, N, 64] with arbitrary batch/head/token strides
// (in elements) and a contiguous head dim, so q/k/v can be strided views of a
// [B, N, H*64] projection and o can be written as [B, N, H, 64].
//
// For training, the kernel also writes each query row's log-sum-exp of the
// scaled scores, lse = m + log(l) (float32 [B, H, Nq]), which the backward
// kernels (flash_attention_bwd.cu) use to recompute P without a second
// softmax pass; JAX's kernel saves l and m separately under save_residuals
// (flash_attention.py:246-251), the same information in two arrays. A null
// lse pointer skips the write (serving, the frozen ViT).
//
// Entry point: flash_attention_fwd(...) launches on the given stream, allocates
// nothing and returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBM = 64;       // query rows per block
constexpr int kBN = 64;       // keys per tile (bf16 kernel)
constexpr int kRow = kD + 8;  // padded shared-memory row (bf16 elements):
                              // 144 B rows make the fragment loads
                              // bank-conflict free
constexpr int kBNf = 32;      // keys per tile (f32 kernel)
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

// lse = m + log(l) in natural units, from the running max m (log2 units of
// the scaled scores) and sum l of exp2(s - m)
__device__ __forceinline__ void store_lse(const Params& p, int b, int h,
                                          int row, float m, float l) {
  if (p.lse != nullptr && row < p.Nq)
    p.lse[(static_cast<long long>(b) * gridDim.y + h) * p.Nq + row] =
        (m + log2f(l)) * kLn2;
}

__global__ void __launch_bounds__(128)
flash_fwd_bf16(const Params p) {
  // two stages: the next K/V tile streams in (cp.async) while this one is
  // used
  __shared__ __align__(128) __nv_bfloat16 Ks[2][kBN][kRow];
  __shared__ __align__(128) __nv_bfloat16 Vs[2][kBN][kRow];

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) +
                           b * p.sqb + h * p.sqh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) +
                           b * p.skb + h * p.skh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) +
                           b * p.svb + h * p.svh;
  const int r0 = blockIdx.x * kBM + warp * 16 + g;  // this thread's rows
  const int r1 = r0 + 8;

  // Q as A fragments, 4 k-steps of 16 over the head dim; rows past Nq read 0
  uint32_t qf[4][4];
  load_a_rows(qf, q, p.sqn, r0, p.Nq, t);

  float acc[8][4];
  zero_acc(acc);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // stage a 64 x 64 K and V tile: 512 16-byte chunks each, 4 per thread;
  // rows past n_keys are zero-filled so that masked keys stay finite
  auto load_tile = [&](int stage, int n0) {
    for (int c = threadIdx.x; c < kBN * kD / 8; c += blockDim.x) {
      const int r = c >> 3, col = (c & 7) * 8;
      const bool ok = n0 + r < p.n_keys;
      const long long row = ok ? n0 + r : 0;
      cp_async16(smem_u32(&Ks[stage][r][col]), k + row * p.skn + col, ok);
      cp_async16(smem_u32(&Vs[stage][r][col]), v + row * p.svn + col, ok);
    }
  };
  const int n_tiles = (p.n_keys + kBN - 1) / kBN;
  load_tile(0, 0);
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, n0 = it * kBN;
    if (it + 1 < n_tiles) {
      load_tile(st ^ 1, n0 + kBN);  // stage st^1 was released below
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[8][4];
    zero_acc(s);
    mma_abt<kRow>(s, qf, Ks[st], lane);

    // scale into log2 units, mask keys past n_keys, row max over the tile
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = key < p.n_keys ? s[j][e] * p.scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // the 4 threads of a quad hold the same two rows
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every processed tile holds key n0 < n_keys, so the maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = exp2f(s[j][0] - m0);
      s[j][1] = exp2f(s[j][1] - m0);
      s[j][2] = exp2f(s[j][2] - m1);
      s[j][3] = exp2f(s[j][3] - m1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }

    // O += P V: the S accumulator layout is the A fragment layout of P;
    // V (keys x head dim) is read transposed
    mma_cm<kRow>(acc, s, Vs[st], lane);
    __syncthreads();  // stage st is free for the load two tiles ahead
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (t == 0) {
    store_lse(p, b, h, r0, m0, l0);
    store_lse(p, b, h, r1, m1, l1);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.sob +
                     h * p.soh;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < p.Nq)
      *reinterpret_cast<uint32_t*>(o + r0 * p.son + c) =
          pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    if (r1 < p.Nq)
      *reinterpret_cast<uint32_t*>(o + r1 * p.son + c) =
          pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
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
// [B, H, Nq] output, or null.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int B, int H,
                                   int Nq, int Nk, int kv_valid,
                                   float sm_scale, const long long* strides,
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
  const dim3 grid((Nq + kBM - 1) / kBM, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    flash_fwd_bf16<<<grid, 128, 0, s>>>(p);
  else if (dtype == 0)
    flash_fwd_f32<<<grid, kBM, 0, s>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
