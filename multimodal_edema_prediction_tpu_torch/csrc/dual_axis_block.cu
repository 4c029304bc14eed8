// K3: one DuETT dual-axis encoder block, fused, for Hopper (sm_90a).
//
// Replaces multimodal_edema_prediction_tpu/ops/pallas_dual_axis.py
// (`_block_kernel` :78, `_fused_forward` :136, pallas_call :171,
// `fused_encoder_block` :192). Per batch element b:
//
//   z = x + Wo·MHA(SN1(x)) + bo
//   y = SNf(z + W2·gelu_tanh(W1·SN2(z) + b1) + b2)
//
// ScaleNorm SN(t) = t / max(||t|| · D^-1/2, 1e-5) · g over the true D; no
// q/k/v bias; softmax in float32; GELU in its tanh form (jax.nn.gelu's
// default, which the TPU kernel calls). x and every weight arrive in x's
// dtype (float32 or bfloat16; the wrapper casts the weights, as the TPU
// wrapper does at :151-163) and are upcast to float32; every product and
// sum is a float32 FMA, as the TPU kernel's float32 dot_generals; the output
// is cast to x's dtype. The three gains g arrive as float32.
//
// Bound on an H100: at DuETT's shapes ([32, 35, 600] event axis, [32, 25,
// 840] time axis; 2 heads x 12, F 512) a block is ~1 GFLOP and moves ~5 MB
// (the float32 weights dominate), so the least time is the bytes over HBM.
// Design: L <= ~35 tokens, so one thread block owns one batch element and
// keeps its tokens in shared memory for the whole encoder block: the
// residual z and the normalised activations h in float32 (2 x 84 KB at
// both axes), q/k/v, the attention output and the scores (~10 KB). The FF
// hidden [L, F] is never held whole: it is walked in chunks of 128 hidden
// units, each chunk's W2 product added into z (the chunk reuses the
// attention buffers). Weights stream from L2, which every block shares;
// each small GEMM gives a thread one output column and 8 rows strided
// over the tokens, so a weight element is read once per 8 rows and the
// activations are warp-wide broadcasts from shared memory. No atomics:
// reruns are bit-equal. Known limit: a block per batch element is 32
// blocks on 132 SMs at batch 32; splitting the block over a cluster is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 8;        // rows per thread in the small GEMMs
constexpr int kFFChunk = 128;   // FF hidden units held at a time

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float gelu_tanh(float v) {
  const float c = 0.7978845608028654f;   // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
}

// out[r][n] = sum_k A[r][k] * W[k][n] for r < L, n < N, handed to
// epi(r, n, sum). A: float32 rows in shared memory (lda, k multiples of 4,
// so rows read as float4); W: [K][ldw] in device memory. A thread owns one
// column n and the rows rg, rg + G, ... (G = ceil(L / kRows)); a warp's 32
// consecutive columns read W coalesced and A as a broadcast.
template <typename TW, typename Epi>
__device__ __forceinline__ void gemm_rows(const float* A, int lda, int K,
                                          int L, const TW* __restrict__ W,
                                          int ldw, int N, Epi epi) {
  const int G = (L + kRows - 1) / kRows;
  for (int item = threadIdx.x; item < N * G; item += blockDim.x) {
    const int n = item % N, rg = item / N;
    float acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = 0.f;
    const TW* wp = W + n;
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      const float w0 = to_f(wp[(size_t)(k + 0) * ldw]);
      const float w1 = to_f(wp[(size_t)(k + 1) * ldw]);
      const float w2 = to_f(wp[(size_t)(k + 2) * ldw]);
      const float w3 = to_f(wp[(size_t)(k + 3) * ldw]);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = rg + j * G;
        if (r < L) {
          const float4 a = *reinterpret_cast<const float4*>(A + r * lda + k);
          acc[j] = fmaf(a.x, w0, acc[j]);
          acc[j] = fmaf(a.y, w1, acc[j]);
          acc[j] = fmaf(a.z, w2, acc[j]);
          acc[j] = fmaf(a.w, w3, acc[j]);
        }
      }
    }
    for (; k < K; ++k) {
      const float w = to_f(wp[(size_t)k * ldw]);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = rg + j * G;
        if (r < L) acc[j] = fmaf(A[r * lda + k], w, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = rg + j * G;
      if (r < L) epi(r, n, acc[j]);
    }
  }
}

// dst[r] = src[r] / max(||src[r]|| * inv_sqrt_d, 1e-5) * g, one warp a row.
template <typename TO>
__device__ __forceinline__ void scalenorm_rows(const float* src, int lds,
                                               int L, int D, float inv_sqrt_d,
                                               float g, TO* dst, int ldd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < L; r += n_warps) {
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = src[r * lds + d];
      ss = fmaf(v, v, ss);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float nrm = fmaxf(sqrtf(ss) * inv_sqrt_d, 1e-5f);
    for (int d = lane; d < D; d += 32)
      dst[r * ldd + d] = from_f<TO>(src[r * lds + d] / nrm * g);
  }
}

// Shared-memory floats of one block: z and h [L][round4(D)], then a work
// area that holds q|k|v [L][round4(3I)], the attention output
// [L][round4(I)] and the scores [H][L][L], or later one FF chunk
// [L][kFFChunk].
__host__ __device__ __forceinline__ size_t smem_floats(int L, int D, int H,
                                                       int dh) {
  const int inner = H * dh;
  const size_t attn = (size_t)L * round4(3 * inner) +
                      (size_t)L * round4(inner) + (size_t)H * L * L;
  const size_t ff = (size_t)L * kFFChunk;
  return 2 * (size_t)L * round4(D) + (attn > ff ? attn : ff);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dual_axis_block_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                           const T* __restrict__ wo, const T* __restrict__ bo,
                           const T* __restrict__ w1, const T* __restrict__ b1,
                           const T* __restrict__ w2, const T* __restrict__ b2,
                           const float* __restrict__ g, T* __restrict__ out,
                           int L, int D, int H, int dh, int F,
                           float inv_sqrt_d, float attn_scale) {
  extern __shared__ __align__(16) float smem[];
  const int inner = H * dh;
  const int ldD = round4(D), ldQ = round4(3 * inner), ldO = round4(inner);
  float* zs = smem;                     // residual, float32
  float* hs = zs + (size_t)L * ldD;     // normalised activations
  float* work = hs + (size_t)L * ldD;
  float* qkv = work;                    // [L][ldQ]: q | k | v
  float* os = qkv + (size_t)L * ldQ;    // [L][ldO]: attention output
  float* ps = os + (size_t)L * ldO;     // [H][L][L]: scores, then P
  float* fs = work;                     // [L][kFFChunk], after attention
  const T* xb = x + (size_t)blockIdx.x * L * D;
  T* ob = out + (size_t)blockIdx.x * L * D;
  const float g1 = g[0], g2 = g[1], gf = g[2];

  for (int i = threadIdx.x; i < L * D; i += blockDim.x)
    zs[(i / D) * ldD + i % D] = to_f(xb[i]);
  __syncthreads();
  scalenorm_rows(zs, ldD, L, D, inv_sqrt_d, g1, hs, ldD);
  __syncthreads();
  gemm_rows(hs, ldD, D, L, wqkv, 3 * inner, 3 * inner,
            [&](int r, int n, float acc) { qkv[r * ldQ + n] = acc; });
  __syncthreads();

  // scores S[h][i][j] = (q_i . k_j) * d_head^-1/2 over each head's columns
  for (int i = threadIdx.x; i < H * L * L; i += blockDim.x) {
    const int hh = i / (L * L), qi = (i / L) % L, kj = i % L;
    const float* qp = qkv + qi * ldQ + hh * dh;
    const float* kp = qkv + kj * ldQ + inner + hh * dh;
    float s = 0.f;
    for (int d = 0; d < dh; ++d) s = fmaf(qp[d], kp[d], s);
    ps[i] = s * attn_scale;
  }
  __syncthreads();
  {  // softmax of each (head, query) row, one warp a row
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int row = warp; row < H * L; row += blockDim.x >> 5) {
      float* p = ps + (size_t)row * L;
      float m = __int_as_float(0xff800000);   // -inf
      for (int j = lane; j < L; j += 32) m = fmaxf(m, p[j]);
#pragma unroll
      for (int o = 16; o; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float e = expf(p[j] - m);
        p[j] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      for (int j = lane; j < L; j += 32) p[j] = p[j] / sum;
    }
  }
  __syncthreads();
  // o[i][h*dh + d] = sum_j P[h][i][j] v[j][h*dh + d]
  for (int i = threadIdx.x; i < L * inner; i += blockDim.x) {
    const int qi = i / inner, c = i % inner, hh = c / dh;
    const float* pp = ps + ((size_t)hh * L + qi) * L;
    float s = 0.f;
    for (int kj = 0; kj < L; ++kj)
      s = fmaf(pp[kj], qkv[kj * ldQ + 2 * inner + c], s);
    os[qi * ldO + c] = s;
  }
  __syncthreads();
  gemm_rows(os, ldO, inner, L, wo, D, D, [&](int r, int n, float acc) {
    zs[r * ldD + n] = (zs[r * ldD + n] + acc) + to_f(bo[n]);
  });
  __syncthreads();
  scalenorm_rows(zs, ldD, L, D, inv_sqrt_d, g2, hs, ldD);
  __syncthreads();

  for (int c0 = 0; c0 < F; c0 += kFFChunk) {
    const int nc = min(kFFChunk, F - c0);
    gemm_rows(hs, ldD, D, L, w1 + c0, F, nc, [&](int r, int n, float acc) {
      fs[r * kFFChunk + n] = gelu_tanh(acc + to_f(b1[c0 + n]));
    });
    __syncthreads();
    gemm_rows(fs, kFFChunk, nc, L, w2 + (size_t)c0 * D, D, D,
              [&](int r, int n, float acc) { zs[r * ldD + n] += acc; });
    __syncthreads();
  }
  for (int i = threadIdx.x; i < L * D; i += blockDim.x)
    zs[(i / D) * ldD + i % D] += to_f(b2[i % D]);
  __syncthreads();
  scalenorm_rows(zs, ldD, L, D, inv_sqrt_d, gf, ob, D);
}

template <typename T>
int launch(const void* x, const void* wqkv, const void* wo, const void* bo,
           const void* w1, const void* b1, const void* w2, const void* b2,
           const float* g, void* out, int B, int L, int D, int H, int dh,
           int F, float inv_sqrt_d, float attn_scale, cudaStream_t stream) {
  const size_t smem = smem_floats(L, D, H, dh) * sizeof(float);
  auto kernel = dual_axis_block_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv),
      static_cast<const T*>(wo), static_cast<const T*>(bo),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), g,
      static_cast<T*>(out), L, D, H, dh, F, inv_sqrt_d, attn_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0: float32, 1: bfloat16. x, out [B, L, D]; wqkv [D, 3·H·dh] (wq |
// wk | wv); wo [H·dh, D]; bo, b2 [D]; w1 [D, F]; b1 [F]; w2 [F, D], all
// contiguous in x's dtype; g [3] float32 (g1, g2, gf). Returns the CUDA
// error of the launch (0 on success).
extern "C" int dual_axis_block(int dtype, const void* x, const void* wqkv,
                               const void* wo, const void* bo, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               const void* g, void* out, int B, int L, int D,
                               int H, int dh, int F, float inv_sqrt_d,
                               float attn_scale, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto gp = static_cast<const float*>(g);
  if (dtype == 0)
    return launch<float>(x, wqkv, wo, bo, w1, b1, w2, b2, gp, out, B, L, D, H,
                         dh, F, inv_sqrt_d, attn_scale, s);
  return launch<__nv_bfloat16>(x, wqkv, wo, bo, w1, b1, w2, b2, gp, out, B, L,
                               D, H, dh, F, inv_sqrt_d, attn_scale, s);
}
