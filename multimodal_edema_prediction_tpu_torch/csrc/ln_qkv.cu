// K4: LayerNorm -> Q, K, V projections, fused, for Hopper (sm_90a).
//
// Replaces multimodal_edema_prediction_tpu/ops/pallas_ln_qkv.py (`_kernel`
// :58, `_forward` :82, pallas_call :108, `fused_ln_qkv` :126):
//
//   h = LN(x) * scale + bias      statistics in float32 (biased variance,
//                                 eps), h rounded to x's dtype
//   q, k, v = h W{q,k,v} + b      x's dtype operands, float32 accumulation,
//                                 bias added in float32, rounded to x's dtype
//
// each written straight into [B, H, N, 64] (head-major, K1's input layout).
// The LN rows, weights and biases arrive in x's dtype (the wrapper casts
// them, as the TPU wrapper does at :92-98).
//
// Bound on an H100 at the ViT's [32, 1536, 768] bf16 with 12 x 64 heads:
// 2·B·N·768·2304 = 174 GFLOP against ~0.31 GB moved, so the tensor cores
// bound it (0.176 ms at 989 TFLOP/s). Design: a block owns a tile of 64
// tokens (bf16) or 32 (float32). Its LayerNorm prologue reads x once and
// keeps h in shared memory (64 x 768 bf16 = 97 KB with row padding); the
// block then walks the 3·H·64 output columns in 64-wide tiles, each over
// the depth in 32-deep W tiles that cp.async double-buffers through shared
// memory. bf16: 4 warps, each 16 rows x 64 columns of mma.sync m16n8k16
// (bf16 in, float32 accumulate; ldmatrix fragments, the helpers of
// mma_bf16.cuh); 2 blocks fit an SM. float32: SIMT FMA, a thread 8 rows of
// one column. A 64-wide column tile is one head of one projection, so the
// epilogue writes a [rows, 64] slab of [B, H, N, 64] directly. Rows past N
// (a ragged last tile) are masked. W is re-read from L2 by every block
// (768 blocks at [32, 1536, 768]); no atomics, so reruns are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kDh = 64;      // head dim = the column tile
constexpr int kBK = 32;      // depth of a W tile

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

// h[r][:] = LN(x[row0 + r]) in T for r < rows (rows past N are zeros); one
// warp a row, three passes over the row in device memory (mean, variance,
// normalise).
template <typename T>
__device__ __forceinline__ void layernorm_tile(
    const T* __restrict__ x, const T* __restrict__ scale,
    const T* __restrict__ bias, T* h, int ldh, int row0, int rows, int N,
    int D, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += n_warps) {
    T* hr = h + (size_t)r * ldh;
    if (row0 + r >= N) {
      for (int d = lane; d < D; d += 32) hr[d] = from_f<T>(0.f);
      continue;
    }
    const T* xr = x + (size_t)(row0 + r) * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += to_f(xr[d]);
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / D;
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float c = to_f(xr[d]) - mean;
      ss = fmaf(c, c, ss);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float inv = rsqrtf(ss / D + eps);
    for (int d = lane; d < D; d += 32)
      hr[d] = from_f<T>((to_f(xr[d]) - mean) * inv * to_f(scale[d]) +
                        to_f(bias[d]));
  }
}

// ---------------------------------------------------------------------------
// bf16: 64-token tiles, 4 warps, mma.sync
// ---------------------------------------------------------------------------
constexpr int kBM16 = 64;
constexpr int kLdW16 = kDh + 8;   // padded W-tile row (bf16), ldmatrix-friendly

__global__ void __launch_bounds__(128)
    ln_qkv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ scale,
                       const __nv_bfloat16* __restrict__ bias,
                       const __nv_bfloat16* __restrict__ w,
                       const __nv_bfloat16* __restrict__ b,
                       __nv_bfloat16* __restrict__ out, int B, int N, int D,
                       int H, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldh = D + 8;   // padded h row: 16-byte aligned, conflict-free
  auto* hs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  auto* ws = reinterpret_cast<__nv_bfloat16(*)[kBK][kLdW16]>(
      smem_raw + (size_t)kBM16 * ldh * sizeof(__nv_bfloat16));
  const int bi = blockIdx.y, row0 = blockIdx.x * kBM16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int inner = H * kDh;
  const int KT = D / kBK, n_tiles = 3 * H * KT;

  layernorm_tile(x + (size_t)bi * N * D, scale, bias, hs, ldh, row0, kBM16,
                 N, D, eps);

  // W tile `tile` (column tile nt = one head of one projection, depth kt)
  // into buffer `buf`: 32 rows x 64 columns, 256 16-byte chunks.
  auto load_w = [&](int tile, int buf) {
    const int nt = tile / KT, kt = tile % KT;
    const int proj = nt / H, head = nt % H;
    const __nv_bfloat16* src =
        w + ((size_t)proj * D + (size_t)kt * kBK) * inner + head * kDh;
    for (int c = threadIdx.x; c < kBK * kDh / 8; c += blockDim.x) {
      const int r = c >> 3, c8 = (c & 7) * 8;
      cp_async16(smem_u32(&ws[buf][r][c8]), src + (size_t)r * inner + c8,
                 true);
    }
    cp_async_commit();
  };

  float acc[8][4];
  load_w(0, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1, kt = tile % KT;
    if (tile + 1 < n_tiles) {
      load_w(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // the tile (and, at the first, h) is in place
    if (kt == 0) zero_acc(acc);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const int k0 = kt * kBK + ks * 16;
      uint32_t a[4];
      ldsm_x4(a, smem_u32(&hs[(size_t)(warp * 16 + (lane & 7) +
                                       ((lane >> 3) & 1) * 8) * ldh +
                                  k0 + (lane >> 4) * 8]));
      const int lr = lane & 7, lm = lane >> 3;
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, smem_u32(&ws[buf][ks * 16 + (lm & 1) * 8 + lr]
                                      [jp * 16 + (lm >> 1) * 8]));
        mma_bf16(acc[2 * jp], a, bf[0], bf[1]);
        mma_bf16(acc[2 * jp + 1], a, bf[2], bf[3]);
      }
    }
    if (kt == KT - 1) {   // epilogue: bias in float32, one head's slab
      const int nt = tile / KT, proj = nt / H, head = nt % H;
      const __nv_bfloat16* bp = b + (size_t)proj * inner + head * kDh;
      __nv_bfloat16* op =
          out + (((size_t)proj * B + bi) * H + head) * (size_t)N * kDh;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j * 8 + 2 * t;
        const float b0 = to_f(bp[col]), b1 = to_f(bp[col + 1]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + warp * 16 + g + half * 8;
          if (row < N) {
            __nv_bfloat162 v = __floats2bfloat162_rn(
                acc[j][2 * half] + b0, acc[j][2 * half + 1] + b1);
            *reinterpret_cast<__nv_bfloat162*>(op + (size_t)row * kDh + col) =
                v;
          }
        }
      }
    }
    __syncthreads();   // the buffer is free for the load two tiles ahead
  }
}

// ---------------------------------------------------------------------------
// float32: 32-token tiles, 256 threads, SIMT FMA
// ---------------------------------------------------------------------------
constexpr int kBM32 = 32;

__global__ void __launch_bounds__(256)
    ln_qkv_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      const float* __restrict__ w, const float* __restrict__ b,
                      float* __restrict__ out, int B, int N, int D, int H,
                      float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hs = reinterpret_cast<float*>(smem_raw);          // [kBM32][D]
  float* ws = hs + (size_t)kBM32 * D;                      // [kBK][kDh]
  const int bi = blockIdx.y, row0 = blockIdx.x * kBM32;
  const int col = threadIdx.x & (kDh - 1), rg = threadIdx.x / kDh;  // rg < 4
  const int inner = H * kDh;

  layernorm_tile(x + (size_t)bi * N * D, scale, bias, hs, D, row0, kBM32, N,
                 D, eps);
  __syncthreads();
  for (int nt = 0; nt < 3 * H; ++nt) {
    const int proj = nt / H, head = nt % H;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int k0 = 0; k0 < D; k0 += kBK) {
      const float* src = w + ((size_t)proj * D + k0) * inner + head * kDh;
      for (int i = threadIdx.x; i < kBK * kDh; i += blockDim.x)
        ws[i] = src[(size_t)(i / kDh) * inner + (i % kDh)];
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kBK; ++k) {
        const float wv = ws[k * kDh + col];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[j] = fmaf(hs[(size_t)(rg + 4 * j) * D + k0 + k], wv, acc[j]);
      }
      __syncthreads();
    }
    const float bv = b[(size_t)proj * inner + head * kDh + col];
    float* op = out + (((size_t)proj * B + bi) * H + head) * (size_t)N * kDh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = row0 + rg + 4 * j;
      if (row < N) op[(size_t)row * kDh + col] = acc[j] + bv;
    }
  }
}

}  // namespace

// Shared-memory bytes of one block (dtype 0: float32, 1: bfloat16).
extern "C" long long ln_qkv_smem_bytes(int dtype, int D) {
  if (dtype == 0) return (long long)(kBM32 * D + kBK * kDh) * 4;
  return (long long)(kBM16 * (D + 8) + 2 * kBK * kLdW16) * 2;
}

// x [B, N, D]; scale, bias [D]; w [3, D, H·64] (wq, wk, wv); b [3, H·64];
// out [3, B, H, N, 64] (q, k, v), all contiguous in x's dtype (dtype 0:
// float32, 1: bfloat16). D a multiple of 32. Returns the CUDA error of the
// launch (0 on success).
extern "C" int ln_qkv(int dtype, const void* x, const void* scale,
                      const void* bias, const void* w, const void* b,
                      void* out, int B, int N, int D, int H, float eps,
                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int smem = (int)ln_qkv_smem_bytes(dtype, D);
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(ln_qkv_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + kBM32 - 1) / kBM32, B);
    ln_qkv_f32_kernel<<<grid, 256, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(out), B, N, D, H,
        eps);
  } else {
    err = cudaFuncSetAttribute(ln_qkv_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + kBM16 - 1) / kBM16, B);
    ln_qkv_bf16_kernel<<<grid, 128, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(scale),
        static_cast<const __nv_bfloat16*>(bias),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(out), B, N, D, H, eps);
  }
  return (int)cudaGetLastError();
}
