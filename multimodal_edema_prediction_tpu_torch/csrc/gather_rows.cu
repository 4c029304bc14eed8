// K2: row gather out[i] = bank[rows[i]] for the encode-once feature bank.
//
// Replaces multimodal_edema_prediction_tpu/ops/pallas_gather.py:60
// gather_rows (with :42 _gather_rows_3d, pallas_call :52, and :37 _kernel):
// a scalar-prefetch Pallas kernel whose grid step i DMAs bank[rows[i]] into
// out[i]. The training step of the encode-once tier calls it twice per step,
// once on the CLS bank [N+1, 768] (as [N+1, 1, 768]) and once on the patch
// bank [N+1, 1370, 768] (bf16, or float32 in float32 loops).
//
// What bounds it on an H100: bytes. It reads each gathered row once and
// writes it once, so the least time is 2·B·row_bytes / 3.35e12 B/s: at
// B = 32 bf16 patch rows (2,104,320 B each) that is 134.7 MB, about 40 us.
// There is no arithmetic at all.
//
// Design (a simple copy kernel that is right; TMA or cp.async.bulk bulk
// copies are for a later change):
// - grid (chunks of a row, B): every block copies one contiguous chunk of one
//   output row, so a 2.1 MB row is spread over ~130 blocks and a batch of 32
//   rows fills the card many times over; a 1.5 KB CLS row is one block.
// - each block loads its own row index (the counterpart of scalar prefetch);
// - the copy is dtype-agnostic: rows move as words of VEC bytes (16 when the
//   row length and both base pointers are 16-byte aligned, as at every shape
//   of the main path; else the widest power of two that divides them all, so
//   no tail case exists); consecutive threads touch consecutive words, and
//   each thread issues UNROLL independent loads before its stores.
// - a row index outside [0, N) never reads the bank: that output row is
//   filled with the 32-bit word `fill` repeated, which the wrapper sets to NaN
//   for float32/bfloat16/float16 banks (the feature bank's NaN-sentinel
//   contract) and to zero bytes for every other dtype.
//
// C entry point (ctypes): returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename V>
__device__ __forceinline__ V splat(uint32_t w);

template <>
__device__ __forceinline__ uint4 splat<uint4>(uint32_t w) {
  return make_uint4(w, w, w, w);
}
template <>
__device__ __forceinline__ uint2 splat<uint2>(uint32_t w) {
  return make_uint2(w, w);
}
template <>
__device__ __forceinline__ uint32_t splat<uint32_t>(uint32_t w) {
  return w;
}
template <>
__device__ __forceinline__ uint16_t splat<uint16_t>(uint32_t w) {
  return static_cast<uint16_t>(w & 0xFFFFu);
}
template <>
__device__ __forceinline__ uint8_t splat<uint8_t>(uint32_t w) {
  return static_cast<uint8_t>(w & 0xFFu);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ bank, const int* __restrict__ rows,
                   V* __restrict__ out, long long n_bank_rows,
                   long long row_words, uint32_t fill) {
  const long long i = blockIdx.y;
  const int r = rows[i];
  const long long first = static_cast<long long>(blockIdx.x) * kThreads *
                          kUnroll + threadIdx.x;
  V* dst = out + i * row_words;
  if (r < 0 || r >= n_bank_rows) {
    const V f = splat<V>(fill);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = first + static_cast<long long>(u) * kThreads;
      if (j < row_words) dst[j] = f;
    }
    return;
  }
  const V* src = bank + static_cast<long long>(r) * row_words;
  V v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = first + static_cast<long long>(u) * kThreads;
    if (j < row_words) v[u] = src[j];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = first + static_cast<long long>(u) * kThreads;
    if (j < row_words) dst[j] = v[u];
  }
}

template <typename V>
cudaError_t launch(const void* bank, const int* rows, void* out,
                   long long n_bank_rows, long long row_bytes, int n_out,
                   uint32_t fill, cudaStream_t stream) {
  const long long row_words = row_bytes / static_cast<long long>(sizeof(V));
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  const long long chunks = (row_words + per_block - 1) / per_block;
  if (chunks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(n_out));
  gather_rows_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(bank), rows, static_cast<V*>(out), n_bank_rows,
      row_words, fill);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gather_rows(const void* bank, const int* rows, void* out,
                           long long n_bank_rows, long long row_bytes,
                           int n_out, unsigned int fill, int vec_bytes,
                           void* stream) {
  if (n_out == 0 || row_bytes == 0) return 0;
  if (n_out < 0 || n_out > 65535 || row_bytes < 0 ||
      row_bytes % vec_bytes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (vec_bytes) {
    case 16:
      err = launch<uint4>(bank, rows, out, n_bank_rows, row_bytes, n_out,
                          fill, s);
      break;
    case 8:
      err = launch<uint2>(bank, rows, out, n_bank_rows, row_bytes, n_out,
                          fill, s);
      break;
    case 4:
      err = launch<uint32_t>(bank, rows, out, n_bank_rows, row_bytes, n_out,
                             fill, s);
      break;
    case 2:
      err = launch<uint16_t>(bank, rows, out, n_bank_rows, row_bytes, n_out,
                             fill, s);
      break;
    case 1:
      err = launch<uint8_t>(bank, rows, out, n_bank_rows, row_bytes, n_out,
                            fill, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
