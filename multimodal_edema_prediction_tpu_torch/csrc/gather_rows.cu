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
// A row index outside [0, N) never reads the bank: that output row is
// filled with the 32-bit word `fill` repeated, which the wrapper sets to NaN
// for float32/bfloat16/float16 banks (the feature bank's NaN-sentinel
// contract) and to zero bytes for every other dtype. Each block loads its
// own row indices (the counterpart of scalar prefetch).
//
// Two kernels; the wrapper picks one by alignment before the launch
// (ops/gather.py::route):
// - gather_rows_bulk_kernel, where the row size and both base pointers are
//   16-byte aligned, as at every shape of the main path. The work items are
//   (row, 32 KB chunk), one block an item, which the hardware schedules as
//   blocks finish (six an SM fit). One thread of a block moves its chunk
//   with TMA bulk copies, no registers or address arithmetic per byte: a
//   cp.async.bulk load into shared memory completing on an mbarrier, then
//   a cp.async.bulk store. A chunk of a row outside the bank is filled by
//   the whole block with 16-byte stores and never goes through shared
//   memory. (A persistent grid, a few blocks an SM walking the items
//   through a ring of chunks, ran no faster on an H100: PERF.md.)
// - gather_rows_kernel, any other row size or alignment (e.g. a [N, 3]
//   bf16 bank, 6-byte rows): grid (chunks of a row, rows), each block one
//   contiguous 16 KB-or-smaller chunk of one output row, as words of the
//   widest power of two up to 16 bytes that divides the row size and both
//   pointers, UNROLL independent loads a thread before its stores; rows
//   beyond the grid's 65,535 are taken in turns.
//
// C entry points (ctypes): each returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "wgmma_bf16.cuh"

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
                   long long row_words, long long n_out, uint32_t fill) {
  const long long first = static_cast<long long>(blockIdx.x) * kThreads *
                          kUnroll + threadIdx.x;
  for (long long i = blockIdx.y; i < n_out; i += gridDim.y) {
    const int r = rows[i];
    V* dst = out + i * row_words;
    if (r < 0 || r >= n_bank_rows) {
      const V f = splat<V>(fill);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long j = first + static_cast<long long>(u) * kThreads;
        if (j < row_words) dst[j] = f;
      }
      continue;
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
}

template <typename V>
cudaError_t launch(const void* bank, const int* rows, void* out,
                   long long n_bank_rows, long long row_bytes,
                   long long n_out, uint32_t fill, cudaStream_t stream) {
  const long long row_words = row_bytes / static_cast<long long>(sizeof(V));
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  const long long chunks = (row_words + per_block - 1) / per_block;
  if (chunks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
  dim3 grid(static_cast<unsigned>(chunks),
            static_cast<unsigned>(n_out < 65535 ? n_out : 65535));
  gather_rows_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(bank), rows, static_cast<V*>(out), n_bank_rows,
      row_words, n_out, fill);
  return cudaGetLastError();
}

constexpr int kBulkThreads = 128;
constexpr uint32_t kChunk = 32768;      // bytes of a work item at most

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Work item it (of n_out * n_chunks): chunk it % n_chunks of output row
// it / n_chunks. A block takes item blockIdx.x, and + gridDim.x, ... only
// where there are more items than a grid holds.
__global__ void __launch_bounds__(kBulkThreads)
gather_rows_bulk_kernel(const uint8_t* __restrict__ bank,
                        const int* __restrict__ rows,
                        uint8_t* __restrict__ out, long long n_bank_rows,
                        long long row_bytes, long long n_out,
                        long long n_chunks, uint32_t fill) {
  __shared__ __align__(128) uint8_t chunk[kChunk];
  __shared__ uint64_t full;
  if (threadIdx.x == 0) {
    mbar_init(&full, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const long long total = n_out * n_chunks;
  uint32_t phase = 0;
  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    const long long i = it / n_chunks, at = (it % n_chunks) * kChunk;
    const long long left = row_bytes - at;
    const uint32_t bytes = static_cast<uint32_t>(left < kChunk ? left
                                                               : kChunk);
    uint8_t* dst = out + i * row_bytes + at;
    const int r = __ldg(rows + i);
    if (r < 0 || r >= n_bank_rows) {
      const uint4 f = make_uint4(fill, fill, fill, fill);
      for (uint32_t k = threadIdx.x; k < bytes / 16; k += kBulkThreads)
        reinterpret_cast<uint4*>(dst)[k] = f;
      continue;
    }
    if (threadIdx.x == 0) {
      mbar_arrive_tx(&full, bytes);
      bulk_load(chunk, bank + r * row_bytes + at, bytes, &full);
      mbar_wait(&full, phase);
      bulk_store(dst, chunk, bytes);
      // the store has read the chunk before the block's next load
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    phase ^= 1;
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

extern "C" int gather_rows(const void* bank, const int* rows, void* out,
                           long long n_bank_rows, long long row_bytes,
                           long long n_out, unsigned int fill, int vec_bytes,
                           void* stream) {
  if (n_out == 0 || row_bytes == 0) return 0;
  if (n_out < 0 || row_bytes < 0 || row_bytes % vec_bytes != 0)
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

// The bulk kernel: row_bytes and both base pointers 16-byte aligned (the
// wrapper routes everything else to gather_rows); one block per 32 KB of
// an output row.
extern "C" int gather_rows_bulk(const void* bank, const int* rows, void* out,
                                long long n_bank_rows, long long row_bytes,
                                long long n_out, unsigned int fill,
                                void* stream) {
  if (n_out == 0 || row_bytes == 0) return 0;
  if (n_out < 0 || row_bytes < 0 || row_bytes % 16 ||
      reinterpret_cast<uintptr_t>(bank) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_chunks = (row_bytes + kChunk - 1) / kChunk;
  const long long items = n_out * n_chunks;
  const long long grid = items < 0x7FFFFFFFLL ? items : 0x7FFFFFFFLL;
  gather_rows_bulk_kernel<<<static_cast<unsigned>(grid), kBulkThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bank), rows, static_cast<uint8_t*>(out),
      n_bank_rows, row_bytes, n_out, n_chunks, fill);
  return static_cast<int>(cudaGetLastError());
}
