// Hopper building blocks of the bf16 flash-attention backward kernels
// (flash_attention_bwd.cu): mbarriers, TMA tile loads, and warpgroup matrix
// multiply (wgmma m64n64k16, bf16 in, f32 accumulate) on tiles stored with
// the 128-byte swizzle.
//
// Tile format: a [64 rows][64] bf16 tile, one 128-byte row each, as a TMA
// load with CU_TENSOR_MAP_SWIZZLE_128B writes it: row r at byte 128 r, its
// 16-byte chunk c at chunk c ^ (r % 8), the tile on a 1024-byte boundary.
// A shared-memory descriptor (sw128_desc) reads such a tile
//   - K-major, where the product's depth runs along the row (Q as B of
//     K Q^T): 8-row groups 1024 B apart (SBO); a k-step of 16 moves the
//     start address by 32 B (sw128_desc(t) + 2 kk);
//   - MN-major, where the depth runs down the rows (dO as B of P^T dO):
//     8-row groups of depth 1024 B apart (SBO), the 64 columns one swizzle
//     atom; a k-step of 16 rows moves the start by 2048 B (+ 128 kk).
// The m64n64 accumulator (32 f32 per thread): warp w of the warpgroup holds
// rows 16w..16w+15 as mma.sync m16n8k16 holds its C (mma_bf16.cuh),
// acc[j][e] = row 16w + g + 8 (e >= 2), column 8j + 2t + (e & 1). An A
// operand from registers takes the m16n8k16 A layout per warp, so
// acc_to_a turns one product's accumulator into the next one's A.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the TMA unit
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one [64][64] bf16 tile, rows [row, row + 64) of head h of batch b, from a
// 4-D tensor map (64, rows, H, B) into shared memory; rows past the map's
// row count read 0. Completion adds 8192 bytes to `bar`.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map,
                                              int row, int h, int b,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(h),
      "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// descriptor of a swizzled [64][64] tile (see the head of this file):
// start address >> 4, LBO 16 B (unused: one atom across), SBO 1024 B,
// layout 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// a warpgroup's registers per thread, lowered or raised to N (every warp of
// the group executes it)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties the registers to this point of the program, so that the compiler
// neither reads an accumulator before the wgmma that writes it has been
// waited for nor reuses an A operand's registers while it is in flight.
__device__ __forceinline__ void fence_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[j][e])::"memory");
}

__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][e])::"memory");
}

#define WGMMA_ACC8(d, j) \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define WGMMA_ACC32(d)                                                  \
  WGMMA_ACC8(d, 0), WGMMA_ACC8(d, 1), WGMMA_ACC8(d, 2), WGMMA_ACC8(d, 3), \
      WGMMA_ACC8(d, 4), WGMMA_ACC8(d, 5), WGMMA_ACC8(d, 6), WGMMA_ACC8(d, 7)
#define WGMMA_D32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"

#define WGMMA_OUT8(d, j) \
  "=f"(d[j][0]), "=f"(d[j][1]), "=f"(d[j][2]), "=f"(d[j][3])
#define WGMMA_OUT32(d)                                                  \
  WGMMA_OUT8(d, 0), WGMMA_OUT8(d, 1), WGMMA_OUT8(d, 2), WGMMA_OUT8(d, 3), \
      WGMMA_OUT8(d, 4), WGMMA_OUT8(d, 5), WGMMA_OUT8(d, 6), WGMMA_OUT8(d, 7)

// d (64 x 64) += A B, A from registers (the m16n8k16 A fragment of the
// warp's 16 rows, 16 deep), B a tile in shared memory: K-major [64 columns]
// [16 deep] for kMN 0, MN-major [16 deep rows][64 columns] for kMN 1
template <int kMN>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WGMMA_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(kMN));
}

// d = A B, as wgmma_rs but overwriting d, an output only: the first k-step
// of a product. (Read as well as written, d's previous values, dead here,
// would have to be kept; on an H100 dkv ran faster with d written only.)
template <int kMN>
__device__ __forceinline__ void wgmma_rs_first(float (&d)[8][4],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0),
        "n"(kMN));
}

#undef WGMMA_ACC8
#undef WGMMA_OUT8
#undef WGMMA_OUT32
#undef WGMMA_ACC32
#undef WGMMA_D32

}  // namespace
