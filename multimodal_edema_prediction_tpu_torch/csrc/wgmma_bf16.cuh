// Hopper building blocks of the bf16 flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu), K4's bf16 kernel
// (ln_qkv.cu) and the bulk row gather (gather_rows.cu): mbarriers, TMA tile
// loads, warpgroup matrix multiply (wgmma m64n64k16 and m64n128k16 with A
// from registers; m64n256k16 with both operands from shared memory; bf16
// in, f32 accumulate) on tiles stored with the 128-byte
// swizzle, and on the host the tensor maps those loads read and the launch
// that hands two of them to a kernel.
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
#include <cuda_runtime.h>
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

// one box of a 3-D tensor map at coordinates (c0, c1, c2), innermost first;
// completion adds the box's bytes to `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// one box of a 2-D tensor map at coordinates (c0, c1), innermost first;
// completion adds the box's bytes to `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma operands)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` (1..15) over `threads` threads
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// descriptor of a swizzled [64][64] tile (see the head of this file):
// start address >> 4, LBO 16 B (unused: one atom across), SBO 1024 B,
// layout 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// 2^x on the special function unit (2 ulp; 0 for -inf)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// dynamic shared memory of a kernel whose shared storage is S, 1024 extra
// bytes to put S on the 1024-byte boundary the 128-byte swizzle repeats on
template <typename S>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(S)) + 1024;
}

template <typename S>
__device__ __forceinline__ S& smem_1024() {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  return *reinterpret_cast<S*>(smem_raw + pad);
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
template <int J>
__device__ __forceinline__ void fence_acc(float (&acc)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[j][e])::"memory");
}

template <int K>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
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

#define WGMMA_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"
#define WGMMA_ACC64(d) \
  WGMMA_ACC8(d, 0), WGMMA_ACC8(d, 1), WGMMA_ACC8(d, 2), \
  WGMMA_ACC8(d, 3), WGMMA_ACC8(d, 4), WGMMA_ACC8(d, 5), \
  WGMMA_ACC8(d, 6), WGMMA_ACC8(d, 7), WGMMA_ACC8(d, 8), \
  WGMMA_ACC8(d, 9), WGMMA_ACC8(d, 10), WGMMA_ACC8(d, 11), \
  WGMMA_ACC8(d, 12), WGMMA_ACC8(d, 13), WGMMA_ACC8(d, 14), \
  WGMMA_ACC8(d, 15)
#define WGMMA_OUT64(d) \
  WGMMA_OUT8(d, 0), WGMMA_OUT8(d, 1), WGMMA_OUT8(d, 2), \
  WGMMA_OUT8(d, 3), WGMMA_OUT8(d, 4), WGMMA_OUT8(d, 5), \
  WGMMA_OUT8(d, 6), WGMMA_OUT8(d, 7), WGMMA_OUT8(d, 8), \
  WGMMA_OUT8(d, 9), WGMMA_OUT8(d, 10), WGMMA_OUT8(d, 11), \
  WGMMA_OUT8(d, 12), WGMMA_OUT8(d, 13), WGMMA_OUT8(d, 14), \
  WGMMA_OUT8(d, 15)

// the same for a 64 x 128 accumulator (64 f32 per thread, acc[j][e] as
// above for j < 16): B a tile of 128 columns, K-major only (the forward's
// scores against a 128-key tile)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WGMMA_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_first_n128(float (&d)[16][4],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WGMMA_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

// The A fragment of k-step kk (16 columns) from the 8-column groups
// 2kk, 2kk + 1 of a J-group accumulator, rounded to bf16 (mma_bf16.cuh's
// acc_to_a for any width)
template <int J>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[J][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// ---- both operands from shared memory (ln_qkv.cu): A a K-major swizzled
// tile (sw128_desc), B an MN-major one of N columns as N / 64 swizzled
// [rows][64] tiles `lbo` bytes apart (sw128_desc_mn) ----

// descriptor of an MN-major B operand whose 64-column swizzle atoms lie
// `lbo` bytes apart along N (LBO), 8-row groups of depth 1024 B apart (SBO)
__device__ __forceinline__ uint64_t sw128_desc_mn(const void* tile,
                                                  uint32_t lbo) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (64ull << 32) | (1ull << 62);
}

#define WGMMA_D128                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "            \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "   \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
  "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "   \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "   \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "   \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "   \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, " \
  "%122, %123, %124, %125, %126, %127}"
#define WGMMA_ACC64_HI(d) \
  WGMMA_ACC8(d, 16), WGMMA_ACC8(d, 17), WGMMA_ACC8(d, 18), \
  WGMMA_ACC8(d, 19), WGMMA_ACC8(d, 20), WGMMA_ACC8(d, 21), \
  WGMMA_ACC8(d, 22), WGMMA_ACC8(d, 23), WGMMA_ACC8(d, 24), \
  WGMMA_ACC8(d, 25), WGMMA_ACC8(d, 26), WGMMA_ACC8(d, 27), \
  WGMMA_ACC8(d, 28), WGMMA_ACC8(d, 29), WGMMA_ACC8(d, 30), \
  WGMMA_ACC8(d, 31)
#define WGMMA_OUT64_HI(d) \
  WGMMA_OUT8(d, 16), WGMMA_OUT8(d, 17), WGMMA_OUT8(d, 18), \
  WGMMA_OUT8(d, 19), WGMMA_OUT8(d, 20), WGMMA_OUT8(d, 21), \
  WGMMA_OUT8(d, 22), WGMMA_OUT8(d, 23), WGMMA_OUT8(d, 24), \
  WGMMA_OUT8(d, 25), WGMMA_OUT8(d, 26), WGMMA_OUT8(d, 27), \
  WGMMA_OUT8(d, 28), WGMMA_OUT8(d, 29), WGMMA_OUT8(d, 30), \
  WGMMA_OUT8(d, 31)

// d (64 x 256) += A B (m64n256k16), one k-step of 16, A and B from shared
// memory; kFirst: d = A B, d an output only (the first k-step of a
// product). acc[j][e] as the m64n64 layout.
template <bool kFirst>
__device__ __forceinline__ void wgmma_ss(float (&d)[32][4], uint64_t a,
                                         uint64_t b) {
  if constexpr (kFirst) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WGMMA_D128
        ", %128, %129, p, 1, 1, 0, 1;\n}\n"
        : WGMMA_OUT64(d), WGMMA_OUT64_HI(d)
        : "l"(a), "l"(b), "r"(0));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WGMMA_D128
        ", %128, %129, p, 1, 1, 0, 1;\n}\n"
        : WGMMA_ACC64(d), WGMMA_ACC64_HI(d)
        : "l"(a), "l"(b), "r"(1));
  }
}

#undef WGMMA_D128
#undef WGMMA_ACC64_HI
#undef WGMMA_OUT64_HI
#undef WGMMA_ACC8
#undef WGMMA_OUT8
#undef WGMMA_OUT32
#undef WGMMA_ACC32
#undef WGMMA_D32
#undef WGMMA_D64
#undef WGMMA_ACC64
#undef WGMMA_OUT64

// ---- host side: tensor maps and the launch of a kernel that streams two
// tensors through them ----

// a bf16 kernel's tensor maps of its two streamed tensors, each (64, rows,
// H, B): K and V for the forward and dq, Q and dO for dkv
struct Maps {
  CUtensorMap a, b;
};

// cuTensorMapEncodeTiled, a driver function, reached through the runtime so
// that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess &&
        ptr != nullptr)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first; `strides` the byte
// strides of dims 1..rank-1) read in boxes `box` with the 128-byte swizzle
// (box[0] = 64: one 128-byte row of the tile format above).
inline bool encode_bf16_map(CUtensorMap* map, const void* base, int rank,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  if (fn == nullptr || rank > 5) return false;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One bf16 tensor map with [64][64] boxes (the tile format above) and the
// 128-byte swizzle. geo: dims (64, rows, H, B), innermost first, then the
// byte strides of rows, heads and batches (ops/attention.py::tma_geometry).
inline bool encode_map(CUtensorMap* map, const void* base,
                       const unsigned long long* geo) {
  if (geo[0] != 64) return false;
  const cuuint64_t dims[4] = {geo[0], geo[1], geo[2], geo[3]};
  const cuuint64_t strides[3] = {geo[4], geo[5], geo[6]};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  return encode_bf16_map(map, base, 4, dims, strides, box);
}

// Launch a bf16 kernel(Maps, P) of `threads` threads on the maps of `a` and
// `b`, 7 values of geo each; returns a CUDA error code (0 = launched).
template <typename Kernel, typename P>
int launch_bf16(Kernel kernel, int threads, int smem, dim3 grid, const P& p,
                const void* a, const void* b, const unsigned long long* geo,
                cudaStream_t s) {
  Maps m;
  if (geo == nullptr || !encode_map(&m.a, a, geo) ||
      !encode_map(&m.b, b, geo + 7))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, s>>>(m, p);
  return (int)cudaGetLastError();
}

}  // namespace
