// Warp-level building blocks shared by the flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): bf16 packing, cp.async
// 16-byte copies, ldmatrix fragment loads and mma.sync m16n8k16 (bf16 in,
// f32 accumulate).
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1],
//                           a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, "col"):      b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16 x 8, f32):        c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// so two neighbouring 8-column C tiles, packed to bf16, are one A fragment
// of a 16-deep product: the accumulator of one product feeds the next
// without a trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with `valid` false the destination is
// zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// D += A * B, A 16x16 bf16 (row), B 16x8 bf16 (col), D 16x8 f32.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 16-row A fragments of a bf16 [rows, 64] matrix in device memory,
// rows r0 and r0 + 8 of the warp (4 k-steps of 16 over the head dim);
// rows at or past `n` read 0.
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[4][4],
                                            const __nv_bfloat16* x,
                                            long long stride, int r0, int n,
                                            int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    f[kk][0] = r0 < n ? ld_u32(x + r0 * stride + c) : 0u;
    f[kk][1] = r1 < n ? ld_u32(x + r1 * stride + c) : 0u;
    f[kk][2] = r0 < n ? ld_u32(x + r0 * stride + c + 8) : 0u;
    f[kk][3] = r1 < n ? ld_u32(x + r1 * stride + c + 8) : 0u;
  }
}

// The A fragment of k-step kk (16 columns) from 8-column accumulator tiles
// c[2kk] and c[2kk + 1], rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[8][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// acc[16 x 64] += A[16 x 64] * M^T for a 64 x 64 tile M ([n][k], padded
// rows in shared memory): acc's n-tile j covers rows j*8.. of M. One
// ldmatrix.x4 gives the B fragments of two k-steps.
template <int R>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4],
                                        const uint32_t (&a)[4][4],
                                        __nv_bfloat16 (*m)[R],
                                        int lane) {
  const int lr = lane & 7, lm = lane >> 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) {
      uint32_t b[4];
      ldsm_x4(b, smem_u32(&m[j * 8 + lr][kp * 32 + lm * 8]));
      mma_bf16(acc[j], a[2 * kp], b[0], b[1]);
      mma_bf16(acc[j], a[2 * kp + 1], b[2], b[3]);
    }
  }
}

// acc[16 x 64] += C * M for C the 16 x 64 accumulator tiles `c` (rounded to
// bf16) and a 64 x 64 tile M ([k][n], padded rows in shared memory), read
// transposed: one ldmatrix.x4.trans covers two 8-wide n-tiles.
template <int R>
__device__ __forceinline__ void mma_cm(float (&acc)[8][4],
                                       const float (&c)[8][4],
                                       __nv_bfloat16 (*m)[R],
                                       int lane) {
  const int lr = lane & 7, lm = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    acc_to_a(a, c, kk);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldsm_x4_trans(b, smem_u32(&m[kk * 16 + (lm & 1) * 8 + lr]
                                  [jp * 16 + (lm >> 1) * 8]));
      mma_bf16(acc[2 * jp], a, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

}  // namespace
