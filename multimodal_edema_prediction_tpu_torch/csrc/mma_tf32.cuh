// Warp-level building blocks of the float32 kernels' tensor-core products
// (flash_attention.cu's flash_fwd_f32, flash_attention_bwd.cu's float32
// D, dkv and dq, ln_qkv.cu's ln_qkv_f32_kernel):
// "3xTF32" products on mma.sync m16n8k8 (TF32 in, f32 accumulate).
//
// TF32 keeps 10 of float32's 23 mantissa bits. Each float32 operand x is
// split into big = tf32(x) and small = tf32(x - big) (cvt.rna: round to
// nearest, ties away from zero), so that x = big + small to about 2^-22
// relative, and a product is summed as small·big + big·small + big·big in
// float32 (the small·small term is below float32's rounding). That keeps
// float32 accuracy (the reference-precision path's 1e-5 / 1e-4 checks) at
// three tensor-core products per product: 495 / 3 TFLOP/s of TF32 on an
// H100 SXM against 67 TFLOP/s of float32 FMA.
//
// The tensor cores add in float32 but truncate what they add; along a
// chain of products into one large accumulator (a score, an output row
// summed over 1370 keys) that error grows with the chain and has one
// sign. Where the check is tight (attention, 1e-5 absolute), the products
// of two k-steps (16 deep) are summed from zero and that sum is added to
// the accumulator in float32, rounded to nearest (mma_3xtf32_sweep_d);
// K4's products go straight into its accumulators (mma_3xtf32_sweep).
// Where B must come through whole (O += P V: with one key of weight 1 the
// output is that key's row of V, which the backward's D = rowsum(dO o)
// cancels against dP = dO V), B takes a third part, tiny = tf32(x - big -
// small), with which big + small + tiny = x exactly
// (mma_3xtf32_exact_b_sweep_d).
//
// Each sweep issues its products a kind at a time over several
// accumulator tiles: a warp issues in order, and a product that waits on
// the one just before it stalls the warp for the tensor cores' latency.
//
// Fragment layout of mma.m16n8k8 .tf32 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major): a0 = A[g][t],   a1 = A[g+8][t],
//                          a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8 x 8, "col"):      b0 = B[t][g],   b1 = B[t+4][g]
//   C (16 x 8, f32):       c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// Unlike bf16's m16n8k16, a C fragment is not an A fragment. The kernels
// here read the 8 k of a step in the order (0, 2, 4, 6, 1, 3, 5, 7): the
// k that the layout calls t is column 2t of the tile and t + 4 is 2t + 1.
// A sum over k does not depend on its order, and in that order
//   - A's (a0, a2) and (a1, a3) are adjacent pairs of one row (one 8-byte
//     load each), as are B's (b0, b1) when B is stored [n][k];
//   - the accumulator C of one product, 8 columns wide, is as it stands
//     the A fragment of a product whose k runs over those 8 columns:
//     (a0, a1, a2, a3) = (c0, c2, c1, c3), no shuffle.
#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, each a TF32 value held in a 32-bit register
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// D += A * B, A 16x8 TF32 (row), B 8x8 TF32 (col), D 16x8 f32.
__device__ __forceinline__ void mma_tf32_m16n8k8(float* d, const uint32_t* a,
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D = A * B, the accumulator input zero (no registers to clear).
__device__ __forceinline__ void mma_tf32_m16n8k8_zero(float* d,
                                                      const uint32_t* a,
                                                      uint32_t b0,
                                                      uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// d[n] (+)= A * B[n] for one A fragment and N B fragments of one k-step,
// the products issued a kind at a time (small·big, big·small, big·big), so
// that no product waits on the one before it; kFirst: d starts at zero.
// kSwap: the first two kinds swapped (big·small, then small·big), so that
// A·B here and Bᵀ·Aᵀ without kSwap add the same products in the same order,
// element for element, and give the same bits (flash_attention_bwd.cu:
// dkv's dPᵀ = V·dOᵀ and dq's dP = dO·Vᵀ, which D = rowsum(dO∘O) must
// cancel).
template <bool kFirst, bool kSwap = false, int N>
__device__ __forceinline__ void mma_3xtf32_sweep_d(
    float (&d)[N][4], const uint32_t (&a_big)[4],
    const uint32_t (&a_small)[4], const uint32_t (&b_big)[N][2],
    const uint32_t (&b_small)[N][2]) {
  const uint32_t(&a1)[4] = kSwap ? a_big : a_small;
  const uint32_t(&b1)[N][2] = kSwap ? b_small : b_big;
  const uint32_t(&a2)[4] = kSwap ? a_small : a_big;
  const uint32_t(&b2)[N][2] = kSwap ? b_big : b_small;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (kFirst)
      mma_tf32_m16n8k8_zero(d[n], a1, b1[n][0], b1[n][1]);
    else
      mma_tf32_m16n8k8(d[n], a1, b1[n][0], b1[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
    mma_tf32_m16n8k8(d[n], a2, b2[n][0], b2[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n)
    mma_tf32_m16n8k8(d[n], a_big, b_big[n][0], b_big[n][1]);
}

// The same with B in three parts, B = big + small + tiny exactly: a fourth
// product, big·tiny, so that where A is a TF32 value (a weight of 1 or 0)
// the sum is A·B exactly.
template <bool kFirst, int N>
__device__ __forceinline__ void mma_3xtf32_exact_b_sweep_d(
    float (&d)[N][4], const uint32_t (&a_big)[4],
    const uint32_t (&a_small)[4], const uint32_t (&b_big)[N][2],
    const uint32_t (&b_small)[N][2], const uint32_t (&b_tiny)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (kFirst)
      mma_tf32_m16n8k8_zero(d[n], a_small, b_big[n][0], b_big[n][1]);
    else
      mma_tf32_m16n8k8(d[n], a_small, b_big[n][0], b_big[n][1]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
    mma_tf32_m16n8k8(d[n], a_big, b_tiny[n][0], b_tiny[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n)
    mma_tf32_m16n8k8(d[n], a_big, b_small[n][0], b_small[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n)
    mma_tf32_m16n8k8(d[n], a_big, b_big[n][0], b_big[n][1]);
}

// acc[m][n] += A[m] * B[n] for every pair of M A fragments and N B
// fragments (one k-step), straight into the accumulators, a kind of
// product at a time as above: each product's accumulator was last touched
// M·N products before. The chain into each accumulator is then as long as
// the sum's depth, and so are its truncation errors (K4: depth D, held to
// 1e-4 of each output's max abs).
template <int M, int N>
__device__ __forceinline__ void mma_3xtf32_sweep(
    float (&acc)[M][N][4], const uint32_t (&a_big)[M][4],
    const uint32_t (&a_small)[M][4], const uint32_t (&b_big)[N][2],
    const uint32_t (&b_small)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int m = 0; m < M; ++m)
      mma_tf32_m16n8k8(acc[m][n], a_small[m], b_big[n][0], b_big[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int m = 0; m < M; ++m)
      mma_tf32_m16n8k8(acc[m][n], a_big[m], b_small[n][0], b_small[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int m = 0; m < M; ++m)
      mma_tf32_m16n8k8(acc[m][n], a_big[m], b_big[n][0], b_big[n][1]);
}

// The A fragment (rows r and r + 8 of a tile of TF32 values in shared
// memory, row stride `ld` floats; the k-step's 8 columns from `k0`) in the
// k order above: one 8-byte load a row.
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const float* s,
                                            int ld, int r, int k0, int t) {
  const uint2 lo = *reinterpret_cast<const uint2*>(s + r * ld + k0 + 2 * t);
  const uint2 hi =
      *reinterpret_cast<const uint2*>(s + (r + 8) * ld + k0 + 2 * t);
  a[0] = lo.x;
  a[1] = hi.x;
  a[2] = lo.y;
  a[3] = hi.y;
}

// The B fragment of a tile of TF32 values stored [n][k] (row n, stride
// `ld`): column n of the product, the k-step's 8 k from `k0`; one 8-byte
// load.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[2], const float* s,
                                          int ld, int n, int k0, int t) {
  const uint2 v = *reinterpret_cast<const uint2*>(s + n * ld + k0 + 2 * t);
  b[0] = v.x;
  b[1] = v.y;
}

// The B fragment, split as it is loaded, of a float32 tile stored [k][n]
// (row k, stride `ld`): column n, the k-step's 8 k from `k0`; two 4-byte
// loads.
__device__ __forceinline__ void load_b_kn(uint32_t (&big)[2],
                                          uint32_t (&small)[2],
                                          const float* s, int ld, int n,
                                          int k0, int t) {
  split_tf32(s[(k0 + 2 * t) * ld + n], big[0], small[0]);
  split_tf32(s[(k0 + 2 * t + 1) * ld + n], big[1], small[1]);
}

// The B fragment of a tile of TF32 values stored [k][n]; two 4-byte loads.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[2], const float* s,
                                          int ld, int n, int k0, int t) {
  b[0] = __float_as_uint(s[(k0 + 2 * t) * ld + n]);
  b[1] = __float_as_uint(s[(k0 + 2 * t + 1) * ld + n]);
}

// The A fragment, split, of the k-step whose 8 k are the columns of the
// 16 x 8 accumulator tile c (the k order above: (c0, c2, c1, c3)).
__device__ __forceinline__ void acc_to_a_tf32(uint32_t (&big)[4],
                                              uint32_t (&small)[4],
                                              const float (&c)[4]) {
  split_tf32(c[0], big[0], small[0]);
  split_tf32(c[2], big[1], small[1]);
  split_tf32(c[1], big[2], small[2]);
  split_tf32(c[3], big[3], small[3]);
}

}  // namespace
