// K3, float32, on the tensor cores: one DuETT dual-axis encoder block,
// fused, for Hopper (sm_90a).
//
// Replaces multimodal_edema_prediction_tpu/ops/pallas_dual_axis.py
// (`_block_kernel` :78, `_fused_forward` :136, pallas_call :171,
// `fused_encoder_block` :192) for float32 x with D % 4 == 0, F % 128 == 0,
// L <= 64 and the layout below within one block's shared memory
// (ops/dual_axis.py::route); bfloat16 takes dual_axis_block_tc.cu and every
// other shape the SIMT kernel of dual_axis_block.cu. Per batch element b:
//
//   z = x + Wo·MHA(SN1(x)) + bo
//   y = SNf(z + W2·gelu_tanh(W1·SN2(z) + b1) + b2)
//
// ScaleNorm SN(t) = t / max(||t|| · D^-1/2, 1e-5) · g over the true D.
//
// Arithmetic. x and every weight arrive as float32. The four products
// (QKV, the out-projection Wo, FF1, FF2) run as "3xTF32" on mma.sync
// m16n8k8 (mma_tf32.cuh): each operand split into TF32 big and small parts,
// each product summed as small·big + big·small + big·big, straight into
// float32 accumulators (K4's scheme: chains of D = 600 / 840 and 128 stay
// within 1e-4 of the output's max abs; tests/test_torch_tf32x3.py models
// it). Everything else is float32 outside the tensor cores: each ScaleNorm,
// q, k, v, the scores, the softmax (keys j >= L take no part), P·V, GELU in
// its tanh form (jax.nn.gelu's default), the residuals and the FF partials
// summed in a fixed order. No float atomics: reruns are bit-equal.
//
// Bound on an H100: at DuETT's shapes ([B, 35, 600] event axis, [B, 25, 840]
// time axis; 2 heads x 12, F 512) the call at batch 32 does ~1 GFLOP, three
// TF32 products each (9.2 us at 495 TFLOP/s / 3), and moves ~5 MB (x, the
// output, the float32 weights once; 1.5 us of HBM time). What limits a
// block is its small products: M = 35 or 25 rows in m16 tiles of 48 or 32,
// on mma.sync, whose TF32 rate on an H100 is far below wgmma's. On an H100
// 80GB HBM3 at 700 W (scripts/k3_phases.py) FF1 and FF2 issue an
// HMMA.1688.F32.TF32 every ~19.5 cycles per SM sub-partition, where K4's
// float32 kernel, a large GEMM, reaches ~15; the four products are about
// three quarters of a block's cycles, the attention half that every slice
// repeats about half.
//
// Design. The grid of dual_axis_block_tc.cu: B x S blocks, S = F / 128;
// block (b, s) owns element b and hidden units [128 s, 128 s + 128) of the
// FF, and repeats the attention half (as the bf16 kernel does). The A
// operand of every product is split into its TF32 parts once, where it is
// written to shared memory (8 warps read each A fragment: splitting it at
// each load instead was 11% slower at the event axis on an H100); each W
// value is split as it is read from the ring, by the one warp that owns its
// column. To fit both
// parts of h (and of h2) in one block's 227 KB, z is not kept beside them:
//   1. x[b] by cp.async into h_big's place, then h = SN1(x) in place, a warp
//      a row, split into h_big | h_small ([L][ldh] each);
//   2. QKV = h · Wqkv (N = 3 x 24) into q|k|v float32, over h_small when
//      Wqkv is one n-chunk of the ring (3 H dh <= 128, as at DuETT's 2 x 12),
//      else after h_small: a later chunk still reads h_small;
//   3. the attention core in float32 SIMT: one warp a (head, query) row for
//      the scores and their softmax, keys j and j + 32 on lane j (L <= 64);
//      o = P · V, split into o_big | o_small;
//   4. z = (x + o · Wo) + bo over h_big, where x was copied again by
//      cp.async under the attention core (K = 24: three k-steps);
//   5. SN2 in place: a warp a row takes z's norm, block s = 0 copies z's row
//      to its slot of the workspace, and the row becomes h2's big part where
//      z was, its small part beside it;
//   6. f = gelu(h2 · W1[:, slice] + b1[slice]), split, over h2; its partial
//      W2[slice, :] · f, float32 [L, D], to a workspace [S + 1, B, L, D]
//      (slot S: z) that the wrapper allocates;
//   7. the last of the S blocks of element b to arrive (a __threadfence and
//      a per-element counter, which that block resets to 0) sums
//      z + (partial 0 + ... + partial S-1) + b2 in that order, applies SNf
//      and writes y.
//
// The products. Each is out[Mp, N] = A[Mp, K] · W[K, N] with A's two parts
// in shared memory, L rows of stride a_ld(K) = K rounded to 8, plus 4 (an
// odd number of 16-byte granules: the eight rows of an ldmatrix phase fall
// in distinct banks), zero in columns K..round8(K). Rows L..Mp (Mp = L
// rounded up to 16) are never stored: a lane gives ldmatrix row L - 1 in
// their place, and the sums of those rows are dropped. W [K, N] row-major
// float32 in device memory streams through a three-stage cp.async ring in
// tiles of 32 k-rows x 128 columns, row stride 136 (the 4-byte B fragment
// loads of rows t and t + 4 hit 32 banks); rows past K and columns past N
// are zero-filled. The 8 warps each own 16 of a tile's 128 columns (two n8
// tiles; a tile past N is skipped) and every m16 row tile: per k-step of 8
// a warp takes each A fragment with one ldmatrix.x4 a TF32 part (its four
// registers in mma order), its B fragments (split), then issues the
// products a kind at a time. The kernel is a template on the count of m16
// tiles, so that no product is predicated. bo, b2 and the block's slice of
// b1 are staged in shared memory.
//
// Built with -DK3_STAMPS (scripts/k3_phases.py does; ops/build.py never
// does), thread 0 of every block writes clock64() and %globaltimer at the
// end of each phase to a buffer set with set_stamps(); otherwise STAMP is
// empty.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

#ifdef K3_STAMPS
// per block (blockIdx.x * gridDim.y + blockIdx.y): 16 clock64() stamps, then
// 16 %globaltimer stamps (ns)
__device__ unsigned long long* g_stamps;
#define STAMP(i)                                                             \
  do {                                                                       \
    if (threadIdx.x == 0) {                                                  \
      unsigned long long t_;                                                 \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                 \
      const size_t o_ = (size_t)(blockIdx.x * gridDim.y + blockIdx.y) * 32;  \
      g_stamps[o_ + (i)] = clock64();                                        \
      g_stamps[o_ + 16 + (i)] = t_;                                          \
    }                                                                        \
  } while (0)
#else
#define STAMP(i) \
  do {           \
  } while (0)
#endif

constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 128;               // FF hidden units per block
constexpr int kNC = 128;                  // columns of a staged W tile
constexpr int kKC = 32;                   // k-rows of a staged W tile
constexpr int kLdw = kNC + 8;             // its row stride
constexpr int kStages = 3;                // the W ring
constexpr int kMaxMT = 4;                 // m16 row tiles: L <= 64

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Row stride (floats) of an A operand of K columns: K rounded to 8, plus 4,
// so that a row spans an odd number of 16-byte granules.
__host__ __device__ constexpr int a_ld(int K) { return round_up(K, 8) + 4; }

// Shared memory of one block, byte offsets (ops/dual_axis.py::
// tf32_smem_bytes mirrors it). A region of three lives: h_big | h_small
// (each [L][ldh] float32; later z over h_big, then h2's parts where h's
// were); in the attention core z, then q|k|v [L][3I + 1] (an odd stride), P
// [H][L][L] and o_big | o_small [L][ldo] over h_small, or after it when
// Wqkv spans more than one n-chunk (the QKV epilogue runs after each chunk,
// and h_small is A to the next); in the FF f_big | f_small [L][ldf] over
// h2. Then the W ring; bo, b2 and this block's slice of b1.
struct Layout {
  int mt, ldh, ldq, ldo, ldf;
  size_t hs, q, p, ob, os, fs, ring, bias, total;
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

__host__ __device__ inline size_t max3(size_t a, size_t b, size_t c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

__host__ __device__ inline Layout make_layout(int L, int D, int H, int dh) {
  Layout s;
  const int inner = H * dh;
  s.mt = (L + 15) / 16;
  s.ldh = a_ld(D);
  s.ldq = 3 * inner + 1;
  s.ldo = a_ld(inner);
  s.ldf = a_ld(kSlice);
  s.hs = align16(sizeof(float) * L * s.ldh);
  const size_t h_end = align16(s.hs + sizeof(float) * L * s.ldh);
  s.q = round_up(3 * inner, 4) <= kNC ? s.hs : h_end;
  s.p = align16(s.q + sizeof(float) * L * s.ldq);
  s.ob = align16(s.p + sizeof(float) * H * L * L);
  s.os = align16(s.ob + sizeof(float) * L * s.ldo);
  const size_t attn_end = align16(s.os + sizeof(float) * L * s.ldo);
  s.fs = align16(sizeof(float) * L * s.ldf);
  const size_t ff_end = align16(s.fs + sizeof(float) * L * s.ldf);
  s.ring = max3(h_end, attn_end, ff_end);
  s.bias = s.ring + sizeof(float) * kStages * kKC * kLdw;
  s.total = align16(s.bias + sizeof(float) * (2 * D + kSlice));
  return s;
}

struct Params {
  const float* x;      // [B, L, D]
  const float* wqkv;   // [D, nq]: wq | wk | wv, zero columns up to nq
  const float* wo;     // [I, D]
  const float* bo;     // [D]
  const float* w1;     // [D, F]
  const float* b1;     // [F]
  const float* w2;     // [F, D]
  const float* b2;     // [D]
  const float* g;      // [3]: g1, g2, gf
  float* out;          // [B, L, D]
  float* ws;           // [S + 1, B, L, D]: the FF partials, then z
  unsigned* count;     // [B]: 0 at launch, 0 again at exit
  int B, L, D, H, dh, nq, F;
  float inv_sqrt_d, attn_scale;
};

__device__ __forceinline__ float gelu_tanh(float v) {
  const float c = 0.7978845608028654f;   // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// g / max(sqrt(ss) * inv_sqrt_d, 1e-5): the ScaleNorm factor of a row
__device__ __forceinline__ float sn_scale(float ss, float inv_sqrt_d,
                                          float g) {
  return g / fmaxf(sqrtf(ss) * inv_sqrt_d, 1e-5f);
}

// The TF32 parts of v · k, four values
__device__ __forceinline__ void split4(float4 v, float k, float4& big,
                                       float4& small) {
  uint32_t b, s;
  split_tf32(v.x * k, b, s);
  big.x = __uint_as_float(b);
  small.x = __uint_as_float(s);
  split_tf32(v.y * k, b, s);
  big.y = __uint_as_float(b);
  small.y = __uint_as_float(s);
  split_tf32(v.z * k, b, s);
  big.z = __uint_as_float(b);
  small.z = __uint_as_float(s);
  split_tf32(v.w * k, b, s);
  big.w = __uint_as_float(b);
  small.w = __uint_as_float(s);
}

// dst[r][:D] = src[r][:D] for the L rows of src ([L][D] float32 in device
// memory, D % 4 == 0) into shared memory rows of stride ldd: 16-byte
// cp.async copies, one commit group.
__device__ __forceinline__ void copy_rows(const float* src, int L, int D,
                                          float* dst, int ldd) {
  const int n4 = D / 4;
  for (int i = threadIdx.x; i < L * n4; i += kThreads) {
    const int r = i / n4, c = (i % n4) * 4;
    cp_async16(smem_u32(dst + r * ldd + c), src + (size_t)r * D + c, true);
  }
  cp_async_commit();
}

// For the L rows of src ([L][lds] float32, D % 4 == 0), one warp a row:
// big[r], small[r] = the TF32 parts of src[r] · SN factor (row stride ldd,
// zero in columns D..k8); with copy set, src's row is also written to
// copy[r] ([L][D]). big may be src itself: each lane reads and writes the
// same four columns, after the row's norm is whole.
__device__ __forceinline__ void scalenorm_split_rows(
    const float* src, int lds, int L, int D, int k8, float inv_sqrt_d,
    float g, float* big, float* small, int ldd, float* copy) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n4 = D / 4;
  for (int r = warp; r < L; r += kWarps) {
    const float4* row = reinterpret_cast<const float4*>(src + (size_t)r * lds);
    float ss = 0.f;
#pragma unroll 4
    for (int c = lane; c < n4; c += 32) {
      const float4 v = row[c];
      ss = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, ss))));
    }
    const float k = sn_scale(warp_sum(ss), inv_sqrt_d, g);
    float4* bo = reinterpret_cast<float4*>(big + (size_t)r * ldd);
    float4* so = reinterpret_cast<float4*>(small + (size_t)r * ldd);
    float4* co = copy ? reinterpret_cast<float4*>(copy + (size_t)r * D)
                      : nullptr;
#pragma unroll 4
    for (int c = lane; c < n4; c += 32) {
      const float4 v = row[c];
      if (co) co[c] = v;
      float4 b, s;
      split4(v, k, b, s);
      bo[c] = b;
      so[c] = s;
    }
    for (int c = n4 + lane; c < k8 / 4; c += 32) {
      bo[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      so[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// acc[m][j] += A[m16 tile m] · B[n8 tile j] over `steps` k-steps of 8 from
// column k0 of A and row 0 of the staged W tile st, in the standard k order
// (a0 = A[g][t], a2 = A[g][t + 4]; b0 = B[t][g], b1 = B[t + 4][g]). A: each
// TF32 part's fragment one ldmatrix.x4 from the lane's row offset arow[m]
// (a 32-bit value is two b16 halves, so the four 8 x 8 b16 matrices are
// rows 0-7 and 8-15 of the tile by columns 0-3 and 4-7: a0..a3 in order).
// B: two 4-byte loads a tile from column n0 + 8 j + g, split as they are
// read. The products are issued a kind at a time (small·big, big·small,
// big·big over every tile), so that no product waits on the one before it.
template <int MT, int NN>
__device__ __forceinline__ void mma_tile(float (&acc)[MT][2][4],
                                         const float* Ab, const float* As,
                                         const int (&arow)[MT], int k0,
                                         const float* st, int n0, int steps,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int ks = 0; ks < steps; ++ks) {
    uint32_t bb[NN][2], bs[NN][2];
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      const float* col = st + (ks * 8 + t) * kLdw + n0 + j * 8 + g;
      split_tf32(col[0], bb[j][0], bs[j][0]);
      split_tf32(col[4 * kLdw], bb[j][1], bs[j][1]);
    }
    uint32_t ab[MT][4], as[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      ldsm_x4(ab[m], smem_u32(Ab + arow[m] + k0 + ks * 8));
      ldsm_x4(as[m], smem_u32(As + arow[m] + k0 + ks * 8));
    }
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        mma_tf32_m16n8k8(acc[m][j], as[m], bb[j][0], bb[j][1]);
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        mma_tf32_m16n8k8(acc[m][j], ab[m], bs[j][0], bs[j][1]);
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        mma_tf32_m16n8k8(acc[m][j], ab[m], bb[j][0], bb[j][1]);
  }
}

// out[Mp, N] = A[Mp, K] · W[K, N] on 3xTF32 mma.sync. A: its TF32 parts Ab,
// As in shared memory, L rows of stride lda, zero in columns K..round8(K).
// W: float32 [K][ldw] in device memory, 16-byte aligned rows, N % 4 == 0.
// W goes through the ring in tiles of kKC k-rows x kNC columns, n-chunk
// major; rows past K and columns past N are zero-filled. Each n-chunk's
// sums go to epi(row, col, v[col], v[col + 1]) for every row < Mp and even
// col < N, after every warp is done with the chunk (so an epilogue may
// write over A once its last chunk is done); run() returns after a barrier,
// with every epilogue's writes visible. The caller issues the first
// kStages - 1 tiles with prefetch() (ahead of other work, while the ring is
// free) and syncs A's writes before run().
struct Gemm {
  const float* Ab;
  const float* As;
  int lda, L, K;
  const float* W;
  int ldw, N;
  float* ring;

  __device__ __forceinline__ int k8() const { return round_up(K, 8); }
  __device__ __forceinline__ int nkc() const {
    return (k8() + kKC - 1) / kKC;
  }
  __device__ __forceinline__ int tiles() const {
    return nkc() * ((N + kNC - 1) / kNC);
  }

  // tile t into its stage, one commit group (empty past the last tile, so
  // that the count of groups stays that of tiles)
  __device__ __forceinline__ void issue(int t) const {
    if (t < tiles()) {
      const int k0 = (t % nkc()) * kKC, n0 = (t / nkc()) * kNC;
      const int rows = min(kKC, k8() - k0);
      const uint32_t dst = smem_u32(ring + (t % kStages) * (kKC * kLdw));
      for (int i = threadIdx.x; i < rows * (kNC / 4); i += kThreads) {
        const int r = i / (kNC / 4), c = (i % (kNC / 4)) * 4;
        const int k = k0 + r, n = n0 + c;
        const bool valid = k < K && n < N;
        cp_async16(dst + (uint32_t)(r * kLdw + c) * 4,
                   valid ? W + (size_t)k * ldw + n : W, valid);
      }
    }
    cp_async_commit();
  }

  __device__ __forceinline__ void prefetch() const {
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) issue(t);
  }

  template <int MT, typename Epi>
  __device__ __forceinline__ void run(Epi epi) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int n_kc = nkc(), total = tiles(), kk = k8();
    // the row (clamped to L - 1) and column offset of this lane's ldmatrix
    // address in each m16 tile
    int arow[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      arow[m] = min(m * 16 + (lane & 15), L - 1) * lda + (lane >> 4) * 4;
    float acc[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
    for (int t = 0; t < total; ++t) {
      issue(t + kStages - 1);
      cp_async_wait<kStages - 1>();    // tile t has landed
      __syncthreads();
      const int k0 = (t % n_kc) * kKC, n0 = (t / n_kc) * kNC;
      const int col = n0 + warp * 16;
      if (col < N) {
        const float* st = ring + (t % kStages) * (kKC * kLdw);
        const int steps = min(kKC, kk - k0) / 8;
        if (col + 8 < N)                // both n8 tiles inside N
          mma_tile<MT, 2>(acc, Ab, As, arow, k0, st, warp * 16, steps, lane);
        else
          mma_tile<MT, 1>(acc, Ab, As, arow, k0, st, warp * 16, steps, lane);
      }
      __syncthreads();                  // the stage and A are free again
      if (t % n_kc == n_kc - 1) {       // this n-chunk's sums are whole
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = col + j * 8 + 2 * tq;
            if (c < N) {
              epi(m * 16 + g, c, acc[m][j][0], acc[m][j][1]);
              epi(m * 16 + g + 8, c, acc[m][j][2], acc[m][j][3]);
            }
            acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
          }
        }
      }
    }
    __syncthreads();                    // the last epilogue's writes
  }
};

// MT: the m16 row tiles, (L + 15) / 16
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
    dual_axis_block_tf32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int L = p.L, D = p.D, H = p.H, dh = p.dh, inner = H * dh;
  const Layout lay = make_layout(L, D, H, dh);
  // h_big, then z, then h2_big, then f_big; h_small, then h2_small
  float* big = reinterpret_cast<float*>(smem);
  float* small = reinterpret_cast<float*>(smem + lay.hs);
  float* qkv = reinterpret_cast<float*>(smem + lay.q);
  float* ps = reinterpret_cast<float*>(smem + lay.p);
  float* ob = reinterpret_cast<float*>(smem + lay.ob);
  float* os = reinterpret_cast<float*>(smem + lay.os);
  float* fs = reinterpret_cast<float*>(smem + lay.fs);
  float* ring = reinterpret_cast<float*>(smem + lay.ring);
  float* bo_s = reinterpret_cast<float*>(smem + lay.bias);
  float* b2_s = bo_s + D;
  float* b1_s = b2_s + D;
  const int b = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int h0 = s * kSlice;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ldh = lay.ldh, ldq = lay.ldq, ldo = lay.ldo, ldf = lay.ldf;
  const int k8d = round_up(D, 8), k8i = round_up(inner, 8);
  const float g1 = p.g[0], g2 = p.g[1], gf = p.g[2];
  const float* xb = p.x + (size_t)b * L * D;
  STAMP(0);

  const Gemm qkv_mm{big, small, ldh, L, D, p.wqkv, p.nq, p.nq, ring};
  copy_rows(xb, L, D, big, ldh);        // x[b] over h_big
  qkv_mm.prefetch();
  cp_async_wait<kStages - 1>();         // x has landed (W's tiles may not)
  __syncthreads();
  // h = SN1(x) in place, split; the biases staged
  scalenorm_split_rows(big, ldh, L, D, k8d, p.inv_sqrt_d, g1, big, small,
                       ldh, nullptr);
  for (int i = threadIdx.x; i < D; i += kThreads) {
    bo_s[i] = p.bo[i];
    b2_s[i] = p.b2[i];
  }
  for (int i = threadIdx.x; i < kSlice; i += kThreads)
    b1_s[i] = p.b1[h0 + i];
  __syncthreads();
  STAMP(1);                             // h = SN1(x)
  qkv_mm.run<MT>([=](int r, int n, float v0, float v1) {
    if (r < L) {
      if (n < 3 * inner) qkv[r * ldq + n] = v0;
      if (n + 1 < 3 * inner) qkv[r * ldq + n + 1] = v1;
    }
  });

  STAMP(2);                             // QKV
  const Gemm out_mm{ob, os, ldo, L, inner, p.wo, D, D, ring};
  // x[b] again over h_big, for the residual: it lands under the attention
  // core, a commit group ahead of out_mm's tiles
  copy_rows(xb, L, D, big, ldh);
  out_mm.prefetch();
  // P[h][i][:] = softmax_j((q_i . k_j) * d_head^-1/2) over the L keys, one
  // warp a (head, query) row, keys j and j + 32 on lane j (L <= 64)
  for (int row = warp; row < H * L; row += kWarps) {
    const int hh = row / L, qi = row % L;
    const float* qp = qkv + qi * ldq + hh * dh;
    const float* k0 = qkv + lane * ldq + inner + hh * dh;
    const float* k1 = k0 + 32 * ldq;
    const bool in0 = lane < L, in1 = lane + 32 < L;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      const float q = qp[d];
      if (in0) s0 = fmaf(q, k0[d], s0);
      if (in1) s1 = fmaf(q, k1[d], s1);
    }
    const float ninf = __int_as_float(0xff800000);
    s0 = in0 ? s0 * p.attn_scale : ninf;
    s1 = in1 ? s1 * p.attn_scale : ninf;
    const float m = warp_max(fmaxf(s0, s1));
    const float e0 = in0 ? expf(s0 - m) : 0.f;
    const float e1 = in1 ? expf(s1 - m) : 0.f;
    const float sum = warp_sum(e0 + e1);
    float* pr = ps + (size_t)row * L;
    if (in0) pr[lane] = e0 / sum;
    if (in1) pr[lane + 32] = e1 / sum;
  }
  __syncthreads();
  STAMP(3);                             // scores and softmax
  // o[i][h*dh + d] = sum_j P[h][i][j] v[j][h*dh + d], split; zero in the
  // columns inner..round8(inner)
  for (int i = threadIdx.x; i < L * k8i; i += kThreads) {
    const int qi = i / k8i, c = i % k8i;
    float acc = 0.f;
    if (c < inner) {
      const float* pp = ps + ((size_t)(c / dh) * L + qi) * L;
#pragma unroll 4
      for (int kj = 0; kj < L; ++kj)
        acc = fmaf(pp[kj], qkv[kj * ldq + 2 * inner + c], acc);
    }
    uint32_t hb, hs;
    split_tf32(acc, hb, hs);
    ob[qi * ldo + c] = __uint_as_float(hb);
    os[qi * ldo + c] = __uint_as_float(hs);
  }
  __syncthreads();
  STAMP(4);                             // P . V
  out_mm.run<MT>([=](int r, int n, float v0, float v1) {
    if (r < L) {
      float2* zr = reinterpret_cast<float2*>(big + (size_t)r * ldh + n);
      const float2 xv = *zr;
      *zr = make_float2((xv.x + v0) + bo_s[n], (xv.y + v1) + bo_s[n + 1]);
    }
  });

  STAMP(5);                             // out-projection: z
  const Gemm ff1_mm{big, small, ldh, L, D, p.w1 + h0, p.F, kSlice, ring};
  ff1_mm.prefetch();
  // h2 = SN2(z) in place; block 0 of the element keeps z in slot S
  float* zslot = p.ws + ((size_t)S * p.B + b) * L * D;
  scalenorm_split_rows(big, ldh, L, D, k8d, p.inv_sqrt_d, g2, big, small,
                       ldh, s == 0 ? zslot : nullptr);
  __syncthreads();
  STAMP(6);                             // SN2
  ff1_mm.run<MT>([=](int r, int n, float v0, float v1) {
    if (r < L) {
      uint32_t b0, s0, b1, s1;
      split_tf32(gelu_tanh(v0 + b1_s[n]), b0, s0);
      split_tf32(gelu_tanh(v1 + b1_s[n + 1]), b1, s1);
      *reinterpret_cast<uint2*>(big + r * ldf + n) = make_uint2(b0, b1);
      *reinterpret_cast<uint2*>(fs + r * ldf + n) = make_uint2(s0, s1);
    }
  });

  STAMP(7);                             // FF1
  const Gemm ff2_mm{big, fs, ldf, L, kSlice, p.w2 + (size_t)h0 * D, D, D,
                    ring};
  ff2_mm.prefetch();
  float* part = p.ws + ((size_t)s * p.B + b) * L * D;
  ff2_mm.run<MT>([=](int r, int n, float v0, float v1) {
    if (r < L)
      *reinterpret_cast<float2*>(part + (size_t)r * D + n) =
          make_float2(v0, v1);
  });

  STAMP(8);                             // FF2
  // the last block of element b to arrive sums the partials in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(p.count + b, 1u) == (unsigned)(S - 1);
  __syncthreads();
  STAMP(9);                             // the arrival counter
  if (!last) return;
  __threadfence();
  float* ys = big;                      // y before SNf, [L][D]
  {  // z + (partial 0 + ... + partial S-1) + b2: kU float4s a thread at a
     // time, z's and up to kT partials' loads of them in flight together
    constexpr int kU = 4, kT = 4;
    const int n4 = L * D / 4;
    const size_t stride = (size_t)p.B * L * D / 4;     // one slot
    const float4* wb =
        reinterpret_cast<const float4*>(p.ws + (size_t)b * L * D);
    float4* y4 = reinterpret_cast<float4*>(ys);
    for (int i0 = threadIdx.x; i0 < n4; i0 += kU * kThreads) {
      float4 z[kU], a[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (i0 + u * kThreads < n4) z[u] = __ldcg(wb + S * stride + i0 +
                                                 u * kThreads);
      for (int t = 0; t < S; t += kT) {
        float4 v[kT][kU];
#pragma unroll
        for (int j = 0; j < kT; ++j)
#pragma unroll
          for (int u = 0; u < kU; ++u)
            if (t + j < S && i0 + u * kThreads < n4)
              v[j][u] = __ldcg(wb + (t + j) * stride + i0 + u * kThreads);
#pragma unroll
        for (int j = 0; j < kT; ++j) {
          if (t + j < S) {
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              if (t + j == 0) {
                a[u] = v[0][u];
              } else {
                a[u].x += v[j][u].x;
                a[u].y += v[j][u].y;
                a[u].z += v[j][u].z;
                a[u].w += v[j][u].w;
              }
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n4) {
          const float* bb = b2_s + (i * 4) % D;
          y4[i] = make_float4((z[u].x + a[u].x) + bb[0],
                              (z[u].y + a[u].y) + bb[1],
                              (z[u].z + a[u].z) + bb[2],
                              (z[u].w + a[u].w) + bb[3]);
        }
      }
    }
  }
  STAMP(10);                            // the sum of the partials
  if (threadIdx.x == 0) p.count[b] = 0u;
  __syncthreads();
  {  // out = SNf(y), one warp a row
    const int n4 = D / 4;
    float* yo = p.out + (size_t)b * L * D;
    for (int r = warp; r < L; r += kWarps) {
      const float4* row = reinterpret_cast<const float4*>(ys + (size_t)r * D);
      float ss = 0.f;
#pragma unroll 4
      for (int c = lane; c < n4; c += 32) {
        const float4 v = row[c];
        ss = fmaf(v.x, v.x,
                  fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, ss))));
      }
      const float k = sn_scale(warp_sum(ss), p.inv_sqrt_d, gf);
      float4* o4 = reinterpret_cast<float4*>(yo + (size_t)r * D);
#pragma unroll 4
      for (int c = lane; c < n4; c += 32) {
        const float4 v = row[c];
        o4[c] = make_float4(v.x * k, v.y * k, v.z * k, v.w * k);
      }
    }
  }
#ifdef K3_STAMPS
  __syncthreads();
  STAMP(11);                            // SNf
#endif
}

}  // namespace

#ifdef K3_STAMPS
// Points the stamps of every later launch at buf [blocks][32] uint64.
extern "C" int set_stamps(void* buf) {
  return (int)cudaMemcpyToSymbol(g_stamps, &buf, sizeof(buf));
}
#endif

namespace {

template <int MT>
int launch(const Params& p, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dual_axis_block_tf32_kernel<MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dual_axis_block_tf32_kernel<MT><<<dim3(p.B, p.F / kSlice), kThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) one block asks for at [L, D] with H heads of dh.
extern "C" long long dual_axis_block_tf32_smem_bytes(int L, int D, int H,
                                                     int dh) {
  return (long long)make_layout(L, D, H, dh).total;
}

// x, out [B, L, D] float32; wqkv [D, nq] (wq | wk | wv, then zero columns
// up to nq, a multiple of 4); wo [H·dh, D]; bo, b2 [D]; w1 [D, F]; b1 [F];
// w2 [F, D], all float32, contiguous, 16-byte aligned; g [3] float32 (g1,
// g2, gf); ws [F / 128 + 1, B, L, D] float32 scratch; count [B] uint32,
// zero (and left zero). Takes 1 <= L <= 64, D % 4 == 0, F % 128 == 0,
// nq = 3·H·dh rounded up to 4 (the layout places q|k|v by it) and a layout
// within one block's shared memory. Returns the CUDA error of the launch (0
// on success).
extern "C" int dual_axis_block_tf32(const void* x, const void* wqkv, int nq,
                                    const void* wo, const void* bo,
                                    const void* w1, const void* b1,
                                    const void* w2, const void* b2,
                                    const void* g, void* out, void* ws,
                                    void* count, int B, int L, int D, int H,
                                    int dh, int F, float inv_sqrt_d,
                                    float attn_scale, void* stream) {
  if (B < 1 || L < 1 || L > 16 * kMaxMT || D % 4 || F < kSlice ||
      F % kSlice || nq != round_up(3 * H * dh, 4))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const float*>(x);
  p.wqkv = static_cast<const float*>(wqkv);
  p.wo = static_cast<const float*>(wo);
  p.bo = static_cast<const float*>(bo);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.g = static_cast<const float*>(g);
  p.out = static_cast<float*>(out);
  p.ws = static_cast<float*>(ws);
  p.count = static_cast<unsigned*>(count);
  p.B = B;
  p.L = L;
  p.D = D;
  p.H = H;
  p.dh = dh;
  p.nq = nq;
  p.F = F;
  p.inv_sqrt_d = inv_sqrt_d;
  p.attn_scale = attn_scale;
  const Layout lay = make_layout(L, D, H, dh);
  switch (lay.mt) {
    case 1: return launch<1>(p, lay.total, stream);
    case 2: return launch<2>(p, lay.total, stream);
    case 3: return launch<3>(p, lay.total, stream);
    default: return launch<4>(p, lay.total, stream);
  }
}
