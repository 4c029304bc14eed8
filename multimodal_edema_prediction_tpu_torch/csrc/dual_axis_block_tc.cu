// K3, bf16, on the tensor cores: one DuETT dual-axis encoder block, fused,
// for Hopper (sm_90a).
//
// Replaces multimodal_edema_prediction_tpu/ops/pallas_dual_axis.py
// (`_block_kernel` :78, `_fused_forward` :136, pallas_call :171,
// `fused_encoder_block` :192) for bfloat16 x with D % 8 == 0 and
// F % 128 == 0 (ops/dual_axis.py::route); float32 and every other shape
// keep the SIMT kernel of dual_axis_block.cu. Per batch element b:
//
//   z = x + Wo·MHA(SN1(x)) + bo
//   y = SNf(z + W2·gelu_tanh(W1·SN2(z) + b1) + b2)
//
// ScaleNorm SN(t) = t / max(||t|| · D^-1/2, 1e-5) · g over the true D.
//
// Arithmetic. x and every weight arrive as bf16 (the wrapper casts the
// weights, as the TPU wrapper does at :151-163); the four products take
// bf16 operands and accumulate in float32 on mma.sync m16n8k16. Their A
// operands h = SN1(x), o = MHA(h), h2 = SN2(z) and f = gelu(·) are rounded
// to bf16 once, where they are written to shared memory. Everything else is
// float32: the residual z, each ScaleNorm, q, k, v, the scores, the softmax
// (keys j >= L take no part), GELU in its tanh form (jax.nn.gelu's default),
// the sum of the FF partials and the final ScaleNorm; the output is rounded
// to bf16. Against the float32 plain version that is within the bf16
// tolerance of 2e-2 of the output's max abs.
//
// Bound on an H100: at DuETT's shapes ([B, 35, 600] event axis, [B, 25, 840]
// time axis; 2 heads x 12, F 512) the whole call at batch 32 moves ~2.7 MB
// (x, the output, the weights once), under 2 us of HBM time, and ~1 GFLOP;
// no launch gets near that. What limits a block is latency: its small
// products (M = 25 or 35 rows) wait on weight tiles from L2.
//
// Design. Grid B x S with S = F / 128: block (b, s) owns batch element b and
// hidden units [128 s, 128 s + 128) of the FF, so batch 32 gives 128 blocks
// on 132 SMs where one block per element gave 32. Each block
//   1. loads x[b] into shared memory (float32 z) and writes h = SN1(x), one
//      warp a row;
//   2. QKV = h · Wqkv (N = 72) on the tensor cores;
//   3. the attention core in float32 SIMT (2 heads x 12 is too narrow for
//      the tensor cores): one warp a (head, query) row for the scores and
//      their softmax, keys j and j + 32 on lane j (L <= 64); o = P · V,
//      rounded to bf16;
//   4. z += o · Wo + bo (K = 24, zero-filled to 32), then h2 = SN2(z);
//   5. f = gelu(h2 · W1[:, slice] + b1[slice]), kept in shared memory, and
//      its partial W2[slice, :] · f, float32 [L, D], to a workspace
//      [S, B, L, D] that the wrapper allocates;
//   6. the last of the S blocks of element b to arrive (a __threadfence and
//      a per-element counter, which that block resets to 0) sums
//      z + (partial 0 + ... + partial S-1) + b2 in that fixed order,
//      applies SNf and writes y. No float atomics: reruns are bit-equal.
// Steps 1-4 run again in each of the S blocks of an element: about 4 of
// the ~15 MFLOP a block does at [35, 600] (before padding). Exchanging z
// instead would need a second launch or a grid-wide wait between the
// attention half and the FF half, and each block would read z back
// (84 KB) from L2 after it was written: a round trip that costs about what
// the repeated ~6 MFLOP of small products cost, and an ordering the
// per-element counter cannot give (all S blocks would have to wait on one).
//
// The products. Each of the four is out[Mp, N] = A[Mp, K] · W[K, N] with A
// bf16 in shared memory (Mp = L rounded up to 16: 25 -> 32, 35 -> 48; rows
// >= L are zero and never stored) and W [K, N] row-major bf16 in device
// memory, streamed in tiles of 64 k-rows x 128 columns through a
// double-buffered cp.async ring (a third stage was no faster on the H100).
// The 8 warps each own 16 of a tile's 128 columns and every m16 row tile:
// per k16 step one ldmatrix.x4.trans for the B fragments of two n8 tiles
// and one ldmatrix.x4 per m16 tile of A. D = 600 and 840 are multiples of
// 8 but not of 16: the last k16 step of the QKV and FF1 products holds one
// valid 16-byte granule of W's rows and one that cp_async16(..., false)
// zero-fills, against A columns that are zero there. Rows of A and of the
// staged W tiles have an odd number of 16-byte granules, so ldmatrix's
// eight rows fall in distinct banks. bo, b2 and the block's slice of b1 are
// staged in shared memory as float32 for the epilogues.
//
// Built with -DK3_STAMPS (scripts/k3_phases.py does; ops/build.py never
// does), thread 0 of every block writes clock64() and %globaltimer at the
// end of each phase to a buffer set with set_stamps(); otherwise STAMP is
// empty.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;

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
constexpr int kKC = 64;                   // k-rows of a staged W tile
constexpr int kLdw = kNC + 8;             // its row stride: 17 granules
constexpr int kStages = 2;                // the W ring: double-buffered
constexpr int kMaxMT = 4;                 // m16 row tiles: L <= 64

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Row stride (elements) of a bf16 A operand of K columns: K rounded to 16,
// plus one granule, so a row spans an odd number of 16-byte granules.
__host__ __device__ constexpr int a_ld(int K) { return round_up(K, 16) + 8; }

// Shared memory of one block, byte offsets (ops/dual_axis.py::
// tc_smem_bytes mirrors it): z float32 [L][D]; h / h2 bf16 [Mp][a_ld(D)];
// a work area holding q|k|v float32 [L][3I + 1] (an odd stride: a warp's
// lanes read 32 rows without bank conflicts), the softmax P [H][L][L] and
// o bf16 [Mp][a_ld(I)], or later f bf16 [Mp][a_ld(128)]; the W ring; bo, b2
// and this block's slice of b1 in float32.
struct Layout {
  int mt, ldh, ldq, ldo, ldf;
  size_t z, h, q, p, o, f, ring, bias, total;
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

__host__ __device__ inline Layout make_layout(int L, int D, int H, int dh) {
  Layout s;
  const int inner = H * dh;
  s.mt = (L + 15) / 16;
  const int mp = s.mt * 16;
  s.ldh = a_ld(D);
  s.ldq = 3 * inner + 1;
  s.ldo = a_ld(inner);
  s.ldf = a_ld(kSlice);
  s.z = 0;
  s.h = align16(s.z + sizeof(float) * L * D);
  const size_t work = align16(s.h + sizeof(bf16) * mp * s.ldh);
  s.q = work;
  s.p = align16(s.q + sizeof(float) * L * s.ldq);
  s.o = align16(s.p + sizeof(float) * H * L * L);
  const size_t attn_end = align16(s.o + sizeof(bf16) * mp * s.ldo);
  s.f = work;
  const size_t ff_end = align16(s.f + sizeof(bf16) * mp * s.ldf);
  s.ring = attn_end > ff_end ? attn_end : ff_end;
  s.bias = s.ring + sizeof(bf16) * kStages * kKC * kLdw;
  s.total = align16(s.bias + sizeof(float) * (2 * D + kSlice));
  return s;
}

struct Params {
  const bf16* x;       // [B, L, D]
  const bf16* wqkv;    // [D, nq]: wq | wk | wv, zero columns up to nq
  const bf16* wo;      // [I, D]
  const bf16* bo;      // [D]
  const bf16* w1;      // [D, F]
  const bf16* b1;      // [F]
  const bf16* w2;      // [F, D]
  const bf16* b2;      // [D]
  const float* g;      // [3]: g1, g2, gf
  bf16* out;           // [B, L, D]
  float* ws;           // [S, B, L, D]: the FF partials
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

__device__ __forceinline__ uint2 pack4(float4 v, float k) {
  return make_uint2(pack_bf16(v.x * k, v.y * k), pack_bf16(v.z * k, v.w * k));
}

// dst[r] = bf16(src[r] · SN factor) for the L float32 rows of src ([L][D],
// contiguous, D % 4 == 0), one warp a row, four columns a lane at a time.
__device__ __forceinline__ void scalenorm_rows(const float* src, int L, int D,
                                               float inv_sqrt_d, float g,
                                               bf16* dst, int ldd) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n4 = D / 4;
  for (int r = warp; r < L; r += kWarps) {
    const float4* row = reinterpret_cast<const float4*>(src + (size_t)r * D);
    float ss = 0.f;
#pragma unroll 4
    for (int c = lane; c < n4; c += 32) {
      const float4 v = row[c];
      ss = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, ss))));
    }
    const float k = sn_scale(warp_sum(ss), inv_sqrt_d, g);
    uint2* out = reinterpret_cast<uint2*>(dst + (size_t)r * ldd);
#pragma unroll 4
    for (int c = lane; c < n4; c += 32) out[c] = pack4(row[c], k);
  }
}

// out[Mp, N] = A[Mp, K] · W[K, N] on mma.sync. A: bf16 in shared memory,
// mt m16 tiles of rows, row stride lda = a_ld(K), zero in columns
// K..round16(K). W: bf16 [K][ldw] in device memory, 16-byte aligned rows,
// N % 8 == 0. W goes through the ring in tiles of kKC k-rows x kNC columns,
// n-chunk major; rows past K and columns past N are zero-filled. Each
// n-chunk's sums go to epi(row, col, v[col], v[col + 1]) for every row
// < Mp and even col < N. The caller issues the first kStages - 1 tiles
// with prefetch() (ahead of other work, while the ring is free) and syncs
// A's writes before run().
struct Gemm {
  const bf16* A;
  int lda, mt, K;
  const bf16* W;
  int ldw, N;
  bf16* ring;

  __device__ __forceinline__ int k16() const { return round_up(K, 16); }
  __device__ __forceinline__ int nkc() const {
    return (k16() + kKC - 1) / kKC;
  }
  __device__ __forceinline__ int tiles() const {
    return nkc() * ((N + kNC - 1) / kNC);
  }

  // tile t into its stage, one commit group (empty past the last tile, so
  // that the count of groups stays that of tiles)
  __device__ __forceinline__ void issue(int t) const {
    if (t < tiles()) {
      const int k0 = (t % nkc()) * kKC, n0 = (t / nkc()) * kNC;
      const int rows = min(kKC, k16() - k0);
      const uint32_t dst = smem_u32(ring + (t % kStages) * (kKC * kLdw));
      for (int i = threadIdx.x; i < rows * (kNC / 8); i += kThreads) {
        const int r = i / (kNC / 8), c = (i % (kNC / 8)) * 8;
        const int k = k0 + r, n = n0 + c;
        const bool valid = k < K && n < N;
        cp_async16(dst + (uint32_t)(r * kLdw + c) * 2,
                   valid ? W + (size_t)k * ldw + n : W, valid);
      }
    }
    cp_async_commit();
  }

  __device__ __forceinline__ void prefetch() const {
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) issue(t);
  }

  template <typename Epi>
  __device__ __forceinline__ void run(Epi epi) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3, lr = lane & 7, lm = lane >> 3;
    const int n_kc = nkc(), total = tiles(), kk = k16();
    float acc[kMaxMT][2][4];
#pragma unroll
    for (int m = 0; m < kMaxMT; ++m)
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
        const bf16* st = ring + (t % kStages) * (kKC * kLdw);
        const int steps = min(kKC, kk - k0) / 16;
        for (int ks = 0; ks < steps; ++ks) {
          uint32_t b[4];
          ldsm_x4_trans(b, smem_u32(st + (ks * 16 + (lm & 1) * 8 + lr) * kLdw
                                    + warp * 16 + (lm >> 1) * 8));
#pragma unroll
          for (int m = 0; m < kMaxMT; ++m) {
            if (m < mt) {
              uint32_t a[4];
              ldsm_x4(a, smem_u32(A + (m * 16 + (lane & 15)) * lda + k0
                                  + ks * 16 + (lane >> 4) * 8));
              mma_bf16(acc[m][0], a, b[0], b[1]);
              mma_bf16(acc[m][1], a, b[2], b[3]);
            }
          }
        }
      }
      if (t % n_kc == n_kc - 1) {       // this n-chunk's sums are whole
#pragma unroll
        for (int m = 0; m < kMaxMT; ++m) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = col + j * 8 + 2 * tq;
            if (m < mt && c < N) {
              epi(m * 16 + g, c, acc[m][j][0], acc[m][j][1]);
              epi(m * 16 + g + 8, c, acc[m][j][2], acc[m][j][3]);
            }
            acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
          }
        }
      }
      __syncthreads();                  // the stage is free again
    }
  }
};

__global__ void __launch_bounds__(kThreads, 1)
    dual_axis_block_tc_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int L = p.L, D = p.D, H = p.H, dh = p.dh, inner = H * dh;
  const Layout lay = make_layout(L, D, H, dh);
  float* zs = reinterpret_cast<float*>(smem + lay.z);
  bf16* hs = reinterpret_cast<bf16*>(smem + lay.h);
  float* qkv = reinterpret_cast<float*>(smem + lay.q);
  float* ps = reinterpret_cast<float*>(smem + lay.p);
  bf16* os = reinterpret_cast<bf16*>(smem + lay.o);
  bf16* fs = reinterpret_cast<bf16*>(smem + lay.f);
  bf16* ring = reinterpret_cast<bf16*>(smem + lay.ring);
  float* bo_s = reinterpret_cast<float*>(smem + lay.bias);
  float* b2_s = bo_s + D;
  float* b1_s = b2_s + D;
  const int b = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int h0 = s * kSlice;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mp = lay.mt * 16, ldh = lay.ldh, ldq = lay.ldq, ldo = lay.ldo;
  const int ldf = lay.ldf;
  const float g1 = p.g[0], g2 = p.g[1], gf = p.g[2];
  STAMP(0);

  const Gemm qkv_mm{hs, ldh, lay.mt, D, p.wqkv, p.nq, p.nq, ring};
  qkv_mm.prefetch();
  {  // x[b] -> z (float32) and h = SN1(x) (bf16), one warp a row; the pad
     // rows and columns of h and o zeroed; the biases staged as float32
    const uint4* xb = reinterpret_cast<const uint4*>(p.x + (size_t)b * L * D);
    const int n8 = D / 8;
    for (int r = warp; r < L; r += kWarps) {
      float4* zr = reinterpret_cast<float4*>(zs + (size_t)r * D);
      float ss = 0.f;
#pragma unroll 4
      for (int c = lane; c < n8; c += 32) {
        const uint4 v = xb[r * n8 + c];
        const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v);
        const float2 a0 = __bfloat1622float2(e[0]);
        const float2 a1 = __bfloat1622float2(e[1]);
        const float2 a2 = __bfloat1622float2(e[2]);
        const float2 a3 = __bfloat1622float2(e[3]);
        zr[2 * c] = make_float4(a0.x, a0.y, a1.x, a1.y);
        zr[2 * c + 1] = make_float4(a2.x, a2.y, a3.x, a3.y);
        ss = fmaf(a0.x, a0.x, fmaf(a0.y, a0.y, fmaf(a1.x, a1.x, fmaf(
            a1.y, a1.y, ss))));
        ss = fmaf(a2.x, a2.x, fmaf(a2.y, a2.y, fmaf(a3.x, a3.x, fmaf(
            a3.y, a3.y, ss))));
      }
      const float k = sn_scale(warp_sum(ss), p.inv_sqrt_d, g1);
      __syncwarp();                     // z's row, written lane by lane
      uint2* hr = reinterpret_cast<uint2*>(hs + (size_t)r * ldh);
#pragma unroll 4
      for (int c = lane; c < 2 * n8; c += 32) hr[c] = pack4(zr[c], k);
      for (int c = 2 * n8 + lane; c < ldh / 4; c += 32)
        hr[c] = make_uint2(0, 0);
    }
    uint4* hz = reinterpret_cast<uint4*>(hs + (size_t)L * ldh);
    for (int i = threadIdx.x; i < (mp - L) * ldh / 8; i += kThreads)
      hz[i] = make_uint4(0, 0, 0, 0);
    uint4* oz = reinterpret_cast<uint4*>(os);
    for (int i = threadIdx.x; i < mp * ldo / 8; i += kThreads)
      oz[i] = make_uint4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < D; i += kThreads) {
      bo_s[i] = __bfloat162float(p.bo[i]);
      b2_s[i] = __bfloat162float(p.b2[i]);
    }
    for (int i = threadIdx.x; i < kSlice; i += kThreads)
      b1_s[i] = __bfloat162float(p.b1[h0 + i]);
  }
  __syncthreads();
  STAMP(1);                             // x loaded, h = SN1(x)
  qkv_mm.run([=](int r, int n, float v0, float v1) {
    if (r < L) {
      if (n < 3 * inner) qkv[r * ldq + n] = v0;
      if (n + 1 < 3 * inner) qkv[r * ldq + n + 1] = v1;
    }
  });

  STAMP(2);                             // QKV
  const Gemm out_mm{os, ldo, lay.mt, inner, p.wo, D, D, ring};
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
  // o[i][h*dh + d] = sum_j P[h][i][j] v[j][h*dh + d], rounded to bf16
  for (int i = threadIdx.x; i < L * inner; i += kThreads) {
    const int qi = i / inner, c = i % inner, hh = c / dh;
    const float* pp = ps + ((size_t)hh * L + qi) * L;
    float acc = 0.f;
#pragma unroll 4
    for (int kj = 0; kj < L; ++kj)
      acc = fmaf(pp[kj], qkv[kj * ldq + 2 * inner + c], acc);
    os[qi * ldo + c] = __float2bfloat16(acc);
  }
  __syncthreads();
  STAMP(4);                             // P . V
  out_mm.run([=](int r, int n, float v0, float v1) {
    if (r < L) {
      float2* zr = reinterpret_cast<float2*>(zs + (size_t)r * D + n);
      const float2 z = *zr;
      *zr = make_float2((z.x + v0) + bo_s[n], (z.y + v1) + bo_s[n + 1]);
    }
  });

  STAMP(5);                             // out-projection
  const Gemm ff1_mm{hs, ldh, lay.mt, D, p.w1 + h0, p.F, kSlice, ring};
  ff1_mm.prefetch();
  scalenorm_rows(zs, L, D, p.inv_sqrt_d, g2, hs, ldh);
  __syncthreads();
  STAMP(6);                             // SN2
  ff1_mm.run([=](int r, int n, float v0, float v1) {
    const uint32_t f2 = r < L ? pack_bf16(gelu_tanh(v0 + b1_s[n]),
                                          gelu_tanh(v1 + b1_s[n + 1]))
                              : 0u;
    *reinterpret_cast<uint32_t*>(fs + r * ldf + n) = f2;
  });

  STAMP(7);                             // FF1
  const Gemm ff2_mm{fs, ldf, lay.mt, kSlice, p.w2 + (size_t)h0 * D, D, D,
                    ring};
  ff2_mm.prefetch();                    // f is synced by ff1_mm.run
  float* part = p.ws + ((size_t)s * p.B + b) * L * D;
  ff2_mm.run([=](int r, int n, float v0, float v1) {
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
  {  // z + (partial 0 + ... + partial S-1) + b2: kU float4s a thread at a
     // time, with up to kT partials of each in flight together
    constexpr int kU = 4, kT = 3;
    const int n4 = L * D / 4;
    const size_t stride = (size_t)p.B * L * D / 4;     // one partial
    const float4* wb =
        reinterpret_cast<const float4*>(p.ws + (size_t)b * L * D);
    float4* z4 = reinterpret_cast<float4*>(zs);
    for (int i0 = threadIdx.x; i0 < n4; i0 += kU * kThreads) {
      float4 a[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (i0 + u * kThreads < n4) a[u] = __ldcg(wb + i0 + u * kThreads);
      for (int t = 1; t < S; t += kT) {
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
              a[u].x += v[j][u].x;
              a[u].y += v[j][u].y;
              a[u].z += v[j][u].z;
              a[u].w += v[j][u].w;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n4) {
          const float* bb = b2_s + (i * 4) % D;
          float4 z = z4[i];
          z.x = (z.x + a[u].x) + bb[0];
          z.y = (z.y + a[u].y) + bb[1];
          z.z = (z.z + a[u].z) + bb[2];
          z.w = (z.w + a[u].w) + bb[3];
          z4[i] = z;
        }
      }
    }
  }
  STAMP(10);                            // the sum of the partials
  if (threadIdx.x == 0) p.count[b] = 0u;
  __syncthreads();
  scalenorm_rows(zs, L, D, p.inv_sqrt_d, gf, p.out + (size_t)b * L * D, D);
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

// Shared memory (bytes) one block asks for at [L, D] with H heads of dh.
extern "C" long long dual_axis_block_tc_smem_bytes(int L, int D, int H,
                                                   int dh) {
  return (long long)make_layout(L, D, H, dh).total;
}

// x, out [B, L, D] bf16; wqkv [D, nq] bf16 (wq | wk | wv, then zero columns
// up to nq, a multiple of 8); wo [H·dh, D]; bo, b2 [D]; w1 [D, F]; b1 [F];
// w2 [F, D], all bf16, contiguous, 16-byte aligned; g [3] float32 (g1, g2,
// gf); ws [F / 128, B, L, D] float32 scratch; count [B] uint32, zero (and
// left zero). Takes 1 <= L <= 64, D % 8 == 0, F % 128 == 0. Returns the
// CUDA error of the launch (0 on success).
extern "C" int dual_axis_block_tc(const void* x, const void* wqkv, int nq,
                                  const void* wo, const void* bo,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* b2,
                                  const void* g, void* out, void* ws,
                                  void* count, int B, int L, int D, int H,
                                  int dh, int F, float inv_sqrt_d,
                                  float attn_scale, void* stream) {
  if (B < 1 || L < 1 || L > 16 * kMaxMT || D % 8 || F < kSlice ||
      F % kSlice || nq % 8 || nq < 3 * H * dh)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.wqkv = static_cast<const bf16*>(wqkv);
  p.wo = static_cast<const bf16*>(wo);
  p.bo = static_cast<const bf16*>(bo);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const bf16*>(b2);
  p.g = static_cast<const float*>(g);
  p.out = static_cast<bf16*>(out);
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
  const size_t smem = make_layout(L, D, H, dh).total;
  cudaError_t err = cudaFuncSetAttribute(
      dual_axis_block_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dual_axis_block_tc_kernel<<<dim3(B, F / kSlice), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
