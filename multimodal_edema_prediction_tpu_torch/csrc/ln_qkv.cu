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
// bound it (0.176 ms at 989 TFLOP/s). The bf16 kernel is a warp-specialised
// GEMM over the B·N token rows with the LayerNorm folded into its A operand
// (wgmma and TMA, the building blocks of wgmma_bf16.cuh):
// - A block owns 128 token rows of [B·N, D] and every output column: two
//   consumer warpgroups of 64 rows and a producer warpgroup, whose
//   registers go to the consumers (setmaxnreg 40 / 232).
// - Prologue: each consumer warp takes the float32 mean and 1/sqrt(biased
//   variance + eps) of 16 rows, two rows at a time held in registers from
//   16-byte loads of x, into shared memory, beside the LN scale and bias
//   (zero past D). The producer's first loads run under it.
// - The producer thread streams, per stage, the x tile [128 rows][64 of the
//   depth] (one 2-D tensor-map box) and the W boxes [64 of the depth][256
//   columns] (4 boxes of a 3-D map of W [3, D, H·64]), all in the 128-byte
//   swizzle, into a ring of 4 stages of 48 KB guarded by mbarriers (full:
//   TMA's byte count; empty: every consumer warp done). Rows past B·N and
//   depth past D read 0. A ring this deep is what keeping the whole of h
//   resident in shared memory (192 KB) left no room for: with 32 KB of W in
//   flight, waiting on W bounded that design (PERF.md).
// - Per stage each consumer thread normalises 4 16-byte chunks of one of
//   its warpgroup's rows in place, h = (x - mean) rstd scale + bias in
//   float32, rounded to bf16 (the reference's h), fences them for the
//   async proxy and meets its warpgroup at a named barrier; then 4 wgmma
//   m64n256k16, A (h, K-major) and B (W, MN-major) from shared memory,
//   float32 accumulators. A stage's products are issued while the previous
//   stage's retire (wait_group 1), which then frees that stage. x is read
//   from L2 again for each column tile, W once per block.
// - Blocks start at different column tiles and walk them cyclically, so
//   that the SMs do not all read the same W lines at once.
// - Epilogue per column tile: the bias (loaded under the last products)
//   added in float32, rounded to bf16; each quad of threads transposes its
//   packed pairs with shuffles, so that a thread writes 16 contiguous bytes
//   of a row of one head's [N, 64] slab of out[3, B, H, N, 64] (an output
//   tile staged in shared memory for TMA stores, at the cost of a ring
//   stage, ran slower on an H100); rows past B·N are not written. No
//   atomics, so reruns are bit-equal.
//
// float32 (the reference-precision path): the same GEMM with the same
// LayerNorm, its products on the tensor cores to float32 accuracy (3xTF32
// mma.sync m16n8k8, mma_tf32.cuh). At [32, 1536, 768] float32 the FMA
// bound is 2.6 ms and that of the TF32 products 1.05 ms; the first
// design, SIMT FMA with W re-staged a 32 x 64 tile at a time and 9 shared
// loads per 8 FMAs, never came near the first.
// - A block owns 128 token rows and 256 output columns (4 heads); the
//   grid walks the column tiles fastest, so that the blocks of one row
//   tile run together and read x from L2. 8 warps, 2 along the rows x 4
//   along the columns, each a 64 x 64 accumulator.
// - The float32 mean and 1/sqrt(biased variance + eps) of every row come
//   first, from a kernel of their own (ln_stats_f32: a warp a row, two
//   passes as the reference takes them) into a scratch the wrapper
//   allocates: taken in each GEMM block, they cost every column tile two
//   more reads of its x rows, and the L2 traffic of those reads bounded
//   the kernel.
// - x tiles [128][32] and W tiles [32][256] come in by 16-byte cp.async
//   into a 3-stage ring, rows padded so that the fragment loads meet no
//   bank conflict; rows past B·N and columns past 3·H·64 read 0.
// - As an x tile lands it is normalised in shared memory, h = (x - mean)
//   rstd scale + bias in float32, and split once into TF32 big (in place)
//   and small parts; W's fragments are split as they are loaded. Each
//   thread normalises the chunks it copied itself, so one barrier a tile
//   does: a warp normalises the next tile while others still multiply.
// - The products go straight into the accumulators, a kind at a time over
//   the warp's 32 accumulator tiles (mma_3xtf32_sweep), so that no product
//   waits on the one before it: issued a k-step's three at a time into
//   one tile, each waiting on the last, they ran 1.25x slower on an H100.
//   The tensor cores' truncated adds along a chain of depth D stay far
//   inside the 1e-4 of max abs that K4 is held to.
// - Epilogue: the bias in float32, a float2 per row and column pair
//   straight into out[3, B, H, N, 64] (row m is (m / N, m % N), so a tile
//   may span batch elements); rows past B·N are not written. No atomics.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: 128-token tiles, x and W streamed by TMA, wgmma
// ---------------------------------------------------------------------------
constexpr int kThreads16 = 384;     // two consumer warpgroups + the producer's
constexpr int kProducerWarp = 8;    // the producer's warp (its group's first)
constexpr int kProducerRegs = 40;   // registers a thread after setmaxnreg:
constexpr int kConsumerRegs = 232;  // 128 (40 + 2 x 232) <= 65536
constexpr int kBM = 128;            // tokens a block: 64 a consumer warpgroup
constexpr int kBD = 64;             // depth of a stage: one swizzled row
constexpr int kBN = 256;            // output columns a tile (4 heads): an
                                    // A/B on an H100 chose it over 128
constexpr int kMaxStages = 8;
constexpr int kMaxD = 2048;         // the scale and bias kept in shared memory
constexpr uint32_t kXBytes = kBM * kBD * 2;   // a stage's x tile, 16 KB
constexpr uint32_t kSubBytes = kBD * 64 * 2;  // one [64][64] box of W, 8 KB
constexpr long long kMaxSmem = 232448;  // an H100 block's dynamic maximum

struct LnQkvParams {
  const __nv_bfloat16* x;      // [B, N, D]
  const __nv_bfloat16* scale;  // [D]
  const __nv_bfloat16* bias;   // [D]
  const __nv_bfloat16* b;      // [3, H·64]
  __nv_bfloat16* out;          // [3, B, H, N, 64]
  int B, N, D, H;
  int stages;  // depth of the ring
  float eps;
};

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// float32 mean and 1/sqrt(biased variance + eps) of the rows m of x
// [M, D] (M = B·N) in [m0, m0 + 16), one warp, two rows at a time, each
// row's 16-byte chunks held in registers (D <= 32 · 8 · kLnChunks); rows
// past M get (0, 0).
constexpr int kLnChunks = 8;   // 16-byte chunks a lane holds of a row

__device__ __forceinline__ void row_stats(const LnQkvParams& p, long long M,
                                          long long m0, float2* stats,
                                          int lane) {
  const int nch = p.D / 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = 0; i < 16; i += 2) {
    uint4 v[2][kLnChunks];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + i + h;
      const uint4* xr = reinterpret_cast<const uint4*>(
          p.x + (m < M ? m : 0) * p.D);
#pragma unroll
      for (int k = 0; k < kLnChunks; ++k) {
        const int c = lane + 32 * k;
        v[h][k] = (m < M && c < nch) ? __ldg(xr + c) : zero;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kLnChunks; ++k) {
        float f[8];
        unpack8(v[h][k], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += f[e];
      }
      const float mean = warp_sum(s) / p.D;
      float ss = 0.f;
#pragma unroll
      for (int k = 0; k < kLnChunks; ++k) {
        if (lane + 32 * k >= nch) continue;
        float f[8];
        unpack8(v[h][k], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = f[e] - mean;
          ss = fmaf(d, d, ss);
        }
      }
      const float inv = rsqrtf(warp_sum(ss) / p.D + p.eps);
      if (lane == 0)
        stats[i + h] = m0 + i + h < M ? make_float2(mean, inv)
                                      : make_float2(0.f, 0.f);
    }
  }
}

// one of four registers by a run-time index, without local memory
__device__ __forceinline__ uint32_t pick4(const uint32_t (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// The 4 x 4 transpose of a quad (lanes 4g .. 4g + 3, t = lane % 4): lane t
// gets in[t] of quad lanes 0..3, in that order. From the accumulator's
// packed pairs of four 8-column groups (lane t: columns 2t, 2t + 1 of
// each), lane t gets the 8 columns of group t, 16 contiguous bytes.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&in)[4],
                                                int lane) {
  const int t = lane & 3;
  uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t v = __shfl_sync(0xffffffffu, pick4(in, (t - r) & 3),
                                   (lane & ~3) | ((t + r) & 3));
    const int k = (t + r) & 3;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = k == e ? v : o[e];
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__global__ void __launch_bounds__(kThreads16, 1)
    ln_qkv_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const LnQkvParams p) {
  constexpr int J = kBN / 8;                              // accumulator groups
  constexpr uint32_t kStageBytes = kXBytes + kSubBytes * (kBN / 64);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int d_pad = (p.D + kBD - 1) / kBD * kBD;
  __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(
      ring + p.stages * kStageBytes);                    // [d_pad], 0 past D
  __nv_bfloat16* bs = sc + d_pad;                        // [d_pad], 0 past D
  float2* stats = reinterpret_cast<float2*>(bs + d_pad);  // [kBM]
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + kBM);
  uint64_t* empty = full + kMaxStages;
  const long long M = static_cast<long long>(p.B) * p.N;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cols = 3 * p.H * 64, inner = p.H * 64;
  const int n_col_tiles = (cols + kBN - 1) / kBN, KT = d_pad / kBD;
  // blocks start at different column tiles and walk them cyclically, so
  // that at any moment the SMs read different W tiles
  const int nt0 = blockIdx.x % n_col_tiles;
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&full[i], 1);   // the producer's arrive with the tx
      mbar_init(&empty[i], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    setmaxnreg_dec<kProducerRegs>();
    if (warp != kProducerWarp || lane != 0) return;
    // per stage: the x tile (rows row0.., depth kt; rows past M and columns
    // past D read 0) and the W boxes of the column tile (depth rows past D
    // read 0), for every column tile in turn
    int it = 0;
    for (int i = 0; i < n_col_tiles; ++i) {
      const int c0 = (nt0 + i) % n_col_tiles * kBN;
      const int n_sub = min(kBN, cols - c0) / 64;
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int st = it % p.stages;
        uint8_t* stage = ring + st * kStageBytes;
        mbar_wait(&empty[st], ((it / p.stages) & 1) ^ 1);
        mbar_arrive_tx(&full[st], kXBytes + n_sub * kSubBytes);
        tma_load_2d(stage, &xmap, kt * kBD, static_cast<int>(row0),
                    &full[st]);
        for (int q = 0; q < n_sub; ++q) {
          const int c = c0 + 64 * q;   // a 64-column group lies in one proj
          tma_load_3d(stage + kXBytes + q * kSubBytes, &wmap, c % inner,
                      kt * kBD, c / inner, &full[st]);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp >> 2, wl = warp & 3, tid = threadIdx.x;
  // the LayerNorm's rows and its scale and bias (zero past D)
  row_stats(p, M, row0 + warp * 16, stats + warp * 16, lane);
  for (int d = tid; d < d_pad; d += 256) {
    sc[d] = d < p.D ? p.scale[d] : __float2bfloat16(0.f);
    bs[d] = d < p.D ? p.bias[d] : __float2bfloat16(0.f);
  }
  named_barrier(1, 256);

  // this thread normalises row xr of its warpgroup's 64 rows of each x
  // tile, 16-byte chunks xc .. xc + 3 (of 8), in place: h = (x - mean) ·
  // rstd · scale + bias, rounded to bf16
  const int xr = wg * 64 + ((tid & 127) >> 1), xc = (tid & 1) * 4;
  const float2 ms = stats[xr];
  auto normalise = [&](uint8_t* xs, int kt) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = xc + k;
      uint4* at = reinterpret_cast<uint4*>(xs + xr * 128 +
                                           ((c ^ (xr & 7)) << 4));
      float f[8], g[8], o[8];
      unpack8(*at, f);
      unpack8(*reinterpret_cast<const uint4*>(sc + kt * kBD + c * 8), g);
      unpack8(*reinterpret_cast<const uint4*>(bs + kt * kBD + c * 8), o);
      uint4 hv;
      uint32_t* w = reinterpret_cast<uint32_t*>(&hv);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = pack_bf16(fmaf((f[2 * e] - ms.x) * ms.y, g[2 * e],
                              o[2 * e]),
                         fmaf((f[2 * e + 1] - ms.x) * ms.y, g[2 * e + 1],
                              o[2 * e + 1]));
      *at = hv;
    }
    fence_proxy_async();         // h, written generically, read by wgmma
    named_barrier(2 + wg, 128);  // the warpgroup's 64 rows of h are in place
  };

  // this thread's accumulator rows, and where each lies in out
  const int g = lane >> 2, t = lane & 3;
  long long rm[2];
  size_t roff[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rm[h] = row0 + wg * 64 + wl * 16 + g + 8 * h;
    const long long m = rm[h] < M ? rm[h] : 0;
    roff[h] = (static_cast<size_t>(m / p.N) * p.H * p.N + m % p.N) * 64;
  }
  // A: the warpgroup's 64 rows of the stage's x tile (now h), 16 of the
  // depth a k-step (32 B, desc + 2); B: the stage's W boxes, kSubBytes apart
  // along N, 16 rows a k-step (2048 B, + 128)
  auto a_desc = [&](int st) {
    return sw128_desc(ring + st * kStageBytes + wg * 64 * 128);
  };
  auto b_desc = [&](int st) {
    return sw128_desc_mn(ring + st * kStageBytes + kXBytes, kSubBytes);
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };
  int it = 0;
  for (int i = 0; i < n_col_tiles; ++i) {
    const int nt = (nt0 + i) % n_col_tiles;
    float acc[J][4];
    {  // the first stage of the tile writes the accumulators
      const int st = it % p.stages;
      mbar_wait(&full[st], (it / p.stages) & 1);
      normalise(ring + st * kStageBytes, 0);
      const uint64_t ad = a_desc(st), bd = b_desc(st);
      wgmma_fence();
      wgmma_ss<true>(acc, ad, bd);
#pragma unroll
      for (int kk = 1; kk < 4; ++kk)
        wgmma_ss<false>(acc, ad + 2 * kk, bd + 128 * kk);
      wgmma_commit();
      ++it;
    }
    for (int kt = 1; kt < KT; ++kt, ++it) {
      const int st = it % p.stages;
      mbar_wait(&full[st], (it / p.stages) & 1);
      normalise(ring + st * kStageBytes, kt);
      const uint64_t ad = a_desc(st), bd = b_desc(st);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<false>(acc, ad + 2 * kk, bd + 128 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      release((it - 1) % p.stages);
    }
    // the bias of this thread's columns, loaded under the last products
    uint32_t bias2[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = nt * kBN + 8 * j + 2 * t;
      bias2[j] = c < cols ? ld_u32(p.b + c) : 0u;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    release((it - 1) % p.stages);

    // epilogue: bias in float32, rounded to bf16; each quad's four
    // 8-column groups transposed (quad_transpose), so that a thread writes
    // 16 contiguous bytes of a row of one head's [N, 64] slab
#pragma unroll
    for (int jb = 0; jb < J; jb += 4) {
      const int c0 = nt * kBN + 8 * jb;   // in a 64-column group
      if (c0 >= cols) continue;
      const int proj = c0 / inner, head = (c0 % inner) >> 6;
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 bv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&bias2[jb + k]));
        lo[k] = pack_bf16(acc[jb + k][0] + bv.x, acc[jb + k][1] + bv.y);
        hi[k] = pack_bf16(acc[jb + k][2] + bv.x, acc[jb + k][3] + bv.y);
      }
      const uint4 v[2] = {quad_transpose(lo, lane), quad_transpose(hi, lane)};
      __nv_bfloat16* op =
          p.out + (static_cast<size_t>(proj) * p.B * p.H + head) * p.N * 64 +
          8 * ((jb + t) & 7);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (rm[h] < M) *reinterpret_cast<uint4*>(op + roff[h]) = v[h];
    }
  }
}

// ---------------------------------------------------------------------------
// float32: 128-token x 256-column tiles, 3xTF32 mma.sync, a cp.async ring
// ---------------------------------------------------------------------------
constexpr int kThreads32 = 256;  // 8 warps: 2 along the rows x 4 the columns
constexpr int kMT32 = 4;         // 16-row tiles of a warp's accumulator
constexpr int kBM32 = 128;       // token rows a block
constexpr int kBN32 = 256;       // output columns a block (4 heads)
constexpr int kBK32 = 32;        // depth of a stage
constexpr int kStages32 = 3;
constexpr int kLdX = kBK32 + 8;  // h read as A by 8-byte loads: 8 mod 32
constexpr int kLdW = kBN32 + 4;  // W read as B [k][n] by 4-byte loads
// the rows apart of one thread's 16-byte copies: of an x tile, of a W tile
constexpr int kXStep = kThreads32 / (kBK32 / 4);
constexpr int kWStep = kThreads32 / (kBN32 / 4);

struct F32Stage {
  float x[kBM32][kLdX];  // the x tile, normalised in place to h's big part
  float w[kBK32][kLdW];
};

struct F32Smem {
  F32Stage st[kStages32];
  float hs[2][kBM32][kLdX];  // h's small part, of the tile multiplied and
                             // of the next
  float2 stats[kBM32];       // (mean, rstd) of the block's rows
};

struct LnQkvF32Params {
  const float* x;      // [B, N, D]
  const float2* stats;  // [B·N]: (mean, rstd) of each row
  const float* scale;  // [D]
  const float* bias;   // [D]
  const float* w;      // [3, D, H·64]
  const float* b;      // [3, H·64]
  float* out;          // [3, B, H, N, 64]
  int B, N, D, H;
  float eps;
};

// (mean, rstd) of each row of x [M, D], a warp a row: the mean, then the
// mean of the squared differences from it (the rows are read again, from
// L1 or L2)
__global__ void __launch_bounds__(256)
    ln_stats_f32(const float* __restrict__ x, float2* __restrict__ stats,
                 long long M, int D, float eps) {
  const long long m = static_cast<long long>(blockIdx.x) * 8 +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31, n4 = D / 4;
  if (m >= M) return;
  const float4* xr = reinterpret_cast<const float4*>(x + m * D);
  float sum = 0.f;
  for (int c = lane; c < n4; c += 32) {
    const float4 v = __ldg(xr + c);
    sum += (v.x + v.y) + (v.z + v.w);
  }
  const float mean = warp_sum(sum) / D;
  float ss = 0.f;
  for (int c = lane; c < n4; c += 32) {
    const float4 v = __ldg(xr + c);
    const float a = v.x - mean, b = v.y - mean, c2 = v.z - mean,
                d = v.w - mean;
    ss = fmaf(a, a, ss);
    ss = fmaf(b, b, ss);
    ss = fmaf(c2, c2, ss);
    ss = fmaf(d, d, ss);
  }
  const float rstd = rsqrtf(warp_sum(ss) / D + eps);
  if (lane == 0) stats[m] = make_float2(mean, rstd);
}

__global__ void __launch_bounds__(kThreads32, 1)
    ln_qkv_f32_kernel(const LnQkvF32Params p) {
  F32Smem& s = smem_1024<F32Smem>();
  const long long M = static_cast<long long>(p.B) * p.N;
  const long long row0 = static_cast<long long>(blockIdx.y) * kBM32;
  const int c0 = blockIdx.x * kBN32;
  const int cols = 3 * p.H * 64, inner = p.H * 64, KT = p.D / kBK32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // rows wm·64.., columns wn·64..

  // stage kt: x rows row0.., depth kt·32.. (rows past M read 0) and the W
  // rows of that depth over columns c0.. (columns past `cols` read 0).
  // Every 16-byte chunk a thread copies lies in one column of chunks, so
  // its sources are fixed offsets from two pointers set here: x's at
  // column xcol of rows xr + kXStep i, W's at column wc of depth rows
  // wr + kWStep i (a chunk of W never straddles two projections:
  // inner % 64 == 0).
  const int xcol = (tid & 7) * 4, xr = tid >> 3;
  const int wc = (tid & 63) * 4, wr = tid >> 6, gc = c0 + wc;
  const bool w_ok = gc < cols;
  const float* xsrc = p.x + (row0 + xr) * p.D + xcol;
  const float* wsrc =
      p.w + (w_ok ? static_cast<size_t>(gc / inner) * p.D * inner +
                        gc % inner
                  : 0);
  auto load_stage = [&](int kt) {
    F32Stage& st = s.st[kt % kStages32];
    const int k0 = kt * kBK32;
#pragma unroll
    for (int i = 0; i < kBM32 / kXStep; ++i) {
      const bool ok = row0 + xr + kXStep * i < M;
      cp_async16(smem_u32(&st.x[xr + kXStep * i][xcol]),
                 ok ? xsrc + static_cast<long long>(kXStep * i) * p.D + k0
                    : p.x,
                 ok);
    }
#pragma unroll
    for (int i = 0; i < kBK32 / kWStep; ++i)
      cp_async16(
          smem_u32(&st.w[wr + kWStep * i][wc]),
          wsrc + (w_ok ? static_cast<size_t>(k0 + wr + kWStep * i) * inner
                       : 0),
          w_ok);
  };
  for (int i = 0; i < kStages32 - 1; ++i) {
    if (i < KT) load_stage(i);
    cp_async_commit();
  }

  // the LayerNorm's statistics of the block's rows (rows past M: (0, 0))
  for (int r = tid; r < kBM32; r += kThreads32)
    s.stats[r] = row0 + r < M ? p.stats[row0 + r] : make_float2(0.f, 0.f);
  __syncthreads();

  // this thread copied, and normalises, the 16-byte chunk at column xcol
  // of rows xr + kXStep i of each x tile; the scale and bias of those
  // columns are loaded a tile ahead
  float4 sc4 = __ldg(reinterpret_cast<const float4*>(p.scale + xcol));
  float4 bs4 = __ldg(reinterpret_cast<const float4*>(p.bias + xcol));
  float acc[kMT32][8][4];
#pragma unroll
  for (int mt = 0; mt < kMT32; ++mt) zero_acc(acc[mt]);

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages32 - 2>();  // this thread's copies of stage kt
    F32Stage& st = s.st[kt % kStages32];
    float(*hs)[kLdX] = s.hs[kt & 1];
    {  // h = (x - mean) rstd scale + bias in float32, split into TF32 parts
      const float scv[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
      const float bsv[4] = {bs4.x, bs4.y, bs4.z, bs4.w};
#pragma unroll
      for (int i = 0; i < kBM32 / kXStep; ++i) {
        const int r = xr + kXStep * i;
        const float2 ms = s.stats[r];
        const float4 xv = *reinterpret_cast<const float4*>(&st.x[r][xcol]);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
        float big[4], small[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t hb, hsm;
          split_tf32(fmaf((xs[e] - ms.x) * ms.y, scv[e], bsv[e]), hb, hsm);
          big[e] = __uint_as_float(hb);
          small[e] = __uint_as_float(hsm);
        }
        *reinterpret_cast<float4*>(&st.x[r][xcol]) =
            make_float4(big[0], big[1], big[2], big[3]);
        *reinterpret_cast<float4*>(&hs[r][xcol]) =
            make_float4(small[0], small[1], small[2], small[3]);
      }
      if (kt + 1 < KT) {
        const int d1 = (kt + 1) * kBK32 + xcol;
        sc4 = __ldg(reinterpret_cast<const float4*>(p.scale + d1));
        bs4 = __ldg(reinterpret_cast<const float4*>(p.bias + d1));
      }
    }
    // h's tile is whole and W's has landed; every warp is done with tile
    // kt - 1, whose stage the next copies fill
    __syncthreads();
    if (kt + kStages32 - 1 < KT) load_stage(kt + kStages32 - 1);
    cp_async_commit();

    // acc[64 x 64] += h[64 x 32] W[32 x 64] for this warp, 4 k-steps of 8.
    // Each k-step's three products (small·big, big·small, big·big) are
    // issued a kind at a time over the warp's 32 accumulator tiles, so that
    // no product waits on the one before it.
#pragma unroll
    for (int kk = 0; kk < kBK32 / 8; ++kk) {
      uint32_t ab[kMT32][4], as[kMT32][4];
#pragma unroll
      for (int mt = 0; mt < kMT32; ++mt) {
        const int r = wm * 16 * kMT32 + mt * 16 + g;
        load_a_frag(ab[mt], &st.x[0][0], kLdX, r, kk * 8, t);
        load_a_frag(as[mt], &hs[0][0], kLdX, r, kk * 8, t);
      }
      uint32_t bb[8][2], bs[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        load_b_kn(bb[nt], bs[nt], &st.w[0][0], kLdW, wn * 64 + nt * 8 + g,
                  kk * 8, t);
      mma_3xtf32_sweep(acc, ab, as, bb, bs);
    }
  }

  // epilogue: the warp's 64 columns are one head of one projection
  const int cw = c0 + wn * 64;
  if (cw >= cols) return;
  const int proj = cw / inner, head = (cw % inner) >> 6;
  float* op = p.out + (static_cast<size_t>(proj) * p.B * p.H + head) *
                          static_cast<size_t>(p.N) * 64;
  float2 bias2[8];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    bias2[nt] = *reinterpret_cast<const float2*>(p.b + cw + nt * 8 + 2 * t);
#pragma unroll
  for (int mt = 0; mt < kMT32; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long m = row0 + wm * 16 * kMT32 + mt * 16 + g + 8 * hh;
      if (m >= M) continue;
      float* orow = op + (static_cast<size_t>(m / p.N) * p.H * p.N + m % p.N)
                             * 64;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<float2*>(orow + nt * 8 + 2 * t) =
            make_float2(acc[mt][nt][2 * hh] + bias2[nt].x,
                        acc[mt][nt][2 * hh + 1] + bias2[nt].y);
    }
  }
}

}  // namespace

namespace {

// the bf16 kernel's ring depth and dynamic shared memory (the ring, the
// padded scale and bias, the row statistics, the barriers, 1024 B of
// alignment); -1 bytes if not even two stages fit
struct Bf16Config {
  int stages;
  long long smem;
};

Bf16Config bf16_config(int D) {
  const long long stage = kXBytes + 2LL * kBD * kBN;
  const long long fixed = 1024 + 2LL * 2 * ((D + kBD - 1) / kBD * kBD) +
                          8LL * kBM + 2LL * kMaxStages * 8;
  for (int stages = kMaxStages; stages >= 2; --stages)
    if (fixed + stages * stage <= kMaxSmem)
      return {stages, fixed + stages * stage};
  return {0, -1};
}

int launch_bf16(const CUtensorMap& xmap, const CUtensorMap& wmap,
                const LnQkvParams& prm, const Bf16Config& cfg,
                cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      ln_qkv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(cfg.smem));
  if (err != cudaSuccess) return (int)err;
  const long long M = static_cast<long long>(prm.B) * prm.N;
  ln_qkv_bf16_kernel<<<static_cast<unsigned>((M + kBM - 1) / kBM),
                       kThreads16, cfg.smem, s>>>(xmap, wmap, prm);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of one block (dtype 0: float32, 1: bfloat16); -1 if
// the block does not fit.
extern "C" long long ln_qkv_smem_bytes(int dtype, int D) {
  if (dtype == 0) return smem_bytes<F32Smem>();
  return bf16_config(D).smem;
}

// x [B, N, D]; scale, bias [D]; w [3, D, H·64] (wq, wk, wv); b [3, H·64];
// out [3, B, H, N, 64] (q, k, v), all contiguous in x's dtype (dtype 0:
// float32, 1: bfloat16), 16-byte aligned; stats: float32 scratch of
// 2·B·N values (float32 only, else unread). D a multiple of 32. Returns
// the CUDA error of the launches (0 on success).
extern "C" int ln_qkv(int dtype, const void* x, const void* scale,
                      const void* bias, const void* w, const void* b,
                      void* out, void* stats, int B, int N, int D, int H,
                      float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const long long M = static_cast<long long>(B) * N;
    if (D % kBK32 || (M + kBM32 - 1) / kBM32 > 65535)
      return (int)cudaErrorInvalidValue;
    const int smem = smem_bytes<F32Smem>();
    cudaError_t err = cudaFuncSetAttribute(
        ln_qkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ln_stats_f32<<<static_cast<unsigned>((M + 7) / 8), 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<float2*>(stats), M, D, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((3 * H * 64 + kBN32 - 1) / kBN32,
                    static_cast<unsigned>((M + kBM32 - 1) / kBM32));
    const LnQkvF32Params prm{
        static_cast<const float*>(x), static_cast<const float2*>(stats),
        static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(out), B, N, D, H,
        eps};
    ln_qkv_f32_kernel<<<grid, kThreads32, smem, s>>>(prm);
    return (int)cudaGetLastError();
  }
  const Bf16Config cfg = bf16_config(D);
  if (cfg.smem < 0 || D % 32 ||
      D > 32 * 8 * kLnChunks || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  // x as [B·N, D] in [128][64] boxes; W as (H·64, D, 3) in [64][64] boxes
  const cuuint64_t inner = 64ull * H;
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)B * N};
  const cuuint64_t xstrides[1] = {2ull * D};
  const cuuint32_t xbox[2] = {kBD, kBM};
  const cuuint64_t wdims[3] = {inner, (cuuint64_t)D, 3};
  const cuuint64_t wstrides[2] = {inner * 2, inner * 2 * D};
  const cuuint32_t wbox[3] = {64, kBD, 1};
  CUtensorMap xmap, wmap;
  if (!encode_bf16_map(&xmap, x, 2, xdims, xstrides, xbox) ||
      !encode_bf16_map(&wmap, w, 3, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  const LnQkvParams prm{static_cast<const __nv_bfloat16*>(x),
                        static_cast<const __nv_bfloat16*>(scale),
                        static_cast<const __nv_bfloat16*>(bias),
                        static_cast<const __nv_bfloat16*>(b),
                        static_cast<__nv_bfloat16*>(out),
                        B, N, D, H, cfg.stages, eps};
  return launch_bf16(xmap, wmap, prm, cfg, s);
}
