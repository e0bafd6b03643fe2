// LayerNorm-prologue matmul and plain matmul + bias, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of the microbenchmark scripts/exp_ln_matmul.py
// (no model calls them):
//   _pallas_fused (:64, pallas_call at :67, body _fused_kernel): for each row
//     of x, float32 mean, variance as the mean of (x - mean)^2, rstd =
//     rsqrt(var + eps); xn = bf16((x - mean) * rstd * g + b); out =
//     bf16(xn @ W + wb) with float32 sums -> gvq_ln_matmul;
//   _pallas_mm (:81, pallas_call at :84, body _mm_kernel): out = bf16(y @ W
//     + wb) with float32 sums -> gvq_matmul_bias.
// Each rounds twice at most: xn once to bf16 before the product (the fused
// kernel), the output once after the float32 bias add.
//
// What bounds it on an H100: at the lab's (16384, 768) @ (768, 2304) one
// launch is 5.8e10 FLOP against 104 MB (x, W, g, b, wb read once, out
// written once), so the tensor cores bound it: 0.059 ms at the bf16 peak
// (0.078 ms at N = 3072).
//
// The design: a TMA + wgmma GEMM whose A operand is normalised in shared
// memory, so the normalised activation never goes through device memory.
// - Statistics first: ln_stats_kernel (a warp a row, the row in registers,
//   two passes in float32, as the TPU kernel's) writes each row's (mean,
//   rstd), 8 bytes a row, into a scratch the wrapper allocates: one read of
//   x.  The GEMM's tiles then need no row's other columns.
// - The GEMM: a block owns a 128-row x 256-column output tile at a time and
//   walks tiles persistently (one block an SM, the grid the card's SMs or
//   the tiles if fewer).  Tiles go in raster groups of bm / 128 M tiles: a
//   group's tiles run column tile by column tile, so the blocks that run
//   together share W's tiles through L2 (bm is the TPU kernel's row block,
//   the rows that share one pass over W; it no longer sets the grid).
// - A producer warp keeps a four-stage ring of TMA boxes in flight: x's
//   128 rows x 64 channels and W's 64 channels x 256 columns as it lies
//   (N contiguous: an MN-major B operand, read with wgmma's transpose bit,
//   no copy), each a 128-byte swizzled row per pixel or channel.  The ring
//   flows across K steps, column tiles and row tiles with no drain.  The
//   copies come from L2 (x and W together fit it), and the consumers hold
//   two stages at a time (the products in flight and the stage being
//   normalised), so the ring is as deep as shared memory allows.
// - Two consumer warpgroups own 64 rows each and run wgmma m64n256k16 (one
//   a k16 step, float32 accumulators, A and B from shared memory).  The
//   fused kernel first rewrites its warpgroup's rows of each arrived A tile
//   in place as bf16((x - mean) * rstd * g + b) (0 past C), while the
//   previous K step's products run.
// - The epilogue from the registers: + the float32 bias, one rounding, a
//   swizzled bf16 half tile at a time staged in its own buffer and stored
//   by TMA (which clips rows past R and columns past N), so the consumers
//   go on to the next tile while the last store drains.
// No split-K and no atomics: the output repeats bit for bit.
//
// Limits: C a multiple of 32 up to 768 (the statistics pass holds a row in
// a warp's registers), N a multiple of 8 (16-byte rows for TMA), any R, bm a
// positive multiple of 128.  Anything else returns cudaErrorInvalidValue and
// runs nothing.  ops/ln_matmul.py ln_matmul_plan mirrors the tiles, stages,
// shared memory, raster and grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using gvq::mbar_arrive;
using gvq::mbar_arrive_expect_tx;
using gvq::mbar_init;
using gvq::mbar_wait;
using gvq::pack_bf16x2;
using gvq::tma_load_2d;
using gvq::tma_store_2d;
using gvq::wg_desc;
using gvq::wg_fence_acc;
using gvq::wg_smem_addr;
using gvq::wgmma_ss_t;

constexpr int kBM = 128;                 // rows of an output tile: two warpgroups of 64
constexpr int kBN = 256;                 // columns of an output tile: two 128-column products
constexpr int kBK = 64;                  // channels a K step: a 128-byte row of bf16
constexpr int kStages = 4;               // ring depth
constexpr int kATile = kBM * kBK * 2;    // 16 KB
constexpr int kBTile = kBN * kBK * 2;    // 32 KB: four boxes of 64 channels x 64 columns
constexpr int kStage = kATile + kBTile;  // 48 KB
constexpr int kEpi = kBM * kBN;          // 32 KB: half the output tile staged, 4 boxes of 64 x 64
constexpr int kThreads = 384;            // two consumer warpgroups, then a producer warpgroup
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kMaxC = 768;
constexpr int kMaxChunks = kMaxC / 8 / 32;  // 16-byte chunks of a row a lane (statistics)
// the ring, the staged tile, the full and empty barriers, alignment slack
constexpr size_t kSmem = (size_t)kStages * kStage + kEpi + 2 * kStages * 8 + 1024;
static_assert(kSmem <= 232448, "one block an SM");

struct LnMmArgs {
  const float2* stats;  // LN: (R,) (mean, rstd) of each row
  const float* g;       // (C,) LN scale (LN only)
  const float* b;       // (C,) LN shift (LN only)
  const float* wb;      // (N,)
  int R, C, N;
  int group;            // M tiles of a raster group (bm / 128)
  int m_tiles, n_tiles, k_steps, tiles;
};

// tile t of the raster -> (M tile, N tile): groups of `group` M tiles (the
// last may have fewer), each walked column tile by column tile
__device__ __forceinline__ void tile_coords(const LnMmArgs& a, int t, int* mt, int* nt) {
  const int span = a.group * a.n_tiles;
  const int grp = t / span;
  const int left = a.m_tiles - grp * a.group;
  const int rows = left < a.group ? left : a.group;
  const int r = t - grp * span;
  *nt = r / rows;
  *mt = grp * a.group + r % rows;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (mean, rstd) of each row of x (R, C): a warp a row, the row in registers,
// float32, the variance as the mean of (x - mean)^2
__global__ void __launch_bounds__(256) ln_stats_kernel(const bf16* __restrict__ x,
                                                       float2* __restrict__ stats, int R, int C,
                                                       float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  if (row >= R) return;
  const int nch = C / 8;
  const bf16* src = x + (size_t)row * C;
  float v[kMaxChunks * 8];
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    const int ch = j * 32 + lane;
    const uint4 raw = ch < nch ? *reinterpret_cast<const uint4*>(src + ch * 8)
                               : make_uint4(0u, 0u, 0u, 0u);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      v[j * 8 + 2 * e] = f.x;
      v[j * 8 + 2 * e + 1] = f.y;
    }
  }
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxChunks * 8; ++i) sum += v[i];  // absent chunks are 0
  const float mean = warp_sum(sum) / (float)C;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    if (j * 32 + lane < nch) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float c = v[j * 8 + e] - mean;
        sq += c * c;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)C + eps);
  if (lane == 0) stats[row] = make_float2(mean, rstd);
}

// this warpgroup's 128 threads (barrier 1 + wg; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// LN: a warpgroup's 64 rows of an A tile (x's K step kb, at `tile`),
// rewritten in place as bf16((x - mean) * rstd * g + b), 0 past C.  This
// thread takes 16-byte chunk tw % 8 (channels 8 (tw % 8) .. + 7 of the
// step) of rows tw / 8 + 16 i, whose statistics are mean[i], rstd[i].  The
// writes are then ordered before the products' (async proxy) reads, and
// the warpgroup's gathered.
__device__ __forceinline__ void normalise_tile(unsigned char* tile, const LnMmArgs& a, int kb,
                                               int tw, const float (&mean)[4],
                                               const float (&rstd)[4], int wg) {
  const int k = tw & 7, ch = kb * kBK + 8 * k;
  const bool in = ch < a.C;  // C % 32 == 0: a chunk is all in or all out
  float gs[8], bs[8];
  if (in) {
    const float4 g0 = __ldg(reinterpret_cast<const float4*>(a.g + ch));
    const float4 g1 = __ldg(reinterpret_cast<const float4*>(a.g + ch) + 1);
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(a.b + ch));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(a.b + ch) + 1);
    gs[0] = g0.x, gs[1] = g0.y, gs[2] = g0.z, gs[3] = g0.w;
    gs[4] = g1.x, gs[5] = g1.y, gs[6] = g1.z, gs[7] = g1.w;
    bs[0] = b0.x, bs[1] = b0.y, bs[2] = b0.z, bs[3] = b0.w;
    bs[4] = b1.x, bs[5] = b1.y, bs[6] = b1.z, bs[7] = b1.w;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = (tw >> 3) + 16 * i;
    uint4* e = reinterpret_cast<uint4*>(tile + p * 128 + ((k ^ (p & 7)) << 4));
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (in) {
      const uint4 v = *e;
      const uint32_t* pv = reinterpret_cast<const uint32_t*>(&v);
      uint32_t* po = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pv[j]));
        po[j] = pack_bf16x2((f.x - mean[i]) * rstd[i] * gs[2 * j] + bs[2 * j],
                            (f.y - mean[i]) * rstd[i] * gs[2 * j + 1] + bs[2 * j + 1]);
      }
    }
    *e = out;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_sync(wg);
}

template <bool LN>
__global__ void __launch_bounds__(kThreads, 1)
ln_matmul_kernel(const __grid_constant__ CUtensorMap tmap_x,
                 const __grid_constant__ CUtensorMap tmap_w,
                 const __grid_constant__ CUtensorMap tmap_out, LnMmArgs a) {
  extern __shared__ unsigned char lm_smem_raw[];
  const uint32_t raw = wg_smem_addr(lm_smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle's 1024-byte atom
  unsigned char* const ring_p = lm_smem_raw + (ring - raw);
  const uint32_t epi = ring + kStages * kStage;
  const uint32_t full_bar = epi + kEpi;  // 8 bytes a stage
  const uint32_t empty_bar = full_bar + kStages * 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);                // the producer's arrive; the copies' bytes
      mbar_init(empty_bar + 8 * s, kConsumerWarps);  // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (warp != kConsumerWarps || lane != 0) return;
    int ks = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      int mt, nt;
      tile_coords(a, t, &mt, &nt);
      for (int kb = 0; kb < a.k_steps; ++kb, ++ks) {
        const int s = ks % kStages;
        mbar_wait(empty_bar + 8 * s, ((ks / kStages) & 1) ^ 1);  // a fresh stage passes
        const uint32_t bar = full_bar + 8 * s, st = ring + s * kStage;
        mbar_arrive_expect_tx(bar, kStage);
        tma_load_2d(st, &tmap_x, bar, kb * kBK, mt * kBM);
#pragma unroll
        for (int h = 0; h < kBN / 64; ++h)  // W[k][n]: 64 k rows of 64 n a box
          tma_load_2d(st + kATile + h * 8192, &tmap_w, bar, nt * kBN + 64 * h, kb * kBK);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. + 63 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int wg = warp >> 2, tw = tid & 127;
  float acc[kBN / 2];
  int ks = 0;  // K steps consumed over the block's tiles

  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    int mt, nt;
    tile_coords(a, t, &mt, &nt);
    const int m0 = mt * kBM, n0 = nt * kBN;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;

    // LN: the statistics of this thread's rows of the warpgroup's 64 (see
    // normalise_tile); rows past R take (0, 0) (they are not stored)
    float mean[4] = {}, rstd[4] = {};
    if (LN) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + wg * 64 + (tw >> 3) + 16 * i;
        const float2 st = row < a.R ? a.stats[row] : make_float2(0.0f, 0.0f);
        mean[i] = st.x;
        rstd[i] = st.y;
      }
    }
    // Stage ks is awaited (and normalised) while the previous K step's
    // products run; the stage before that is released as soon as its
    // products are done.
    for (int kb = 0; kb < a.k_steps; ++kb, ++ks) {
      const int s = ks % kStages;
      mbar_wait(full_bar + 8 * s, (ks / kStages) & 1);
      if (LN) normalise_tile(ring_p + s * kStage + wg * 8192, a, kb, tw, mean, rstd, wg);
      const uint32_t st = ring + s * kStage;
      wg_fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // A K-major rows; B MN-major, four 64-column boxes
        wgmma_ss_t<0, 1>(acc, wg_desc(st + wg * 8192 + kk * 32, 16, 1024),
                         wg_desc(st + kATile + kk * 2048, 8192, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // the previous step's
      wg_fence_acc(acc);
      if (kb > 0 && lane == 0) mbar_arrive(empty_bar + 8 * ((ks - 1) % kStages));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(acc);
    if (lane == 0) mbar_arrive(empty_bar + 8 * ((ks - 1) % kStages));

    // Epilogue, in two halves of 128 columns through this warpgroup's 16 KB
    // staging buffer: once the previous store has read it, stage the half
    // as two 64 x 64 boxes, row p at p * 128, 16-byte chunk c at (c ^ p %
    // 8) * 16 (the map's 128-byte swizzle), and store them by TMA.
    // Accumulator fragment: acc[4 j + e] is row (lane / 4) + 8 (e / 2) of
    // the warp's 16, column 8 j + 2 (lane % 4) + e % 2.
    unsigned char* const stage_p = ring_p + kStages * kStage + wg * (kEpi / 2);
    const int q = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (tw == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      wg_sync(wg);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = (warp & 3) * 16 + (lane >> 2) + 8 * half;
#pragma unroll
        for (int j = 16 * h; j < 16 * h + 16; ++j) {
          const int n = n0 + 8 * j + 2 * q;
          const float2 bb = n < a.N ? __ldg(reinterpret_cast<const float2*>(a.wb + n))
                                    : make_float2(0.0f, 0.0f);
          const int box = (j >> 3) & 1, c = j & 7;
          *reinterpret_cast<uint32_t*>(stage_p + box * 8192 + p * 128 + ((c ^ (p & 7)) << 4) +
                                       q * 4) =
              pack_bf16x2(acc[4 * j + 2 * half] + bb.x, acc[4 * j + 2 * half + 1] + bb.y);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(wg);
      if (tw == 0 && m0 + wg * 64 < a.R) {
#pragma unroll
        for (int box = 0; box < 2; ++box)
          if (n0 + 128 * h + 64 * box < a.N)
            tma_store_2d(&tmap_out, epi + wg * (kEpi / 2) + box * 8192, n0 + 128 * h + 64 * box,
                         m0 + wg * 64);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }
  if (tw == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// a 2-D bf16 map of a row-major (rows, cols) tensor, a box of box_cols x
// box_rows, the 128-byte swizzle, zero fill out of bounds
bool encode_2d(CUtensorMap* map, const void* base, int rows, int cols, int box_rows,
               int box_cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return gvq::encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides, box);
}

template <bool LN>
int launch(const bf16* x, float2* stats, const float* g, const float* b, const bf16* w,
           const float* wb, bf16* out, int R, int C, int N, int bm, float eps,
           cudaStream_t stream) {
  if (R <= 0 || C <= 0 || C % 32 != 0 || C > kMaxC || N <= 0 || N % 8 != 0 || bm <= 0 ||
      bm % kBM != 0 || (LN && (stats == nullptr || g == nullptr || b == nullptr)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw, to;
  if (!encode_2d(&tx, x, R, C, kBM, kBK) || !encode_2d(&tw, w, C, N, kBK, 64) ||
      !encode_2d(&to, out, R, N, 64, 64))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  LnMmArgs a{stats, g, b, wb, R, C, N, bm / kBM, (R + kBM - 1) / kBM, (N + kBN - 1) / kBN,
             (C + kBK - 1) / kBK, 0};
  const long long tiles = (long long)a.m_tiles * a.n_tiles;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  if (LN) {
    ln_stats_kernel<<<(R + 7) / 8, 256, 0, stream>>>(x, stats, R, C, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(ln_matmul_kernel<LN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = a.tiles < sms ? a.tiles : sms;
  ln_matmul_kernel<LN><<<grid, kThreads, kSmem, stream>>>(tx, tw, to, a);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (R, C) bf16; g, b: (C,) float32; w: (C, N) bf16; wb: (N,) float32;
// stats: (R, 2) float32 scratch; out: (R, N) bf16; all contiguous and
// 16-byte aligned.  bm: the rows of one raster group, a multiple of 128.
extern "C" int gvq_ln_matmul(const void* x, const void* g, const void* b, const void* w,
                             const void* wb, void* stats, void* out, int R, int C, int N, int bm,
                             float eps, void* stream) {
  return launch<true>(static_cast<const bf16*>(x), static_cast<float2*>(stats),
                      static_cast<const float*>(g), static_cast<const float*>(b),
                      static_cast<const bf16*>(w), static_cast<const float*>(wb),
                      static_cast<bf16*>(out), R, C, N, bm, eps, static_cast<cudaStream_t>(stream));
}

// y: (R, C) bf16; w, wb, out, bm as above.
extern "C" int gvq_matmul_bias(const void* y, const void* w, const void* wb, void* out, int R,
                               int C, int N, int bm, void* stream) {
  return launch<false>(static_cast<const bf16*>(y), nullptr, nullptr, nullptr,
                       static_cast<const bf16*>(w), static_cast<const float*>(wb),
                       static_cast<bf16*>(out), R, C, N, bm, 0.0f,
                       static_cast<cudaStream_t>(stream));
}
