// Weight-gradient body shared by the resample backward kernels
// (downsample_bwd.cu, upsample_bwd.cu) and the resblock conv's
// (conv3x3_wgrad.cu), designed for Hopper (sm_90a).
//
// Replaces the TPU kernels
//   vqvae_from_gaussian_vae_tpu/ops/conv3x3_train.py   _conv3x3_wgrad   (kWgSame)
//   vqvae_from_gaussian_vae_tpu/ops/downsample_conv.py _downsample_wgrad (kWgDown)
//   vqvae_from_gaussian_vae_tpu/ops/upsample_conv.py   _upsample_wgrad   (kWgUp)
// All three are one reduction: for each tap t,
//
//   dW[t] (C x O) = sum over pixels p of X_t[p, :]^T . G[p, :]
//
// where p runs over one pixel grid per sample (B * Mh * Mw pixels in all), G
// is the cotangent at p's output position and X_t the forward input at p's
// tap-shifted position (zero outside the image):
//
//   down (kWgDown): 9 taps (r, s); p = (b, i, j) over the (H/2, W/2)
//       output grid; X_t[p] = x[b, 2i + r, 2j + s] (row H and column W are
//       the (0,1) pad), G[p] = g[b, i, j].
//   up   (kWgUp):  16 taps (di, dj, a, bb); p = (b, i, j) over the
//       low-resolution (H, W) grid; X_t[p] = x[b, i + di + a - 1,
//       j + dj + bb - 1], G[p] = g[b, 2i + di, 2j + dj] (the phase-kernel
//       gradient dk22; the wrapper maps it back to dw).
//   same (kWgSame): 9 taps (r, s) of the stride-1 "same" conv; p = (b, i,
//       j) over the (H, W) grid; X_t[p] = x[b, i + r - 1, j + s - 1],
//       G[p] = g[b, i, j].
//
// What bounds it on an H100: a GEMM with M = C, N = O and K = pixels (16,384
// to 1,048,576 at bs=16), 2 * taps * C * O FLOP per pixel: 7.7e10 to
// 6.2e11 FLOP per launch at the main path's shapes against 34 to 806 MB of
// x and g, so the tensor cores bound every shape (the old wmma body ran at
// 75-88 TFLOP/s, 8% of the 989 bf16 peak).
//
// The design, against what held the wmma body back:
// - wgmma.  A block owns a 128 (C) x BN (O) tile of one tap; two consumer
//   warpgroups each accumulate 64 x BN in registers with wgmma.m64nBNk16
//   (bf16 in, float32 accumulators).  Both operands sit in shared memory
//   pixel-major with channels contiguous, so A = X_t^T is M-major and
//   B = G is N-major: both descriptors take the transpose bit.
// - TMA into a ring.  One producer thread keeps a ring of stages (64
//   pixels x 128 channels of X_t and x BN of G) in flight with
//   cp.async.bulk.tensor and mbarriers; the consumers release a stage once
//   the wgmma group that read it has retired.  The copies write the
//   128-byte swizzle that the descriptors read (each 64-channel slice is
//   one 128-byte row per pixel, 1024-byte aligned).
// - No address math per element.  A K step is one spatial tile of one
//   sample (tile_w x 64/tile_w pixels); the tensor maps are 4-D (channel,
//   column, row, sample), so a tile never crosses a sample, and TMA's zero
//   fill out of bounds is the "same" conv's border, the downsample's (0,1)
//   pad and the ragged edge of the tiles.  The stride-2 reads (x for
//   kWgDown, g for kWgUp) are the maps' element strides.
// - Occupancy by design, 288 threads (8 consumer warps, 1 producer warp):
//   BN = 128 takes 90 registers and 3 x 32 KB of ring, so two blocks share
//   an SM and one's prologue and epilogue hide behind the other's MMAs;
//   BN = 256 (O a multiple of 256) takes 154 registers and 4 x 48 KB, one
//   block an SM, and reads a quarter fewer operand bytes per FLOP: faster
//   at every main-path shape that takes it (PERF.md).
// - Taps: one tap per block; the nine (or sixteen) tap blocks of one split
//   are adjacent in the grid, so they read the same x and g rows through L2
//   at about the same time.
//
// Fixed order, no float atomics: each block writes its float32 partial to
// (splits, taps, C, O), the split a fixed run of spatial tiles; a second
// kernel sums the splits of each element in ascending order, so two runs
// give the same bits.  The launch planner (ops/downsample_conv.py
// wgrad_plan) picks the split count from the shape alone.
#pragma once

#include "conv_common.cuh"  // bf16
#include "sm90.cuh"

namespace gvq {
namespace {

enum WgradMode { kWgDown = 0, kWgUp = 1, kWgSame = 2 };

__host__ __device__ constexpr int wgrad_taps(int mode) { return mode == kWgUp ? 16 : 9; }

constexpr int kWgBM = 128;                    // input channels of a block's tile
constexpr int kWgBK = 64;                     // pixels per stage: one spatial tile
constexpr int kWgHalf = kWgBK * 64 * 2;       // one TMA box: 64 pixels x 64 channels, 8 KB
constexpr int kWgThreads = 288;               // two consumer warpgroups + one producer warp

// A block's output-channel tile BN: 256 where O is a multiple of 256 (one
// block an SM, four 48 KB stages), else 128 (two blocks an SM, three 32 KB
// stages); ops/downsample_conv.py wgrad_tile_o is the same rule.
__host__ __device__ constexpr int wgrad_stages(int bn) { return bn == 256 ? 4 : 3; }
__host__ __device__ constexpr int wgrad_stage_bytes(int bn) { return (2 + bn / 64) * kWgHalf; }
__host__ __device__ constexpr size_t wgrad_smem(int bn) {  // + barriers + alignment slack
  return (size_t)wgrad_stages(bn) * wgrad_stage_bytes(bn) + 2 * wgrad_stages(bn) * 8 + 1024;
}
inline int wgrad_tile_o(int o) { return o % 256 == 0 ? 256 : 128; }

struct WgradArgs {
  float* partial;        // (splits, taps, C, O)
  int C, O;
  int tile_h, tile_w;    // a K step: tile_h x tile_w pixels of one sample's grid
  int tiles_w;           // tiles across the grid's width
  int tiles_per_sample;
  int steps;             // K steps over the batch
  int chunk;             // K steps per split
};

// The spatial tile of a K step on an (mh, mw) pixel grid: tile_w in {64,
// 32, 16, 8} and tile_h = 64 / tile_w, the widest that covers the grid with
// the fewest pixels (ops/downsample_conv.py wgrad_tile is the same rule).
inline void wgrad_tile(int mh, int mw, int* tile_h, int* tile_w) {
  long long best = -1;
  for (int tw = 64; tw >= 8; tw /= 2) {
    const int th = kWgBK / tw;
    const long long cover =
        (long long)((mh + th - 1) / th) * th * (long long)((mw + tw - 1) / tw) * tw;
    if (best < 0 || cover < best) {
      best = cover;
      *tile_h = th;
      *tile_w = tw;
    }
  }
}

template <int MODE, int BN>
__global__ void __launch_bounds__(kWgThreads, BN == 256 ? 1 : 2)
conv_wgrad_kernel(const __grid_constant__ CUtensorMap tmap_x,
                  const __grid_constant__ CUtensorMap tmap_g, WgradArgs a) {
  constexpr int STAGES = wgrad_stages(BN);
  constexpr int STAGE = wgrad_stage_bytes(BN);
  extern __shared__ unsigned char wg_smem[];
  const uint32_t ring = (wg_smem_addr(wg_smem) + 1023u) & ~1023u;  // the swizzle's 1024-byte atom
  const uint32_t full_bar = ring + STAGES * STAGE;                 // 8 bytes per stage
  const uint32_t empty_bar = full_bar + STAGES * 8;

  constexpr int TAPS = wgrad_taps(MODE);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n_ct = (a.C + kWgBM - 1) / kWgBM;
  const int c0 = (blockIdx.x % n_ct) * kWgBM;
  const int o0 = (blockIdx.x / n_ct) * BN;
  const int t = blockIdx.y;
  const int split = blockIdx.z;
  const int q0 = split * a.chunk;
  const int nsteps = max(0, min(a.chunk, a.steps - q0));

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);   // the producer's arrive; the copies' bytes
      mbar_init(empty_bar + 8 * s, 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer: one thread issues every copy
    if ((tid & 31) != 0) return;
    // tap geometry: x at (xm * i + xr, xm * j + xc), g at (gm * i + gr,
    // gm * j + gc), in elements of the maps (the stride-2 maps step by 2)
    int xm, xr, xc, gm, gr, gc;
    if (MODE == kWgUp) {
      const int di = t >> 3, dj = (t >> 2) & 1;
      xm = 1, xr = di + ((t >> 1) & 1) - 1, xc = dj + (t & 1) - 1;
      gm = 2, gr = di, gc = dj;
    } else if (MODE == kWgSame) {
      xm = 1, xr = t / 3 - 1, xc = t % 3 - 1;
      gm = 1, gr = 0, gc = 0;
    } else {
      xm = 2, xr = t / 3, xc = t % 3;
      gm = 1, gr = 0, gc = 0;
    }
    for (int ks = 0; ks < nsteps; ++ks) {
      const int s = ks % STAGES;
      mbar_wait(empty_bar + 8 * s, ((ks / STAGES) & 1) ^ 1);  // a fresh stage passes
      mbar_arrive_expect_tx(full_bar + 8 * s, STAGE);
      const int q = q0 + ks;
      const int b = q / a.tiles_per_sample;
      const int rem = q - b * a.tiles_per_sample;
      const int i0 = (rem / a.tiles_w) * a.tile_h;
      const int j0 = (rem % a.tiles_w) * a.tile_w;
      const uint32_t dst = ring + s * STAGE;
      const uint32_t bar = full_bar + 8 * s;
      const int xi = xm * i0 + xr, xj = xm * j0 + xc;
      const int gi = gm * i0 + gr, gj = gm * j0 + gc;
      tma_load_4d(dst, &tmap_x, bar, c0, xj, xi, b);
      tma_load_4d(dst + kWgHalf, &tmap_x, bar, c0 + 64, xj, xi, b);
#pragma unroll
      for (int h = 0; h < BN / 64; ++h)
        tma_load_4d(dst + (2 + h) * kWgHalf, &tmap_g, bar, o0 + 64 * h, gj, gi, b);
    }
    return;
  }

  // consumers: warpgroup wg owns input channels c0 + 64 wg .. + 63
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int ks = 0; ks < nsteps; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(full_bar + 8 * s, (ks / STAGES) & 1);
    const uint32_t st = ring + s * STAGE;
    wg_fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      // 16 pixels = 16 rows of 128 bytes; A: one 64-channel half, B: every one
      const uint64_t da = wg_desc(st + wg * kWgHalf + kk * 2048, kWgHalf, 1024);
      const uint64_t db = wg_desc(st + 2 * kWgHalf + kk * 2048, kWgHalf, 1024);
      wgmma_ss_t<1, 1>(acc, da, db);  // both MN-major
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // the previous step's group
    wg_fence_acc(acc);
    if (ks > 0 && (tid & 127) == 0) mbar_arrive(empty_bar + 8 * ((ks - 1) % STAGES));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_fence_acc(acc);

  // accumulator fragment: warp w of the warpgroup holds rows 16 w .. +15;
  // acc[4 j + e]: row (lane / 4) + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2
  const int lane = tid & 31;
  const int row = c0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  float* dst = a.partial + ((size_t)split * TAPS + t) * a.C * a.O;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = o0 + 8 * j + 2 * (lane & 3);
    if (col < a.O) {
      if (row < a.C)
        *reinterpret_cast<float2*>(dst + (size_t)row * a.O + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (row + 8 < a.C)
        *reinterpret_cast<float2*>(dst + (size_t)(row + 8) * a.O + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// out[e] = sum over s of partial[s, e], s ascending
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                    int splits, size_t n) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += partial[(size_t)s * n + idx];
  out[idx] = acc;
}

// a 4-D bf16 map over an NHWC tensor (dims: channels, columns, rows,
// samples) whose box is 64 channels x the spatial tile, reading every
// `step`-th row and column, written with the 128-byte swizzle
inline bool encode_nhwc_map(CUtensorMap* map, const bf16* base, int n, int h, int w, int c,
                            int tile_h, int tile_w, int step) {
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)w * c * 2,
                                 (cuuint64_t)h * w * c * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)(tile_w * step), (cuuint32_t)(tile_h * step), 1};
  const cuuint32_t elem[4] = {1, (cuuint32_t)step, (cuuint32_t)step, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box, elem);
}

template <int MODE, int BN>
inline cudaError_t launch_wgrad_body(const CUtensorMap& tmap_x, const CUtensorMap& tmap_g,
                                     const WgradArgs& a, int splits, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv_wgrad_kernel<MODE, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)wgrad_smem(BN));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv_wgrad_kernel<MODE, BN>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int n_tiles = ((a.C + kWgBM - 1) / kWgBM) * ((a.O + BN - 1) / BN);
  conv_wgrad_kernel<MODE, BN><<<dim3(n_tiles, wgrad_taps(MODE), splits), kWgThreads,
                                wgrad_smem(BN), stream>>>(tmap_x, tmap_g, a);
  return cudaGetLastError();
}

// x (B, H, W, C) and g (B, Hg, Wg, O) bf16; the reduction runs over B x
// (Mh, Mw) pixels in `splits` runs of `chunk` spatial tiles; partial
// (splits, taps, C, O) float32 scratch; out (taps, C, O) float32
template <int MODE>
inline int launch_wgrad(const bf16* x, const bf16* g, float* partial, float* out, int B, int H,
                        int W, int C, int O, int Hg, int Wg, int Mh, int Mw, int splits,
                        int chunk, cudaStream_t stream) {
  constexpr int TAPS = wgrad_taps(MODE);
  WgradArgs a{};
  a.partial = partial;
  a.C = C;
  a.O = O;
  wgrad_tile(Mh, Mw, &a.tile_h, &a.tile_w);
  a.tiles_w = (Mw + a.tile_w - 1) / a.tile_w;
  a.tiles_per_sample = ((Mh + a.tile_h - 1) / a.tile_h) * a.tiles_w;
  const long long steps = (long long)B * a.tiles_per_sample;
  a.chunk = chunk;
  if (C % 8 != 0 || O % 8 != 0 || C <= 0 || O <= 0 || splits <= 0 || splits > 65535 ||
      chunk <= 0 || steps > 0x7fffffff || (long long)splits * chunk < steps ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  a.steps = (int)steps;
  CUtensorMap tmap_x, tmap_g;
  if (!encode_nhwc_map(&tmap_x, x, B, H, W, C, a.tile_h, a.tile_w, MODE == kWgDown ? 2 : 1) ||
      !encode_nhwc_map(&tmap_g, g, B, Hg, Wg, O, a.tile_h, a.tile_w, MODE == kWgUp ? 2 : 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = wgrad_tile_o(O) == 256
                        ? launch_wgrad_body<MODE, 256>(tmap_x, tmap_g, a, splits, stream)
                        : launch_wgrad_body<MODE, 128>(tmap_x, tmap_g, a, splits, stream);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)TAPS * C * O;
  wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(partial, out, splits, n);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gvq
