// Implicit-GEMM 3x3 convolution body designed for Hopper (sm_90a), for the
// stride-2 downsample's forward (downsample_conv.cu) and input gradient
// (downsample_bwd.cu), and the nearest-x2 upsample's input gradient
// (upsample_bwd.cu).  The upsample's forward (kUpFwd) and the fused
// GroupNorm + swish conv (kSameGn) stay on the wmma body, conv_igemm.cuh.
//
// Replaces the TPU kernels of vqvae_from_gaussian_vae_tpu/ops/downsample_conv.py
//   kIgDownFwd   <- _downsample_conv  -> pl.pallas_call (body _kernel)
//   kIgDownDgrad <- _downsample_dgrad -> pl.pallas_call (body _dgrad_kernel)
// and of vqvae_from_gaussian_vae_tpu/ops/upsample_conv.py
//   kIgUpDgrad   <- _upsample_dgrad   -> pl.pallas_call (body _dgrad_kernel_hwbc)
//
//   M = output pixels of one sample (of one parity phase for dgrad), N =
//   output channels, K = taps x input channels:
//   kIgDownFwd: 9 taps (r, s); output pixel (i, j) reads x (or x + add,
//       summed in float32 and rounded once to bf16) at (2i + r, 2j + s);
//       row H and column W are the (0,1) zero pad.  Epilogue: + bias,
//       rounded to bf16, and per-block column (sum, sum of squares) of the
//       ROUNDED values into a (B, tiles, 2, N) partial buffer, which
//       conv_stats_reduce_kernel sums in ascending order.
//   kIgDownDgrad: the adjoint; input = the cotangent g (B, H/2, W/2, O).
//       Parity phase (pm, pn) of dx takes the taps r = pm + 2 tr <= 2 and
//       s = pn + 2 tc <= 2 (4, 2, 2, 1 taps): dx[2i + pm, 2j + pn] =
//       sum g[i - tr, j - tc] . w[r, s]^T; negative g rows and columns are
//       zero.
//   kIgUpDgrad: the adjoint of nearest x2 + 3x3 conv as 16 low-resolution
//       taps (di, dj, a, b), t = 8 di + 4 dj + 2 a + b; input = the
//       cotangent g (B, 2H, 2W, O), weights k22 (16, C, O) as they lie:
//       dx[i, j] = sum g[2 (i - dr) + di, 2 (j - dc) + dj] . k22[t]^T with
//       dr = di + a - 1, dc = dj + b - 1; a term whose i - dr or j - dc
//       leaves the image is zero.
//
// What bounds it on an H100: every main-path launch is 7.73e10 FLOP
// (0.078 ms at the bf16 peak) against 89 to 604 MB (the forward at 256^2
// reads x and add, 2 x 268 MB: 0.180 ms of bytes).  The wmma body ran at
// 91-116 TFLOP/s: one shared buffer filled by register prefetch behind two
// block barriers a 32-channel step, address math for every element, and a
// 66 KB float32 C tile in shared memory.  The upsample's dgrad is 1.37e11
// (32^2) and 5.50e11 FLOP (64^2, 128^2) against 92 to 673 MB: the tensor
// cores (0.14 and 0.56 ms); the wmma body ran it at 130 TFLOP/s.
//
// The design, as conv_wgrad.cuh's:
// - TMA, no address math per element.  A block's M tile is a tile_h x
//   tile_w rectangle of 128 pixels of one sample's grid (igemm_tile, the
//   widest that covers the grid with the fewest pixels); a K step is 64
//   channels of one tap: one box of the 4-D map (channel, column, row,
//   sample), a 128-byte swizzled row per pixel.  The forward's maps on x
//   and add step by 2 in rows and columns (element strides), origin
//   (c0, 2 w0 + s, 2 h0 + r, b); dgrad's map on g steps by 1, origin
//   (o0, w0 - tc, h0 - tr, b); the upsample dgrad's map on g steps by 2,
//   origin (o0, 2 w0 + 2 - dj - 2 b, 2 h0 + 2 - di - 2 a, b).  The zero
//   fill of out-of-bounds and negative coordinates is the pad, the phases'
//   missing rows, the upsample's masked halo and the ragged edges: no
//   padded or zero-stuffed copy of any operand is made.
// - The weights by TMA as they lie, a 4-D map (O, C, s, r): HWIO (3, 3)
//   taps, k22 (4, 4): s = 2 a + b, r = 2 di + dj.  The forward's
//   B[k = c][n = o] is N-major (the transpose bit: an MN-major descriptor),
//   both dgrads' B[k = o][n = c] is K-major; no transposed copy.
// - wgmma m64n128k16 (bf16, float32 accumulators; BN = 256 is two of them
//   a k16 step).  Two consumer warpgroups own 64 rows each; one producer
//   thread keeps a ring of stages in flight on full / empty mbarriers.
// - The A operand's transform is a hook (AX): AIdentity reads A from shared
//   memory (wgmma's SS form); AAdd reads the x and add tiles with ldmatrix,
//   sums each pair in float32, rounds once to bf16 and issues the register
//   form (RS).  A GroupNorm + swish transform is the same hook.
// - Epilogue from registers: (+ bias,) rounding to bf16, staged through the
//   ring as a swizzled bf16 tile, stored with 16-byte stores (the
//   downsample dgrad at its phase's interleaved pixels); the forward's
//   statistics are a column pass over the staged tile (64 or 128 rows a
//   thread, ascending) and a fixed two-part sum.  No split-K and no float atomics: y, the statistics and
//   dx repeat bit for bit.
// - Occupancy: 288 threads.  BN = 128 (N not a multiple of 256) without
//   the add fits two blocks an SM, so one block's prologue and epilogue
//   hide behind the other's products; the add's BN = 128 runs one block an
//   SM with four stages (two blocks leave too few registers for its
//   register-A products); BN = 256 runs one block an SM and reads half the
//   A tiles per FLOP.  The dgrad grid runs the longest phase first.
//
// ops/downsample_conv.py igemm_plan mirrors the tile, stage and shared
// memory rules below.
#pragma once

#include "conv_igemm.cuh"  // bf16, conv_stats_reduce_kernel
#include "sm90.cuh"

namespace gvq {
namespace {

enum IgemmMode { kIgDownFwd = 0, kIgDownDgrad = 1, kIgUpDgrad = 2 };

constexpr int kIgBM = 128;             // output pixels a block: one spatial tile
constexpr int kIgBK = 64;              // channels a K step
constexpr int kIgTile = kIgBM * 128;   // one A (or add) tile of a stage: 16 KB
constexpr int kIgThreads = 288;        // two consumer warpgroups + one producer warp
constexpr int kIgConsumerWarps = 8;

// Blocks an SM, stages and shared memory of a block with `extra` tiles
// beside A (the add) and an N tile of bn: two blocks an SM at bn = 128
// without extra tiles (three stages each), else one (three or four
// stages): at two blocks an SM a thread has 96 registers, and the add's
// register-A products then serialise for want of them (ptxas C7512)
// (ops/downsample_conv.py igemm_blocks_per_sm / igemm_stages / igemm_smem
// are the same rules).
__host__ __device__ constexpr int ig_blocks_per_sm(int extra, int bn) {
  return bn == 128 && extra == 0 ? 2 : 1;
}
__host__ __device__ constexpr int ig_stage_bytes(int extra, int bn) {
  return (1 + extra) * kIgTile + bn * 128;
}
__host__ __device__ constexpr int ig_stages(int extra, int bn) {
  return ig_blocks_per_sm(extra, bn) == 2 || (extra && bn == 256) ? 3 : 4;
}
__host__ __device__ constexpr size_t ig_smem(int extra, int bn) {  // + barriers + alignment slack
  return (size_t)ig_stages(extra, bn) * ig_stage_bytes(extra, bn) + 2 * ig_stages(extra, bn) * 8 +
         1024;
}
inline int igemm_tile_n(int n) { return n % 256 == 0 ? 256 : 128; }

// The spatial tile of a block on an (mh, mw) pixel grid: tile_w in {128,
// 64, 32, 16, 8} and tile_h = 128 / tile_w, the widest that covers the grid
// with the fewest pixels (ops/downsample_conv.py igemm_tile is the same rule).
inline void igemm_tile(int mh, int mw, int* tile_h, int* tile_w) {
  long long best = -1;
  for (int tw = kIgBM; tw >= 8; tw /= 2) {
    const int th = kIgBM / tw;
    const long long cover =
        (long long)((mh + th - 1) / th) * th * (long long)((mw + tw - 1) / tw) * tw;
    if (best < 0 || cover < best) {
      best = cover;
      *tile_h = th;
      *tile_w = tw;
    }
  }
}

struct IgemmArgs {
  const float* bias;  // (N,) bf16-rounded values as float32 (forward); null for dgrad
  bf16* out;          // forward: y (B, Mh, Mw, N); dgrad: dx (B, 2 Mh, 2 Mw, N);
                      // up dgrad: dx (B, Mh, Mw, N)
  float* partial;     // forward: (B, tiles, 2, N) per-block statistics
  int B, Mh, Mw;      // the M grid of one sample (and phase); up dgrad: dx's (H, W)
  int N, K;           // output channels; channels of a tap
  int tile_h, tile_w, tiles_w, tiles;  // spatial tile; tiles across the grid; tiles a sample
  int n_tiles;        // N tiles of BN
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the eight consumer warps only (the producer warp has left)
__device__ __forceinline__ void ig_consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// two bf16 pairs summed in float32 and rounded once (add_bf16x8's numerics)
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  return pack_bf16x2(fa.x + fb.x, fa.y + fb.y);
}

// A transforms.  kExtra: tiles a stage holds beside A (each kIgTile bytes,
// right after it, same layout); kRegisters: A reaches wgmma through
// registers, built by frag() from the stage's tiles for one k16 step: `a`
// is this lane's ldmatrix address in the A tile (row, 16-byte chunk, with
// the swizzle applied), the same offset in each extra tile.
struct AIdentity {
  static constexpr int kExtra = 0;
  static constexpr bool kRegisters = false;
};

struct AAdd {  // x + add, summed in float32, rounded once to bf16
  static constexpr int kExtra = 1;
  static constexpr bool kRegisters = true;
  __device__ static void frag(uint32_t (&f)[4], uint32_t a) {
    uint32_t x[4], y[4];
    ldsm_x4(x, a);
    ldsm_x4(y, a + kIgTile);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = add_bf16x2(x[i], y[i]);
  }
};

// D (64 x 128, float32) += A (64 x 16) . B (16 x 128): A K-major and B
// MN-major (transpose bit) in shared memory
__device__ __forceinline__ void wgmma_ss_bt128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int MODE, int BN, class AX>
__global__ void __launch_bounds__(kIgThreads, ig_blocks_per_sm(AX::kExtra, BN))
conv_igemm_sm90_kernel(const __grid_constant__ CUtensorMap tmap_a,
                       const __grid_constant__ CUtensorMap tmap_add,
                       const __grid_constant__ CUtensorMap tmap_w, IgemmArgs a) {
  constexpr bool FWD = MODE == kIgDownFwd;
  constexpr bool UP = MODE == kIgUpDgrad;
  constexpr int STAGES = ig_stages(AX::kExtra, BN);
  constexpr int STAGE = ig_stage_bytes(AX::kExtra, BN);
  constexpr int B_OFF = (1 + AX::kExtra) * kIgTile;  // the weight tile of a stage
  constexpr int NH = BN / 128;                        // 128-column products a k16 step
  constexpr int PITCH = BN * 2;                       // bytes a row of the staged output
  static_assert(kIgBM * PITCH + 2 * BN * 4 <= STAGES * STAGE, "the epilogue reuses the ring");
  extern __shared__ unsigned char ig_smem_raw[];
  const uint32_t raw = wg_smem_addr(ig_smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle's 1024-byte atom
  unsigned char* const ring_p = ig_smem_raw + (ring - raw);
  const uint32_t full_bar = ring + STAGES * STAGE;  // 8 bytes per stage
  const uint32_t empty_bar = full_bar + STAGES * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // block -> (phase, sample, spatial tile, N tile), the N tile fastest (the
  // blocks of one A tile run together), the phase slowest (dgrad's phases in
  // order 0..3 have 4, 2, 2, 1 taps: the longest first)
  int rest = blockIdx.x;
  const int nt = rest % a.n_tiles;
  rest /= a.n_tiles;
  const int mt = rest % a.tiles;
  rest /= a.tiles;
  const int b = rest % a.B;
  const int phase = rest / a.B;
  const int pm = phase >> 1, pn = phase & 1;
  const int h0 = (mt / a.tiles_w) * a.tile_h, w0 = (mt % a.tiles_w) * a.tile_w;
  const int n0 = nt * BN;
  const int taps_s = FWD ? 3 : UP ? 4 : (pn == 0 ? 2 : 1);  // column taps
  const int taps = (FWD ? 3 : UP ? 4 : (pm == 0 ? 2 : 1)) * taps_s;
  const int kc = (a.K + kIgBK - 1) / kIgBK;  // K steps a tap
  const int nsteps = taps * kc;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);                  // the producer's arrive; the copies' bytes
      mbar_init(empty_bar + 8 * s, kIgConsumerWarps);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kIgConsumerWarps) {  // producer: one thread issues every copy
    if (lane != 0) return;
    for (int ks = 0; ks < nsteps; ++ks) {
      const int s = ks % STAGES;
      mbar_wait(empty_bar + 8 * s, ((ks / STAGES) & 1) ^ 1);  // a fresh stage passes
      const uint32_t bar = full_bar + 8 * s;
      mbar_arrive_expect_tx(bar, STAGE);
      const int t = ks / kc;
      const int k0 = (ks - t * kc) * kIgBK;
      const int tr = t / taps_s, tc = t - tr * taps_s;
      const uint32_t dst = ring + s * STAGE;
      if (FWD) {  // tap (r, s) = (tr, tc); the maps step by 2
        tma_load_4d(dst, &tmap_a, bar, k0, 2 * w0 + tc, 2 * h0 + tr, b);
        if (AX::kExtra) tma_load_4d(dst + kIgTile, &tmap_add, bar, k0, 2 * w0 + tc, 2 * h0 + tr, b);
#pragma unroll
        for (int h = 0; h < BN / 64; ++h)  // B[k = c][n = o]: 64 c rows of 64 o a box
          tma_load_4d(dst + B_OFF + h * 8192, &tmap_w, bar, n0 + 64 * h, k0, tc, tr);
      } else if (UP) {  // tap t = (di, dj, a, b); the map on g steps by 2
        const int di = t >> 3, dj = (t >> 2) & 1, ta = (t >> 1) & 1, tb = t & 1;
        tma_load_4d(dst, &tmap_a, bar, k0, 2 * w0 + 2 - dj - 2 * tb, 2 * h0 + 2 - di - 2 * ta, b);
        tma_load_4d(dst + B_OFF, &tmap_w, bar, k0, n0, 2 * ta + tb, 2 * di + dj);  // BN c rows
      } else {  // tap (r, s) = (pm + 2 tr, pn + 2 tc) reads g[i - tr, j - tc]
        tma_load_4d(dst, &tmap_a, bar, k0, w0 - tc, h0 - tr, b);
        tma_load_4d(dst + B_OFF, &tmap_w, bar, k0, n0, pn + 2 * tc, pm + 2 * tr);  // BN c rows
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. + 63 of the tile, warp w of
  // it rows 16 w .. + 15
  const int wg = warp >> 2;
  float acc[NH][64];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.0f;
  // this lane's ldmatrix row and 16-byte chunk of a k16 step (x4: matrices
  // rows 0-7 / 8-15 x k 0-7 / 8-15 in fragment order), and its swizzle
  const int lrow = wg * 64 + (warp & 3) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t lrow_off = lrow * 128;
  const int lchunk = lane >> 4;

  for (int ks = 0; ks < nsteps; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(full_bar + 8 * s, (ks / STAGES) & 1);
    const uint32_t st = ring + s * STAGE;
    if constexpr (AX::kRegisters) {
      // two fragment buffers (8 registers): k16 step kk + 1's fragment is
      // built while step kk's products run, into the buffer that step
      // kk - 1's products have released
      uint32_t f[2][4];
      AX::frag(f[0], st + lrow_off + ((lchunk ^ (lrow & 7)) << 4));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < NH; ++h) wg_fence_acc(acc[h]);
        wg_fence_frag(f);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int h = 0; h < NH; ++h)  // B MN-major: two 64-column chunks 8 KB apart
          wgmma_rs<128>(acc[h], f[kk & 1],
                        wg_desc(st + B_OFF + h * 16384 + kk * 2048, 8192, 1024));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (kk < 3) {
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // step kk - 1's
          wg_fence_frag(f);
          AX::frag(f[(kk + 1) & 1],
                   st + lrow_off + (((2 * (kk + 1) + lchunk) ^ (lrow & 7)) << 4));
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int h = 0; h < NH; ++h) wg_fence_acc(acc[h]);
      wg_fence_frag(f);
      if (lane == 0) mbar_arrive(empty_bar + 8 * s);
    } else {
#pragma unroll
      for (int h = 0; h < NH; ++h) wg_fence_acc(acc[h]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = wg_desc(st + wg * 8192 + kk * 32, 16, 1024);  // K-major pixel rows
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          if (FWD)  // B MN-major: two 64-column chunks 8 KB apart, 16 k rows a step
            wgmma_ss_bt128(acc[h], da, wg_desc(st + B_OFF + h * 16384 + kk * 2048, 8192, 1024));
          else  // B K-major: 128 c rows of 128 bytes
            wgmma_ss<128>(acc[h], da, wg_desc(st + B_OFF + h * 16384 + kk * 32, 16, 1024), 1);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // the previous step's group
#pragma unroll
      for (int h = 0; h < NH; ++h) wg_fence_acc(acc[h]);
      if (ks > 0 && lane == 0) mbar_arrive(empty_bar + 8 * ((ks - 1) % STAGES));
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int h = 0; h < NH; ++h) wg_fence_acc(acc[h]);

  // Epilogue.  Every consumer is done with the ring (and every copy has
  // landed): stage the rounded tile there, row p at p * PITCH, its 16-byte
  // chunks XOR-swizzled by p % 8.  Accumulator fragment: acc[h][4 j + e] is
  // row (lane / 4) + 8 (e / 2) of the warp's 16, column 128 h + 8 j +
  // 2 (lane % 4) + e % 2.  Pixels off the grid stage 0 (the statistics add
  // nothing for them) and are not stored.
  ig_consumers_sync();
  const int q = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * half;
    const int ti = row / a.tile_w, tj = row - ti * a.tile_w;
    const bool valid = h0 + ti < a.Mh && w0 + tj < a.Mw;
    unsigned char* srow = ring_p + row * PITCH;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float v0 = acc[h][4 * j + 2 * half], v1 = acc[h][4 * j + 2 * half + 1];
        if (FWD) {
          const float2 bb =
              __ldg(reinterpret_cast<const float2*>(a.bias + n0 + 128 * h + 8 * j + 2 * q));
          v0 += bb.x;
          v1 += bb.y;
        }
        const int chunk = (h * 16 + j) ^ (row & 7);
        *reinterpret_cast<uint32_t*>(srow + chunk * 16 + q * 4) = valid ? pack_bf16x2(v0, v1) : 0u;
      }
  }
  ig_consumers_sync();

  // 16-byte stores: y or the upsample's dx rows of the tile, or the
  // downsample's dx at the phase's pixels
  constexpr int CHUNKS = BN / 8;
  for (int id = tid; id < kIgBM * CHUNKS; id += 32 * kIgConsumerWarps) {
    const int row = id / CHUNKS, ch = id - row * CHUNKS;
    const int ti = row / a.tile_w, tj = row - ti * a.tile_w;
    const int mh = h0 + ti, mw = w0 + tj, n = n0 + 8 * ch;
    if (mh < a.Mh && mw < a.Mw && n < a.N) {
      const uint4 v = *reinterpret_cast<const uint4*>(ring_p + row * PITCH + ((ch ^ (row & 7)) << 4));
      const size_t off = MODE != kIgDownDgrad
                             ? (((size_t)b * a.Mh + mh) * a.Mw + mw) * a.N + n
                             : (((size_t)b * 2 * a.Mh + 2 * mh + pm) * (2 * a.Mw) + 2 * mw + pn) *
                                       a.N + n;
      *reinterpret_cast<uint4*>(a.out + off) = v;
    }
  }
  if (!FWD) return;

  // per-block column statistics of the rounded values: a thread sums one
  // column over 128 / PARTS rows in ascending order; the parts add in order
  constexpr int PARTS = 32 * kIgConsumerWarps / BN;  // 2 at BN = 128, 1 at 256
  constexpr int ROWS = kIgBM / PARTS;
  const int col = tid % BN, part = tid / BN;
  float sum = 0.0f, sumsq = 0.0f;
  for (int r = part * ROWS; r < (part + 1) * ROWS; ++r) {
    const unsigned char* e = ring_p + r * PITCH + ((((col >> 3) ^ (r & 7)) << 4) | ((col & 7) * 2));
    const float v = __bfloat162float(*reinterpret_cast<const bf16*>(e));
    sum += v;
    sumsq += v * v;
  }
  if (PARTS == 2) {
    float* red = reinterpret_cast<float*>(ring_p + kIgBM * PITCH);
    if (part == 1) {
      red[col] = sum;
      red[BN + col] = sumsq;
    }
    ig_consumers_sync();
    if (part == 1) return;
    sum += red[col];
    sumsq += red[BN + col];
  }
  float* dst = a.partial + ((size_t)b * a.tiles + mt) * 2 * a.N + n0 + col;
  dst[0] = sum;
  dst[a.N] = sumsq;
}

// A 4-D bf16 map, dims innermost first, byte strides of dims 1..3, written
// with the 128-byte swizzle, zero fill out of bounds.
inline bool ig_encode(CUtensorMap* map, const bf16* base, const cuuint64_t (&dims)[4],
                      const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4],
                      const cuuint32_t (&elem)[4]) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// NHWC (n, h, w, c) as (channel, column, row, sample); a box of 64 channels
// x the spatial tile, reading every `step`-th row and column
inline bool ig_nhwc_map(CUtensorMap* map, const bf16* base, int n, int h, int w, int c,
                        int tile_h, int tile_w, int step) {
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)w * c * 2,
                                 (cuuint64_t)h * w * c * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)(tile_w * step), (cuuint32_t)(tile_h * step), 1};
  const cuuint32_t elem[4] = {1, (cuuint32_t)step, (cuuint32_t)step, 1};
  return ig_encode(map, base, dims, strides, box, elem);
}

// (taps, taps, C, O) weights (HWIO: 3 x 3; k22 (2, 2, 2, 2, C, O): 4 x 4)
// as (o, c, s, r); a box of 64 o x `rows` c of one tap
inline bool ig_weight_map(CUtensorMap* map, const bf16* w, int c, int o, int rows, int taps) {
  const cuuint64_t dims[4] = {(cuuint64_t)o, (cuuint64_t)c, (cuuint64_t)taps, (cuuint64_t)taps};
  const cuuint64_t strides[3] = {(cuuint64_t)o * 2, (cuuint64_t)c * o * 2,
                                 (cuuint64_t)taps * c * o * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return ig_encode(map, w, dims, strides, box, elem);
}

template <int MODE, int BN, class AX>
inline cudaError_t launch_igemm_sm90(const CUtensorMap& ta, const CUtensorMap& tadd,
                                     const CUtensorMap& tw, const IgemmArgs& a, long long blocks,
                                     cudaStream_t stream) {
  const size_t smem = ig_smem(AX::kExtra, BN);
  cudaError_t err = cudaFuncSetAttribute(conv_igemm_sm90_kernel<MODE, BN, AX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv_igemm_sm90_kernel<MODE, BN, AX>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  conv_igemm_sm90_kernel<MODE, BN, AX>
      <<<(unsigned)blocks, kIgThreads, smem, stream>>>(ta, tadd, tw, a);
  return cudaGetLastError();
}

// The block geometry of a launch over B samples of an (mh, mw) grid and
// `phases` phases, N output channels, K channels a tap; false where the
// grid does not fit one launch.
inline bool igemm_args(IgemmArgs* a, int B, int mh, int mw, int N, int K, int phases,
                       long long* blocks) {
  a->B = B;
  a->Mh = mh;
  a->Mw = mw;
  a->N = N;
  a->K = K;
  igemm_tile(mh, mw, &a->tile_h, &a->tile_w);
  a->tiles_w = (mw + a->tile_w - 1) / a->tile_w;
  const long long tiles = (long long)((mh + a->tile_h - 1) / a->tile_h) * a->tiles_w;
  const int bn = igemm_tile_n(N);
  a->n_tiles = (N + bn - 1) / bn;
  *blocks = (long long)phases * B * tiles * a->n_tiles;
  a->tiles = (int)tiles;
  return B > 0 && mh > 0 && mw > 0 && N > 0 && K > 0 && tiles <= 0x7fffffff &&
         *blocks <= 0x7fffffff;
}

}  // namespace
}  // namespace gvq
