// Implicit-GEMM 3x3 convolution body designed for Hopper (sm_90a), for the
// stride-2 downsample's forward (downsample_conv.cu) and input gradient
// (downsample_bwd.cu), the nearest-x2 upsample's forward (upsample_conv.cu)
// and input gradient (upsample_bwd.cu), and the fused GroupNorm + swish +
// 3x3 conv (fused_gn_conv.cu, bf16).
//
// Replaces the TPU kernels of vqvae_from_gaussian_vae_tpu/ops/downsample_conv.py
//   kIgDownFwd   <- _downsample_conv  -> pl.pallas_call (body _kernel)
//   kIgDownDgrad <- _downsample_dgrad -> pl.pallas_call (body _dgrad_kernel)
// of vqvae_from_gaussian_vae_tpu/ops/upsample_conv.py
//   kIgUpFwd     <- _upsample_conv_hwbc -> pl.pallas_call (body _kernel_hwbc)
//   kIgUpDgrad   <- _upsample_dgrad   -> pl.pallas_call (body _dgrad_kernel_hwbc)
// and of vqvae_from_gaussian_vae_tpu/ops/fused_gn_conv.py
//   kIgSameGn    <- _fused_gn_swish_conv -> pl.pallas_call (body _kernel)
//
//   M = output pixels of one sample (of one phase where the op has four),
//   N = output channels, K = taps x input channels:
//   kIgDownFwd: 9 taps (r, s); output pixel (i, j) reads x (or x + add,
//       summed in float32 and rounded once to bf16) at (2i + r, 2j + s);
//       row H and column W are the (0,1) zero pad.  Epilogue: + bias,
//       rounded to bf16, and per-block column (sum, sum of squares) of the
//       ROUNDED values into a (B, phases x tiles, 2, N) partial buffer,
//       which conv_stats_reduce_kernel sums in ascending order.
//   kIgDownDgrad: the adjoint; input = the cotangent g (B, H/2, W/2, O).
//       Parity phase (pm, pn) of dx takes the taps r = pm + 2 tr <= 2 and
//       s = pn + 2 tc <= 2 (4, 2, 2, 1 taps): dx[2i + pm, 2j + pn] =
//       sum g[i - tr, j - tc] . w[r, s]^T; negative g rows and columns are
//       zero.
//   kIgUpFwd: nearest x2 then the 3x3 same conv, as four phases (di, dj)
//       of 4 low-resolution taps (a, b) with the phase kernels k22 (2, 2,
//       2, 2, C, O): y[2i + di, 2j + dj] = bias + sum (x or x + add)[i + di
//       + a - 1, j + dj + b - 1] . k22[di, dj, a, b], rows and columns off
//       the image zero; the forward's epilogue, statistics over all four
//       phases, stored at the phase's interleaved pixels.
//   kIgUpDgrad: the adjoint of nearest x2 + 3x3 conv as 16 low-resolution
//       taps (di, dj, a, b), t = 8 di + 4 dj + 2 a + b; input = the
//       cotangent g (B, 2H, 2W, O), weights k22 (16, C, O) as they lie:
//       dx[i, j] = sum g[2 (i - dr) + di, 2 (j - dc) + dj] . k22[t]^T with
//       dr = di + a - 1, dc = dj + b - 1; a term whose i - dr or j - dc
//       leaves the image is zero.
//   kIgSameGn: 9 taps (r, s) of h = swish(x . scale + shift) (the
//       per-(sample, channel) GroupNorm affine, float32, rounded once to
//       bf16) zero-padded AFTER the transform; + the float32 bias and the
//       optional bf16 residual (B, H, W, O), summed in float32 and rounded
//       once; no statistics.
//
// What bounds it on an H100: every downsample launch is 7.73e10 FLOP
// (0.078 ms at the bf16 peak) against 89 to 604 MB (the forward at 256^2
// reads x and add, 2 x 268 MB: 0.180 ms of bytes).  The upsample's
// forward and dgrad are 1.37e11 (32^2) and 5.50e11 FLOP (64^2, 128^2)
// against 89 to 807 MB: the tensor cores (0.14 and 0.56 ms).  The fused
// GroupNorm conv is 7.73e10 to 6.18e11 FLOP against 38 to 806 MB: the
// tensor cores again, with two MUFU operations (exp, reciprocal) for each
// transformed input element beside them.
//
// The design, as conv_wgrad.cuh's:
// - TMA, no address math per element.  A block's M tile is a tile_h x
//   tile_w rectangle of 128 pixels of one sample's grid (igemm_tile, the
//   widest that covers the grid with the fewest pixels; 8 x 16 for
//   kIgSameGn); a K step is 64 channels of one tap: one box of the 4-D map
//   (channel, column, row, sample), a 128-byte swizzled row per pixel.  The
//   downsample forward's maps on x and add step by 2 in rows and columns
//   (element strides), origin (c0, 2 w0 + s, 2 h0 + r, b); dgrad's map on
//   g steps by 1, origin (o0, w0 - tc, h0 - tr, b); the upsample forward's
//   maps step by 1, origin (c0, w0 + dj + b - 1, h0 + di + a - 1, b); the
//   upsample dgrad's map on g steps by 2, origin (o0, 2 w0 + 2 - dj - 2 b,
//   2 h0 + 2 - di - 2 a, b).  The zero fill of out-of-bounds and negative
//   coordinates is the pad, the phases' missing rows, the upsample's halo
//   and the ragged edges: no padded or zero-stuffed copy of any operand.
// - kIgSameGn transforms each input element about once, not once a tap:
//   for each 64-channel K step the producer loads the tile's halo box,
//   (8 + 2) x (16 + 2) pixels (one box, zero fill), into one of three halo
//   buffers; the consumers rewrite it in place as h, writing 0 for every
//   pixel off the image and every channel past C (the pad applies after
//   the transform), a sixth of it after each of the previous K step's
//   first six taps, while that step's products run; the nine taps then
//   read shifted windows of the buffer with ldmatrix (per-lane row
//   addresses: a shift is free) into register A fragments, while the
//   taps' weight tiles stream through the ring.  (180 / 128 = 1.4
//   transforms an element, against 9 for a transform on each tap's tile.)
// - The weights by TMA as they lie, a 4-D map (O, C, s, r): HWIO (3, 3)
//   taps, k22 (4, 4): s = 2 a + b, r = 2 di + dj.  The forwards' B[k = c]
//   [n = o] is N-major (the transpose bit: an MN-major descriptor), both
//   dgrads' B[k = o][n = c] is K-major; no transposed copy.
// - wgmma m64n128k16 (bf16, float32 accumulators; BN = 256 is two of them
//   a k16 step).  Two consumer warpgroups own 64 rows each; one producer
//   thread keeps a ring of stages in flight on full / empty mbarriers.
// - The A operand's source is a hook (AX): AIdentity reads A from shared
//   memory (wgmma's SS form); AAdd reads the x and add tiles with ldmatrix,
//   sums each pair in float32, rounds once to bf16 and issues the register
//   form (RS); AGn reads the transformed halo buffer (RS).
// - Epilogue from registers: (+ bias, + residual,) rounding to bf16, staged
//   through the ring as a swizzled bf16 tile, stored with 16-byte stores
//   (the downsample dgrad and the upsample forward at their phase's
//   interleaved pixels); the forwards' statistics are a column pass over
//   the staged tile (64 or 128 rows a thread, ascending) and a fixed
//   two-part sum.  No split-K and no float atomics: y, the statistics and
//   dx repeat bit for bit.
// - Occupancy: 288 threads (kIgSameGn: 384, setmaxnreg giving the
//   consumers 232 registers a thread for the accumulators, the fragments
//   and the transform).  BN = 128 (N not a multiple of 256) with the
//   A operand in shared memory fits two blocks an SM, so one block's
//   prologue and epilogue hide behind the other's products; the register
//   forms run one block an SM (two blocks leave too few registers for
//   register-A products); BN = 256 runs one block an SM and reads half the
//   A tiles per FLOP.  The dgrad grid runs the longest phase first; the
//   upsample forward's grid runs a tile's four phases together, so they
//   share its input through L2.
//
// ops/downsample_conv.py igemm_plan mirrors the tile, stage and shared
// memory rules below.
#pragma once

#include "conv_common.cuh"  // bf16, the GN + swish transform, conv_stats_reduce_kernel
#include "sm90.cuh"

namespace gvq {
namespace {

enum IgemmMode { kIgDownFwd = 0, kIgDownDgrad = 1, kIgUpDgrad = 2, kIgUpFwd = 3, kIgSameGn = 4 };

constexpr int kIgBM = 128;             // output pixels a block: one spatial tile
constexpr int kIgBK = 64;              // channels a K step
constexpr int kIgTile = kIgBM * 128;   // one A (or add) tile of a stage: 16 KB
constexpr int kIgConsumerWarps = 8;    // two consumer warpgroups
// + one producer warp; kIgSameGn: + a producer warpgroup whose registers
// setmaxnreg moves to the consumers (40 left to it, 232 a consumer thread)
__host__ __device__ constexpr int ig_threads(bool halo) { return halo ? 384 : 288; }
constexpr int kIgProducerRegs = 40, kIgConsumerRegs = 232;
// kIgSameGn: an 8 x 16 tile; its halo box, (8 + 2) x (16 + 2) pixels of 64
// channels, in a 1024-byte-aligned buffer, three buffers
constexpr int kIgGnTileH = 8, kIgGnTileW = 16;
constexpr int kIgHaloW = kIgGnTileW + 2;
constexpr int kIgHaloPixels = (kIgGnTileH + 2) * kIgHaloW;  // 180
constexpr int kIgHaloBox = kIgHaloPixels * 128;             // bytes a copy brings
constexpr int kIgHaloBytes = (kIgHaloBox + 1023) / 1024 * 1024;
constexpr int kIgHaloStages = 3;
constexpr int kIgHaloIters = (kIgHaloPixels * 8 + 32 * kIgConsumerWarps - 1) /
                             (32 * kIgConsumerWarps);  // 16-byte chunks a consumer thread

// Blocks an SM, stages and shared memory of a block with `extra` tiles
// beside A (the add), a halo ring in place of A tiles (kIgSameGn) and an N
// tile of bn: two blocks an SM at bn = 128 with A in shared memory (three
// stages each), else one (three or four stages): at two blocks an SM a
// thread has 96 registers, and register-A products then serialise for
// want of them (ptxas C7512) (ops/downsample_conv.py igemm_blocks_per_sm /
// igemm_stages / igemm_smem are the same rules).
__host__ __device__ constexpr int ig_blocks_per_sm(int extra, bool halo, int bn) {
  return bn == 128 && extra == 0 && !halo ? 2 : 1;
}
__host__ __device__ constexpr int ig_stage_bytes(int extra, bool halo, int bn) {
  return (halo ? 0 : (1 + extra) * kIgTile) + bn * 128;
}
__host__ __device__ constexpr int ig_stages(int extra, bool halo, int bn) {
  return ig_blocks_per_sm(extra, halo, bn) == 2 || (extra && bn == 256) ? 3 : 4;
}
__host__ __device__ constexpr int ig_halo_bytes(bool halo) {  // + its barriers
  return halo ? kIgHaloStages * (kIgHaloBytes + 16) : 0;
}
__host__ __device__ constexpr size_t ig_smem(int extra, bool halo, int bn) {
  // + barriers + alignment slack
  return (size_t)ig_stages(extra, halo, bn) * ig_stage_bytes(extra, halo, bn) +
         ig_halo_bytes(halo) + 2 * ig_stages(extra, halo, bn) * 8 + 1024;
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
  const float* bias;   // (N,) float32 (bf16-rounded values for the resamples); null for dgrad
  bf16* out;           // forwards: y (B, Mh, Mw, N), the upsample's (B, 2 Mh, 2 Mw, N);
                       // dgrad: dx (B, 2 Mh, 2 Mw, N); up dgrad: dx (B, Mh, Mw, N)
  float* partial;      // resample forwards: (B, phases x tiles, 2, N) per-block statistics
  const float* scale;  // kIgSameGn: (B, K) GroupNorm affine, float32
  const float* shift;  // (B, K)
  const bf16* res;     // kIgSameGn: the residual (B, Mh, Mw, N) or null
  int B, Mh, Mw;       // the M grid of one sample (and phase); up dgrad: dx's (H, W)
  int N, K;            // output channels; channels of a tap
  int tile_h, tile_w, tiles_w, tiles;  // spatial tile; tiles across the grid; tiles a sample
  int n_tiles;         // N tiles of BN
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

// two bf16 pairs summed in float32 and rounded once (the TPU kernels' bf16 add)
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  return pack_bf16x2(fa.x + fb.x, fa.y + fb.y);
}

// A sources.  kExtra: tiles a stage holds beside A (each kIgTile bytes,
// right after it, same layout); kRegisters: A reaches wgmma through
// registers, built by frag() from the stage's tiles for one k16 step: `a`
// is this lane's ldmatrix address in the A tile (row, 16-byte chunk, with
// the swizzle applied), the same offset in each extra tile; kHalo: A is
// read from the transformed halo buffers, not from the ring.
struct AIdentity {
  static constexpr int kExtra = 0;
  static constexpr bool kRegisters = false;
  static constexpr bool kHalo = false;
};

struct AAdd {  // x + add, summed in float32, rounded once to bf16
  static constexpr int kExtra = 1;
  static constexpr bool kRegisters = true;
  static constexpr bool kHalo = false;
  __device__ static void frag(uint32_t (&f)[4], uint32_t a) {
    uint32_t x[4], y[4];
    ldsm_x4(x, a);
    ldsm_x4(y, a + kIgTile);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = add_bf16x2(x[i], y[i]);
  }
};

struct AGn {  // swish(x . scale + shift), transformed in the halo buffer
  static constexpr int kExtra = 0;
  static constexpr bool kRegisters = true;
  static constexpr bool kHalo = true;
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
__global__ void __launch_bounds__(ig_threads(AX::kHalo),
                                  ig_blocks_per_sm(AX::kExtra, AX::kHalo, BN))
conv_igemm_sm90_kernel(const __grid_constant__ CUtensorMap tmap_a,
                       const __grid_constant__ CUtensorMap tmap_add,
                       const __grid_constant__ CUtensorMap tmap_w, IgemmArgs a) {
  constexpr bool FWD = MODE == kIgDownFwd;
  constexpr bool UP = MODE == kIgUpDgrad;
  constexpr bool UPF = MODE == kIgUpFwd;
  constexpr bool GN = MODE == kIgSameGn;
  static_assert(GN == AX::kHalo, "kIgSameGn reads A from the halo buffers, and only it");
  constexpr bool STATS = FWD || UPF;                        // bias, statistics
  constexpr bool BMN = FWD || UPF || GN;                    // B[k = c][n = o]: N-major
  constexpr bool INTERLEAVE = MODE == kIgDownDgrad || UPF;  // out at the phase's pixels
  constexpr int STAGES = ig_stages(AX::kExtra, AX::kHalo, BN);
  constexpr int STAGE = ig_stage_bytes(AX::kExtra, AX::kHalo, BN);
  constexpr int B_OFF = AX::kHalo ? 0 : (1 + AX::kExtra) * kIgTile;  // the weight tile of a stage
  constexpr int NH = BN / 128;                        // 128-column products a k16 step
  constexpr int PITCH = BN * 2;                       // bytes a row of the staged output
  constexpr int HALO = GN ? kIgHaloStages * kIgHaloBytes : 0;  // the halo buffers, before the ring
  static_assert(kIgBM * PITCH + 2 * BN * 4 <= HALO + STAGES * STAGE,
                "the epilogue reuses the halo buffers and the ring");
  extern __shared__ unsigned char ig_smem_raw[];
  const uint32_t raw = wg_smem_addr(ig_smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle's 1024-byte atom
  unsigned char* const ring_p = ig_smem_raw + (ring - raw);
  // kIgSameGn: the halo buffers first, then the weight stages
  const uint32_t halo = ring;
  const uint32_t stages = ring + HALO;
  const uint32_t full_bar = stages + STAGES * STAGE;  // 8 bytes per stage
  const uint32_t empty_bar = full_bar + STAGES * 8;
  const uint32_t halo_full = empty_bar + STAGES * 8;  // kIgSameGn: 8 bytes per halo buffer
  const uint32_t halo_empty = halo_full + kIgHaloStages * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // block -> (phase, sample, spatial tile, N tile), the N tile fastest (the
  // blocks of one A tile run together); dgrad's phase slowest (its phases
  // in order 0..3 have 4, 2, 2, 1 taps: the longest first), the upsample
  // forward's next to the N tile (a tile's four phases read one input
  // patch)
  int rest = blockIdx.x;
  const int nt = rest % a.n_tiles;
  rest /= a.n_tiles;
  int phase = 0;
  if (UPF) {
    phase = rest & 3;
    rest >>= 2;
  }
  const int mt = rest % a.tiles;
  rest /= a.tiles;
  const int b = rest % a.B;
  if (!UPF) phase = rest / a.B;
  const int pm = phase >> 1, pn = phase & 1;
  const int h0 = (mt / a.tiles_w) * a.tile_h, w0 = (mt % a.tiles_w) * a.tile_w;
  const int n0 = nt * BN;
  const int taps_s = FWD || GN ? 3 : UP ? 4 : UPF ? 2 : (pn == 0 ? 2 : 1);  // column taps
  const int taps = (FWD || GN ? 3 : UP ? 4 : UPF ? 2 : (pm == 0 ? 2 : 1)) * taps_s;
  const int kc = (a.K + kIgBK - 1) / kIgBK;  // K steps a tap
  const int nsteps = taps * kc;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);                  // the producer's arrive; the copies' bytes
      mbar_init(empty_bar + 8 * s, kIgConsumerWarps);  // one arrive per consumer warp
    }
    if (GN)
      for (int s = 0; s < kIgHaloStages; ++s) {
        mbar_init(halo_full + 8 * s, 1);
        mbar_init(halo_empty + 8 * s, kIgConsumerWarps);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if over the producer warp (kIgSameGn: warpgroup) that returns, so
  // that setmaxnreg moves its registers to the consumers
  if (warp >= kIgConsumerWarps) {  // producer: one thread issues every copy
    if constexpr (GN) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kIgProducerRegs) : "memory");
      if (warp != kIgConsumerWarps) return;
    }
    if (lane != 0) return;
    if constexpr (GN) {
      // K step k0 (64 channels): the halo box, then the nine taps' weight
      // tiles; the next step's halo goes out before this step's weights
      auto load_halo = [&](int c) {
        const int hs = c % kIgHaloStages;
        mbar_wait(halo_empty + 8 * hs, ((c / kIgHaloStages) & 1) ^ 1);
        mbar_arrive_expect_tx(halo_full + 8 * hs, kIgHaloBox);
        tma_load_4d(halo + hs * kIgHaloBytes, &tmap_a, halo_full + 8 * hs, c * kIgBK, w0 - 1,
                    h0 - 1, b);
      };
      load_halo(0);
      int ks = 0;
      for (int c = 0; c < kc; ++c) {
        if (c + 1 < kc) load_halo(c + 1);
        for (int t = 0; t < 9; ++t, ++ks) {
          const int s = ks % STAGES;
          mbar_wait(empty_bar + 8 * s, ((ks / STAGES) & 1) ^ 1);
          const uint32_t bar = full_bar + 8 * s;
          mbar_arrive_expect_tx(bar, STAGE);
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)  // B[k = c][n = o]: 64 c rows of 64 o a box
            tma_load_4d(stages + s * STAGE + h * 8192, &tmap_w, bar, n0 + 64 * h, c * kIgBK,
                        t % 3, t / 3);
        }
      }
    } else {
      for (int ks = 0; ks < nsteps; ++ks) {
        const int s = ks % STAGES;
        mbar_wait(empty_bar + 8 * s, ((ks / STAGES) & 1) ^ 1);  // a fresh stage passes
        const uint32_t bar = full_bar + 8 * s;
        mbar_arrive_expect_tx(bar, STAGE);
        const int t = ks / kc;
        const int k0 = (ks - t * kc) * kIgBK;
        const int tr = t / taps_s, tc = t - tr * taps_s;
        const uint32_t dst = stages + s * STAGE;
        if (FWD || UPF) {
          // downsample: tap (r, s) = (tr, tc), the maps step by 2; upsample:
          // phase (di, dj) = (pm, pn), tap (a, b) = (tr, tc), the maps step by 1
          const int cx = FWD ? 2 * w0 + tc : w0 + pn + tc - 1;
          const int cy = FWD ? 2 * h0 + tr : h0 + pm + tr - 1;
          tma_load_4d(dst, &tmap_a, bar, k0, cx, cy, b);
          if (AX::kExtra) tma_load_4d(dst + kIgTile, &tmap_add, bar, k0, cx, cy, b);
          const int ws = FWD ? tc : 2 * tr + tc, wr = FWD ? tr : 2 * pm + pn;
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)  // B[k = c][n = o]: 64 c rows of 64 o a box
            tma_load_4d(dst + B_OFF + h * 8192, &tmap_w, bar, n0 + 64 * h, k0, ws, wr);
        } else if (UP) {  // tap t = (di, dj, a, b); the map on g steps by 2
          const int di = t >> 3, dj = (t >> 2) & 1, ta = (t >> 1) & 1, tb = t & 1;
          tma_load_4d(dst, &tmap_a, bar, k0, 2 * w0 + 2 - dj - 2 * tb, 2 * h0 + 2 - di - 2 * ta, b);
          tma_load_4d(dst + B_OFF, &tmap_w, bar, k0, n0, 2 * ta + tb, 2 * di + dj);  // BN c rows
        } else {  // tap (r, s) = (pm + 2 tr, pn + 2 tc) reads g[i - tr, j - tc]
          tma_load_4d(dst, &tmap_a, bar, k0, w0 - tc, h0 - tr, b);
          tma_load_4d(dst + B_OFF, &tmap_w, bar, k0, n0, pn + 2 * tc, pm + 2 * tr);  // BN c rows
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. + 63 of the tile, warp w of
  // it rows 16 w .. + 15
  if constexpr (GN)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kIgConsumerRegs) : "memory");
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

  if constexpr (GN) {
    // the halo buffer of K step c, rewritten in place: 16-byte chunk id
    // (pixel p = id / 8 of the box, channels 8 (id % 8) .. + 7 of the step)
    // becomes h, or 0 off the image and past C
    auto transform = [&](int c, int i) {
      const int id = tid + i * 32 * kIgConsumerWarps;
      if (id >= kIgHaloPixels * 8) return;
      const int p = id >> 3, k = id & 7;
      const int r = p / kIgHaloW, y = h0 - 1 + r, x = w0 - 1 + p - r * kIgHaloW;
      const int ch = c * kIgBK + 8 * k;
      uint4* e = reinterpret_cast<uint4*>(ring_p + (c % kIgHaloStages) * kIgHaloBytes + p * 128 +
                                          ((k ^ (p & 7)) << 4));
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (y >= 0 && y < a.Mh && x >= 0 && x < a.Mw && ch < a.K) {
        const size_t off = (size_t)b * a.K + ch;
        v = gn_swish_bf16x8(*e, a.scale + off, a.shift + off);
      }
      *e = v;
    };
    // this lane's fragment of tap t (r, s) = (t / 3, t % 3), k16 step kk:
    // the tile pixel of row lrow shifted by (r, s) in the halo box
    const int lti = lrow / kIgGnTileW, ltj = lrow - lti * kIgGnTileW;
    auto frag = [&](uint32_t (&f)[4], int c, int t, int kk) {
      const int r = t / 3;
      const int pp = (lti + r) * kIgHaloW + ltj + t - 3 * r;
      ldsm_x4(f, halo + (c % kIgHaloStages) * kIgHaloBytes + pp * 128 +
                     (((2 * kk + lchunk) ^ (pp & 7)) << 4));
    };
    mbar_wait(halo_full, 0);
    for (int i = 0; i < kIgHaloIters; ++i) transform(0, i);
    ig_consumers_sync();
    uint32_t f[2][4];
    frag(f[0], 0, 0, 0);
    int ks = 0;  // weight tiles consumed
    for (int c = 0; c < kc; ++c) {
      for (int t = 0; t < 9; ++t, ++ks) {
        const int s = ks % STAGES;
        mbar_wait(full_bar + 8 * s, (ks / STAGES) & 1);
        const uint32_t st = stages + s * STAGE;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int h = 0; h < NH; ++h) wg_fence_acc(acc[h]);
          wg_fence_frag(f);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int h = 0; h < NH; ++h)  // B MN-major: two 64-column chunks 8 KB apart
            wgmma_rs<128>(acc[h], f[kk & 1], wg_desc(st + h * 16384 + kk * 2048, 8192, 1024));
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          // the previous k16 step's products are done: its fragment buffer
          // is free, and after a tap's last step its weight stage
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
          for (int h = 0; h < NH; ++h) wg_fence_acc(acc[h]);
          wg_fence_frag(f);
          if (kk == 0 && ks > 0 && lane == 0) mbar_arrive(empty_bar + 8 * ((ks - 1) % STAGES));
          if (kk < 3)
            frag(f[(kk + 1) & 1], c, t, kk + 1);
          else if (t < 8)
            frag(f[0], c, t + 1, 0);
        }
        // a sixth of the next K step's halo after each of this step's first
        // six taps, while the products run
        if (c + 1 < kc && t < kIgHaloIters) {
          if (t == 0)
            mbar_wait(halo_full + 8 * ((c + 1) % kIgHaloStages), ((c + 1) / kIgHaloStages) & 1);
          transform(c + 1, t);
        }
      }
      // every read of this step's halo buffer is done: order the in-place
      // writes before the producer's next copy into it, and release it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(halo_empty + 8 * (c % kIgHaloStages));
      if (c + 1 < kc) {
        ig_consumers_sync();  // the next step's halo is transformed
        frag(f[0], c + 1, 0, 0);
      }
    }
  } else if constexpr (AX::kRegisters) {
    for (int ks = 0; ks < nsteps; ++ks) {
      const int s = ks % STAGES;
      mbar_wait(full_bar + 8 * s, (ks / STAGES) & 1);
      const uint32_t st = stages + s * STAGE;
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
    }
  } else {
    for (int ks = 0; ks < nsteps; ++ks) {
      const int s = ks % STAGES;
      mbar_wait(full_bar + 8 * s, (ks / STAGES) & 1);
      const uint32_t st = stages + s * STAGE;
#pragma unroll
      for (int h = 0; h < NH; ++h) wg_fence_acc(acc[h]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = wg_desc(st + wg * 8192 + kk * 32, 16, 1024);  // K-major pixel rows
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          if (BMN)  // B MN-major: two 64-column chunks 8 KB apart, 16 k rows a step
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
    const bf16* res = GN && a.res != nullptr && valid
                          ? a.res + (((size_t)b * a.Mh + h0 + ti) * a.Mw + w0 + tj) * a.N
                          : nullptr;
    unsigned char* srow = ring_p + row * PITCH;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float v0 = acc[h][4 * j + 2 * half], v1 = acc[h][4 * j + 2 * half + 1];
        const int n = n0 + 128 * h + 8 * j + 2 * q;
        if (STATS || (GN && n < a.N)) {  // the resamples' N is a multiple of BN
          const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bias + n));
          v0 += bb.x;
          v1 += bb.y;
          if (res != nullptr) {
            const uint32_t rv = __ldg(reinterpret_cast<const unsigned int*>(res + n));
            const float2 rf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv));
            v0 += rf.x;
            v1 += rf.y;
          }
        }
        const int chunk = (h * 16 + j) ^ (row & 7);
        *reinterpret_cast<uint32_t*>(srow + chunk * 16 + q * 4) = valid ? pack_bf16x2(v0, v1) : 0u;
      }
  }
  ig_consumers_sync();

  // 16-byte stores: y or the upsample dgrad's dx rows of the tile, or the
  // downsample dgrad's dx and the upsample's y at the phase's pixels
  constexpr int CHUNKS = BN / 8;
  for (int id = tid; id < kIgBM * CHUNKS; id += 32 * kIgConsumerWarps) {
    const int row = id / CHUNKS, ch = id - row * CHUNKS;
    const int ti = row / a.tile_w, tj = row - ti * a.tile_w;
    const int mh = h0 + ti, mw = w0 + tj, n = n0 + 8 * ch;
    if (mh < a.Mh && mw < a.Mw && n < a.N) {
      const uint4 v = *reinterpret_cast<const uint4*>(ring_p + row * PITCH + ((ch ^ (row & 7)) << 4));
      const size_t off = !INTERLEAVE
                             ? (((size_t)b * a.Mh + mh) * a.Mw + mw) * a.N + n
                             : (((size_t)b * 2 * a.Mh + 2 * mh + pm) * (2 * a.Mw) + 2 * mw + pn) *
                                       a.N + n;
      *reinterpret_cast<uint4*>(a.out + off) = v;
    }
  }
  if (!STATS) return;

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
  // the partial slot (sample, phase, tile): the upsample's four phases
  // before its tiles, in ascending order
  const size_t slot = UPF ? ((size_t)b * 4 + phase) * a.tiles + mt : (size_t)b * a.tiles + mt;
  float* dst = a.partial + slot * 2 * a.N + n0 + col;
  dst[0] = sum;
  dst[a.N] = sumsq;
}

// NHWC (n, h, w, c) as (channel, column, row, sample); a box of 64 channels
// x box_h x box_w pixels, reading every `step`-th row and column
inline bool ig_nhwc_map(CUtensorMap* map, const bf16* base, int n, int h, int w, int c,
                        int box_h, int box_w, int step) {
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)w * c * 2,
                                 (cuuint64_t)h * w * c * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)(box_w * step), (cuuint32_t)(box_h * step), 1};
  const cuuint32_t elem[4] = {1, (cuuint32_t)step, (cuuint32_t)step, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box, elem);
}

// (taps, taps, C, O) weights (HWIO: 3 x 3; k22 (2, 2, 2, 2, C, O): 4 x 4)
// as (o, c, s, r); a box of 64 o x `rows` c of one tap
inline bool ig_weight_map(CUtensorMap* map, const bf16* w, int c, int o, int rows, int taps) {
  const cuuint64_t dims[4] = {(cuuint64_t)o, (cuuint64_t)c, (cuuint64_t)taps, (cuuint64_t)taps};
  const cuuint64_t strides[3] = {(cuuint64_t)o * 2, (cuuint64_t)c * o * 2,
                                 (cuuint64_t)taps * c * o * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, w, dims, strides, box);
}

template <int MODE, int BN, class AX>
inline cudaError_t launch_igemm_sm90(const CUtensorMap& ta, const CUtensorMap& tadd,
                                     const CUtensorMap& tw, const IgemmArgs& a, long long blocks,
                                     cudaStream_t stream) {
  const size_t smem = ig_smem(AX::kExtra, AX::kHalo, BN);
  cudaError_t err = cudaFuncSetAttribute(conv_igemm_sm90_kernel<MODE, BN, AX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv_igemm_sm90_kernel<MODE, BN, AX>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  conv_igemm_sm90_kernel<MODE, BN, AX>
      <<<(unsigned)blocks, ig_threads(AX::kHalo), smem, stream>>>(ta, tadd, tw, a);
  return cudaGetLastError();
}

// The block geometry of a launch over B samples of an (mh, mw) grid and
// `phases` phases, N output channels, K channels a tap, with the spatial
// tile igemm_tile picks or (tile_h, tile_w) where given; false where the
// grid does not fit one launch.
inline bool igemm_args(IgemmArgs* a, int B, int mh, int mw, int N, int K, int phases,
                       long long* blocks, int tile_h = 0, int tile_w = 0) {
  a->B = B;
  a->Mh = mh;
  a->Mw = mw;
  a->N = N;
  a->K = K;
  if (tile_h > 0) {
    a->tile_h = tile_h;
    a->tile_w = tile_w;
  } else {
    igemm_tile(mh, mw, &a->tile_h, &a->tile_w);
  }
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
