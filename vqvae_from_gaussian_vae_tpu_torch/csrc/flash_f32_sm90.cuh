// Pieces shared by the float32 head-major flash bodies designed for Hopper
// (sm_90a) as split TF32 on the tensor cores: the forward
// (csrc/flash_fwd_f32_sm90.cuh) and the backward (csrc/flash_bwd_f32_sm90.cuh)
// of gvq_flash_fwd_hm_f32 and gvq_flash_bwd_hm_f32 at head dims 64 and 128,
// and their wide form at 256 and 512 (csrc/flash_fwd_f32_sm90_wide.cuh,
// csrc/flash_bwd_f32_sm90_wide.cuh).
//
// Split TF32.  A float32 operand a becomes a pair of TF32 values, hi =
// cvt.rna.tf32(a) and lo = cvt.rna.tf32(a - hi), and a product is three
// wgmma passes summed in float32 accumulators, the small terms first:
// lo.hi, then hi.lo, then hi.hi (lo.lo, about 2^-22 of the product, is
// dropped).  The result is float32-accurate (1e-6 to 5e-6 of the largest
// value on an H100 at the smoke's shapes, PERF.md; one pass misses the
// 1e-4 bar, tests/test_torch_flash_f32_plan.py), so the bodies do not read
// torch.backends.cuda.matmul.allow_tf32: they run the same with it on or
// off.  A tensor core's float32 sum truncates, so no accumulator is
// carried across tiles: each tile's product starts from zero and is added
// into the running sum on the CUDA cores (tf_product_rs, tf_add).
//
// Layouts.  wgmma takes .tf32 operands only K-major (no transpose bits), A
// from shared memory or from registers, B from shared memory.  So each
// product's B operand lies in device memory in the layout its product
// reads, written with its (hi, lo) pair by a pre-pass a call (tf_prep_kernel):
//   "rows": a (rows, cols) tensor as it lies, hi and lo planes of it,
//           (B*H, 2, rows, cols);
//   "cols": transposed, (B*H, 2, cols, pitch), the row index along pitch (a
//           multiple of 8, zero past the length), each group of 8 rows
//           permuted so that position j holds row tf_perm(j);
// and the backward's pre-pass also writes di = rowsum(o * do).  A operands
// that lie in shared memory (the fixed q, do, k, v tiles) come from the
// same "rows" planes.  A operands made in registers (p, ds and their
// transposes, from an accumulator) are split in registers: the
// accumulator holds columns 2t and 2t + 1 of each 8 (t = lane % 4) where
// the TF32 A fragment wants columns t and t + 4, so the thread hands its
// own two values in as k-indices t and t + 4, and the "cols" planes hold
// row 2t at position t and row 2t + 1 at position t + 4: the same
// permutation on both sides of the sum, no shuffle.
//
// Shared memory.  A K-major tile of rows x cols floats lies as cols / 32
// chunks of rows x 128 bytes under the 128-byte swizzle (TfTile), or as one
// chunk of rows x 64 or 32 bytes under the 64- or 32-byte swizzle where
// cols is 16 or 8; TMA boxes of the plan's maps (ops/flash_attention.py
// flash_f32_plan) write them, and a k-step of 8 columns is 32 bytes along
// a chunk's rows.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include "sm90.cuh"
#include "tf32_sm90.cuh"  // the .tf32 wgmma forms, tf32_rna, TfTile

namespace {

using gvq::mbar_arrive;
using gvq::mbar_arrive_expect_tx;
using gvq::mbar_init;
using gvq::mbar_wait;
using gvq::PlanMap;
using gvq::tma_load_4d;
using gvq::wg_fence_acc;
using gvq::wg_fence_frag;
using gvq::wg_smem_addr;

// D (64 x N) = A (64 x KD) . B^T (KD x N) in three passes (lo.hi, hi.lo,
// hi.hi) over KD / 8 k-steps: A the rows from a_row0 of a TA tile, B a TB
// tile (N x KD), both split into planes in shared memory
template <int KD, int N, class TA, class TB>
__device__ __forceinline__ void tf_product_ss(float (&d)[N / 2], uint32_t a, int a_row0, uint32_t b) {
  const uint64_t ah = TA::desc0(a), al = TA::desc0(a + TA::kBytes);
  const uint64_t bh = TB::desc0(b), bl = TB::desc0(b + TB::kBytes);
#pragma unroll
  for (int kk = 0; kk < KD / 8; ++kk)
    wgmma_tf32_ss<N>(d, TA::step(al, kk, a_row0), TB::step(bh, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < KD / 8; ++kk) wgmma_tf32_ss<N>(d, TA::step(ah, kk, a_row0), TB::step(bl, kk), 1);
#pragma unroll
  for (int kk = 0; kk < KD / 8; ++kk) wgmma_tf32_ss<N>(d, TA::step(ah, kk, a_row0), TB::step(bh, kk), 1);
}

// O (64 x N) = A (64 x KN, split fragments in registers) . B (KN x N) in
// three passes: B the N rows from b_row0 of a TB tile (D x KN) split into
// planes in shared memory.
// O starts from zero: the bodies add each tile's product into their
// running sums on the CUDA cores (tf_add), because the tensor cores' own
// float32 sums truncate, and a chain of thousands of issues into one
// accumulator drifts with its length toward the 1e-4 bar
template <int KN, int N, class TB>
__device__ __forceinline__ void tf_product_rs(float (&o)[N / 2], const uint32_t (&hi)[KN / 8][4],
                                              const uint32_t (&lo)[KN / 8][4], uint32_t b,
                                              int b_row0 = 0) {
  const uint64_t bh = TB::desc0(b), bl = TB::desc0(b + TB::kBytes);
#pragma unroll
  for (int kk = 0; kk < KN / 8; ++kk)
    wgmma_tf32_rs<N>(o, lo[kk], TB::step(bh, kk, b_row0), kk > 0);
#pragma unroll
  for (int kk = 0; kk < KN / 8; ++kk) wgmma_tf32_rs<N>(o, hi[kk], TB::step(bl, kk, b_row0), 1);
#pragma unroll
  for (int kk = 0; kk < KN / 8; ++kk) wgmma_tf32_rs<N>(o, hi[kk], TB::step(bh, kk, b_row0), 1);
}

// sum += part, elementwise, rounded to nearest on the CUDA cores
template <int R>
__device__ __forceinline__ void tf_add(float (&sum)[R], const float (&part)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) sum[i] += part[i];
}

// An accumulator (64 x N, this thread's N / 2) split into the A fragments
// of a product over its N columns: k-step kk's fragment takes s[4 kk],
// s[4 kk + 2] (columns 8 kk + 2t of rows r and r + 8) as k-indices t and
// s[4 kk + 1], s[4 kk + 3] (columns 8 kk + 2t + 1) as t + 4, so that the B
// operand's k-index j must hold column tf_perm(j) of each 8
template <int N>
__device__ __forceinline__ void tf_split_frag(const float (&s)[N / 2], uint32_t (&hi)[N / 8][4],
                                              uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    const float v[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1], s[4 * kk + 3]};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      hi[kk][r] = tf32_rna(v[r]);
      lo[kk][r] = tf32_rna(v[r] - __uint_as_float(hi[kk][r]));
    }
  }
}

// registers a thread after setmaxnreg in a block of WG consumer warpgroups
// and a producer warpgroup, WG > 1: the producer's go to the consumers (an
// SM sub-partition holds WG + 1 warps of the block: 16,384 registers)
__host__ __device__ constexpr int tf_producer_regs(int wg) { return wg == 3 ? 24 : 40; }
__host__ __device__ constexpr int tf_consumer_regs(int wg) { return wg == 3 ? 160 : 232; }

// the row of each 8 that a "cols" plane holds at position j
__host__ __device__ constexpr int tf_perm(int j) { return j < 4 ? 2 * j : 2 * (j - 4) + 1; }

// both planes of a TILE whose box origin is (col0, row0) of (b, h) = bh in
// a plan map (dims cols, rows, 2, B*H): COLS / kChunkCols boxes a plane
template <class Tile>
__device__ __forceinline__ void tf_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        int col0, int row0, int bh) {
#pragma unroll
  for (int hl = 0; hl < 2; ++hl)
#pragma unroll
    for (int c = 0; c < (int)(Tile::kBytes / Tile::kChunk); ++c)
      tma_load_4d(dst + hl * Tile::kBytes + c * Tile::kChunk, map, bar,
                  col0 + c * Tile::kChunkCols, row0, hl, bh);
}

// this thread's share of a 64-row accumulator (rows from row0, D columns)
// stored as float32 into dst (row stride D), rows at or past `rows` not
// stored; `mul0` and `mul1` scale rows r and r + 8
template <int D>
__device__ __forceinline__ void tf_store(const float (&o)[D / 2], float* dst, int row0, int rows,
                                         float mul0 = 1.0f, float mul1 = 1.0f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = row0 + (warp & 3) * 16 + (lane >> 2);
  float* p = dst + 2 * (lane & 3);
  const bool in0 = r0 < rows, in1 = r0 + 8 < rows;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (in0)
      *reinterpret_cast<float2*>(p + (size_t)r0 * D + 8 * j) =
          make_float2(o[4 * j] * mul0, o[4 * j + 1] * mul0);
    if (in1)
      *reinterpret_cast<float2*>(p + (size_t)(r0 + 8) * D + 8 * j) =
          make_float2(o[4 * j + 2] * mul1, o[4 * j + 3] * mul1);
  }
}

// ---------------------------------------------------------------------------
// The wide bodies' pieces (D = 256 and 512: csrc/flash_fwd_f32_sm90_wide.cuh,
// csrc/flash_bwd_f32_sm90_wide.cuh).  A block owns C of D's columns, and the
// N = D / C blocks of one row tile form a cluster: each forms its partial
// scores over its columns, and tw_exchange sums them over the cluster.

// The exchange region of a block: two buffers (even and odd tiles), each
// one slot for every other block of the cluster, a slot the R floats of
// each of the 128 consumer threads as R / 4 float4 (float4 i of thread tw
// at (128 i + tw) 16 bytes).  A sender's slot in a receiver's buffer is
// its rank, less one past the receiver's own.
template <int R, int N>
struct TwExchange {
  static_assert(R % 4 == 0 && N >= 2 && N <= 8, "float4s a thread; 2 to 8 blocks a cluster");
  static constexpr uint32_t kSlot = R * 4 * 128;
  static constexpr uint32_t kBuf = (N - 1) * kSlot;
  static constexpr uint32_t kBytes = 2 * kBuf;
};

// Tile t's partial products x (R floats of this thread, over this block's
// columns) summed over the cluster's N blocks, in rank order, into x: every
// block of the cluster ends with the same bits.  This thread's floats go
// by st.async into its slot of buffer t % 2 of every other block, where
// they complete on that block's mbarrier of the buffer as a TMA copy does;
// thread 0 arms this block's with the bytes it expects, and every thread
// waits for it, then adds the N parts.  Two buffers and no release step:
// a block writes tile t + 2 into a buffer only after it has received every
// block's tile t + 1, which each thread sends after its reads of tile t.
// xa / xp: this block's exchange region (shared address, pointer); bars:
// its two mbarriers (one arrive each phase, and the bytes).
template <int R, int N>
__device__ __forceinline__ void tw_exchange(float (&x)[R], uint32_t xa, const unsigned char* xp,
                                            uint32_t bars, uint32_t rank, int t) {
  using X = TwExchange<R, N>;
  const int tw = threadIdx.x & 127, buf = t & 1;
  const uint32_t full = bars + 8 * buf;
  if (tw == 0) mbar_arrive_expect_tx(full, X::kBuf);
#pragma unroll
  for (uint32_t p = 0; p < (uint32_t)N; ++p) {
    if (p == rank) continue;
    const uint32_t slot = rank < p ? rank : rank - 1;
    const uint32_t dst = gvq::cluster_map(xa + buf * X::kBuf + slot * X::kSlot + tw * 16, p);
    const uint32_t bar = gvq::cluster_map(full, p);
#pragma unroll
    for (int i = 0; i < R / 4; ++i)
      gvq::st_async_f4(dst + i * 2048, x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3], bar);
  }
  mbar_wait(full, (t >> 1) & 1);
  const float4* in = reinterpret_cast<const float4*>(xp + buf * X::kBuf) + tw;
  float sum[R];
#pragma unroll
  for (uint32_t r = 0; r < (uint32_t)N; ++r) {
    float part[R];
    if (r == rank) {
#pragma unroll
      for (int i = 0; i < R; ++i) part[i] = x[i];
    } else {
      const float4* f = in + (r < rank ? r : r - 1) * (X::kSlot / 16);
#pragma unroll
      for (int i = 0; i < R / 4; ++i) {
        const float4 u = f[128 * i];
        part[4 * i] = u.x;
        part[4 * i + 1] = u.y;
        part[4 * i + 2] = u.z;
        part[4 * i + 3] = u.w;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) sum[i] = r == 0 ? part[i] : sum[i] + part[i];
  }
#pragma unroll
  for (int i = 0; i < R; ++i) x[i] = sum[i];
}

// this thread's share of a 64-row accumulator of C columns (rows from
// row0) stored as float32 into dst (its first column; row stride ld), rows
// at or past `rows` not stored; `mul0` and `mul1` scale rows r and r + 8
template <int C>
__device__ __forceinline__ void tw_store(const float (&o)[C / 2], float* dst, int ld, int row0,
                                         int rows, float mul0 = 1.0f, float mul1 = 1.0f) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = row0 + warp * 16 + (lane >> 2);
  float* p = dst + 2 * (lane & 3);
  const bool in0 = r0 < rows, in1 = r0 + 8 < rows;
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    if (in0)
      *reinterpret_cast<float2*>(p + (size_t)r0 * ld + 8 * j) =
          make_float2(o[4 * j] * mul0, o[4 * j + 1] * mul0);
    if (in1)
      *reinterpret_cast<float2*>(p + (size_t)(r0 + 8) * ld + 8 * j) =
          make_float2(o[4 * j + 2] * mul1, o[4 * j + 3] * mul1);
  }
}

// the start of a wide block: thread 0 has initialised its mbarriers; every
// block of the cluster waits for every other's before a remote write
__device__ __forceinline__ void tw_start() {
  if (threadIdx.x == 0) asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  gvq::cluster_sync();
}

// a wide kernel's launch: `cluster` blocks along the grid's z a cluster
template <class... Params, class... Args>
int tw_launch(void (*kernel)(Params...), dim3 grid, int threads, size_t smem, unsigned cluster,
              cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = cluster;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The pre-pass: up to kTfJobs jobs in one launch of 256-thread blocks, a
// job's blocks after the previous job's.
//   kTfRows: src (bh, rows, cols) -> dst (bh, 2, rows, cols), 4 floats a thread;
//   kTfCols: src (bh, rows, cols) -> dst (bh, 2, cols, pitch) by 32 x 32
//            tiles through shared memory, position j of each 8 holding row
//            tf_perm(j), zero past rows;
//   kTfDi:   dst (bh * rows) = rowsum(src * src2), a warp a row.
enum TfJobKind { kTfRows = 0, kTfCols = 1, kTfDi = 2 };
constexpr int kTfJobs = 8;

struct TfJob {
  int kind, blocks, rows, cols, pitch;
  long long bh;
  const float* src;
  const float* src2;
  float* dst;
};

struct TfJobs {
  TfJob job[kTfJobs];
  int n;
};

__device__ __forceinline__ float4 tf_hi4(float4 x) {
  return make_float4(__uint_as_float(tf32_rna(x.x)), __uint_as_float(tf32_rna(x.y)),
                     __uint_as_float(tf32_rna(x.z)), __uint_as_float(tf32_rna(x.w)));
}

__device__ __forceinline__ float4 tf_lo4(float4 x, float4 h) {
  return tf_hi4(make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w));
}

__global__ void __launch_bounds__(256) tf_prep_kernel(const __grid_constant__ TfJobs jobs) {
  int b = blockIdx.x, j = 0;
  while (j + 1 < jobs.n && b >= jobs.job[j].blocks) b -= jobs.job[j++].blocks;
  const TfJob& g = jobs.job[j];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (g.kind == kTfRows) {
    const size_t per = (size_t)g.rows * g.cols;
    const size_t e = 4 * ((size_t)b * 256 + tid);
    if (e >= (size_t)g.bh * per) return;
    const size_t bh = e / per, r = e - bh * per;
    const float4 x = *reinterpret_cast<const float4*>(g.src + e);
    const float4 h = tf_hi4(x);
    float* d = g.dst + bh * 2 * per + r;
    *reinterpret_cast<float4*>(d) = h;
    *reinterpret_cast<float4*>(d + per) = tf_lo4(x, h);
  } else if (g.kind == kTfCols) {
    __shared__ float tile[32][33];
    const int tiles_l = (g.pitch + 31) / 32, tiles_c = g.cols / 32;
    const long long bh = b / (tiles_l * tiles_c);
    const int rem = b - (int)(bh * tiles_l * tiles_c);
    const int l0 = (rem / tiles_c) * 32, c0 = (rem % tiles_c) * 32;
    for (int i = warp; i < 32; i += 8) {
      const int row = l0 + i;
      tile[i][lane] = row < g.rows ? g.src[((size_t)bh * g.rows + row) * g.cols + c0 + lane] : 0.0f;
    }
    __syncthreads();
    const int pos = l0 + lane, from = (lane & ~7) + tf_perm(lane & 7);
    if (pos >= g.pitch) return;
    for (int i = warp; i < 32; i += 8) {
      const float x = tile[from][i];
      const float h = __uint_as_float(tf32_rna(x));
      float* d = g.dst + ((size_t)bh * 2 * g.cols + c0 + i) * g.pitch + pos;
      d[0] = h;
      d[(size_t)g.cols * g.pitch] = __uint_as_float(tf32_rna(x - h));
    }
  } else {
    const size_t row = (size_t)b * 8 + warp;
    if (row >= (size_t)g.bh * g.rows) return;
    const float* o = g.src + row * g.cols;
    const float* d = g.src2 + row * g.cols;
    float acc = 0.0f;
    for (int c = 4 * lane; c < g.cols; c += 128) {
      const float4 x = *reinterpret_cast<const float4*>(o + c);
      const float4 y = *reinterpret_cast<const float4*>(d + c);
      acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (lane == 0) g.dst[row] = acc;
  }
}

// blocks of a pre-pass job
inline int tf_job_blocks(int kind, long long bh, int rows, int cols, int pitch) {
  if (kind == kTfRows) return (int)((bh * rows * cols / 4 + 255) / 256);
  if (kind == kTfCols) return (int)(bh * ((pitch + 31) / 32) * (cols / 32));
  return (int)((bh * rows + 7) / 8);
}

// The launch plan of ops/flash_attention.py flash_f32_plan, as the int64
// array the wrappers pass (FlashF32Plan.as_array): kF32PlanLen numbers in
// this order.  A kernel's tiles are {rows a block, streamed rows a tile,
// stages, threads, shared memory, grid x, grid y, mask, column share,
// cluster}: the forward's {q rows, keys, .., key mask, ..}, the dK/dV
// kernel's {keys, q rows, .., q mask, ..}, the dQ kernel's {q rows, keys,
// .., key mask, ..}; a block owns `share` of D's columns, and the D / share
// blocks of a row tile form a cluster along the grid's z (share D and
// cluster 1 at D = 64 and 128).  Maps (PlanMap: csrc/sm90.cuh; offsets in
// floats into the call's scratch), each with its kernel's box: the
// forward's q, k ("rows") and v ("cols"); the dK/dV kernel's q, k, v, do
// ("rows"), q, do ("cols"); the dQ kernel's q, k, v, do ("rows", the same
// planes as the dK/dV kernel's) and k ("cols").  A "rows" box is 32
// columns wide, a block's share that many boxes from its first column; a
// "cols" box holds the share's rows of the plane.
struct F32Plan {
  long long body;  // 0: split TF32 at D = 64, 128; 1: its wide form at D = 256, 512
  long long fwd[10], dkdv[10], dq[10];
  long long lq_pitch, lk_pitch, fwd_scratch, bwd_scratch;  // floats
  PlanMap map[14];
};

constexpr int kF32PlanLen = 203;
static_assert(sizeof(F32Plan) == kF32PlanLen * sizeof(long long), "the plan's layout");
enum {
  kMapFq = 0, kMapFk, kMapFvt,                         // forward
  kMapKq, kMapKk, kMapKv, kMapKdo, kMapKqt, kMapKdot,  // dK/dV
  kMapQq, kMapQk, kMapQv, kMapQdo, kMapQkt             // dQ
};

// the wide body's tiling of each kernel at D = 256 and 512 (column share,
// streamed rows a tile, stages), as ops/flash_attention.py F32_WIDE_TILES
template <int D>
struct TwTiles;
template <>
struct TwTiles<256> {
  static constexpr int kFwd[3] = {128, 32, 2}, kDkdv[3] = {64, 16, 3}, kDq[3] = {128, 8, 3};
};
template <>
struct TwTiles<512> {
  static constexpr int kFwd[3] = {128, 16, 3}, kDkdv[3] = {128, 8, 2}, kDq[3] = {128, 8, 3};
};

// Encode a plan map over scratch (float32, the 128-, 64- or 32-byte swizzle
// by the box's inner width, zero fill out of bounds), held first to planes
// of (bh, 2, rows, cols) floats within `capacity` floats of scratch and to
// the box (box0 columns, box1 rows):
// a "rows" plane has the tensor's rows and cols, a "cols" plane D rows and
// the pitch as its cols
inline bool tf_encode(CUtensorMap* map, float* scratch, long long capacity, const PlanMap& m,
                      long long bh, int rows, int cols, int box0, int box1) {
  if (m.dims[0] != cols || m.dims[1] != rows || m.dims[2] != 2 || m.dims[3] != bh ||
      m.offset + 2 * bh * rows * cols > capacity ||
      m.strides[0] != 4LL * cols || m.strides[1] != 4LL * rows * cols ||
      m.strides[2] != 8LL * rows * cols || m.box[0] != box0 || m.box[1] != box1 ||
      m.box[2] != 1 || m.box[3] != 1 || m.offset < 0)
    return false;
  const CUtensorMapSwizzle swizzle = box0 == 32   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box0 == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : box0 == 8  ? CU_TENSOR_MAP_SWIZZLE_32B
                                                  : CU_TENSOR_MAP_SWIZZLE_NONE;
  if (swizzle == CU_TENSOR_MAP_SWIZZLE_NONE) return false;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  for (int i = 0; i < 4; ++i) {
    dims[i] = (cuuint64_t)m.dims[i];
    box[i] = (cuuint32_t)m.box[i];
  }
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)m.strides[i];
  return gvq::encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scratch + m.offset, dims,
                           strides, box, nullptr, swizzle);
}

// a pre-pass job whose destination is a plan map's plane
inline TfJob tf_job(int kind, const float* src, const float* src2, float* dst, long long bh, int rows,
                    int cols, int pitch) {
  return TfJob{kind, tf_job_blocks(kind, bh, rows, cols, pitch), rows, cols, pitch, bh, src, src2,
               dst};
}

inline int tf_prep(const TfJobs& jobs, cudaStream_t stream) {
  long long blocks = 0;
  for (int i = 0; i < jobs.n; ++i) blocks += jobs.job[i].blocks;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tf_prep_kernel<<<(unsigned)blocks, 256, 0, stream>>>(jobs);
  return (int)cudaGetLastError();
}

}  // namespace
