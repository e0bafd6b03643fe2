// The bf16 flash-attention forward body designed for Hopper (sm_90a), for
// head dims 64 and 128: every shipped bf16 forward entry of
// csrc/flash_fwd.cu at those D (gvq_flash_fwd, gvq_flash_fwd_res,
// gvq_flash_fwd_qkv, gvq_flash_fwd_qkv_res, gvq_flash_fwd_hm).  D = 256 and
// 512 run csrc/flash_fwd_sm90_wide.cuh, which shares this file's softmax
// and plan; the labs run csrc/flash_fwd.cuh.
//
// Replaces the TPU kernels vqvae_from_gaussian_vae_tpu/ops/flash_blc.py
// _fwd_impl (packed and unpacked, with and without z; body _fwd_kernel)
// and the forward of vqvae_from_gaussian_vae_tpu/ops/flash_attention.py
// (the upstream _flash_attention_impl): o = softmax(q k^T * scale) v per
// (batch, head), and z = m + ln(sum) of each row where asked for.
//
// Numerics follow the TPU kernel: scores in fp32, scaled in fp32; p rounded
// to bf16 before the P.V product, which accumulates in fp32; the row sum
// over the fp32 p; 1/sum applied once at the end; expf.
//
// What bounds it on an H100: the tensor cores.  A packed launch at the
// ViT's shape (B=16, L=1024, H=12, D=64) is 5.15e10 FLOP against 101 MB
// (0.052 ms at the bf16 peak, 0.030 ms of bytes); the head-major training
// call's forward at (1, 12, 8192, 64) is 2.06e11 FLOP against 50.7 MB.
//
// The design, against what held the wmma body (csrc/flash_fwd.cuh) back:
// 1. Scores never touch shared memory.  S = Q K^T is wgmma.m64n128k16 with
//    both operands K-major in shared memory; S stays in the accumulator's
//    registers (64 floats a thread), and the online softmax runs there: a
//    row is spread over the four threads of a quad, so its max is two
//    quad shuffles; each thread keeps its own share of the row sum, and
//    the quad adds the shares once, at the end.
// 2. The output accumulator lives in registers: O += P V is
//    wgmma.m64n{D}k16 with A = P from registers (the .RS form: p is
//    rounded to bf16 in the accumulator's own register order, which is the
//    bf16 A fragment's), B = V MN-major in shared memory (transpose bit).
//    The rescale by exp(m_old - m_new) is a multiply on registers.
// 3. No block barrier in the key loop.  One producer thread keeps a
//    3-stage ring of K and V tiles (128 keys x D each) in flight with TMA
//    copies and full / empty mbarriers; Q is copied once.  Each consumer
//    warpgroup issues tile t's Q K^T and tile t-1's P V back to back, and
//    runs tile t's softmax while the P V product is on the tensor cores.
// 4. Bigger tiles and wgmma.  A block owns 192 q rows at D = 64 (three
//    consumer warpgroups of 64) and 128 at D = 128 (two), so each (b, h)'s
//    K and V pass through L2 a sixth or a quarter as often as with the
//    32-row tiles.  One block an SM: 512 or 384 threads, Q 24 KB + 3 x 32
//    KB at D = 64, 32 + 3 x 64 KB at D = 128; setmaxnreg moves the
//    producer warpgroup's registers to the consumers (160 or 232 a thread).
//
// What bounds it now, at D = 64: the softmax's issue slots, not the tensor
// cores.  Each score costs about a dozen instructions (scale, max, sub,
// the accurate expf's eight, sum, half a conversion), and expf stays, as
// the TPU kernel's numerics ask; with the products alone the packed
// forward would take well under half its time (PERF.md, Findings).
//
// The tensor maps are 4-D, built on the host for each launch from the
// launch plan (ops/flash_attention.py flash_fwd_plan): head-major tensors
// as (D, L, H, B), token-major and packed ones as (D, H, L, B) with the
// input's token stride, the packed q, k and v at element offsets 0, C and
// 2C of the (B, L, 3C) projection.  A box never leaves its (b, h): TMA's
// zero fill past L is the ragged edge, and a zero-filled key still scores
// -inf before the row max in the last tile (kMask).  A consumer warpgroup
// whose 64 rows all lie past Lq computes nothing; the rows past Lq of the
// others are computed on zeros and not stored.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

using gvq::encode_plan_map;
using gvq::mbar_arrive;
using gvq::mbar_arrive_expect_tx;
using gvq::mbar_init;
using gvq::mbar_wait;
using gvq::pack_bf16x2;
using gvq::PlanMap;
using gvq::tma_load_4d;
using gvq::wg_desc;
using gvq::wg_fence_acc;
using gvq::wg_fence_frag;
using gvq::wg_opaque;
using gvq::wg_smem_addr;
using gvq::wgmma_rs;
using gvq::wgmma_ss;

constexpr int kF9Keys = 128;  // keys a K or V tile
constexpr int kF9Stages = 3;  // K/V tiles in flight

// Consumer warpgroups a block, each owning 64 q rows: three at D = 64 (192
// rows), two at D = 128, where a thread's O takes 64 registers.
__host__ __device__ constexpr int f9_warpgroups(int d) { return d == 64 ? 3 : 2; }

// Shared memory, from a 1024-byte-aligned base: the Q tile, then the
// stages, each a K tile and a V tile; then the mbarriers (Q full; per
// stage K full, V full, empty).  A tile of `rows` x D is D / 64 chunks of
// rows x 128 bytes (64 columns each), as the 128-byte swizzle lays them.
template <int D>
struct F9Layout {
  static constexpr int kWarpgroups = f9_warpgroups(D);
  static constexpr int kRows = 64 * kWarpgroups;             // q rows a block
  static constexpr int kThreads = 128 * (kWarpgroups + 1);   // + the producer warpgroup
  // registers a thread after setmaxnreg: the producer warpgroup gives its
  // share to the consumers (one of the SM's four sub-partitions holds
  // kWarpgroups + 1 warps: 16,384 registers)
  static constexpr int kProducerRegs = kWarpgroups == 3 ? 24 : 40;
  static constexpr int kConsumerRegs = kWarpgroups == 3 ? 160 : 232;
  static constexpr int kChunks = D / 64;
  static constexpr uint32_t kChunkQ = kRows * 128;
  static constexpr uint32_t kChunkKV = kF9Keys * 128;
  static constexpr uint32_t kQ = kChunks * kChunkQ;
  static constexpr uint32_t kKV = kChunks * kChunkKV;
  static constexpr uint32_t kStage = 2 * kKV;
  static constexpr uint32_t kBars = kQ + kF9Stages * kStage;
  static constexpr size_t kSmem = kBars + (1 + 3 * kF9Stages) * 8 + 1024;  // + alignment slack
};

struct F9Args {
  bf16* o;
  float* z;                       // (B, H, Lq) float32, or null
  long long so_b, so_h, so_row;   // o's strides, elements
  int Lq, Lk, H;
  int row_dim;                    // the maps' coordinates: 1 (d, row, h, b), 2 (d, h, row, b)
  float scale;
};

// S = Q K^T for one warpgroup's 64 rows and a 128-key tile: D / 16 k-steps,
// each 16 columns = 32 bytes inside a chunk's 128-byte rows
template <int D>
__device__ __forceinline__ void f9_qk(float (&s)[64], uint32_t qa, uint32_t ka) {
  using Lay = F9Layout<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<128>(s, wg_desc(qa + (kk >> 2) * Lay::kChunkQ + (kk & 3) * 32, 16, 1024),
                  wg_desc(ka + (kk >> 2) * Lay::kChunkKV + (kk & 3) * 32, 16, 1024), kk > 0);
}

// O += P V over a 128-key tile: 8 k-steps of 16 keys (16 rows of V, 2048
// bytes); V's 64-column chunks lie kChunkKV apart (the descriptor's LBO)
template <int D>
__device__ __forceinline__ void f9_pv(float (&o)[D / 2], const uint32_t (&p)[8][4], uint32_t va) {
  using Lay = F9Layout<D>;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_rs<D>(o, p[kk], wg_desc(va + kk * 2048, Lay::kChunkKV, 1024));
  }
}

// One key tile's online-softmax step on this thread's scores (NS of them:
// a tile of 2 NS keys; also the wide body's, csrc/flash_fwd_sm90_wide.cuh):
// accumulator element s[4 j + e] is row (lane / 4) + 8 (e / 2) of the
// warp's 16, key 8 j + 2 (lane % 4) + e % 2 of the tile.  Scale, mask the keys at or past
// `valid` (kLast: the last tile of a ragged Lk; a zero-filled key would
// score 0, not -inf), fold the tile's row maxima into m0 / m1 (two quad
// shuffles each), p = exp(s - m) in place, add p to this thread's share
// of the row sums l0 / l1, and return the rows' rescale exp(m_old - m_new)
// (0 on the first tile, where m_old is -inf).  The maxima and sums run in
// eight independent chains a thread (key blocks j even and odd, e), not
// one chain a row, so that their latencies overlap.
template <bool kLast, int NS>
__device__ __forceinline__ float2 f9_softmax(float (&s)[NS], float& m0, float& m1, float& l0,
                                             float& l1, float scale, int valid) {
  const int c0 = 2 * (threadIdx.x & 3);
  float xs[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) xs[i] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[4 * j + e] * scale;
      if (kLast && 8 * j + c0 + (e & 1) >= valid) v = -INFINITY;
      s[4 * j + e] = v;
      xs[(j & 1) * 4 + e] = fmaxf(xs[(j & 1) * 4 + e], v);
    }
  float x0 = fmaxf(fmaxf(xs[0], xs[1]), fmaxf(xs[4], xs[5]));
  float x1 = fmaxf(fmaxf(xs[2], xs[3]), fmaxf(xs[6], xs[7]));
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
  x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
  x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
  const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
  const float2 alpha = make_float2(expf(m0 - n0), expf(m1 - n1));
  m0 = n0;
  m1 = n1;
  float ts[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) ts[i] = 0.0f;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[4 * j + e] - (e < 2 ? n0 : n1));
      s[4 * j + e] = p;
      ts[(j & 1) * 4 + e] += p;
    }
  const float t0 = (ts[0] + ts[1]) + (ts[4] + ts[5]);
  const float t1 = (ts[2] + ts[3]) + (ts[6] + ts[7]);
  l0 = l0 * alpha.x + t0;
  l1 = l1 * alpha.y + t1;
  return alpha;
}

// p rounded to bf16 in the accumulator's register order: k-step kk's A
// fragment is s[8 kk .. 8 kk + 7] in pairs (rows r and r + 8, keys
// 16 kk + 2 (lane % 4) + {0, 1} and + 8), the m16n8k16 A layout that
// wgmma takes from registers for bf16
template <int NS>
__device__ __forceinline__ void f9_round_p(const float (&s)[NS], uint32_t (&p)[NS / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// A consumer warpgroup's whole life: warpgroup wg (threadIdx.x / 128) owns
// q rows q0 + 64 wg .. + 63 of (b, h) = bh.  Per key tile t it issues
// S = Q K_t^T and then O += P_{t-1} V_{t-1} back to back, runs tile t's
// softmax while the P V product is on the tensor cores, releases tile
// t-1's stage, rescales O and rounds p.  Every mbarrier wait comes before
// the wgmma.fence of the products that need it.
template <int D, bool kMask>
__device__ __forceinline__ void f9_consume(const F9Args& a, uint32_t base, int n_tiles, int q0,
                                           int bh) {
  using Lay = F9Layout<D>;
  constexpr int S = kF9Stages;
  const uint32_t ring = base + Lay::kQ;
  const uint32_t q_bar = base + Lay::kBars;
  const uint32_t k_full = q_bar + 8, v_full = k_full + 8 * S, empty = v_full + 8 * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const uint32_t qa = base + wg * 64 * 128;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float s[64];
  uint32_t p[8][4];
  float m0 = -INFINITY, m1 = -INFINITY;  // running maxima of rows r and r + 8
  float l0 = 0.0f, l1 = 0.0f;            // this thread's shares of their sums

  mbar_wait(q_bar, 0);
  mbar_wait(k_full, 0);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  f9_qk<D>(s, qa, ring);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_fence_acc(s);
  if (kMask && n_tiles == 1)
    f9_softmax<true>(s, m0, m1, l0, l1, a.scale, a.Lk);
  else
    f9_softmax<false>(s, m0, m1, l0, l1, a.scale, kF9Keys);
  f9_round_p(s, p);

  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % S, pst = (t - 1) % S;
    mbar_wait(k_full + 8 * st, (t / S) & 1);
    mbar_wait(v_full + 8 * pst, ((t - 1) / S) & 1);
    wg_fence_acc(o);
    wg_fence_frag(p);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    f9_qk<D>(s, qa, ring + st * Lay::kStage);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    f9_pv<D>(o, p, ring + pst * Lay::kStage + Lay::kKV);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S of tile t
    wg_fence_acc(s);
    const float2 alpha =
        kMask && t == n_tiles - 1
            ? f9_softmax<true>(s, m0, m1, l0, l1, a.scale, a.Lk - t * kF9Keys)
            : f9_softmax<false>(s, m0, m1, l0, l1, a.scale, kF9Keys);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // P V of tile t - 1
    wg_fence_acc(o);
    wg_fence_frag(p);
    if ((tid & 127) == 0) mbar_arrive(empty + 8 * pst);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha.x;
      o[4 * j + 1] *= alpha.x;
      o[4 * j + 2] *= alpha.y;
      o[4 * j + 3] *= alpha.y;
    }
    f9_round_p(s, p);
  }
  {
    const int last = (n_tiles - 1) % S;
    mbar_wait(v_full + 8 * last, ((n_tiles - 1) / S) & 1);
    wg_fence_acc(o);
    wg_fence_frag(p);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    f9_pv<D>(o, p, ring + last * Lay::kStage + Lay::kKV);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(o);
  }

  // the rows' sums from the quad's shares; 1/sum once; rows past Lq are
  // not stored
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = 1.0f / l0, i1 = 1.0f / l1;
  const int b = bh / a.H, h = bh - b * a.H;
  const int r0 = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  bf16* ob = a.o + b * a.so_b + h * a.so_h + c0;
  const bool in0 = r0 < a.Lq, in1 = r0 + 8 < a.Lq;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (in0)
      *reinterpret_cast<uint32_t*>(ob + r0 * a.so_row + 8 * j) =
          pack_bf16x2(o[4 * j] * i0, o[4 * j + 1] * i0);
    if (in1)
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * a.so_row + 8 * j) =
          pack_bf16x2(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
  }
  if (a.z != nullptr && (lane & 3) == 0) {
    float* zb = a.z + (size_t)bh * a.Lq;
    if (in0) zb[r0] = m0 + logf(l0);
    if (in1) zb[r0 + 8] = m1 + logf(l1);
  }
}

template <int D, bool kMask>
__global__ void __launch_bounds__(F9Layout<D>::kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tmap_q,
                      const __grid_constant__ CUtensorMap tmap_k,
                      const __grid_constant__ CUtensorMap tmap_v, F9Args a) {
  using Lay = F9Layout<D>;
  constexpr int S = kF9Stages;
  extern __shared__ unsigned char f9_smem[];
  const uint32_t base = (wg_smem_addr(f9_smem) + 1023u) & ~1023u;  // the swizzle's 1024-byte atom
  const uint32_t ring = base + Lay::kQ;
  const uint32_t q_bar = base + Lay::kBars;
  const uint32_t k_full = q_bar + 8;           // + 8 s for stage s
  const uint32_t v_full = k_full + 8 * S;
  const uint32_t empty = v_full + 8 * S;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * Lay::kRows;
  const int n_tiles = (a.Lk + kF9Keys - 1) / kF9Keys;

  // warpgroups whose 64 rows all lie past Lq compute nothing
  const int active = min(Lay::kWarpgroups, (a.Lq - q0 + 63) / 64);
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + 8 * s, 1);       // the producer's arrive; the copies' bytes
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, active);   // one arrive per active consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if / else over warpgroups that never reconverges, so that
  // setmaxnreg moves the producer warpgroup's registers to the consumers
  if (warp >= 4 * Lay::kWarpgroups) {  // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Lay::kProducerRegs));
    if (tid == 128 * Lay::kWarpgroups) {
      const int b = bh / a.H, h = bh - b * a.H;
      // the box of a tile whose rows start at `row`, chunk c (columns 64 c ..)
      auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int c, int row) {
        if (a.row_dim == 1)
          tma_load_4d(dst, map, bar, 64 * c, row, h, b);
        else
          tma_load_4d(dst, map, bar, 64 * c, h, row, b);
      };
      mbar_arrive_expect_tx(q_bar, Lay::kQ);
#pragma unroll
      for (int c = 0; c < Lay::kChunks; ++c) load(base + c * Lay::kChunkQ, &tmap_q, q_bar, c, q0);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        mbar_wait(empty + 8 * s, ((t / S) & 1) ^ 1);  // a fresh stage passes
        const uint32_t kd = ring + s * Lay::kStage, vd = kd + Lay::kKV;
        mbar_arrive_expect_tx(k_full + 8 * s, Lay::kKV);
#pragma unroll
        for (int c = 0; c < Lay::kChunks; ++c)
          load(kd + c * Lay::kChunkKV, &tmap_k, k_full + 8 * s, c, t * kF9Keys);
        mbar_arrive_expect_tx(v_full + 8 * s, Lay::kKV);
#pragma unroll
        for (int c = 0; c < Lay::kChunks; ++c)
          load(vd + c * Lay::kChunkKV, &tmap_v, v_full + 8 * s, c, t * kF9Keys);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Lay::kConsumerRegs));
    if (warp / 4 < active) f9_consume<D, kMask>(a, base, n_tiles, q0, bh);
  }
}

// The launch plan of ops/flash_attention.py flash_fwd_plan, as the int64
// array the wrappers pass (FlashFwdPlan.as_array): kPlanLen numbers in this
// order (PlanMap: csrc/sm90.cuh).
struct FwdPlan {
  long long body;  // 1: this body; 2: csrc/flash_fwd_sm90_wide.cuh
  long long q_rows, k_rows, stages, grid_x, grid_y, threads, smem, key_mask, row_dim;
  PlanMap map[3];  // q, k, v
  long long o_strides[3];  // b, h, row, elements
};

constexpr int kPlanLen = 49;
static_assert(sizeof(FwdPlan) == kPlanLen * sizeof(long long), "the plan's layout");

template <int D, bool kMask>
int launch_f9(const CUtensorMap (&maps)[3], const F9Args& a, dim3 grid, cudaStream_t stream) {
  const size_t smem = F9Layout<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D, kMask>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_sm90_kernel<D, kMask><<<grid, F9Layout<D>::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], a);
  return (int)cudaGetLastError();
}

// Hold the plan to the body that reads it (`body` and its tiles, stages,
// threads and shared memory) and to the shapes the entry was given, encode
// its three maps over bases[] (q, k, v; the packed entries pass the
// (B, L, 3C) base three times) and fill the kernel's arguments; false
// where anything disagrees.  The wide body (flash_fwd_sm90_wide.cuh) takes
// the same plan.
inline bool fwd_plan_args(const FwdPlan& p, long long body, int q_rows, int k_rows, int stages,
                          int threads, size_t smem, const bf16* const (&bases)[3], bf16* o,
                          float* z, int B, int H, int Lq, int Lk, int D, float scale,
                          CUtensorMap (&maps)[3], F9Args* a) {
  const long long bh = (long long)B * H;
  bool ok = p.body == body && p.q_rows == q_rows && p.k_rows == k_rows && p.stages == stages &&
            p.threads == threads && p.smem == (long long)smem &&
            p.grid_x == (Lq + q_rows - 1) / q_rows && p.grid_y == bh && bh <= 65535 &&
            p.key_mask == (Lk % k_rows != 0) && (p.row_dim == 1 || p.row_dim == 2) &&
            p.o_strides[0] > 0 && p.o_strides[1] > 0 && p.o_strides[2] >= D;
  const int hd = p.row_dim == 1 ? 2 : 1;  // the head's dim in the map
  for (int i = 0; ok && i < 3; ++i) {
    const PlanMap& m = p.map[i];
    ok = m.dims[0] == D && m.dims[p.row_dim] == (i == 0 ? Lq : Lk) && m.dims[hd] == H &&
         m.dims[3] == B && m.box[0] == 64 && m.box[p.row_dim] == (i == 0 ? q_rows : k_rows) &&
         m.box[hd] == 1 && m.box[3] == 1 && encode_plan_map(&maps[i], bases[i], m);
  }
  *a = F9Args{o, z, p.o_strides[0], p.o_strides[1], p.o_strides[2], Lq, Lk, H, (int)p.row_dim,
              scale};
  return ok;
}

inline int launch_flash_fwd_sm90(const FwdPlan& p, const bf16* const (&bases)[3], bf16* o,
                                 float* z, int B, int H, int Lq, int Lk, int D, float scale,
                                 cudaStream_t stream) {
  CUtensorMap maps[3];
  F9Args a;
  if ((D != 64 && D != 128) ||
      !(D == 64 ? fwd_plan_args(p, 1, F9Layout<64>::kRows, kF9Keys, kF9Stages,
                                F9Layout<64>::kThreads, F9Layout<64>::kSmem, bases, o, z, B, H,
                                Lq, Lk, D, scale, maps, &a)
                : fwd_plan_args(p, 1, F9Layout<128>::kRows, kF9Keys, kF9Stages,
                                F9Layout<128>::kThreads, F9Layout<128>::kSmem, bases, o, z, B,
                                H, Lq, Lk, D, scale, maps, &a)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)p.grid_x, (unsigned)p.grid_y);
  if (D == 64)
    return p.key_mask ? launch_f9<64, true>(maps, a, grid, stream)
                      : launch_f9<64, false>(maps, a, grid, stream);
  return p.key_mask ? launch_f9<128, true>(maps, a, grid, stream)
                    : launch_f9<128, false>(maps, a, grid, stream);
}

}  // namespace
