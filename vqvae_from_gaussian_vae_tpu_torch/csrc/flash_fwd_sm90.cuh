// The bf16 flash-attention forward body designed for Hopper (sm_90a), for
// head dims 64 and 128: every shipped bf16 forward entry of
// csrc/flash_fwd.cu at those D (gvq_flash_fwd, gvq_flash_fwd_res,
// gvq_flash_fwd_qkv, gvq_flash_fwd_qkv_res, gvq_flash_fwd_hm).  D = 256 and
// 512 run csrc/flash_fwd_sm90_wide.cuh, which shares this file's softmax
// and plan.  The forward lab (csrc/flash_lab_fwd.cu: B15's softmax policies
// and depth, B16's tilings) instantiates this body at other knobs
// (F9Knobs: warpgroups, key tile, heads a block, policy, depth); the
// shipped entries run F9Ship<D>.
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
// The design, against what held the port's first (wmma) body back:
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

constexpr int kF9Keys = 128;  // keys a K or V tile (the shipped entries)
constexpr int kF9Stages = 3;  // K/V tiles in flight

// Consumer warpgroups a block, each owning 64 q rows: three at D = 64 (192
// rows), two at D = 128, where a thread's O takes 64 registers.
__host__ __device__ constexpr int f9_warpgroups(int d) { return d == 64 ? 3 : 2; }

// Registers a thread after setmaxnreg, by consumer warpgroups (2, 3 or 4):
// a block launches with 65,536 / threads of them a thread (rounded down to
// 8: 168, 128, 96), and the producer warpgroup gives up all but 40 or 24
// of its share to the consumers, which may take no more than that pool
__host__ __device__ constexpr int f9_producer_regs(int wg) { return wg == 2 ? 40 : 24; }
__host__ __device__ constexpr int f9_consumer_regs(int wg) {
  return wg == 2 ? 232 : (wg == 3 ? 160 : 112);
}

// The softmax of a key tile.  The shipped entries run kF9Base (f9_softmax);
// the others are the forward lab's policies (csrc/flash_lab_fwd.cu),
// priced on this body.
constexpr int kF9Base = 0;     // per-row running max, expf(s - m), O rescaled
constexpr int kF9NoMax = 1;    // expf(min(s, 30) - 30): no max pass, no rescale
constexpr int kF9Exp2 = 2;     // scores scaled by scale log2 e, exp2f(s' - m')
constexpr int kF9TileMax = 3;  // one running max a warpgroup's 64 rows and key tile
constexpr int kF9MatOnly = 4;  // p = s: no softmax (a control, timed only)
constexpr int kF9Chunk = 5;    // kF9NoMax on each tile's two 64-key halves, exp and P V interleaved
constexpr int kF9Sbf16 = 6;    // scores rounded to bf16 before the max, (s - m) rounded to bf16

// The body's knobs: WG consumer warpgroups of 64 q rows, KEYS keys a K or V
// tile, HEADS heads of one batch row that a block walks one after another
// (the ring of K and V tiles flows across each head boundary, and the next
// head's Q lands in a second Q tile), the softmax POLICY, and DEPTH score
// tiles in flight (1: tile t's Q K^T is issued beside tile t-1's P V; 2:
// tile t+1's Q K^T is issued too before tile t's softmax runs).  The
// shipped entries run F9Ship<D>; the forward lab (csrc/flash_lab_fwd.cu)
// the others.
template <int WG, int KEYS = kF9Keys, int HEADS = 1, int POLICY = kF9Base, int DEPTH = 1>
struct F9Knobs {
  static constexpr int kWarpgroups = WG, kKeys = KEYS, kHeads = HEADS, kPolicy = POLICY,
                       kDepth = DEPTH;
};

template <int D>
using F9Ship = F9Knobs<f9_warpgroups(D)>;

// Shared memory, from a 1024-byte-aligned base: the Q tile (two where a
// block walks several heads), then the stages, each a K tile and a V tile;
// then the mbarriers (Q full a Q tile; per stage K full, V full, empty; Q
// empty a Q tile where there are two), then kF9TileMax's exchange of the
// warps' maxima (two slots of four floats a warpgroup).  A tile of `rows`
// x D is D / 64 chunks of rows x 128 bytes (64 columns each), as the
// 128-byte swizzle lays them.
template <int D, class K = F9Ship<D>>
struct F9Layout {
  static constexpr int kWarpgroups = K::kWarpgroups;
  static constexpr int kRows = 64 * kWarpgroups;             // q rows a block
  static constexpr int kThreads = 128 * (kWarpgroups + 1);   // + the producer warpgroup
  static constexpr int kProducerRegs = f9_producer_regs(kWarpgroups);
  static constexpr int kConsumerRegs = f9_consumer_regs(kWarpgroups);
  static constexpr int kChunks = D / 64;
  static constexpr int kQBufs = K::kHeads > 1 ? 2 : 1;
  static constexpr uint32_t kChunkQ = kRows * 128;
  static constexpr uint32_t kChunkKV = K::kKeys * 128;
  static constexpr uint32_t kQ = kChunks * kChunkQ;
  static constexpr uint32_t kKV = kChunks * kChunkKV;
  static constexpr uint32_t kStage = 2 * kKV;
  static constexpr uint32_t kRing = kQBufs * kQ;
  static constexpr uint32_t kBars = kRing + kF9Stages * kStage;
  static constexpr int kNumBars = kQBufs + 3 * kF9Stages + (kQBufs > 1 ? kQBufs : 0);
  static constexpr uint32_t kXch = kBars + kNumBars * 8;
  static constexpr size_t kSmem =
      kXch + (K::kPolicy == kF9TileMax ? kWarpgroups * 32 : 0) + 1024;  // + alignment slack
};

struct F9Args {
  bf16* o;
  float* z;                       // (B, H, Lq) float32, or null
  long long so_b, so_h, so_row;   // o's strides, elements
  int Lq, Lk, H;
  int row_dim;                    // the maps' coordinates: 1 (d, row, h, b), 2 (d, h, row, b)
  float scale;
};

// S = Q K^T for one warpgroup's 64 rows and a key tile: D / 16 k-steps,
// each 16 columns = 32 bytes inside a chunk's 128-byte rows
template <int D, class K = F9Ship<D>>
__device__ __forceinline__ void f9_qk(float (&s)[K::kKeys / 2], uint32_t qa, uint32_t ka) {
  using Lay = F9Layout<D, K>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<K::kKeys>(s, wg_desc(qa + (kk >> 2) * Lay::kChunkQ + (kk & 3) * 32, 16, 1024),
                       wg_desc(ka + (kk >> 2) * Lay::kChunkKV + (kk & 3) * 32, 16, 1024),
                       kk > 0);
}

// O += P V over key steps kFirst .. kFirst + kSteps - 1 of a tile (16 keys,
// 16 rows of V, 2048 bytes each; by default the whole tile); V's 64-column
// chunks lie kChunkKV apart (the descriptor's LBO)
template <int D, class K = F9Ship<D>, int kFirst = 0, int kSteps = K::kKeys / 16>
__device__ __forceinline__ void f9_pv(float (&o)[D / 2], const uint32_t (&p)[K::kKeys / 16][4],
                                      uint32_t va) {
  using Lay = F9Layout<D, K>;
#pragma unroll
  for (int kk = kFirst; kk < kFirst + kSteps; ++kk) {
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

__device__ __forceinline__ float f9_round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One key tile's softmax step under a lab policy, with f9_softmax's
// contract (s becomes p, the shares of the row sums grow, the rows' rescale
// of O is returned: 1 where the policy keeps no running max).  kF9Exp2
// takes scores already scaled by scale log2 e (the lab entry's `scale`).
// kF9TileMax folds its maxima over the warpgroup's 64 rows: a warp's by
// shuffles, then the four warps' through `xch` (slot t % 2 of this
// warpgroup's two; a slot is rewritten two tiles later, after every warp
// passed the barrier between) behind named barrier 1 + warpgroup.
template <int POLICY, bool kLast, int NS>
__device__ __forceinline__ float2 f9_lab_softmax(float (&s)[NS], float& m0, float& m1, float& l0,
                                                 float& l1, float scale, int valid, uint32_t xch,
                                                 int t) {
  constexpr bool kMax = POLICY == kF9Exp2 || POLICY == kF9TileMax || POLICY == kF9Sbf16;
  const int c0 = 2 * (threadIdx.x & 3);
  float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[4 * j + e] * scale;
      if constexpr (POLICY == kF9Sbf16) v = f9_round_bf16(v);
      if (kLast && 8 * j + c0 + (e & 1) >= valid) v = POLICY == kF9MatOnly ? 0.0f : -INFINITY;
      s[4 * j + e] = v;
      if constexpr (kMax) {
        if (e < 2)
          x0 = fmaxf(x0, v);
        else
          x1 = fmaxf(x1, v);
      }
    }
  float2 alpha = make_float2(1.0f, 1.0f);
  float n0 = 0.0f, n1 = 0.0f;
  if constexpr (kMax) {
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
    if constexpr (POLICY == kF9TileMax) {
      float x = fmaxf(x0, x1);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
      const int warp = threadIdx.x >> 5, wg = warp >> 2;
      const uint32_t slot = xch + wg * 32 + (t & 1) * 16;
      if ((threadIdx.x & 31) == 0)
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(slot + 4 * (warp & 3)), "f"(x) : "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(w[i]) : "r"(slot + 4 * i) : "memory");
      x0 = x1 = fmaxf(fmaxf(w[0], w[1]), fmaxf(w[2], w[3]));
    }
    n0 = fmaxf(m0, x0);
    n1 = fmaxf(m1, x1);
    alpha = POLICY == kF9Exp2 ? make_float2(exp2f(m0 - n0), exp2f(m1 - n1))
                              : make_float2(expf(m0 - n0), expf(m1 - n1));
    m0 = n0;
    m1 = n1;
  }
  float ts[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[4 * j + e], n = e < 2 ? n0 : n1;
      float p;
      if constexpr (POLICY == kF9Exp2)
        p = exp2f(x - n);
      else if constexpr (POLICY == kF9Sbf16)
        p = expf(f9_round_bf16(x - n));
      else if constexpr (POLICY == kF9TileMax)
        p = expf(x - n);
      else if constexpr (POLICY == kF9MatOnly)
        p = x;
      else  // kF9NoMax, kF9Chunk
        p = expf(fminf(x, 30.0f) - 30.0f);
      s[4 * j + e] = p;
      ts[e] += p;
    }
  l0 = l0 * alpha.x + (ts[0] + ts[1]);
  l1 = l1 * alpha.y + (ts[2] + ts[3]);
  return alpha;
}

// a key tile's softmax step under the knobs' policy
template <int POLICY, bool kLast, int NS>
__device__ __forceinline__ float2 f9_tile_softmax(float (&s)[NS], float& m0, float& m1, float& l0,
                                                  float& l1, float scale, int valid, uint32_t xch,
                                                  int t) {
  if constexpr (POLICY == kF9Base)
    return f9_softmax<kLast>(s, m0, m1, l0, l1, scale, valid);
  else
    return f9_lab_softmax<POLICY, kLast>(s, m0, m1, l0, l1, scale, valid, xch, t);
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

// The rows' sums from the quad's shares; 1/sum once; o rounded to bf16 and
// stored, and z = m + ln(sum) where asked for; rows past Lq are not stored
template <int D>
__device__ __forceinline__ void f9_store(const F9Args& a, const float (&o)[D / 2], float m0,
                                         float m1, float l0, float l1, int q0, int bh, int warp,
                                         int lane, int wg) {
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

// Where a consumer warpgroup finds one head's tiles: the head's Q tile
// (`head` % kQBufs), its first key tile's place in the ring (g0: the ring
// runs on across the block's heads) and the mbarriers.
template <int D, class K>
struct F9Head {
  using Lay = F9Layout<D, K>;
  uint32_t ring, q_full, k_full, v_full, empty, q_empty, xch, qa;
  int qb, g0;
  __device__ __forceinline__ F9Head(uint32_t base, int n_tiles, int head) {
    ring = base + Lay::kRing;
    q_full = base + Lay::kBars;
    k_full = q_full + 8 * Lay::kQBufs;
    v_full = k_full + 8 * kF9Stages;
    empty = v_full + 8 * kF9Stages;
    q_empty = empty + 8 * kF9Stages;
    xch = base + Lay::kXch;
    qb = head % Lay::kQBufs;
    g0 = head * n_tiles;
    const int tid = threadIdx.x, warp = tid >> 5;
    const int wg = warp >> 2;
    qa = base + qb * Lay::kQ + wg * 64 * 128;
  }
  // the shared-memory address of ring position g's stage
  __device__ __forceinline__ uint32_t stage(int g) const {
    return ring + (g % kF9Stages) * Lay::kStage;
  }
};

// After one head's last product: where a block walks several heads, its
// warpgroup releases the last tile's stage and the head's Q tile
template <int D, class K>
__device__ __forceinline__ void f9_release_head(const F9Head<D, K>& hd, int g_last) {
  if constexpr (K::kHeads > 1) {
    if ((threadIdx.x & 127) == 0) {
      mbar_arrive(hd.empty + 8 * (g_last % kF9Stages));
      mbar_arrive(hd.q_empty + 8 * hd.qb);
    }
  }
}

// A consumer warpgroup's work on one head (depth 1, every policy but
// kF9Chunk): warpgroup wg (threadIdx.x / 128) owns q rows q0 + 64 wg .. +
// 63 of (b, h) = bh.  Per key tile t it issues S = Q K_t^T and then
// O += P_{t-1} V_{t-1} back to back, runs tile t's softmax while the P V
// product is on the tensor cores, releases tile t-1's stage, rescales O and
// rounds p.  Every mbarrier wait comes before the wgmma.fence of the
// products that need it.
template <int D, bool kMask, class K = F9Ship<D>>
__device__ __forceinline__ void f9_consume(const F9Args& a, uint32_t base, int n_tiles, int q0,
                                           int bh, int head) {
  using Lay = F9Layout<D, K>;
  constexpr int S = kF9Stages, NK = K::kKeys, P = K::kPolicy;
  constexpr bool kRescale = P != kF9NoMax && P != kF9MatOnly;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const F9Head<D, K> hd(base, n_tiles, head);
  const int g0 = hd.g0;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float s[NK / 2];
  uint32_t p[NK / 16][4];
  float m0 = -INFINITY, m1 = -INFINITY;  // running maxima of rows r and r + 8
  float l0 = 0.0f, l1 = 0.0f;            // this thread's shares of their sums

  mbar_wait(hd.q_full + 8 * hd.qb, (head / Lay::kQBufs) & 1);
  mbar_wait(hd.k_full + 8 * (g0 % S), (g0 / S) & 1);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  f9_qk<D, K>(s, hd.qa, hd.stage(g0));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_fence_acc(s);
  if (kMask && n_tiles == 1)
    f9_tile_softmax<P, true>(s, m0, m1, l0, l1, a.scale, a.Lk, hd.xch, g0);
  else
    f9_tile_softmax<P, false>(s, m0, m1, l0, l1, a.scale, NK, hd.xch, g0);
  f9_round_p(s, p);

  for (int t = 1; t < n_tiles; ++t) {
    const int g = g0 + t;
    const int st = g % S, pst = (g - 1) % S;
    mbar_wait(hd.k_full + 8 * st, (g / S) & 1);
    mbar_wait(hd.v_full + 8 * pst, ((g - 1) / S) & 1);
    wg_fence_acc(o);
    wg_fence_frag(p);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    f9_qk<D, K>(s, hd.qa, hd.ring + st * Lay::kStage);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    f9_pv<D, K>(o, p, hd.ring + pst * Lay::kStage + Lay::kKV);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S of tile t
    wg_fence_acc(s);
    const float2 alpha =
        kMask && t == n_tiles - 1
            ? f9_tile_softmax<P, true>(s, m0, m1, l0, l1, a.scale, a.Lk - t * NK, hd.xch, g)
            : f9_tile_softmax<P, false>(s, m0, m1, l0, l1, a.scale, NK, hd.xch, g);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // P V of tile t - 1
    wg_fence_acc(o);
    wg_fence_frag(p);
    if ((tid & 127) == 0) mbar_arrive(hd.empty + 8 * pst);
    if constexpr (kRescale) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha.x;
        o[4 * j + 1] *= alpha.x;
        o[4 * j + 2] *= alpha.y;
        o[4 * j + 3] *= alpha.y;
      }
    }
    f9_round_p(s, p);
  }
  {
    const int g = g0 + n_tiles - 1, last = g % S;
    mbar_wait(hd.v_full + 8 * last, (g / S) & 1);
    wg_fence_acc(o);
    wg_fence_frag(p);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    f9_pv<D, K>(o, p, hd.ring + last * Lay::kStage + Lay::kKV);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(o);
    f9_release_head(hd, g);
  }
  f9_store<D>(a, o, m0, m1, l0, l1, q0, bh, warp, lane, wg);
}

// One tile t >= 1 of the depth-2 order (kF9Base): S_t is in `cur`, done.
// Issue O += P_{t-1} V_{t-1}, then (kMore: tile t is not the last) S_{t+1}
// into `nxt`; run tile t's softmax while both products are on the tensor
// cores; wait for both, release tile t-1's stage, rescale O and round p
// from S_t.  Each tile's wgmma groups are fixed at compile time and all
// retired before o, p or a score tile is written again: ptxas serialises
// every product where it cannot prove that (C7513, C7515).
template <int D, bool kMask, class K, bool kMore>
__device__ __forceinline__ void f9_deep_tile(const F9Args& a, const F9Head<D, K>& hd,
                                             float (&o)[D / 2], float (&cur)[K::kKeys / 2],
                                             float (&nxt)[K::kKeys / 2],
                                             uint32_t (&p)[K::kKeys / 16][4], float& m0,
                                             float& m1, float& l0, float& l1, int t) {
  using Lay = F9Layout<D, K>;
  constexpr int S = kF9Stages, NK = K::kKeys;
  const int g = hd.g0 + t, pst = (g - 1) % S;
  mbar_wait(hd.v_full + 8 * pst, ((g - 1) / S) & 1);
  if (kMore) mbar_wait(hd.k_full + 8 * ((g + 1) % S), ((g + 1) / S) & 1);
  wg_fence_acc(o);
  wg_fence_frag(p);
  wg_fence_acc(nxt);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  f9_pv<D, K>(o, p, hd.ring + pst * Lay::kStage + Lay::kKV);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  if constexpr (kMore) {
    f9_qk<D, K>(nxt, hd.qa, hd.stage(g + 1));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
  const float2 alpha = kMask && !kMore
                           ? f9_softmax<true>(cur, m0, m1, l0, l1, a.scale, a.Lk - t * NK)
                           : f9_softmax<false>(cur, m0, m1, l0, l1, a.scale, NK);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // P V, and S of tile t + 1
  wg_fence_acc(o);
  wg_fence_frag(p);
  wg_fence_acc(nxt);
  if ((threadIdx.x & 127) == 0) mbar_arrive(hd.empty + 8 * pst);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= alpha.x;
    o[4 * j + 1] *= alpha.x;
    o[4 * j + 2] *= alpha.y;
    o[4 * j + 3] *= alpha.y;
  }
  f9_round_p(cur, p);
}

// A consumer warpgroup's work on one head at depth 2: two score tiles in
// flight, in two register sets that swap roles each tile (tile t's scores
// in sb for odd t, sa for even t), so the tile loop runs two tiles a pass.
// A head of one key tile has nothing to overlap: it runs the depth-1 order.
template <int D, bool kMask, class K>
__device__ __forceinline__ void f9_consume_deep(const F9Args& a, uint32_t base, int n_tiles,
                                                int q0, int bh, int head) {
  static_assert(K::kPolicy == kF9Base, "depth 2 runs the shipped softmax");
  if (n_tiles < 2) return f9_consume<D, kMask, K>(a, base, n_tiles, q0, bh, head);
  using Lay = F9Layout<D, K>;
  constexpr int S = kF9Stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const F9Head<D, K> hd(base, n_tiles, head);
  const int g0 = hd.g0;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float sa[K::kKeys / 2], sb[K::kKeys / 2];
  uint32_t p[K::kKeys / 16][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(hd.q_full + 8 * hd.qb, (head / Lay::kQBufs) & 1);
  mbar_wait(hd.k_full + 8 * (g0 % S), (g0 / S) & 1);
  mbar_wait(hd.k_full + 8 * ((g0 + 1) % S), ((g0 + 1) / S) & 1);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  f9_qk<D, K>(sa, hd.qa, hd.stage(g0));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  f9_qk<D, K>(sb, hd.qa, hd.stage(g0 + 1));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S of tile 0
  wg_fence_acc(sa);
  f9_softmax<false>(sa, m0, m1, l0, l1, a.scale, K::kKeys);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // S of tile 1
  wg_fence_acc(sb);
  f9_round_p(sa, p);
  int t = 1;
  for (; t + 2 < n_tiles; t += 2) {
    f9_deep_tile<D, kMask, K, true>(a, hd, o, sb, sa, p, m0, m1, l0, l1, t);
    f9_deep_tile<D, kMask, K, true>(a, hd, o, sa, sb, p, m0, m1, l0, l1, t + 1);
  }
  if (t + 1 < n_tiles) {
    f9_deep_tile<D, kMask, K, true>(a, hd, o, sb, sa, p, m0, m1, l0, l1, t);
    f9_deep_tile<D, kMask, K, false>(a, hd, o, sa, sb, p, m0, m1, l0, l1, t + 1);
  } else {
    f9_deep_tile<D, kMask, K, false>(a, hd, o, sb, sa, p, m0, m1, l0, l1, t);
  }
  {
    const int g = g0 + n_tiles - 1, last = g % S;
    mbar_wait(hd.v_full + 8 * last, (g / S) & 1);
    wg_fence_acc(o);
    wg_fence_frag(p);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    f9_pv<D, K>(o, p, hd.ring + last * Lay::kStage + Lay::kKV);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(o);
    f9_release_head(hd, g);
  }
  f9_store<D>(a, o, m0, m1, l0, l1, q0, bh, warp, lane, wg);
}

// kF9Chunk's half H (keys 64 H .. 64 H + 63) of a 128-key tile: p =
// expf(min(s, 30) - 30) into the A fragments of k-steps 4 H .. 4 H + 3,
// the keys at or past `valid` 0, the row sums' shares grown
template <int H, bool kMask>
__device__ __forceinline__ void f9_chunk_half(float (&s)[64], uint32_t (&p)[8][4], float& l0,
                                              float& l1, float scale, int valid) {
  const int c0 = 2 * (threadIdx.x & 3);
  float ts[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 8 * H; j < 8 * H + 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[4 * j + e] * scale;
      if (kMask && 8 * j + c0 + (e & 1) >= valid) v = -INFINITY;
      const float pe = expf(fminf(v, 30.0f) - 30.0f);
      s[4 * j + e] = pe;
      ts[e] += pe;
    }
  l0 += ts[0] + ts[1];
  l1 += ts[2] + ts[3];
#pragma unroll
  for (int kk = 4 * H; kk < 4 * H + 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
#pragma unroll
  for (int kk = 4 * H; kk < 4 * H + 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(p[kk][r])::"memory");
}

// A consumer warpgroup's work on one head under kF9Chunk (no max, so no
// rescale: each tile's products accumulate into O as they come).  Per key
// tile: exp of the first 64 keys, their P V issued; exp of the other 64
// while it runs, their P V issued; then tile t+1's Q K^T; one wait for all
// three, and the tile's stage released.
template <int D, bool kMask, class K>
__device__ __forceinline__ void f9_consume_chunk(const F9Args& a, uint32_t base, int n_tiles,
                                                 int q0, int bh, int head) {
  static_assert(K::kKeys == 128 && K::kDepth == 1, "kF9Chunk halves 128-key tiles at depth 1");
  using Lay = F9Layout<D, K>;
  constexpr int S = kF9Stages;
  const F9Head<D, K> hd(base, n_tiles, head);
  const int g0 = hd.g0;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float s[64];
  uint32_t p[8][4];
  float l0 = 0.0f, l1 = 0.0f;

  mbar_wait(hd.q_full + 8 * hd.qb, (head / Lay::kQBufs) & 1);
  mbar_wait(hd.k_full + 8 * (g0 % S), (g0 / S) & 1);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  f9_qk<D, K>(s, hd.qa, hd.stage(g0));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_fence_acc(s);
  for (int t = 0; t < n_tiles; ++t) {
    const int g = g0 + t, st = g % S;
    const int valid = kMask && t == n_tiles - 1 ? a.Lk - t * 128 : 128;
    const uint32_t va = hd.ring + st * Lay::kStage + Lay::kKV;
    f9_chunk_half<0, kMask>(s, p, l0, l1, a.scale, valid);
    mbar_wait(hd.v_full + 8 * st, (g / S) & 1);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    f9_pv<D, K, 0, 4>(o, p, va);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    f9_chunk_half<1, kMask>(s, p, l0, l1, a.scale, valid);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    f9_pv<D, K, 4, 4>(o, p, va);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (t + 1 < n_tiles) {
      mbar_wait(hd.k_full + 8 * ((g + 1) % S), ((g + 1) / S) & 1);
      f9_qk<D, K>(s, hd.qa, hd.stage(g + 1));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(o);
    wg_fence_frag(p);
    wg_fence_acc(s);
    if ((threadIdx.x & 127) == 0) mbar_arrive(hd.empty + 8 * st);
  }
  if constexpr (K::kHeads > 1) {
    if ((threadIdx.x & 127) == 0) mbar_arrive(hd.q_empty + 8 * hd.qb);
  }
  const int tid = threadIdx.x, warp = tid >> 5;
  // the static shift stands for the max
  f9_store<D>(a, o, 30.0f, 30.0f, l0, l1, q0, bh, warp, tid & 31, warp >> 2);
}

// one head of a consumer warpgroup, in the order the knobs ask for
template <int D, bool kMask, class K>
__device__ __forceinline__ void f9_consume_head(const F9Args& a, uint32_t base, int n_tiles,
                                                int q0, int bh, int head) {
  if constexpr (K::kPolicy == kF9Chunk)
    f9_consume_chunk<D, kMask, K>(a, base, n_tiles, q0, bh, head);
  else if constexpr (K::kDepth == 2)
    f9_consume_deep<D, kMask, K>(a, base, n_tiles, q0, bh, head);
  else
    f9_consume<D, kMask, K>(a, base, n_tiles, q0, bh, head);
}

// The producer thread's copies for head `i` of its block ((b, h) = bh):
// the head's Q tile into Q tile i % kQBufs (once the consumers released
// its last use), then every K and V tile through the ring, whose position
// runs on across the block's heads
template <int D, class K>
__device__ __forceinline__ void f9_produce_head(const CUtensorMap* tmap_q,
                                               const CUtensorMap* tmap_k,
                                               const CUtensorMap* tmap_v, const F9Args& a,
                                               uint32_t base, int n_tiles, int q0, int bh, int i) {
  using Lay = F9Layout<D, K>;
  constexpr int S = kF9Stages, NK = K::kKeys;
  const uint32_t ring = base + Lay::kRing;
  const uint32_t q_bar = base + Lay::kBars;
  const uint32_t k_full = q_bar + 8 * Lay::kQBufs;
  const uint32_t v_full = k_full + 8 * S;
  const uint32_t empty = v_full + 8 * S;
  const uint32_t q_empty = empty + 8 * S;
  const int b = bh / a.H, h = bh - b * a.H;
  // the box of a tile whose rows start at `row`, chunk c (columns 64 c ..)
  auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int c, int row) {
    if (a.row_dim == 1)
      tma_load_4d(dst, map, bar, 64 * c, row, h, b);
    else
      tma_load_4d(dst, map, bar, 64 * c, h, row, b);
  };
  const int qb = i % Lay::kQBufs;
  if constexpr (Lay::kQBufs > 1) mbar_wait(q_empty + 8 * qb, ((i / 2) & 1) ^ 1);
  mbar_arrive_expect_tx(q_bar + 8 * qb, Lay::kQ);
#pragma unroll
  for (int c = 0; c < Lay::kChunks; ++c)
    load(base + qb * Lay::kQ + c * Lay::kChunkQ, tmap_q, q_bar + 8 * qb, c, q0);
  for (int t = 0; t < n_tiles; ++t) {
    const int g = i * n_tiles + t;
    const int s = g % S;
    mbar_wait(empty + 8 * s, ((g / S) & 1) ^ 1);  // a fresh stage passes
    const uint32_t kd = ring + s * Lay::kStage, vd = kd + Lay::kKV;
    mbar_arrive_expect_tx(k_full + 8 * s, Lay::kKV);
#pragma unroll
    for (int c = 0; c < Lay::kChunks; ++c)
      load(kd + c * Lay::kChunkKV, tmap_k, k_full + 8 * s, c, t * NK);
    mbar_arrive_expect_tx(v_full + 8 * s, Lay::kKV);
#pragma unroll
    for (int c = 0; c < Lay::kChunks; ++c)
      load(vd + c * Lay::kChunkKV, tmap_v, v_full + 8 * s, c, t * NK);
  }
}

// A block: q rows blockIdx.x * kRows.. of heads blockIdx.y * HEADS.. (one
// batch row: H is a multiple of HEADS).  One producer thread copies each
// head's Q tile and then its K and V tiles through the ring; the consumer
// warpgroups walk the heads in the same order.
template <int D, bool kMask, class K>
__device__ __forceinline__ void f9_block(const CUtensorMap* tmap_q, const CUtensorMap* tmap_k,
                                         const CUtensorMap* tmap_v, const F9Args& a) {
  using Lay = F9Layout<D, K>;
  constexpr int S = kF9Stages, NK = K::kKeys;
  extern __shared__ unsigned char f9_smem[];
  const uint32_t base = (wg_smem_addr(f9_smem) + 1023u) & ~1023u;  // the swizzle's 1024-byte atom
  const uint32_t q_bar = base + Lay::kBars;      // + 8 i for Q tile i
  const uint32_t k_full = q_bar + 8 * Lay::kQBufs;  // + 8 s for stage s
  const uint32_t v_full = k_full + 8 * S;
  const uint32_t empty = v_full + 8 * S;
  const uint32_t q_empty = empty + 8 * S;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int bh0 = blockIdx.y * K::kHeads;
  const int q0 = blockIdx.x * Lay::kRows;
  const int n_tiles = (a.Lk + NK - 1) / NK;

  // warpgroups whose 64 rows all lie past Lq compute nothing
  const int active = min(Lay::kWarpgroups, (a.Lq - q0 + 63) / 64);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < Lay::kQBufs; ++i) mbar_init(q_bar + 8 * i, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + 8 * s, 1);       // the producer's arrive; the copies' bytes
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, active);   // one arrive per active consumer warpgroup
    }
    if constexpr (Lay::kQBufs > 1) {
#pragma unroll
      for (int i = 0; i < Lay::kQBufs; ++i) mbar_init(q_empty + 8 * i, active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if / else over warpgroups that never reconverges, so that
  // setmaxnreg moves the producer warpgroup's registers to the consumers
  if (warp >= 4 * Lay::kWarpgroups) {  // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Lay::kProducerRegs));
    if (tid == 128 * Lay::kWarpgroups) {
      if constexpr (K::kHeads == 1) {
        f9_produce_head<D, K>(tmap_q, tmap_k, tmap_v, a, base, n_tiles, q0, bh0, 0);
      } else {
#pragma unroll 1
        for (int i = 0; i < K::kHeads; ++i)
          f9_produce_head<D, K>(tmap_q, tmap_k, tmap_v, a, base, n_tiles, q0, bh0 + i, i);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Lay::kConsumerRegs));
    if (warp / 4 < active) {
      if constexpr (K::kHeads == 1) {
        f9_consume_head<D, kMask, K>(a, base, n_tiles, q0, bh0, 0);
      } else {
#pragma unroll 1
        for (int i = 0; i < K::kHeads; ++i)
          f9_consume_head<D, kMask, K>(a, base, n_tiles, q0, bh0 + i, i);
      }
    }
  }
}

// The shipped entries' kernel (D = 64 and 128)
template <int D, bool kMask>
__global__ void __launch_bounds__(F9Layout<D>::kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tmap_q,
                      const __grid_constant__ CUtensorMap tmap_k,
                      const __grid_constant__ CUtensorMap tmap_v, F9Args a) {
  f9_block<D, kMask, F9Ship<D>>(&tmap_q, &tmap_k, &tmap_v, a);
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

// Hold the plan to the body that reads it (`body` and its tiles, stages,
// threads and shared memory) and to the shapes the entry was given, encode
// its three maps over bases[] (q, k, v; the packed entries pass the
// (B, L, 3C) base three times) and fill the kernel's arguments; false
// where anything disagrees.  The wide body (flash_fwd_sm90_wide.cuh) takes
// the same plan; the forward lab's blocks walk `heads` heads each, so its
// grid's y is B * H / heads.
inline bool fwd_plan_args(const FwdPlan& p, long long body, int q_rows, int k_rows, int stages,
                          int threads, size_t smem, const bf16* const (&bases)[3], bf16* o,
                          float* z, int B, int H, int Lq, int Lk, int D, float scale,
                          CUtensorMap (&maps)[3], F9Args* a, int heads = 1) {
  const long long bh = (long long)B * H;
  bool ok = p.body == body && p.q_rows == q_rows && p.k_rows == k_rows && p.stages == stages &&
            p.threads == threads && p.smem == (long long)smem &&
            p.grid_x == (Lq + q_rows - 1) / q_rows && H % heads == 0 &&
            p.grid_y * heads == bh && p.grid_y <= 65535 &&
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

}  // namespace
