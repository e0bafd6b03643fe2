// The bf16 flash-attention backward body designed for Hopper (sm_90a), for
// head dims 64 and 128: every bf16 backward entry of csrc/flash_bwd.cu at
// those D (gvq_flash_bwd_qkv, gvq_flash_bwd, gvq_flash_bwd_hm).  D = 256 and
// 512 run csrc/flash_bwd_sm90_wide.cuh, which shares this body's di
// pre-pass, launch plan, argument struct and elementwise steps.  The
// backward lab (csrc/flash_lab_bwd.cu, B17) instantiates this body at other
// knobs (B9Knobs: streamed tile rows, stages, the no-softmax control); the
// shipped entries run B9Ship<D>.
//
// Replaces the TPU kernels vqvae_from_gaussian_vae_tpu/ops/flash_blc.py
// _bwd_impl (packed and unpacked; body _bwd_kernel) and the backward of
// vqvae_from_gaussian_vae_tpu/ops/flash_attention.py (_bwd: the upstream
// _flash_attention_bwd_dkv, then _bwd_dq_lean).  Per (batch, head), from the
// forward's log-normaliser z and di = rowsum(do * o) in float32 (a
// pre-pass, b9_di_kernel):
//
//   p  = expf(s * scale - z),  s = q k^T in float32   (no max or sum pass)
//   ds = p (do v^T - di) scale                         (rounded once to bf16)
//   dv = bf16(p)^T do,  dk = ds^T q,  dq = ds k        (float32 sums, one rounding)
//
// What bounds it on an H100: the tensor cores, then the elementwise work.
// A packed launch at the ViT's shape (B=16, L=1024, H=12, D=64) is 1.29e11
// FLOP for the five products against 202 MB (0.130 ms at the bf16 peak);
// the head-major call's backward at (1, 12, 8192, 64) 5.15e11 FLOP against
// 101 MB.  Each score costs two expf (one in each kernel below) and a dozen
// other instructions.
//
// The design, against what held the port's first (wmma) body back:
// 1. Scores, P and dS never touch shared memory.  Every product is wgmma
//    with its accumulator in registers; p and ds are computed on the
//    accumulator registers and rounded to bf16 in the accumulator's own
//    register order, which is the bf16 A fragment wgmma takes from
//    registers (the .RS form), so P^T, dS^T and dS feed the next products
//    directly.
// 2. Two kernels, no atomics, bit-reproducible (seven products where the
//    function needs five: each kernel recomputes s and do v^T).
//    - dK/dV: one block per (128-key tile, b, h), two consumer warpgroups of
//      64 keys.  K and V are copied once; the transposed scores
//      S^T = K Q^T and dP^T = V dO^T (both operands K-major) put a q row in
//      a column, so z and di are read by column from shared memory, where
//      the producer warp stores them with each q tile.  dV += P^T dO and
//      dK += dS^T Q (A from registers, B MN-major) accumulate in registers
//      over the whole q loop.
//    - dQ: one block per (128-row q tile, b, h), two consumer warpgroups of
//      64 rows.  Q and dO are copied once, each thread's z and di are two
//      registers; S = Q K^T, dP = dO V^T, then dQ += dS K over the key
//      tiles, dQ in registers.
// 3. No block barrier in either loop.  One producer thread keeps a 3-stage
//    ring of TMA copies in flight (q and dO tiles, or K and V tiles) with
//    full / empty mbarriers.  Each consumer warpgroup starts tile t's score
//    products and tile t-1's accumulation products back to back, every
//    mbarrier wait before the wgmma fence, and computes tile t's p and ds
//    while the accumulation products run.  The two warpgroups take turns
//    to start their products (two named barriers), so that the tensor
//    cores run one's products while the other computes p and ds.
// 4. setmaxnreg moves the producer warpgroup's registers to the consumers
//    (40 and 232 a thread).  Tiles by head dim, for the registers: at D = 64
//    the dK/dV kernel streams 64-row q tiles and the dQ kernel 128-key
//    tiles; at D = 128, where dK and dV take 128 registers a thread, 32-row
//    q tiles and 64-key tiles.
// 5. Outputs are rounded to bf16 and stored from the accumulator layout;
//    no staging tile, no barrier.  di comes from a pre-pass whose lanes read
//    16 bytes each of neighbouring rows, so a warp reads contiguous memory.
//
// What bounds it now: the product count and the dispatch of the elementwise
// work beside the products.  At (1, 12, 8192, 64) on an H100 80GB HBM3 at
// 700 W (chip_smoke.py) the pair runs its seven products at about 456
// TFLOP/s, PyTorch's SDPA backward its five at about 462: the split's two
// extra products are the gap.  At L = 1024 a block's prologue and epilogue
// (the K/V or Q/dO copy, the stores) weigh more.
//
// The tensor maps are 4-D, built on the host from the launch plan
// (ops/flash_attention.py flash_bwd_plan): head-major tensors as (D, L, H,
// B), token-major and packed ones as (D, H, L, B) with the input's token
// stride, the packed q, k and v at element offsets 0, C and 2C of the (B,
// L, 3C) projection, do (B, L, C) at its own stride.  A map's box holds the
// rows of the smaller tile that either kernel reads of that tensor, so the
// larger tile is two or four copies.  A box never leaves its (b, h): TMA's
// zero fill past L is the ragged edge.  Zero-filled q rows would give p = 1
// in the dK/dV kernel and zero-filled keys p = exp(-z) in the dQ kernel, so
// the last q tile (dK/dV) and the last key tile (dQ) mask p and ds to 0
// explicitly; rows of dk, dv past Lk and of dq past Lq are computed on
// zeros and not stored, and a warpgroup whose 64 rows all lie past the
// length computes nothing.
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

constexpr int kB9Rows = 128;    // keys a dK/dV block, q rows a dQ block: two warpgroups of 64
constexpr int kB9Stages = 3;    // streamed tiles in flight
constexpr int kB9Threads = 384;  // two consumer warpgroups and the producer warpgroup
constexpr int kB9ProducerRegs = 40, kB9ConsumerRegs = 232;

// q rows a streamed tile of the dK/dV kernel (the box rows of q and dO), and
// keys a streamed tile of the dQ kernel (the box rows of k and v): twice
// the q tile's rows
__host__ __device__ constexpr int b9_q_tile(int d) { return d == 64 ? 64 : 32; }
__host__ __device__ constexpr int b9_k_tile(int d) { return 2 * b9_q_tile(d); }

// The body's knobs: NQ q rows a streamed tile of the dK/dV kernel (the dQ
// kernel streams 2 NQ keys a tile), STAGES streamed tiles in flight, and
// CONTROL, the lab's no-softmax control (p = bf16(s), ds = bf16(dp),
// unscaled; no z, no di).  The shipped entries run B9Ship<D>; the backward
// lab (csrc/flash_lab_bwd.cu) the others.
template <int NQ, int STAGES = kB9Stages, bool CONTROL = false>
struct B9Knobs {
  static constexpr int kNQ = NQ, kNK = 2 * NQ, kStages = STAGES;
  static constexpr bool kControl = CONTROL;
};

template <int D>
using B9Ship = B9Knobs<b9_q_tile(D)>;

// Shared memory of the dK/dV kernel, from a 1024-byte-aligned base: the K
// tile, the V tile (128 rows each), the ring's stages (a q tile and a dO
// tile each), z and di of each stage (float32), then the mbarriers (K/V
// full; per stage tile full, z/di full, empty).  A tile of `rows` x D is
// D / 64 chunks of rows x 128 bytes, as the 128-byte swizzle lays them.
template <int D, class K = B9Ship<D>>
struct B9KvLayout {
  static constexpr int kStages = K::kStages;
  static constexpr int kQRows = K::kNQ;
  static constexpr int kChunks = D / 64;
  static constexpr uint32_t kChunkKV = kB9Rows * 128;
  static constexpr uint32_t kChunkQ = kQRows * 128;
  static constexpr uint32_t kKV = kChunks * kChunkKV;
  static constexpr uint32_t kQ = kChunks * kChunkQ;
  static constexpr uint32_t kStage = 2 * kQ;
  static constexpr uint32_t kRing = 2 * kKV;
  static constexpr uint32_t kZd = kRing + kStages * kStage;  // stage s: z, then di, kQRows each
  static constexpr uint32_t kBars = kZd + kStages * 2 * kQRows * 4;
  static constexpr size_t kSmem = kBars + (1 + 3 * kStages) * 8 + 1024;  // + alignment slack
};

// Shared memory of the dQ kernel: the Q tile and the dO tile (128 rows
// each), the ring's stages (a K tile and a V tile each), the mbarriers (Q/dO
// full; per stage full, empty).
template <int D, class K = B9Ship<D>>
struct B9QLayout {
  static constexpr int kStages = K::kStages;
  static constexpr int kKRows = K::kNK;
  static constexpr int kChunks = D / 64;
  static constexpr uint32_t kChunkQ = kB9Rows * 128;
  static constexpr uint32_t kChunkK = kKRows * 128;
  static constexpr uint32_t kQ = kChunks * kChunkQ;
  static constexpr uint32_t kK = kChunks * kChunkK;
  static constexpr uint32_t kStage = 2 * kK;
  static constexpr uint32_t kRing = 2 * kQ;
  static constexpr uint32_t kBars = kRing + kStages * kStage;
  static constexpr size_t kSmem = kBars + (1 + 2 * kStages) * 8 + 1024;
};

struct B9Args {
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const float* z;   // (B, H, Lq) float32
  float* di;        // (B, H, Lq) float32, written by the pre-pass
  long long sq_b, sq_h, sq_row;     // dq's strides, elements
  long long skv_b, skv_h, skv_row;  // dk's and dv's
  int Lq, Lk, H;
  int row_dim;  // the maps' coordinates: 1 (d, row, h, b), 2 (d, h, row, b)
  float scale;
};

// the box of rows row.. of (b, h), columns 64 c.., from a map of the plan
__device__ __forceinline__ void b9_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                        int row_dim, int c, int row, int b, int h) {
  if (row_dim == 1)
    tma_load_4d(dst, map, bar, 64 * c, row, h, b);
  else
    tma_load_4d(dst, map, bar, 64 * c, h, row, b);
}

// a tile of `rows` rows from row `row` into dst: D / 64 chunks of rows x 128
// bytes, each `rows / box` copies of `box` rows
template <int D>
__device__ __forceinline__ void b9_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int row_dim, int rows, int box, int row, int b,
                                             int h) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    for (int r = 0; r < rows; r += box)
      b9_load(dst + c * rows * 128 + r * 128, map, bar, row_dim, c, row + r, b, h);
}

// D (64 x N) = A (64 x D) . B^T (D x N), A and B K-major tiles whose 64-column
// chunks lie kChunkA and kChunkB bytes apart: D / 16 k-steps, each 16
// columns = 32 bytes inside a chunk's 128-byte rows
template <int D, int N, uint32_t kChunkA, uint32_t kChunkB>
__device__ __forceinline__ void b9_scores(float (&d)[N / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<N>(d, wg_desc(a + (kk >> 2) * kChunkA + (kk & 3) * 32, 16, 1024),
                wg_desc(b + (kk >> 2) * kChunkB + (kk & 3) * 32, 16, 1024), kk > 0);
}

// O (64 x D) += A (64 x K, bf16 fragments in registers) . B (K x D), B an
// MN-major tile: K / 16 k-steps of 16 rows (2048 bytes); its 64-column
// chunks lie kChunkB apart (the descriptor's LBO)
template <int D, int K, uint32_t kChunkB>
__device__ __forceinline__ void b9_accumulate(float (&o)[D / 2], const uint32_t (&a)[K / 16][4],
                                              uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) wgmma_rs<D>(o, a[kk], wg_desc(b + kk * 2048, kChunkB, 1024));
}

// values rounded to bf16 in the accumulator's register order: k-step kk's A
// fragment is s[8 kk .. 8 kk + 7] in pairs (rows r and r + 8, columns
// 16 kk + 2 (lane % 4) + {0, 1} and + 8), the m16n8k16 A layout that wgmma
// takes from registers for bf16
template <int N>
__device__ __forceinline__ void b9_round(const float (&s)[N / 2], uint32_t (&f)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) f[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// p and ds of one q tile on this thread's share of the transposed scores:
// accumulator element [4 j + e] is key row (lane / 4) + 8 (e / 2) of the
// warp's 16 and q column 8 j + 2 (lane % 4) + e % 2 of the tile, whose z
// and di (by column) are in shared memory.  s becomes p, dp becomes ds; kLast:
// the columns at or past `valid` (q rows past Lq) get p = ds = 0.
// kControl (the lab's control): p = s and ds = dp, unscaled, reading no z
// and no di.
template <int N, bool kLast, bool kControl = false>
__device__ __forceinline__ void b9_kv_probs(float (&s)[N / 2], float (&dp)[N / 2], const float* zs,
                                            const float* dis, float scale, int valid) {
  const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float2 zz = make_float2(0.0f, 0.0f), dd = zz;
    if constexpr (!kControl) {
      zz = *reinterpret_cast<const float2*>(zs + 8 * j + c0);
      dd = *reinterpret_cast<const float2*>(dis + 8 * j + c0);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p =
          kControl ? s[4 * j + e] : expf(s[4 * j + e] * scale - ((e & 1) ? zz.y : zz.x));
      const float ds =
          kControl ? dp[4 * j + e] : p * (dp[4 * j + e] - ((e & 1) ? dd.y : dd.x)) * scale;
      const bool out = kLast && 8 * j + c0 + (e & 1) >= valid;
      s[4 * j + e] = out ? 0.0f : p;
      dp[4 * j + e] = out ? 0.0f : ds;
    }
  }
}

// ds of one key tile on this thread's scores (rows r and r + 8, whose z and
// di the thread holds; key column 8 j + 2 (lane % 4) + e % 2), into s;
// kLast: the keys at or past `valid` get ds = 0; kControl: ds = dp
template <int N, bool kLast, bool kControl = false>
__device__ __forceinline__ void b9_q_ds(float (&s)[N / 2], const float (&dp)[N / 2], float z0,
                                        float z1, float di0, float di1, float scale, int valid) {
  const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = kControl ? 0.0f : expf(s[4 * j + e] * scale - (e < 2 ? z0 : z1));
      const float ds = kControl ? dp[4 * j + e] : p * (dp[4 * j + e] - (e < 2 ? di0 : di1)) * scale;
      s[4 * j + e] = kLast && 8 * j + c0 + (e & 1) >= valid ? 0.0f : ds;
    }
}

// the accumulator (64 rows of this warpgroup from row0, D columns) rounded
// to bf16 into dst (row stride `stride`), rows at or past `rows` not stored
template <int D>
__device__ __forceinline__ void b9_store(const float (&o)[D / 2], bf16* dst, long long stride,
                                         int row0, int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = row0 + (warp & 3) * 16 + (lane >> 2);
  bf16* p = dst + 2 * (lane & 3);
  const bool in0 = r0 < rows, in1 = r0 + 8 < rows;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (in0)
      *reinterpret_cast<uint32_t*>(p + r0 * stride + 8 * j) = pack_bf16x2(o[4 * j], o[4 * j + 1]);
    if (in1)
      *reinterpret_cast<uint32_t*>(p + (r0 + 8) * stride + 8 * j) =
          pack_bf16x2(o[4 * j + 2], o[4 * j + 3]);
  }
}

// The turns of the two consumer warpgroups, where both are active
// (pp), so that the tensor cores run one's products while the other
// computes p and ds: warpgroup wg waits on named barrier 1 + wg before it
// starts a tile's products and passes the turn on the other's after;
// warpgroup 1 hands warpgroup 0 the first turn and keeps its last, so that
// every barrier phase completes.
__device__ __forceinline__ void b9_turn_first(bool pp, int wg) {
  if (pp && wg == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void b9_turn_wait(bool pp, int wg) {
  if (pp) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void b9_turn_pass(bool pp, int wg, bool last) {
  if (pp && !(last && wg == 1)) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// A dK/dV consumer warpgroup: warpgroup wg owns keys k0 + 64 wg .. + 63 of
// (b, h) = bh.  Per q tile t it starts S^T = K Q_t^T and dP^T = V dO_t^T,
// then dV += P_{t-1}^T dO_{t-1} and dK += dS_{t-1}^T Q_{t-1}; computes tile
// t's p and ds while the latter run; then releases tile t-1's stage (each
// warp, after its reads of z and di) and rounds p and ds.
template <int D, bool kMask, class K = B9Ship<D>>
__device__ __forceinline__ void b9_kv_consume(const B9Args& a, uint32_t base,
                                              const unsigned char* basep, int n_tiles, int k0,
                                              int bh, bool pp) {
  using Lay = B9KvLayout<D, K>;
  constexpr int S = K::kStages, NQ = Lay::kQRows;
  constexpr bool C = K::kControl;
  const uint32_t ring = base + Lay::kRing;
  const uint32_t kv_bar = base + Lay::kBars;
  const uint32_t full = kv_bar + 8, zd_full = full + 8 * S, empty = zd_full + 8 * S;
  const float* zd = reinterpret_cast<const float*>(basep + Lay::kZd);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const uint32_t ka = base + wg * 64 * 128, va = ka + Lay::kKV;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;
  float s[NQ / 2], dp[NQ / 2];
  uint32_t pf[NQ / 16][4], dsf[NQ / 16][4];

  b9_turn_first(pp, wg);
  mbar_wait(kv_bar, 0);
  mbar_wait(full, 0);
  mbar_wait(zd_full, 0);
  b9_turn_wait(pp, wg);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  b9_scores<D, NQ, Lay::kChunkKV, Lay::kChunkQ>(s, ka, ring);
  b9_scores<D, NQ, Lay::kChunkKV, Lay::kChunkQ>(dp, va, ring + Lay::kQ);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  b9_turn_pass(pp, wg, false);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_fence_acc(s);
  wg_fence_acc(dp);
  if (kMask && n_tiles == 1)
    b9_kv_probs<NQ, true, C>(s, dp, zd, zd + NQ, a.scale, a.Lq);
  else
    b9_kv_probs<NQ, false, C>(s, dp, zd, zd + NQ, a.scale, NQ);
  b9_round<NQ>(s, pf);
  b9_round<NQ>(dp, dsf);

  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % S, pst = (t - 1) % S;
    mbar_wait(full + 8 * st, (t / S) & 1);
    mbar_wait(zd_full + 8 * st, (t / S) & 1);
    b9_turn_wait(pp, wg);
    wg_fence_acc(dk);
    wg_fence_acc(dv);
    wg_fence_frag(pf);
    wg_fence_frag(dsf);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint32_t qa = ring + st * Lay::kStage, pqa = ring + pst * Lay::kStage;
    b9_scores<D, NQ, Lay::kChunkKV, Lay::kChunkQ>(s, ka, qa);
    b9_scores<D, NQ, Lay::kChunkKV, Lay::kChunkQ>(dp, va, qa + Lay::kQ);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    b9_accumulate<D, NQ, Lay::kChunkQ>(dv, pf, pqa + Lay::kQ);
    b9_accumulate<D, NQ, Lay::kChunkQ>(dk, dsf, pqa);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    b9_turn_pass(pp, wg, false);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S^T, dP^T of tile t
    wg_fence_acc(s);
    wg_fence_acc(dp);
    const float* zs = zd + st * 2 * NQ;
    if (kMask && t == n_tiles - 1)
      b9_kv_probs<NQ, true, C>(s, dp, zs, zs + NQ, a.scale, a.Lq - t * NQ);
    else
      b9_kv_probs<NQ, false, C>(s, dp, zs, zs + NQ, a.scale, NQ);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // dV, dK of tile t - 1
    wg_fence_acc(dk);
    wg_fence_acc(dv);
    wg_fence_frag(pf);
    wg_fence_frag(dsf);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * pst);
    b9_round<NQ>(s, pf);
    b9_round<NQ>(dp, dsf);
  }
  {
    const uint32_t pqa = ring + ((n_tiles - 1) % S) * Lay::kStage;
    b9_turn_wait(pp, wg);
    wg_fence_acc(dk);
    wg_fence_acc(dv);
    wg_fence_frag(pf);
    wg_fence_frag(dsf);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    b9_accumulate<D, NQ, Lay::kChunkQ>(dv, pf, pqa + Lay::kQ);
    b9_accumulate<D, NQ, Lay::kChunkQ>(dk, dsf, pqa);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    b9_turn_pass(pp, wg, true);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(dk);
    wg_fence_acc(dv);
  }
  const int b = bh / a.H, h = bh - b * a.H;
  const long long off = b * a.skv_b + h * a.skv_h;
  b9_store<D>(dk, a.dk + off, a.skv_row, k0 + wg * 64, a.Lk);
  b9_store<D>(dv, a.dv + off, a.skv_row, k0 + wg * 64, a.Lk);
}

// A dK/dV block: keys blockIdx.x * 128.. of (b, h) = blockIdx.y.  The
// producer warp's thread 0 copies K and V once and each q tile and dO tile
// through the ring; its 32 lanes store each tile's z and di (none in the
// control).
template <int D, bool kMask, class K = B9Ship<D>>
__device__ __forceinline__ void b9_kv_block(const CUtensorMap* tmap_q, const CUtensorMap* tmap_k,
                                            const CUtensorMap* tmap_v,
                                            const CUtensorMap* tmap_do, const B9Args& a) {
  using Lay = B9KvLayout<D, K>;
  constexpr int S = K::kStages, NQ = Lay::kQRows;
  extern __shared__ unsigned char b9_smem[];
  const uint32_t raw = wg_smem_addr(b9_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's 1024-byte atom
  unsigned char* basep = b9_smem + (base - raw);
  const uint32_t ring = base + Lay::kRing;
  const uint32_t kv_bar = base + Lay::kBars;
  const uint32_t full = kv_bar + 8, zd_full = full + 8 * S, empty = zd_full + 8 * S;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kB9Rows;
  const int n_tiles = (a.Lq + NQ - 1) / NQ;
  // warpgroups whose 64 keys all lie past Lk compute nothing
  const int active = min(2, (a.Lk - k0 + 63) / 64);
  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);           // the producer's arrive; the copies' bytes
      mbar_init(zd_full + 8 * s, 32);       // the producer warp's z and di stores
      mbar_init(empty + 8 * s, 4 * active);  // one arrive per warp of an active consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if / else over warpgroups that never reconverges, so that
  // setmaxnreg moves the producer warpgroup's registers to the consumers
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kB9ProducerRegs));
    if (warp == 8) {  // the producer warp: one thread copies, every lane stores z and di
      const int lane = tid & 31;
      const int b = bh / a.H, h = bh - b * a.H;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_bar, 2 * Lay::kKV);
        b9_load_tile<D>(base, tmap_k, kv_bar, a.row_dim, kB9Rows, K::kNK, k0, b, h);
        b9_load_tile<D>(base + Lay::kKV, tmap_v, kv_bar, a.row_dim, kB9Rows, K::kNK, k0, b, h);
      }
      const float* zb = K::kControl ? nullptr : a.z + (size_t)bh * a.Lq;
      const float* dib = K::kControl ? nullptr : a.di + (size_t)bh * a.Lq;
      float* zd = reinterpret_cast<float*>(basep + Lay::kZd);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        mbar_wait(empty + 8 * s, ((t / S) & 1) ^ 1);  // a fresh stage passes
        if (lane == 0) {
          const uint32_t qd = ring + s * Lay::kStage;
          mbar_arrive_expect_tx(full + 8 * s, Lay::kStage);
          b9_load_tile<D>(qd, tmap_q, full + 8 * s, a.row_dim, NQ, NQ, t * NQ, b, h);
          b9_load_tile<D>(qd + Lay::kQ, tmap_do, full + 8 * s, a.row_dim, NQ, NQ, t * NQ, b, h);
        }
        if constexpr (!K::kControl) {
          float* zs = zd + s * 2 * NQ;
          for (int i = lane; i < NQ; i += 32) {
            const int row = t * NQ + i;
            const bool in = row < a.Lq;
            zs[i] = in ? zb[row] : 0.0f;
            zs[NQ + i] = in ? dib[row] : 0.0f;
          }
        }
        mbar_arrive(zd_full + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kB9ConsumerRegs));
    if (warp / 4 < active)
      b9_kv_consume<D, kMask, K>(a, base, basep, n_tiles, k0, bh, active == 2);
  }
}

template <int D, bool kMask>
__global__ void __launch_bounds__(kB9Threads, 1)
flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tmap_q,
                           const __grid_constant__ CUtensorMap tmap_k,
                           const __grid_constant__ CUtensorMap tmap_v,
                           const __grid_constant__ CUtensorMap tmap_do, B9Args a) {
  b9_kv_block<D, kMask>(&tmap_q, &tmap_k, &tmap_v, &tmap_do, a);
}

// A dQ consumer warpgroup: warpgroup wg owns q rows q0 + 64 wg .. + 63 of
// (b, h) = bh.  Per key tile t it starts S = Q K_t^T and dP = dO V_t^T, then
// dQ += dS_{t-1} K_{t-1}; computes tile t's ds while the latter runs; then
// releases tile t-1's stage and rounds ds.
template <int D, bool kMask, class K = B9Ship<D>>
__device__ __forceinline__ void b9_q_consume(const B9Args& a, uint32_t base, int n_tiles, int q0,
                                             int bh, bool pp) {
  using Lay = B9QLayout<D, K>;
  constexpr int S = K::kStages, NK = Lay::kKRows;
  constexpr bool C = K::kControl;
  const uint32_t ring = base + Lay::kRing;
  const uint32_t q_bar = base + Lay::kBars;
  const uint32_t full = q_bar + 8, empty = full + 8 * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const uint32_t qa = base + wg * 64 * 128, doa = qa + Lay::kQ;
  // z and di of this thread's rows r0 and r0 + 8 (0 past Lq: computed, not stored)
  const int r0 = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  float z0 = 0.0f, z1 = 0.0f, di0 = 0.0f, di1 = 0.0f;
  if constexpr (!C) {
    const float* zb = a.z + (size_t)bh * a.Lq;
    const float* dib = a.di + (size_t)bh * a.Lq;
    z0 = r0 < a.Lq ? zb[r0] : 0.0f;
    z1 = r0 + 8 < a.Lq ? zb[r0 + 8] : 0.0f;
    di0 = r0 < a.Lq ? dib[r0] : 0.0f;
    di1 = r0 + 8 < a.Lq ? dib[r0 + 8] : 0.0f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
  float s[NK / 2], dp[NK / 2];
  uint32_t dsf[NK / 16][4];

  b9_turn_first(pp, wg);
  mbar_wait(q_bar, 0);
  mbar_wait(full, 0);
  b9_turn_wait(pp, wg);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  b9_scores<D, NK, Lay::kChunkQ, Lay::kChunkK>(s, qa, ring);
  b9_scores<D, NK, Lay::kChunkQ, Lay::kChunkK>(dp, doa, ring + Lay::kK);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  b9_turn_pass(pp, wg, false);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_fence_acc(s);
  wg_fence_acc(dp);
  if (kMask && n_tiles == 1)
    b9_q_ds<NK, true, C>(s, dp, z0, z1, di0, di1, a.scale, a.Lk);
  else
    b9_q_ds<NK, false, C>(s, dp, z0, z1, di0, di1, a.scale, NK);
  b9_round<NK>(s, dsf);

  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % S, pst = (t - 1) % S;
    mbar_wait(full + 8 * st, (t / S) & 1);
    b9_turn_wait(pp, wg);
    wg_fence_acc(dq);
    wg_fence_frag(dsf);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint32_t kt = ring + st * Lay::kStage;
    b9_scores<D, NK, Lay::kChunkQ, Lay::kChunkK>(s, qa, kt);
    b9_scores<D, NK, Lay::kChunkQ, Lay::kChunkK>(dp, doa, kt + Lay::kK);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    b9_accumulate<D, NK, Lay::kChunkK>(dq, dsf, ring + pst * Lay::kStage);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    b9_turn_pass(pp, wg, false);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S, dP of tile t
    wg_fence_acc(s);
    wg_fence_acc(dp);
    if (kMask && t == n_tiles - 1)
      b9_q_ds<NK, true, C>(s, dp, z0, z1, di0, di1, a.scale, a.Lk - t * NK);
    else
      b9_q_ds<NK, false, C>(s, dp, z0, z1, di0, di1, a.scale, NK);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // dQ of tile t - 1
    wg_fence_acc(dq);
    wg_fence_frag(dsf);
    if ((tid & 127) == 0) mbar_arrive(empty + 8 * pst);
    b9_round<NK>(s, dsf);
  }
  {
    b9_turn_wait(pp, wg);
    wg_fence_acc(dq);
    wg_fence_frag(dsf);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    b9_accumulate<D, NK, Lay::kChunkK>(dq, dsf, ring + ((n_tiles - 1) % S) * Lay::kStage);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    b9_turn_pass(pp, wg, true);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(dq);
  }
  const int b = bh / a.H, h = bh - b * a.H;
  b9_store<D>(dq, a.dq + b * a.sq_b + h * a.sq_h, a.sq_row, q0 + wg * 64, a.Lq);
}

// A dQ block: q rows blockIdx.x * 128.. of (b, h) = blockIdx.y.  The
// producer thread copies Q and dO once and each K tile and V tile through
// the ring.
template <int D, bool kMask, class K = B9Ship<D>>
__device__ __forceinline__ void b9_q_block(const CUtensorMap* tmap_q, const CUtensorMap* tmap_k,
                                           const CUtensorMap* tmap_v, const CUtensorMap* tmap_do,
                                           const B9Args& a) {
  using Lay = B9QLayout<D, K>;
  constexpr int S = K::kStages, NK = Lay::kKRows;
  extern __shared__ unsigned char b9_smem[];
  const uint32_t base = (wg_smem_addr(b9_smem) + 1023u) & ~1023u;
  const uint32_t ring = base + Lay::kRing;
  const uint32_t q_bar = base + Lay::kBars;
  const uint32_t full = q_bar + 8, empty = full + 8 * S;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kB9Rows;
  const int n_tiles = (a.Lk + NK - 1) / NK;
  const int active = min(2, (a.Lq - q0 + 63) / 64);
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, active);  // one arrive per active consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kB9ProducerRegs));
    if (tid == 256) {  // the producer thread
      const int b = bh / a.H, h = bh - b * a.H;
      mbar_arrive_expect_tx(q_bar, 2 * Lay::kQ);
      b9_load_tile<D>(base, tmap_q, q_bar, a.row_dim, kB9Rows, K::kNQ, q0, b, h);
      b9_load_tile<D>(base + Lay::kQ, tmap_do, q_bar, a.row_dim, kB9Rows, K::kNQ, q0, b, h);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        mbar_wait(empty + 8 * s, ((t / S) & 1) ^ 1);
        const uint32_t kd = ring + s * Lay::kStage;
        mbar_arrive_expect_tx(full + 8 * s, Lay::kStage);
        b9_load_tile<D>(kd, tmap_k, full + 8 * s, a.row_dim, NK, NK, t * NK, b, h);
        b9_load_tile<D>(kd + Lay::kK, tmap_v, full + 8 * s, a.row_dim, NK, NK, t * NK, b, h);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kB9ConsumerRegs));
    if (warp / 4 < active)
      b9_q_consume<D, kMask, K>(a, base, n_tiles, q0, bh, active == 2);
  }
}

template <int D, bool kMask>
__global__ void __launch_bounds__(kB9Threads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tmap_q,
                         const __grid_constant__ CUtensorMap tmap_k,
                         const __grid_constant__ CUtensorMap tmap_v,
                         const __grid_constant__ CUtensorMap tmap_do, B9Args a) {
  b9_q_block<D, kMask>(&tmap_q, &tmap_k, &tmap_v, &tmap_do, a);
}

// di[b, h, l] = sum_d do[b, h, l, d] * o[b, h, l, d] (o and do as s says) in
// float32: min(D / 8, 32) lanes a row, 16 bytes each (two at D = 512),
// summed across the lanes by shuffles; neighbouring rows take the index of
// the smaller stride (the head in the token-major layouts, the row in the
// head-major one), so a warp reads contiguous memory of each
template <int D>
__global__ void __launch_bounds__(256) b9_di_kernel(const bf16* __restrict__ o,
                                                    const bf16* __restrict__ dout,
                                                    float* __restrict__ di, Strides s, int B,
                                                    int L, int H) {
  constexpr int kLanes = D / 8 < 32 ? D / 8 : 32;
  constexpr int kVecs = D / 8 / kLanes;  // 16-byte vectors a lane
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t idx = t / kLanes;
  const int part = (int)(t % kLanes);
  const bool in = idx < (size_t)B * L * H;
  float acc = 0.0f;
  int b = 0, h = 0, l = 0;
  if (in) {
    if (s.h < s.row) {
      h = (int)(idx % H);
      l = (int)((idx / H) % L);
    } else {
      l = (int)(idx % L);
      h = (int)((idx / L) % H);
    }
    b = (int)(idx / ((size_t)H * L));
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const long long off = b * s.b + h * s.h + l * s.row + 8 * (part + kLanes * v);
      alignas(16) bf16 oe[8];
      alignas(16) bf16 de[8];
      *reinterpret_cast<uint4*>(oe) = *reinterpret_cast<const uint4*>(o + off);
      *reinterpret_cast<uint4*>(de) = *reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc += __bfloat162float(oe[i]) * __bfloat162float(de[i]);
    }
  }
#pragma unroll
  for (int m = kLanes / 2; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (in && part == 0) di[((size_t)b * H + h) * L + l] = acc;
}

// the di pre-pass over B * L * H rows of head dim D (64, 128, 256 or 512)
template <int D>
int launch_b9_di(const bf16* o, const bf16* dout, float* di, Strides s, int B, int L, int H,
                 cudaStream_t stream) {
  const size_t threads = (size_t)B * L * H * (D / 8 < 32 ? D / 8 : 32);
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  b9_di_kernel<D><<<blocks, 256, 0, stream>>>(o, dout, di, s, B, L, H);
  return (int)cudaGetLastError();
}

// The launch plan of ops/flash_attention.py flash_bwd_plan, as the int64
// array the wrappers pass (FlashBwdPlan.as_array): kBwdPlanLen numbers in
// this order (PlanMap: csrc/sm90.cuh).
struct BwdPlan {
  long long body;  // 1: this body (D = 64, 128); 2: csrc/flash_bwd_sm90_wide.cuh (D = 256, 512)
  long long kv_rows, kv_q_rows, q_rows, q_k_rows, stages;
  long long kv_grid_x, kv_grid_y, q_grid_x, q_grid_y, threads, kv_smem, q_smem;
  long long q_mask, key_mask, row_dim;
  PlanMap map[4];  // q, k, v, do
  long long dq_strides[3], dkv_strides[3];  // b, h, row, elements
  long long splits;  // blocks along D, a cluster: both kernels' grid z
};

constexpr int kBwdPlanLen = 71;
static_assert(sizeof(BwdPlan) == kBwdPlanLen * sizeof(long long), "the plan's layout");

// Hold the plan to the body it names (its tiles, stages, shared memory,
// blocks along D) and to the shapes the entry was given, then encode
// its four maps over bases[] (q, k, v, do; the packed entry passes the (B,
// L, 3C) base three times).  q and do are Lq rows in nq-row boxes, k and v
// Lk rows in nk-row boxes; a block owns `rows` keys (dK/dV) or q rows (dQ).
inline bool bwd_plan_maps(const BwdPlan& p, const bf16* const (&bases)[4], const B9Args& a, int B,
                          int D, int body, int rows, int nq, int nk, int stages, long long kv_smem,
                          long long q_smem, int splits, CUtensorMap (&maps)[4]) {
  const long long bh = (long long)B * a.H;
  bool ok = p.body == body && p.kv_rows == rows && p.kv_q_rows == nq && p.q_rows == rows &&
            p.q_k_rows == nk && p.stages == stages && p.threads == kB9Threads &&
            p.kv_smem == kv_smem && p.q_smem == q_smem && p.splits == splits &&
            p.kv_grid_x == (a.Lk + rows - 1) / rows && p.q_grid_x == (a.Lq + rows - 1) / rows &&
            p.kv_grid_y == bh && p.q_grid_y == bh && bh <= 65535 &&
            p.q_mask == (a.Lq % nq != 0) && p.key_mask == (a.Lk % nk != 0) &&
            p.row_dim == a.row_dim && (p.row_dim == 1 || p.row_dim == 2) &&
            p.dq_strides[0] == a.sq_b && p.dq_strides[1] == a.sq_h &&
            p.dq_strides[2] == a.sq_row && p.dkv_strides[0] == a.skv_b &&
            p.dkv_strides[1] == a.skv_h && p.dkv_strides[2] == a.skv_row;
  const int hd = p.row_dim == 1 ? 2 : 1;  // the head's dim in the map
  for (int i = 0; ok && i < 4; ++i) {
    const PlanMap& m = p.map[i];
    const bool is_q = i == 0 || i == 3;  // q and do: Lq rows, q-tile boxes
    ok = m.dims[0] == D && m.dims[p.row_dim] == (is_q ? a.Lq : a.Lk) && m.dims[hd] == a.H &&
         m.dims[3] == B && m.box[0] == 64 && m.box[p.row_dim] == (is_q ? nq : nk) &&
         m.box[hd] == 1 && m.box[3] == 1;
  }
  for (int i = 0; ok && i < 4; ++i) ok = encode_plan_map(&maps[i], bases[i], p.map[i]);
  return ok;
}

// one kernel of a backward body's pair (either body: the four maps and
// B9Args) over `grid`, its blocks grouped `cluster` to a cluster along the
// grid's z where that is above 1
template <typename Kernel>
int b9_launch(Kernel kernel, dim3 grid, size_t smem, unsigned cluster, const CUtensorMap (&m)[4],
              const B9Args& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kB9Threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = cluster;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, m[0], m[1], m[2], m[3], a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
