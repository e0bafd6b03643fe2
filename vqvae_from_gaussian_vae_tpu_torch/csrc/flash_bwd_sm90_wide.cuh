// The bf16 flash-attention backward body designed for Hopper (sm_90a), for
// head dims 256 and 512: every bf16 backward entry of csrc/flash_bwd.cu at
// those D (gvq_flash_bwd_qkv, gvq_flash_bwd, gvq_flash_bwd_hm).  D = 64 and
// 128 run csrc/flash_bwd_sm90.cuh, whose di pre-pass, launch plan (BwdPlan,
// body 2 here), argument struct (B9Args) and elementwise steps this body
// shares.
//
// Replaces the TPU kernels vqvae_from_gaussian_vae_tpu/ops/flash_blc.py
// _bwd_impl (reached from _bwd_call, the UNet AttnBlock at D = 512, and
// _bwd_call_packed) and the backward of
// vqvae_from_gaussian_vae_tpu/ops/flash_attention.py (_bwd: the upstream
// _flash_attention_bwd_dkv, then _bwd_dq_lean) at those D.  The numerics
// are flash_bwd_sm90.cuh's: di = rowsum(do * o) in float32 (the pre-pass),
// p = expf(s * scale - z) with s = q k^T in float32, ds = p (do v^T - di)
// scale rounded once to bf16, dv = bf16(p)^T do, dk = ds^T q, dq = ds k as
// float32 sums with one rounding.
//
// What bounds it on an H100: the UNet AttnBlock's backward (B=16, L=1024,
// H=1, D=512) is 8.6e10 FLOP for the five products the function needs
// (0.087 ms at the bf16 peak) against 101 MB of device memory; this body
// runs seven of those units (1.2e11 FLOP: each kernel forms S and dP).
// Each dK/dV block streams its (b, h)'s q and do over its 256 columns, 1 MB
// at (1024, 512), and each dQ block its k and v: 16 blocks a sample and
// kernel at each of two column halves make 0.5 GB a launch through L2 for
// each kernel.  What bounds it as built (PERF.md §6): L2, which streams the
// tiles at about 3.2 TB/s when the score products alone run; then the
// handoffs.  Per 32-row tile a warpgroup waits for its scores, meets the
// other warpgroup (and at D = 512 the other block) to sum them, then
// computes p and ds; only the previous tile's accumulation products run
// meanwhile.
//
// The design, against the register file.  A 64-key tile's dK and dV at
// D = 512 in float32 are 256 KB, the whole register file of an SM.
// 1. A block owns 64 keys (dK/dV) or 64 q rows (dQ) of one (b, h) and 256
//    of the head dim's columns (kBwShare); at D = 512 the two blocks that
//    own one row's two halves form a cluster (the grid's z).  Its two
//    consumer warpgroups own 128 columns each, of dK and dV (128 registers
//    a thread) or of dQ (64).  The block's columns of the resident tiles (K
//    and V, or Q and dO) stay in shared memory; its columns of q and do (or
//    k and v) stream in 32-row tiles through a 3-stage ring.
// 2. The scores are split by the head dim, not duplicated: each warpgroup
//    forms the partial S^T and dP^T (64 keys x 32 q rows, dK/dV) or S and
//    dP (64 q rows x 32 keys, dQ) over its own 128 columns
//    (wgmma.m64n32k16, both operands K-major in shared memory), writes
//    them to the exchange tile (each thread its registers' order: no thread
//    reads another lane's layout), meets the other warpgroup at a named
//    barrier and adds the other's.  At D = 512 each block then sends its
//    sums to the other block of the cluster by st.async into that block's
//    shared memory, where they complete on an mbarrier as a TMA copy does
//    (two cluster tiles, alternating, so that no release step is needed),
//    and adds the other block's.  a + b = b + a in float32: every
//    warpgroup of the cluster holds the same bits of S and dP, computes the
//    same p and ds and rounds them to the same bf16 A fragments.  The
//    function's five products then run seven times (S and dP in both
//    kernels), at D = 512 as at 256; a split that had each block form the
//    whole depth ran nine (measured slower at D = 512: PERF.md §6), and
//    scores duplicated in every warpgroup would run eleven and fifteen.
// 3. The accumulations dV += P^T dO_t, dK += dS^T Q_t and dQ += dS K_t
//    (wgmma.m64n128k16, A from registers, the .RS form, B MN-major: this
//    warpgroup's 128 columns of the tile).  Per streamed tile a warpgroup
//    starts tile t's score products and tile t-1's accumulation products
//    back to back, sums and computes tile t's p and ds while the
//    accumulation runs, then releases tile t-1's stage and rounds p and ds,
//    as flash_bwd_sm90.cuh does.
// 4. A producer warp keeps the ring full through TMA (the plan's four maps,
//    64-column boxes of 32 rows, the block's four chunks; a resident tile is
//    two boxes a chunk) and in the dK/dV kernel stores each tile's z and di
//    (by column) beside it.  setmaxnreg moves the producer warpgroup's
//    registers to the consumers (40 and 232 a thread).  The score products'
//    descriptors are formed afresh for each tile from one opaque base
//    (wg_opaque).
//
// Budget.  Registers of a consumer thread: dK/dV 64 + 64 (dK, dV), 16 + 16
// (S^T, dP^T), 8 + 8 (their bf16 fragments); dQ 64 + 32 + 8.  Shared memory
// (BwLayout): the resident pair 2 x 64 x 256 x 2 bytes (64 KB), three
// stages of 2 x 32 x 256 x 2 bytes (32 KB each), the exchange tile 2 x 32 x
// 128 x 4 bytes (32 KB), at D = 512 the two cluster tiles (16 KB each), the
// dK/dV kernel's z and di, the mbarriers and 1024 bytes of alignment slack:
// 198,496 and 197,704 bytes (dK/dV, dQ) at D = 256, 231,264 and 230,472 at
// D = 512.
//
// Ragged edges as flash_bwd_sm90.cuh: TMA's zero fill past Lq and Lk; the
// last q tile of the dK/dV kernel (kMask) gives the columns past Lq p = ds
// = 0, the last key tile of the dQ kernel the keys past Lk ds = 0; rows of
// dk, dv past Lk and of dq past Lq are computed on zeros and not stored.
// No float atomics: every output element is summed by one block in a fixed
// order, so the gradients repeat bit for bit.  A block's last remote write
// into the other block of its cluster is waited for there before that
// block exits.
#pragma once

#include "flash_bwd_sm90.cuh"

namespace {

using gvq::cluster_map;
using gvq::cluster_rank;
using gvq::cluster_sync;
using gvq::st_async_f4;

constexpr int kBwRows = 64;    // keys a dK/dV block, q rows a dQ block
constexpr int kBwShare = 256;  // head-dim columns a block owns (128 a consumer warpgroup)
constexpr int kBwTile = 32;    // rows of a streamed tile: q and do (dK/dV), k and v (dQ)
constexpr int kBwStages = 3;   // streamed tiles in flight

// Shared memory, from a 1024-byte-aligned base, the same in both kernels:
// the block's two resident 64-row tiles (K and V, or Q and dO), the ring's
// stages (two streamed tiles each), the exchange tile (each consumer
// warpgroup's float32 partial scores, kBwTile / 4 float4 a thread), at
// D = 512 two cluster tiles (the other block's partial scores, written by
// it, for even and odd streamed tiles), then the dK/dV kernel's z and di
// of each stage and the mbarriers (resident tiles full; per stage full,
// [z/di full,] empty; the two cluster tiles full).  A tile holds the
// block's 256 columns as 4 chunks of rows x 128 bytes, as the 128-byte
// swizzle lays them.
template <int D, bool kKv>
struct BwLayout {
  static constexpr int kSplits = D / kBwShare;  // blocks of a cluster
  static constexpr int kChunks = kBwShare / 64;
  static constexpr uint32_t kChunkR = kBwRows * 128;  // a resident tile's chunk
  static constexpr uint32_t kChunkT = kBwTile * 128;  // a streamed tile's chunk
  static constexpr uint32_t kRes = kChunks * kChunkR;
  static constexpr uint32_t kTile = kChunks * kChunkT;
  static constexpr uint32_t kStage = 2 * kTile;
  static constexpr uint32_t kRing = 2 * kRes;
  static constexpr uint32_t kX = kRing + kBwStages * kStage;
  static constexpr uint32_t kCrossTile = kBwTile * 128 * 4;  // 64 x kBwTile of s and of dp
  static constexpr uint32_t kCross = kX + 2 * kBwTile * 128 * 4;
  static constexpr uint32_t kZd = kCross + (kSplits > 1 ? 2 * kCrossTile : 0);
  static constexpr uint32_t kBars = kZd + (kKv ? kBwStages * 2 * kBwTile * 4 : 0);
  static constexpr int kNBars = 1 + (kKv ? 3 : 2) * kBwStages + 2;
  static constexpr size_t kSmem = kBars + kNBars * 8 + 1024;  // + alignment slack
};

// a tile of `rows` rows from row `row` of (b, h): the block's 4 chunks from
// chunk c0 of the map, each `rows / box` copies of `box` rows
__device__ __forceinline__ void bw_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int row_dim, int rows, int row, int b, int h,
                                             int c0) {
#pragma unroll
  for (int c = 0; c < kBwShare / 64; ++c)
    for (int r = 0; r < rows; r += kBwTile)
      b9_load(dst + c * rows * 128 + r * 128, map, bar, row_dim, c0 + c, row + r, b, h);
}

// D (64 x N) = A (64 x 128) . B^T (128 x N) over this warpgroup's 128
// columns: A and B K-major tiles from their first chunk, chunks kChunkA and
// kChunkB apart; 8 k-steps of 16 columns = 32 bytes inside a chunk's
// 128-byte rows (a descriptor's address field counts 16-byte units)
template <int N, uint32_t kChunkA, uint32_t kChunkB>
__device__ __forceinline__ void bw_scores(float (&d)[N / 2], uint32_t a, uint32_t b) {
  const uint64_t da = wg_opaque(wg_desc(a, 16, 1024)), db = wg_opaque(wg_desc(b, 16, 1024));
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss<N>(d, da + ((kk >> 2) * kChunkA + (kk & 3) * 32) / 16,
                db + ((kk >> 2) * kChunkB + (kk & 3) * 32) / 16, kk > 0);
}

// Where a consumer thread's partial scores go: its slot of the exchange
// tile (float4 i of warpgroup w's part at index (w kBwTile / 4 + i) 128 +
// its place in the warpgroup), and at D = 512 the cluster tiles: its part
// there (warpgroup 0 sends s, warpgroup 1 dp) in the other block and that
// block's barriers, and the parts it reads in its own and their barriers
// (tile 1 and its barrier kCrossTile and 8 bytes after tile 0's).
struct BwSlots {
  float4* mine;
  const float4* theirs;
  const float4* cross;  // this block's cluster tile 0 at this thread's place
  uint32_t full;        // its barrier
  uint32_t peer_dst;    // shared::cluster address in the other block's tile 0
  uint32_t peer_full;   // and of its barrier
};

template <int D, bool kKv>
__device__ __forceinline__ BwSlots bw_slots(uint32_t base, unsigned char* basep) {
  using Lay = BwLayout<D, kKv>;
  constexpr int V = kBwTile / 4;  // float4 a thread's partial s and dp take
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  float4* x = reinterpret_cast<float4*>(basep + Lay::kX) + tw;
  BwSlots sl;
  sl.mine = x + wg * V * 128;
  sl.theirs = x + (1 - wg) * V * 128;
  sl.cross = reinterpret_cast<const float4*>(basep + Lay::kCross) + tw;
  sl.full = base + Lay::kBars + (Lay::kNBars - 2) * 8;
  sl.peer_dst = sl.peer_full = 0;
  if constexpr (Lay::kSplits > 1) {
    const uint32_t peer = cluster_rank() ^ 1u;
    sl.peer_dst = cluster_map(base + Lay::kCross + (wg * (V / 2) * 128 + tw) * 16, peer);
    sl.peer_full = cluster_map(sl.full, peer);
  }
  return sl;
}

// Tile t's scores summed over the head dim: this warpgroup's s and dp
// (each N / 2 floats a thread, over its 128 columns) go to its part of the
// exchange tile and the other warpgroup's are added (barrier 2: the other
// has read the last tile's; barrier 1: it has written this tile's).  At
// D = 512 the block's sums then go to the other block of the cluster (s
// from warpgroup 0, dp from warpgroup 1) by st.async into its cluster tile
// t % 2, whose barrier counts the bytes, and the other block's sums are
// added from this block's tile t % 2 once its barrier (armed here with the
// bytes it expects) completes.  Two tiles and no release step: the other
// block writes tile t + 2 only after it has received this block's tile
// t + 1, which this block sends after it has read tile t.  a + b = b + a in
// float32: every warpgroup of the cluster ends with the same bits of S and
// dP.
template <int N, int kSplits>
__device__ __forceinline__ void bw_sum_scores(float (&s)[N / 2], float (&dp)[N / 2],
                                              const BwSlots& sl, int t) {
  asm volatile("bar.sync 2, 256;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    sl.mine[128 * i] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
    sl.mine[128 * (N / 8 + i)] =
        make_float4(dp[4 * i], dp[4 * i + 1], dp[4 * i + 2], dp[4 * i + 3]);
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const float4 u = sl.theirs[128 * i], w = sl.theirs[128 * (N / 8 + i)];
    s[4 * i] += u.x;
    s[4 * i + 1] += u.y;
    s[4 * i + 2] += u.z;
    s[4 * i + 3] += u.w;
    dp[4 * i] += w.x;
    dp[4 * i + 1] += w.y;
    dp[4 * i + 2] += w.z;
    dp[4 * i + 3] += w.w;
  }
  if constexpr (kSplits > 1) {
    constexpr uint32_t kTileBytes = N * 128 * 4;  // both parts of a cluster tile
    const int buf = t & 1;
    const uint32_t full = sl.full + 8 * buf;
    if (threadIdx.x == 0) mbar_arrive_expect_tx(full, kTileBytes);
    const uint32_t dst = sl.peer_dst + buf * kTileBytes, bar = sl.peer_full + 8 * buf;
    if (threadIdx.x < 128) {
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
        st_async_f4(dst + 2048 * i, s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3], bar);
    } else {
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
        st_async_f4(dst + 2048 * i, dp[4 * i], dp[4 * i + 1], dp[4 * i + 2], dp[4 * i + 3], bar);
    }
    mbar_wait(full, (t >> 1) & 1);
    const float4* x = sl.cross + buf * (kTileBytes / 16);
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const float4 u = x[128 * i], w = x[128 * (N / 8 + i)];
      s[4 * i] += u.x;
      s[4 * i + 1] += u.y;
      s[4 * i + 2] += u.z;
      s[4 * i + 3] += u.w;
      dp[4 * i] += w.x;
      dp[4 * i + 1] += w.y;
      dp[4 * i + 2] += w.z;
      dp[4 * i + 3] += w.w;
    }
  }
}

// The mbarriers' initial counts and the start of a block: the resident
// tiles' barrier (the producer's arrive), per stage the streamed tile's
// (the producer's arrive) [and the z/di stores' (32 lanes)] and the empty
// one (`consumers` arrives), the two cluster tiles' (one arrive, which
// arms it, and the other block's bytes); then every block of the cluster
// waits for every other's barriers.
template <int D, bool kKv>
__device__ __forceinline__ void bw_init(uint32_t base, int consumers) {
  using Lay = BwLayout<D, kKv>;
  const uint32_t bars = base + Lay::kBars;
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kBwStages; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);
      if (kKv) mbar_init(bars + 8 * (1 + kBwStages + s), 32);
      mbar_init(bars + 8 * (1 + (kKv ? 2 : 1) * kBwStages + s), consumers);
    }
    mbar_init(bars + 8 * (Lay::kNBars - 2), 1);
    mbar_init(bars + 8 * (Lay::kNBars - 1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (Lay::kSplits > 1)
    cluster_sync();
  else
    __syncthreads();
}

// A dK/dV consumer warpgroup: keys k0 .. k0 + 63 of (b, h) = bh; columns
// c0 .. c0 + 127 of dK and dV, which are also the columns of its partial
// scores.  Per q tile t it starts the partial S^T = K Q_t^T and
// dP^T = V dO_t^T, then dV += P_{t-1}^T dO_{t-1} and dK += dS_{t-1}^T
// Q_{t-1}; sums the scores (bw_sum_scores) and computes tile t's p and ds
// while the latter run; then releases tile t-1's stage (each warp) and
// rounds p and ds.
template <int D, bool kMask>
__device__ __forceinline__ void bw_kv_consume(const B9Args& a, uint32_t base, unsigned char* basep,
                                              int n_tiles, int k0, int c0, int bh) {
  using Lay = BwLayout<D, true>;
  constexpr int S = kBwStages, NT = kBwTile;
  const uint32_t ring = base + Lay::kRing;
  const uint32_t kv_bar = base + Lay::kBars;
  const uint32_t full = kv_bar + 8, zd_full = full + 8 * S, empty = zd_full + 8 * S;
  const float* zd = reinterpret_cast<const float*>(basep + Lay::kZd);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const uint32_t ka = base + 2 * wg * Lay::kChunkR, va = ka + Lay::kRes;
  const uint32_t qw = 2 * wg * Lay::kChunkT;  // this warpgroup's columns inside a q or do tile
  const BwSlots sl = bw_slots<D, true>(base, basep);
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.0f;
  float s[NT / 2], dp[NT / 2];
  uint32_t pf[NT / 16][4], dsf[NT / 16][4];

  mbar_wait(kv_bar, 0);
  mbar_wait(full, 0);
  mbar_wait(zd_full, 0);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  bw_scores<NT, Lay::kChunkR, Lay::kChunkT>(s, ka, ring + qw);
  bw_scores<NT, Lay::kChunkR, Lay::kChunkT>(dp, va, ring + Lay::kTile + qw);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_fence_acc(s);
  wg_fence_acc(dp);
  bw_sum_scores<NT, Lay::kSplits>(s, dp, sl, 0);
  if (kMask && n_tiles == 1)
    b9_kv_probs<NT, true>(s, dp, zd, zd + NT, a.scale, a.Lq);
  else
    b9_kv_probs<NT, false>(s, dp, zd, zd + NT, a.scale, NT);
  b9_round<NT>(s, pf);
  b9_round<NT>(dp, dsf);

  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % S, pst = (t - 1) % S;
    mbar_wait(full + 8 * st, (t / S) & 1);
    mbar_wait(zd_full + 8 * st, (t / S) & 1);
    wg_fence_acc(dk);
    wg_fence_acc(dv);
    wg_fence_frag(pf);
    wg_fence_frag(dsf);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint32_t qa = ring + st * Lay::kStage, pqa = ring + pst * Lay::kStage;
    bw_scores<NT, Lay::kChunkR, Lay::kChunkT>(s, ka, qa + qw);
    bw_scores<NT, Lay::kChunkR, Lay::kChunkT>(dp, va, qa + Lay::kTile + qw);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    b9_accumulate<128, NT, Lay::kChunkT>(dv, pf, pqa + Lay::kTile + qw);
    b9_accumulate<128, NT, Lay::kChunkT>(dk, dsf, pqa + qw);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S^T, dP^T of tile t
    wg_fence_acc(s);
    wg_fence_acc(dp);
    bw_sum_scores<NT, Lay::kSplits>(s, dp, sl, t);
    const float* zs = zd + st * 2 * NT;
    if (kMask && t == n_tiles - 1)
      b9_kv_probs<NT, true>(s, dp, zs, zs + NT, a.scale, a.Lq - t * NT);
    else
      b9_kv_probs<NT, false>(s, dp, zs, zs + NT, a.scale, NT);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // dV, dK of tile t - 1
    wg_fence_acc(dk);
    wg_fence_acc(dv);
    wg_fence_frag(pf);
    wg_fence_frag(dsf);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * pst);
    b9_round<NT>(s, pf);
    b9_round<NT>(dp, dsf);
  }
  {
    const uint32_t pqa = ring + ((n_tiles - 1) % S) * Lay::kStage;
    wg_fence_acc(dk);
    wg_fence_acc(dv);
    wg_fence_frag(pf);
    wg_fence_frag(dsf);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    b9_accumulate<128, NT, Lay::kChunkT>(dv, pf, pqa + Lay::kTile + qw);
    b9_accumulate<128, NT, Lay::kChunkT>(dk, dsf, pqa + qw);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(dk);
    wg_fence_acc(dv);
  }
  const int b = bh / a.H, h = bh - b * a.H;
  const long long off = b * a.skv_b + h * a.skv_h + c0;
  b9_store<128>(dk, a.dk + off, a.skv_row, k0, a.Lk);
  b9_store<128>(dv, a.dv + off, a.skv_row, k0, a.Lk);
}

template <int D, bool kMask>
__global__ void __launch_bounds__(kB9Threads, 1)
flash_bwd_dkdv_wide_kernel(const __grid_constant__ CUtensorMap tmap_q,
                           const __grid_constant__ CUtensorMap tmap_k,
                           const __grid_constant__ CUtensorMap tmap_v,
                           const __grid_constant__ CUtensorMap tmap_do, B9Args a) {
  using Lay = BwLayout<D, true>;
  constexpr int S = kBwStages, NT = kBwTile;
  extern __shared__ unsigned char bw_smem[];
  const uint32_t raw = wg_smem_addr(bw_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's 1024-byte atom
  unsigned char* basep = bw_smem + (base - raw);
  const uint32_t ring = base + Lay::kRing;
  const uint32_t kv_bar = base + Lay::kBars;
  const uint32_t full = kv_bar + 8, zd_full = full + 8 * S, empty = zd_full + 8 * S;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBwRows;
  const int c0 = kBwShare * blockIdx.z;  // the block's columns, its rank in the cluster
  const int n_tiles = (a.Lq + NT - 1) / NT;
  bw_init<D, true>(base, 8);  // empty: one arrive per consumer warp

  // one if / else over warpgroups that never reconverges, so that
  // setmaxnreg moves the producer warpgroup's registers to the consumers
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kB9ProducerRegs));
    if (warp == 8) {  // the producer warp: one thread copies, every lane stores z and di
      const int lane = tid & 31;
      const int b = bh / a.H, h = bh - b * a.H;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_bar, 2 * Lay::kRes);
        bw_load_tile(base, &tmap_k, kv_bar, a.row_dim, kBwRows, k0, b, h, c0 / 64);
        bw_load_tile(base + Lay::kRes, &tmap_v, kv_bar, a.row_dim, kBwRows, k0, b, h, c0 / 64);
      }
      const float* zb = a.z + (size_t)bh * a.Lq;
      const float* dib = a.di + (size_t)bh * a.Lq;
      float* zd = reinterpret_cast<float*>(basep + Lay::kZd);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        mbar_wait(empty + 8 * s, ((t / S) & 1) ^ 1);  // a fresh stage passes
        if (lane == 0) {
          const uint32_t qd = ring + s * Lay::kStage;
          mbar_arrive_expect_tx(full + 8 * s, Lay::kStage);
          bw_load_tile(qd, &tmap_q, full + 8 * s, a.row_dim, NT, t * NT, b, h, c0 / 64);
          bw_load_tile(qd + Lay::kTile, &tmap_do, full + 8 * s, a.row_dim, NT, t * NT, b, h,
                       c0 / 64);
        }
        float* zs = zd + s * 2 * NT;
        const int row = t * NT + lane;
        const bool in = row < a.Lq;
        zs[lane] = in ? zb[row] : 0.0f;
        zs[NT + lane] = in ? dib[row] : 0.0f;
        mbar_arrive(zd_full + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kB9ConsumerRegs));
    bw_kv_consume<D, kMask>(a, base, basep, n_tiles, k0, c0 + 128 * (warp >> 2), bh);
  }
}

// A dQ consumer warpgroup: q rows q0 .. q0 + 63 of (b, h) = bh; columns
// c0 .. c0 + 127 of dQ, which are also the columns of its partial scores.
// Per key tile t it starts the partial S = Q K_t^T and dP = dO V_t^T, then
// dQ += dS_{t-1} K_{t-1}; sums the scores and computes tile t's ds while
// the latter runs; then releases tile t-1's stage and rounds ds.
template <int D, bool kMask>
__device__ __forceinline__ void bw_q_consume(const B9Args& a, uint32_t base, unsigned char* basep,
                                             int n_tiles, int q0, int c0, int bh) {
  using Lay = BwLayout<D, false>;
  constexpr int S = kBwStages, NT = kBwTile;
  const uint32_t ring = base + Lay::kRing;
  const uint32_t q_bar = base + Lay::kBars;
  const uint32_t full = q_bar + 8, empty = full + 8 * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const uint32_t qa = base + 2 * wg * Lay::kChunkR, doa = qa + Lay::kRes;
  const uint32_t kw = 2 * wg * Lay::kChunkT;  // this warpgroup's columns inside a k or v tile
  const BwSlots sl = bw_slots<D, false>(base, basep);
  // z and di of this thread's rows r0 and r0 + 8 (0 past Lq: computed, not stored)
  const int r0 = q0 + (warp & 3) * 16 + (lane >> 2);
  const float* zb = a.z + (size_t)bh * a.Lq;
  const float* dib = a.di + (size_t)bh * a.Lq;
  const float z0 = r0 < a.Lq ? zb[r0] : 0.0f, z1 = r0 + 8 < a.Lq ? zb[r0 + 8] : 0.0f;
  const float di0 = r0 < a.Lq ? dib[r0] : 0.0f, di1 = r0 + 8 < a.Lq ? dib[r0 + 8] : 0.0f;
  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.0f;
  float s[NT / 2], dp[NT / 2];
  uint32_t dsf[NT / 16][4];

  mbar_wait(q_bar, 0);
  mbar_wait(full, 0);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  bw_scores<NT, Lay::kChunkR, Lay::kChunkT>(s, qa, ring + kw);
  bw_scores<NT, Lay::kChunkR, Lay::kChunkT>(dp, doa, ring + Lay::kTile + kw);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_fence_acc(s);
  wg_fence_acc(dp);
  bw_sum_scores<NT, Lay::kSplits>(s, dp, sl, 0);
  if (kMask && n_tiles == 1)
    b9_q_ds<NT, true>(s, dp, z0, z1, di0, di1, a.scale, a.Lk);
  else
    b9_q_ds<NT, false>(s, dp, z0, z1, di0, di1, a.scale, NT);
  b9_round<NT>(s, dsf);

  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % S, pst = (t - 1) % S;
    mbar_wait(full + 8 * st, (t / S) & 1);
    wg_fence_acc(dq);
    wg_fence_frag(dsf);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint32_t kt = ring + st * Lay::kStage;
    bw_scores<NT, Lay::kChunkR, Lay::kChunkT>(s, qa, kt + kw);
    bw_scores<NT, Lay::kChunkR, Lay::kChunkT>(dp, doa, kt + Lay::kTile + kw);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    b9_accumulate<128, NT, Lay::kChunkT>(dq, dsf, ring + pst * Lay::kStage + kw);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S, dP of tile t
    wg_fence_acc(s);
    wg_fence_acc(dp);
    bw_sum_scores<NT, Lay::kSplits>(s, dp, sl, t);
    if (kMask && t == n_tiles - 1)
      b9_q_ds<NT, true>(s, dp, z0, z1, di0, di1, a.scale, a.Lk - t * NT);
    else
      b9_q_ds<NT, false>(s, dp, z0, z1, di0, di1, a.scale, NT);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // dQ of tile t - 1
    wg_fence_acc(dq);
    wg_fence_frag(dsf);
    if ((tid & 127) == 0) mbar_arrive(empty + 8 * pst);
    b9_round<NT>(s, dsf);
  }
  {
    wg_fence_acc(dq);
    wg_fence_frag(dsf);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    b9_accumulate<128, NT, Lay::kChunkT>(dq, dsf, ring + ((n_tiles - 1) % S) * Lay::kStage + kw);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(dq);
  }
  const int b = bh / a.H, h = bh - b * a.H;
  b9_store<128>(dq, a.dq + b * a.sq_b + h * a.sq_h + c0, a.sq_row, q0, a.Lq);
}

template <int D, bool kMask>
__global__ void __launch_bounds__(kB9Threads, 1)
flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tmap_q,
                         const __grid_constant__ CUtensorMap tmap_k,
                         const __grid_constant__ CUtensorMap tmap_v,
                         const __grid_constant__ CUtensorMap tmap_do, B9Args a) {
  using Lay = BwLayout<D, false>;
  constexpr int S = kBwStages, NT = kBwTile;
  extern __shared__ unsigned char bw_smem[];
  const uint32_t raw = wg_smem_addr(bw_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* basep = bw_smem + (base - raw);
  const uint32_t ring = base + Lay::kRing;
  const uint32_t q_bar = base + Lay::kBars;
  const uint32_t full = q_bar + 8, empty = full + 8 * S;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBwRows;
  const int c0 = kBwShare * blockIdx.z;
  const int n_tiles = (a.Lk + NT - 1) / NT;
  bw_init<D, false>(base, 2);  // empty: one arrive per consumer warpgroup

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kB9ProducerRegs));
    if (tid == 256) {  // the producer thread
      const int b = bh / a.H, h = bh - b * a.H;
      mbar_arrive_expect_tx(q_bar, 2 * Lay::kRes);
      bw_load_tile(base, &tmap_q, q_bar, a.row_dim, kBwRows, q0, b, h, c0 / 64);
      bw_load_tile(base + Lay::kRes, &tmap_do, q_bar, a.row_dim, kBwRows, q0, b, h, c0 / 64);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        mbar_wait(empty + 8 * s, ((t / S) & 1) ^ 1);
        const uint32_t kd = ring + s * Lay::kStage;
        mbar_arrive_expect_tx(full + 8 * s, Lay::kStage);
        bw_load_tile(kd, &tmap_k, full + 8 * s, a.row_dim, NT, t * NT, b, h, c0 / 64);
        bw_load_tile(kd + Lay::kTile, &tmap_v, full + 8 * s, a.row_dim, NT, t * NT, b, h,
                     c0 / 64);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kB9ConsumerRegs));
    bw_q_consume<D, kMask>(a, base, basep, n_tiles, q0, c0 + 128 * (warp >> 2), bh);
  }
}

template <int D, bool kQMask, bool kKeyMask>
int launch_bw(const CUtensorMap (&m)[4], const B9Args& a, dim3 kv_grid, dim3 q_grid,
              cudaStream_t stream) {
  const int err = b9_launch(flash_bwd_dkdv_wide_kernel<D, kQMask>, kv_grid,
                            BwLayout<D, true>::kSmem, D / kBwShare, m, a, stream);
  if (err != 0) return err;
  return b9_launch(flash_bwd_dq_wide_kernel<D, kKeyMask>, q_grid, BwLayout<D, false>::kSmem,
                   D / kBwShare, m, a, stream);
}

template <int D>
int launch_bw_masks(const CUtensorMap (&m)[4], const B9Args& a, const BwdPlan& p,
                    cudaStream_t stream) {
  const dim3 kv_grid((unsigned)p.kv_grid_x, (unsigned)p.kv_grid_y, (unsigned)p.splits);
  const dim3 q_grid((unsigned)p.q_grid_x, (unsigned)p.q_grid_y, (unsigned)p.splits);
  if (p.q_mask)
    return p.key_mask ? launch_bw<D, true, true>(m, a, kv_grid, q_grid, stream)
                      : launch_bw<D, true, false>(m, a, kv_grid, q_grid, stream);
  return p.key_mask ? launch_bw<D, false, true>(m, a, kv_grid, q_grid, stream)
                    : launch_bw<D, false, false>(m, a, kv_grid, q_grid, stream);
}

// Hold the plan (body 2) to this body and the entry's shapes
// (bwd_plan_maps), then launch the di pre-pass (o and do as sdo says; di
// into a.di), the dK/dV kernel and the dQ kernel.
inline int launch_flash_bwd_wide(const BwdPlan& p, const bf16* const (&bases)[4], const B9Args& a,
                                 const bf16* o, Strides sdo, int B, int D, cudaStream_t stream) {
  const long long kv_smem = D == 512 ? BwLayout<512, true>::kSmem : BwLayout<256, true>::kSmem;
  const long long q_smem = D == 512 ? BwLayout<512, false>::kSmem : BwLayout<256, false>::kSmem;
  CUtensorMap maps[4];
  if ((D != 256 && D != 512) ||
      !bwd_plan_maps(p, bases, a, B, D, 2, kBwRows, kBwTile, kBwTile, kBwStages, kv_smem, q_smem,
                     D / kBwShare, maps))
    return (int)cudaErrorInvalidValue;
  const int err = D == 512 ? launch_b9_di<512>(o, bases[3], a.di, sdo, B, a.Lq, a.H, stream)
                           : launch_b9_di<256>(o, bases[3], a.di, sdo, B, a.Lq, a.H, stream);
  if (err != 0) return err;
  return D == 512 ? launch_bw_masks<512>(maps, a, p, stream)
                  : launch_bw_masks<256>(maps, a, p, stream);
}

}  // namespace
