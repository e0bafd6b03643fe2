// The float32 head-major flash-attention backward designed for Hopper
// (sm_90a) as split TF32 on the tensor cores, for head dims 256 and 512:
// csrc/flash_bwd.cu gvq_flash_bwd_hm_f32 at those D (64 and 128 run
// csrc/flash_bwd_f32_sm90.cuh, whose numerics, pre-pass, argument struct
// and p / ds steps this body shares).
//
// Replaces the TPU kernels behind the backward of
// vqvae_from_gaussian_vae_tpu/ops/flash_attention.py (_bwd: the upstream
// Pallas _flash_attention_bwd_dkv, then _bwd_dq_lean) at those D, float32
// at the global matmul precision:
//
//   p  = expf(s * scale - z),  s = q k^T       (no max or sum pass)
//   di = rowsum(o * do)                        (the pre-pass)
//   ds = p (do v^T - di) scale
//   dv = p^T do,  dk = ds^T q,  dq = ds k      (float32 sums)
//
// every product in three TF32 passes, p and ds kept in float32 and split in
// registers, each tile's accumulation product started from a zeroed
// accumulator and added into dK, dV or dQ on the CUDA cores.
//
// What bounds it on an H100: the tensor cores.  At (4, 2, 1024, 1024, 256)
// the function's five products are 2.15e10 FLOP, 6.4e10 of TF32 issue in
// three passes: 0.130 ms at 495 TFLOP/s (the two kernels form S and dP
// both: seven products, 0.182 ms); the pre-pass reads 42 MB and writes
// 117 MB.
//
// The design, against shared memory, as the bf16 wide body
// (csrc/flash_bwd_sm90_wide.cuh) splits D for the register file.  Every
// operand is two float32 planes, so the dK/dV kernel's resident K and V
// over all of D would be 256 KB at D = 256 alone.
// 1. A block owns 64 keys (dK/dV) or 64 q rows (dQ) of one (b, h) and C of
//    D's columns; the D / C blocks of a row tile form a cluster along the
//    grid's z.  Its share of the resident tiles (K and V, or Q and dO, both
//    planes) is copied once; a producer warp keeps a ring of the streamed
//    tiles' shares in flight with TMA (dK/dV: q and do as they lie and
//    transposed, NQ q rows, and each tile's z and di stored by the warp's
//    lanes; dQ: k and v as they lie and k transposed, NK keys).
// 2. Each block forms the partial S^T = K Q^T and dP^T = V dO^T (dK/dV) or
//    S = Q K^T and dP = dO V^T (dQ) over its columns, and tw_exchange sums
//    the D / C partials of both in rank order over the cluster by
//    st.async: every block holds the same bits of S and dP and computes
//    the same p and ds (b9_kv_probs, b9_q_ds).
// 3. The accumulations run over the block's columns only: dV += P^T dO and
//    dK += dS^T Q (B = the share of do^T, q^T), dQ += dS K (B = the share of
//    k^T), A the split fragments.  Tile t's score products and tile t-1's
//    first accumulation are issued back to back; the exchange, p and ds of
//    tile t run while the latter runs.  At C = 128 a tile's dV and dK run as
//    blocks of 64 columns through one accumulator (dK and dV take 128
//    registers), at C = 64 both at once.
// 4. No atomics: every output element is summed by one block in a fixed
//    order, so the gradients repeat bit for bit.
// One consumer warpgroup and a producer warpgroup (256 threads).
//
// Ragged shapes as the D = 64 body: TMA's zero fill past Lq and Lk and the
// pre-pass's zeros past them in the "cols" planes; the last q tile (dK/dV)
// and the last key tile (dQ) mask p and ds to 0; rows of dk, dv past Lk
// and of dq past Lq are computed on zeros and not stored.
#pragma once

#include "flash_bwd_f32_sm90.cuh"

namespace {

// The dK/dV kernel's shared memory, from a 1024-byte-aligned base: the
// shares of K and V, the ring's stages (q, do, q^T, do^T), the exchange
// of S^T and dP^T, z and di of each stage, the mbarriers (K/V full; per
// stage full, z/di full, empty; the exchange's two).
template <int D, int C, int NQ, int ST>
struct TwKvLayout {
  static constexpr int kSplits = D / C;
  using KTile = TfTile<64, C>;   // K and V
  using QTile = TfTile<NQ, C>;   // q and do as they lie
  using QtTile = TfTile<C, NQ>;  // q^T and do^T
  using X = TwExchange<NQ, kSplits>;  // S^T, then dP^T: NQ / 2 floats each a thread
  static constexpr int kThreads = 256;
  static constexpr uint32_t kKV = 2 * KTile::kBytes;
  static constexpr uint32_t kQ = 2 * QTile::kBytes;
  static constexpr uint32_t kQt = 2 * QtTile::kBytes;
  static constexpr uint32_t kStage = 2 * kQ + 2 * kQt;
  static constexpr uint32_t kRing = 2 * kKV;
  static constexpr uint32_t kX = kRing + ST * kStage;
  static constexpr uint32_t kZd = kX + X::kBytes;      // stage s: z, then di, NQ each
  static constexpr uint32_t kBars = kZd + ST * 2 * NQ * 4;
  static constexpr size_t kSmem = kBars + (3 + 3 * ST) * 8 + 1024;
};

// The dQ kernel's: the shares of Q and dO, the ring's stages (k, v, k^T),
// the exchange of S and dP, the mbarriers (Q/dO full; per stage full,
// empty; the exchange's two).
template <int D, int C, int NK, int ST>
struct TwQLayout {
  static constexpr int kSplits = D / C;
  using QTile = TfTile<64, C>;   // Q and dO
  using KTile = TfTile<NK, C>;   // k and v as they lie
  using KtTile = TfTile<C, NK>;  // k^T
  using X = TwExchange<NK, kSplits>;
  static constexpr int kThreads = 256;
  static constexpr uint32_t kQ = 2 * QTile::kBytes;
  static constexpr uint32_t kK = 2 * KTile::kBytes;
  static constexpr uint32_t kStage = 2 * kK + 2 * KtTile::kBytes;
  static constexpr uint32_t kRing = 2 * kQ;
  static constexpr uint32_t kX = kRing + ST * kStage;
  static constexpr uint32_t kBars = kX + X::kBytes;
  static constexpr size_t kSmem = kBars + (3 + 2 * ST) * 8 + 1024;
};

// the partial s and dp of a tile summed over the cluster (one exchange of
// both)
template <int NS, int N>
__device__ __forceinline__ void tw_sum_scores(float (&s)[NS], float (&dp)[NS], uint32_t xa,
                                              const unsigned char* xp, uint32_t bars,
                                              uint32_t rank, int t) {
  float x[2 * NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    x[i] = s[i];
    x[NS + i] = dp[i];
  }
  tw_exchange<2 * NS, N>(x, xa, xp, bars, rank, t);
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    s[i] = x[i];
    dp[i] = x[NS + i];
  }
}

// A dK/dV consumer warpgroup: keys k0 .. k0 + 63 of (b, h) = bh, columns
// c0 .. c0 + C - 1 of dK and dV.  Per q tile t it starts the partial
// S^T = K Q_t^T and dP^T = V dO_t^T, then the first block of P_{t-1}^T
// dO_{t-1} (at C = 64 also dS_{t-1}^T Q_{t-1}); sums the scores over the
// cluster and computes tile t's p and ds while that runs; adds it in and
// runs the other blocks; releases tile t-1's stage (each warp, after its
// reads of z and di) and splits p and ds.
template <int D, int C, int NQ, int ST, bool kMask>
__device__ __forceinline__ void tw_kv_consume(const TfBwdArgs& a, uint32_t base,
                                              const unsigned char* basep, int n_tiles, int k0,
                                              int c0, int bh, uint32_t rank) {
  using Lay = TwKvLayout<D, C, NQ, ST>;
  using KT = typename Lay::KTile;
  using QT = typename Lay::QTile;
  using QtT = typename Lay::QtTile;
  constexpr int N = Lay::kSplits;
  constexpr bool kPair = C == 64;
  constexpr int kBlocks = C / 64;  // blocks of 64 columns of a tile's dV (and dK)
  const uint32_t ring = base + Lay::kRing;
  const uint32_t kv_bar = base + Lay::kBars;
  const uint32_t full = kv_bar + 8, zd_full = full + 8 * ST, empty = zd_full + 8 * ST;
  const uint32_t x_bars = empty + 8 * ST;
  const unsigned char* xp = basep + Lay::kX;
  const float* zd = reinterpret_cast<const float*>(basep + Lay::kZd);
  const int lane = threadIdx.x & 31;
  float dk[C / 2], dv[C / 2];
  float part_v[32], part_k[kPair ? 32 : 1];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) dk[i] = dv[i] = 0.0f;
  float s[NQ / 2], dp[NQ / 2];
  uint32_t ph[NQ / 8][4], pl[NQ / 8][4], dsh[NQ / 8][4], dsl[NQ / 8][4];
  // a stage's planes: q, do, q^T, do^T
  auto q_at = [&](int st) { return ring + st * Lay::kStage; };
  auto fence_frags = [&]() {
    wg_fence_frag(ph);
    wg_fence_frag(pl);
    wg_fence_frag(dsh);
    wg_fence_frag(dsl);
  };
  auto fold = [&](float (&sum)[C / 2], int hh) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[32 * hh + i] += part_v[i];
  };
  // the accumulation products that overlap the next tile's p and ds
  auto issue_parts = [&](uint32_t qa) {
    tf_product_rs<NQ, 64, QtT>(part_v, ph, pl, qa + 2 * Lay::kQ + Lay::kQt);
    if constexpr (kPair) tf_product_rs<NQ, 64, QtT>(part_k, dsh, dsl, qa + 2 * Lay::kQ);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };
  // once they are done: add them in, then (C = 128) the other blocks one
  // after another: dV's second, dK's two
  auto add_parts = [&](uint32_t qa) {
    wg_fence_acc(part_v);
    fold(dv, 0);
    if constexpr (kPair) {
      wg_fence_acc(part_k);
      tf_add(dk, part_k);
    } else {
#pragma unroll
      for (int i = 1; i < 2 * kBlocks; ++i) {
        const bool is_v = i < kBlocks;
        const int hh = is_v ? i : i - kBlocks;
        wg_fence_acc(part_v);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        if (is_v)
          tf_product_rs<NQ, 64, QtT>(part_v, ph, pl, qa + 2 * Lay::kQ + Lay::kQt, 64 * hh);
        else
          tf_product_rs<NQ, 64, QtT>(part_v, dsh, dsl, qa + 2 * Lay::kQ, 64 * hh);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        wg_fence_acc(part_v);
        fold(is_v ? dv : dk, hh);
      }
    }
  };

  mbar_wait(kv_bar, 0);
  mbar_wait(full, 0);
  mbar_wait(zd_full, 0);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  tf_product_ss<C, NQ, KT, QT>(s, base, 0, q_at(0));
  tf_product_ss<C, NQ, KT, QT>(dp, base + Lay::kKV, 0, q_at(0) + Lay::kQ);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_fence_acc(s);
  wg_fence_acc(dp);
  tw_sum_scores<NQ / 2, N>(s, dp, base + Lay::kX, xp, x_bars, rank, 0);
  if (kMask && n_tiles == 1)
    b9_kv_probs<NQ, true>(s, dp, zd, zd + NQ, a.scale, a.Lq);
  else
    b9_kv_probs<NQ, false>(s, dp, zd, zd + NQ, a.scale, NQ);
  tf_split_frag<NQ>(s, ph, pl);
  tf_split_frag<NQ>(dp, dsh, dsl);

  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % ST, pst = (t - 1) % ST;
    mbar_wait(full + 8 * st, (t / ST) & 1);
    mbar_wait(zd_full + 8 * st, (t / ST) & 1);
    wg_fence_acc(part_v);
    if constexpr (kPair) wg_fence_acc(part_k);
    fence_frags();
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    tf_product_ss<C, NQ, KT, QT>(s, base, 0, q_at(st));
    tf_product_ss<C, NQ, KT, QT>(dp, base + Lay::kKV, 0, q_at(st) + Lay::kQ);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    issue_parts(q_at(pst));
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S^T, dP^T of tile t
    wg_fence_acc(s);
    wg_fence_acc(dp);
    tw_sum_scores<NQ / 2, N>(s, dp, base + Lay::kX, xp, x_bars, rank, t);
    const float* zs = zd + st * 2 * NQ;
    if (kMask && t == n_tiles - 1)
      b9_kv_probs<NQ, true>(s, dp, zs, zs + NQ, a.scale, a.Lq - t * NQ);
    else
      b9_kv_probs<NQ, false>(s, dp, zs, zs + NQ, a.scale, NQ);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // tile t - 1's products
    fence_frags();
    add_parts(q_at(pst));
    fence_frags();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * pst);
    tf_split_frag<NQ>(s, ph, pl);
    tf_split_frag<NQ>(dp, dsh, dsl);
  }
  {
    const uint32_t last = q_at((n_tiles - 1) % ST);
    wg_fence_acc(part_v);
    if constexpr (kPair) wg_fence_acc(part_k);
    fence_frags();
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    issue_parts(last);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_frags();
    add_parts(last);
  }
  const size_t off = (size_t)bh * a.Lk * D + c0;
  tw_store<C>(dk, a.dk + off, D, k0, a.Lk);
  tw_store<C>(dv, a.dv + off, D, k0, a.Lk);
}

template <int D, int C, int NQ, int ST, bool kMask>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkdv_f32_wide_kernel(const __grid_constant__ CUtensorMap tmap_q,
                               const __grid_constant__ CUtensorMap tmap_k,
                               const __grid_constant__ CUtensorMap tmap_v,
                               const __grid_constant__ CUtensorMap tmap_do,
                               const __grid_constant__ CUtensorMap tmap_qt,
                               const __grid_constant__ CUtensorMap tmap_dot, TfBwdArgs a) {
  using Lay = TwKvLayout<D, C, NQ, ST>;
  extern __shared__ unsigned char tf_smem[];
  const uint32_t raw = wg_smem_addr(tf_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's 1024-byte atom
  unsigned char* basep = tf_smem + (base - raw);
  const uint32_t ring = base + Lay::kRing;
  const uint32_t kv_bar = base + Lay::kBars;
  const uint32_t full = kv_bar + 8, zd_full = full + 8 * ST, empty = zd_full + 8 * ST;
  const uint32_t x_bars = empty + 8 * ST;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * 64;
  const uint32_t rank = gvq::cluster_rank();  // blockIdx.z: the cluster lies along z
  const int c0 = C * (int)rank;
  const int n_tiles = (a.Lq + NQ - 1) / NQ;
  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);     // the producer's arrive; the copies' bytes
      mbar_init(zd_full + 8 * s, 32); // the producer warp's z and di stores
      mbar_init(empty + 8 * s, 4);    // one arrive per consumer warp
    }
    mbar_init(x_bars, 1);  // the arming arrive; the other blocks' bytes
    mbar_init(x_bars + 8, 1);
  }
  tw_start();

  if (warp >= 4) {
    if (warp == 4) {  // the producer warp: one thread copies, every lane stores z and di
      const int lane = tid & 31;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_bar, 2 * Lay::kKV);
        tf_load<typename Lay::KTile>(base, &tmap_k, kv_bar, c0, k0, bh);
        tf_load<typename Lay::KTile>(base + Lay::kKV, &tmap_v, kv_bar, c0, k0, bh);
      }
      const float* zb = a.z + (size_t)bh * a.Lq;
      const float* dib = a.di + (size_t)bh * a.Lq;
      float* zd = reinterpret_cast<float*>(basep + Lay::kZd);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        mbar_wait(empty + 8 * s, ((t / ST) & 1) ^ 1);  // a fresh stage passes
        if (lane == 0) {
          const uint32_t qd = ring + s * Lay::kStage;
          mbar_arrive_expect_tx(full + 8 * s, Lay::kStage);
          tf_load<typename Lay::QTile>(qd, &tmap_q, full + 8 * s, c0, t * NQ, bh);
          tf_load<typename Lay::QTile>(qd + Lay::kQ, &tmap_do, full + 8 * s, c0, t * NQ, bh);
          tf_load<typename Lay::QtTile>(qd + 2 * Lay::kQ, &tmap_qt, full + 8 * s, t * NQ, c0, bh);
          tf_load<typename Lay::QtTile>(qd + 2 * Lay::kQ + Lay::kQt, &tmap_dot, full + 8 * s,
                                        t * NQ, c0, bh);
        }
        float* zs = zd + s * 2 * NQ;
        for (int i = lane; i < NQ; i += 32) {
          const int row = t * NQ + i;
          const bool in = row < a.Lq;
          zs[i] = in ? zb[row] : 0.0f;
          zs[NQ + i] = in ? dib[row] : 0.0f;
        }
        mbar_arrive(zd_full + 8 * s);
      }
    }
  } else {
    tw_kv_consume<D, C, NQ, ST, kMask>(a, base, basep, n_tiles, k0, c0, bh, rank);
  }
}

// A dQ consumer warpgroup: q rows q0 .. q0 + 63 of (b, h) = bh, columns
// c0 .. c0 + C - 1 of dQ.  Per key tile t it starts the partial S = Q K_t^T
// and dP = dO V_t^T, then dQ += dS_{t-1} K_{t-1}; sums the scores over the
// cluster and computes tile t's ds while the latter runs; then releases
// tile t-1's stage and splits ds.
template <int D, int C, int NK, int ST, bool kMask>
__device__ __forceinline__ void tw_q_consume(const TfBwdArgs& a, uint32_t base,
                                             const unsigned char* basep, int n_tiles, int q0,
                                             int c0, int bh, uint32_t rank) {
  using Lay = TwQLayout<D, C, NK, ST>;
  using QT = typename Lay::QTile;
  using KT = typename Lay::KTile;
  using KtT = typename Lay::KtTile;
  constexpr int N = Lay::kSplits;
  const uint32_t ring = base + Lay::kRing;
  const uint32_t q_bar = base + Lay::kBars;
  const uint32_t full = q_bar + 8, empty = full + 8 * ST, x_bars = empty + 8 * ST;
  const unsigned char* xp = basep + Lay::kX;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // z and di of this thread's rows r0 and r0 + 8 (0 past Lq: computed, not stored)
  const int r0 = q0 + warp * 16 + (lane >> 2);
  const float* zb = a.z + (size_t)bh * a.Lq;
  const float* dib = a.di + (size_t)bh * a.Lq;
  const float z0 = r0 < a.Lq ? zb[r0] : 0.0f, z1 = r0 + 8 < a.Lq ? zb[r0 + 8] : 0.0f;
  const float di0 = r0 < a.Lq ? dib[r0] : 0.0f, di1 = r0 + 8 < a.Lq ? dib[r0 + 8] : 0.0f;
  float dq[C / 2], part[C / 2];  // the running dq; one tile's dS K
#pragma unroll
  for (int i = 0; i < C / 2; ++i) dq[i] = 0.0f;
  float s[NK / 2], dp[NK / 2];
  uint32_t dsh[NK / 8][4], dsl[NK / 8][4];
  // a stage's planes: k, v, k^T
  auto k_at = [&](int st) { return ring + st * Lay::kStage; };

  mbar_wait(q_bar, 0);
  mbar_wait(full, 0);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  tf_product_ss<C, NK, QT, KT>(s, base, 0, k_at(0));
  tf_product_ss<C, NK, QT, KT>(dp, base + Lay::kQ, 0, k_at(0) + Lay::kK);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_fence_acc(s);
  wg_fence_acc(dp);
  tw_sum_scores<NK / 2, N>(s, dp, base + Lay::kX, xp, x_bars, rank, 0);
  if (kMask && n_tiles == 1)
    b9_q_ds<NK, true>(s, dp, z0, z1, di0, di1, a.scale, a.Lk);
  else
    b9_q_ds<NK, false>(s, dp, z0, z1, di0, di1, a.scale, NK);
  tf_split_frag<NK>(s, dsh, dsl);

  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % ST, pst = (t - 1) % ST;
    mbar_wait(full + 8 * st, (t / ST) & 1);
    wg_fence_acc(part);
    wg_fence_frag(dsh);
    wg_fence_frag(dsl);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    tf_product_ss<C, NK, QT, KT>(s, base, 0, k_at(st));
    tf_product_ss<C, NK, QT, KT>(dp, base + Lay::kQ, 0, k_at(st) + Lay::kK);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    tf_product_rs<NK, C, KtT>(part, dsh, dsl, k_at(pst) + 2 * Lay::kK);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S, dP of tile t
    wg_fence_acc(s);
    wg_fence_acc(dp);
    tw_sum_scores<NK / 2, N>(s, dp, base + Lay::kX, xp, x_bars, rank, t);
    if (kMask && t == n_tiles - 1)
      b9_q_ds<NK, true>(s, dp, z0, z1, di0, di1, a.scale, a.Lk - t * NK);
    else
      b9_q_ds<NK, false>(s, dp, z0, z1, di0, di1, a.scale, NK);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // dQ of tile t - 1
    wg_fence_acc(part);
    wg_fence_frag(dsh);
    wg_fence_frag(dsl);
    if (tid == 0) mbar_arrive(empty + 8 * pst);
    tf_add(dq, part);
    tf_split_frag<NK>(s, dsh, dsl);
  }
  {
    wg_fence_acc(part);
    wg_fence_frag(dsh);
    wg_fence_frag(dsl);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    tf_product_rs<NK, C, KtT>(part, dsh, dsl, k_at((n_tiles - 1) % ST) + 2 * Lay::kK);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(part);
    tf_add(dq, part);
  }
  tw_store<C>(dq, a.dq + (size_t)bh * a.Lq * D + c0, D, q0, a.Lq);
}

template <int D, int C, int NK, int ST, bool kMask>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dq_f32_wide_kernel(const __grid_constant__ CUtensorMap tmap_q,
                             const __grid_constant__ CUtensorMap tmap_k,
                             const __grid_constant__ CUtensorMap tmap_v,
                             const __grid_constant__ CUtensorMap tmap_do,
                             const __grid_constant__ CUtensorMap tmap_kt, TfBwdArgs a) {
  using Lay = TwQLayout<D, C, NK, ST>;
  extern __shared__ unsigned char tf_smem[];
  const uint32_t raw = wg_smem_addr(tf_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* basep = tf_smem + (base - raw);
  const uint32_t ring = base + Lay::kRing;
  const uint32_t q_bar = base + Lay::kBars;
  const uint32_t full = q_bar + 8, empty = full + 8 * ST, x_bars = empty + 8 * ST;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const uint32_t rank = gvq::cluster_rank();
  const int c0 = C * (int)rank;
  const int n_tiles = (a.Lk + NK - 1) / NK;
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);  // the consumer warpgroup's arrive
    }
    mbar_init(x_bars, 1);
    mbar_init(x_bars + 8, 1);
  }
  tw_start();

  if (tid >= 128) {
    if (tid == 128) {  // the producer thread
      mbar_arrive_expect_tx(q_bar, 2 * Lay::kQ);
      tf_load<typename Lay::QTile>(base, &tmap_q, q_bar, c0, q0, bh);
      tf_load<typename Lay::QTile>(base + Lay::kQ, &tmap_do, q_bar, c0, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        mbar_wait(empty + 8 * s, ((t / ST) & 1) ^ 1);
        const uint32_t kd = ring + s * Lay::kStage;
        mbar_arrive_expect_tx(full + 8 * s, Lay::kStage);
        tf_load<typename Lay::KTile>(kd, &tmap_k, full + 8 * s, c0, t * NK, bh);
        tf_load<typename Lay::KTile>(kd + Lay::kK, &tmap_v, full + 8 * s, c0, t * NK, bh);
        tf_load<typename Lay::KtTile>(kd + 2 * Lay::kK, &tmap_kt, full + 8 * s, t * NK, c0, bh);
      }
    }
  } else {
    tw_q_consume<D, C, NK, ST, kMask>(a, base, basep, n_tiles, q0, c0, bh, rank);
  }
}

// Hold the backward's part of the plan to this body at head dim D and the
// tilings (dK/dV: C, NQ, KST; dQ: C, NK, QST) and to the shapes, then run
// the pre-pass into scratch (and di), the dK/dV kernel and the dQ kernel.
template <int D, int KC, int NQ, int KST, int QC, int NK, int QST>
int launch_flash_bwd_f32_wide(const F32Plan& p, const float* q, const float* k, const float* v,
                              const float* o, const float* dout, float* scratch,
                              const TfBwdArgs& a, int B, int H, cudaStream_t stream) {
  using KvLay = TwKvLayout<D, KC, NQ, KST>;
  using QLay = TwQLayout<D, QC, NK, QST>;
  static_assert(KvLay::kSmem <= 232448 && QLay::kSmem <= 232448, "a block's shared memory");
  const long long bh = (long long)B * H;
  const int Lq = a.Lq, Lk = a.Lk;
  const long long kv[10] = {64, NQ, KST, KvLay::kThreads, (long long)KvLay::kSmem, (Lk + 63) / 64,
                            bh, Lq % NQ != 0, KC, D / KC};
  const long long qq[10] = {64, NK, QST, QLay::kThreads, (long long)QLay::kSmem, (Lq + 63) / 64,
                            bh, Lk % NK != 0, QC, D / QC};
  const int lqp = (Lq + 7) / 8 * 8, lkp = (Lk + 7) / 8 * 8;
  bool ok = p.body == 1 && scratch != nullptr && bh <= 65535 && p.lq_pitch == lqp &&
            p.lk_pitch == lkp;
  for (int i = 0; ok && i < 10; ++i) ok = p.dkdv[i] == kv[i] && p.dq[i] == qq[i];
  for (int i = 0; ok && i < 4; ++i) ok = p.map[kMapQq + i].offset == p.map[kMapKq + i].offset;
  CUtensorMap kvm[6], qm[5];
  ok = ok && tf_encode(&kvm[0], scratch, p.bwd_scratch, p.map[kMapKq], bh, Lq, D, 32, NQ) &&
       tf_encode(&kvm[1], scratch, p.bwd_scratch, p.map[kMapKk], bh, Lk, D, 32, 64) &&
       tf_encode(&kvm[2], scratch, p.bwd_scratch, p.map[kMapKv], bh, Lk, D, 32, 64) &&
       tf_encode(&kvm[3], scratch, p.bwd_scratch, p.map[kMapKdo], bh, Lq, D, 32, NQ) &&
       tf_encode(&kvm[4], scratch, p.bwd_scratch, p.map[kMapKqt], bh, D, lqp,
                 KvLay::QtTile::kChunkCols, KC) &&
       tf_encode(&kvm[5], scratch, p.bwd_scratch, p.map[kMapKdot], bh, D, lqp,
                 KvLay::QtTile::kChunkCols, KC) &&
       tf_encode(&qm[0], scratch, p.bwd_scratch, p.map[kMapQq], bh, Lq, D, 32, 64) &&
       tf_encode(&qm[1], scratch, p.bwd_scratch, p.map[kMapQk], bh, Lk, D, 32, NK) &&
       tf_encode(&qm[2], scratch, p.bwd_scratch, p.map[kMapQv], bh, Lk, D, 32, NK) &&
       tf_encode(&qm[3], scratch, p.bwd_scratch, p.map[kMapQdo], bh, Lq, D, 32, 64) &&
       tf_encode(&qm[4], scratch, p.bwd_scratch, p.map[kMapQkt], bh, D, lkp,
                 QLay::KtTile::kChunkCols, QC);
  if (!ok) return (int)cudaErrorInvalidValue;
  TfJobs jobs{};
  jobs.n = 8;
  float* di = const_cast<float*>(a.di);
  jobs.job[0] = tf_job(kTfRows, q, nullptr, scratch + p.map[kMapKq].offset, bh, Lq, D, 0);
  jobs.job[1] = tf_job(kTfRows, k, nullptr, scratch + p.map[kMapKk].offset, bh, Lk, D, 0);
  jobs.job[2] = tf_job(kTfRows, v, nullptr, scratch + p.map[kMapKv].offset, bh, Lk, D, 0);
  jobs.job[3] = tf_job(kTfRows, dout, nullptr, scratch + p.map[kMapKdo].offset, bh, Lq, D, 0);
  jobs.job[4] = tf_job(kTfCols, q, nullptr, scratch + p.map[kMapKqt].offset, bh, Lq, D, lqp);
  jobs.job[5] = tf_job(kTfCols, k, nullptr, scratch + p.map[kMapQkt].offset, bh, Lk, D, lkp);
  jobs.job[6] = tf_job(kTfCols, dout, nullptr, scratch + p.map[kMapKdot].offset, bh, Lq, D, lqp);
  jobs.job[7] = tf_job(kTfDi, o, dout, di, bh, Lq, D, 0);
  int err = tf_prep(jobs, stream);
  if (err != 0) return err;
  const dim3 kv_grid((unsigned)kv[5], (unsigned)bh, D / KC);
  const dim3 q_grid((unsigned)qq[5], (unsigned)bh, D / QC);
  err = kv[7] ? tw_launch(flash_bwd_dkdv_f32_wide_kernel<D, KC, NQ, KST, true>, kv_grid, 256,
                          KvLay::kSmem, D / KC, stream, kvm[0], kvm[1], kvm[2], kvm[3], kvm[4],
                          kvm[5], a)
              : tw_launch(flash_bwd_dkdv_f32_wide_kernel<D, KC, NQ, KST, false>, kv_grid, 256,
                          KvLay::kSmem, D / KC, stream, kvm[0], kvm[1], kvm[2], kvm[3], kvm[4],
                          kvm[5], a);
  if (err != 0) return err;
  return qq[7] ? tw_launch(flash_bwd_dq_f32_wide_kernel<D, QC, NK, QST, true>, q_grid, 256,
                           QLay::kSmem, D / QC, stream, qm[0], qm[1], qm[2], qm[3], qm[4], a)
               : tw_launch(flash_bwd_dq_f32_wide_kernel<D, QC, NK, QST, false>, q_grid, 256,
                           QLay::kSmem, D / QC, stream, qm[0], qm[1], qm[2], qm[3], qm[4], a);
}

}  // namespace
