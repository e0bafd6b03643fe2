// The float32 head-major flash-attention backward designed for Hopper
// (sm_90a) as split TF32 on the tensor cores, for head dims 64 and 128:
// csrc/flash_bwd.cu gvq_flash_bwd_hm_f32 at those D (256 and 512 run their
// wide form, csrc/flash_bwd_f32_sm90_wide.cuh).
//
// Replaces the TPU kernels behind the backward of
// vqvae_from_gaussian_vae_tpu/ops/flash_attention.py (_bwd: the upstream
// Pallas _flash_attention_bwd_dkv, then _bwd_dq_lean), float32 at the
// global matmul precision.  Per (batch, head), from the forward's z:
//
//   p  = expf(s * scale - z),  s = q k^T       (no max or sum pass)
//   di = rowsum(o * do)                        (the pre-pass)
//   ds = p (do v^T - di) scale
//   dv = p^T do,  dk = ds^T q,  dq = ds k      (float32 sums)
//
// every product in three TF32 passes (csrc/flash_f32_sm90.cuh), p and ds
// kept in float32 and split in registers.
//
// What bounds it on an H100: the tensor cores.  At (1, 12, 8192, 64) the
// two kernels' seven products are 7.21e11 FLOP, 2.16e12 of TF32 issue:
// 4.37 ms at 495 TFLOP/s; the pre-pass reads 126 MB and writes 353 MB.
//
// The design, as the bf16 body csrc/flash_bwd_sm90.cuh, whose p / ds
// helpers (b9_kv_probs, b9_q_ds) and warpgroup turns (b9_turn_*) it takes:
// 1. One pre-pass launch writes q, k, v, do as "rows" planes, q, k, do as
//    "cols" planes (transposed, rows permuted in 8s) and di.
// 2. Two kernels, no atomics, bit-reproducible.  dK/dV: a block owns 64 WG
//    keys, K and V (both planes) copied once; per streamed q tile the
//    transposed scores S^T = K Q^T and dP^T = V dO^T (B = q and do as they
//    lie), z and di read by column from the stage; dV += P^T dO (B = do^T)
//    and dK += dS^T Q (B = q^T) from split fragments.  dQ: a block owns 64
//    WG q rows, Q and dO copied once; per key tile S = Q K^T and dP = dO
//    V^T (B = k and v as they lie); dQ += dS K (B = k^T).  Each tile's
//    accumulation product starts from a zeroed accumulator and is added
//    into dK, dV or dQ on the CUDA cores (the tensor cores' float32 sums
//    truncate, and one chain over all tiles drifts with L toward the 1e-4
//    bar).
// 3. A producer thread keeps a TMA ring of the streamed tiles (all four,
//    or three, planes pairs) with full / empty mbarriers; each consumer
//    warpgroup starts tile t's score products and tile t-1's accumulations
//    back to back and computes tile t's p and ds while those run.  Two
//    consumer warpgroups take turns to start their products.
// Tiles (mirrored in flash_f32_plan), for shared memory: every operand is
// two float32 planes, four times a bf16 tile's bytes.  dK/dV: D = 64 two
// warpgroups (128 keys) against 16-row q tiles in 3 stages (128 + 3 x 32
// KB); D = 128 one warpgroup against 8-row q tiles in 3 stages.  dQ: one
// warpgroup (64 q rows) against 32-key tiles in 3 stages at D = 64 (64 + 3
// x 48 KB; faster on an H100 than two warpgroups in 2 stages), 16-key
// tiles in 2 stages at D = 128.
//
// Ragged shapes as the bf16 body: TMA's zero fill past Lq and Lk and the
// pre-pass's zeros past them in the "cols" planes; the last q tile
// (dK/dV) and the last key tile (dQ) mask p and ds to 0; rows of dk, dv
// past Lk and of dq past Lq are computed on zeros and not stored.
#pragma once

#include "flash_bwd_sm90.cuh"
#include "flash_f32_sm90.cuh"

namespace {

template <int D, int WG, int NQ, int ST>
struct TfKvLayout {
  using KTile = TfTile<64 * WG, D>;  // K and V
  using QTile = TfTile<NQ, D>;       // Q and dO as they lie
  using QtTile = TfTile<D, NQ>;      // Q^T and dO^T
  static constexpr int kThreads = 128 * (WG + 1);
  static constexpr uint32_t kKV = 2 * KTile::kBytes;  // one tensor's two planes
  static constexpr uint32_t kQ = 2 * QTile::kBytes;
  static constexpr uint32_t kQt = 2 * QtTile::kBytes;
  // a stage: Q, dO, Q^T, dO^T
  static constexpr uint32_t kStage = 2 * kQ + 2 * kQt;
  static constexpr uint32_t kRing = 2 * kKV;
  static constexpr uint32_t kZd = kRing + ST * kStage;  // stage s: z, then di, NQ each
  static constexpr uint32_t kBars = kZd + ST * 2 * NQ * 4;  // K/V full; per stage full, z/di full, empty
  static constexpr size_t kSmem = kBars + (1 + 3 * ST) * 8 + 1024;
};

template <int D, int WG, int NK, int ST>
struct TfQLayout {
  using QTile = TfTile<64 * WG, D>;  // Q and dO
  using KTile = TfTile<NK, D>;       // K and V as they lie
  using KtTile = TfTile<D, NK>;      // K^T
  static constexpr int kThreads = 128 * (WG + 1);
  static constexpr uint32_t kQ = 2 * QTile::kBytes;
  static constexpr uint32_t kK = 2 * KTile::kBytes;
  // a stage: K, V, K^T
  static constexpr uint32_t kStage = 2 * kK + 2 * KtTile::kBytes;
  static constexpr uint32_t kRing = 2 * kQ;
  static constexpr uint32_t kBars = kRing + ST * kStage;  // Q/dO full; per stage full, empty
  static constexpr size_t kSmem = kBars + (1 + 2 * ST) * 8 + 1024;
};

struct TfBwdArgs {
  float* dq;
  float* dk;
  float* dv;
  const float* z;   // (B, H, Lq)
  const float* di;  // (B, H, Lq), written by the pre-pass
  int Lq, Lk;
  float scale;
};

// A dK/dV consumer warpgroup: warpgroup wg owns keys k0 + 64 wg .. + 63 of
// (b, h) = bh.  Per q tile t it starts S^T = K Q_t^T and dP^T = V dO_t^T,
// then P_{t-1}^T dO_{t-1} and dS_{t-1}^T Q_{t-1}, each into a zeroed
// accumulator that is then added into dV or dK on the CUDA cores
// (tf_product_rs); computes tile t's p and ds while the latter run; then
// releases tile t-1's stage (each warp, after its reads of z and di) and
// splits p and ds.  At D = 64 the two tile products have an accumulator
// each; at D = 128, where dK and dV take 128 registers, each runs as two
// blocks of 64 columns through one accumulator, the first overlapping p
// and ds, the other three after it.
template <int D, int WG, int NQ, int ST, bool kMask>
__device__ __forceinline__ void tf_kv_consume(const TfBwdArgs& a, uint32_t base,
                                              const unsigned char* basep, int n_tiles, int k0,
                                              int bh, bool pp) {
  using Lay = TfKvLayout<D, WG, NQ, ST>;
  using KT = typename Lay::KTile;
  using QT = typename Lay::QTile;
  using QtT = typename Lay::QtTile;
  constexpr bool kPair = D == 64;
  const uint32_t ring = base + Lay::kRing;
  const uint32_t kv_bar = base + Lay::kBars;
  const uint32_t full = kv_bar + 8, zd_full = full + 8 * ST, empty = zd_full + 8 * ST;
  const float* zd = reinterpret_cast<const float*>(basep + Lay::kZd);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const int row0 = 64 * wg;
  float dk[D / 2], dv[D / 2];
  // one tile's P^T dO and dS^T Q: at D = 64 whole, one accumulator each; at
  // D = 128 by blocks of 64 columns in turn through one accumulator
  float part_v[32], part_k[kPair ? 32 : 1];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;
  float s[NQ / 2], dp[NQ / 2];
  uint32_t ph[NQ / 8][4], pl[NQ / 8][4], dsh[NQ / 8][4], dsl[NQ / 8][4];
  // a stage's planes: Q, dO, Q^T, dO^T
  auto q_at = [&](int st) { return ring + st * Lay::kStage; };
  auto fence_frags = [&]() {
    wg_fence_frag(ph);
    wg_fence_frag(pl);
    wg_fence_frag(dsh);
    wg_fence_frag(dsl);
  };
  // sum (columns 64 hh ..) += part_v
  auto fold = [&](float (&sum)[D / 2], int hh) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[32 * hh + i] += part_v[i];
  };
  // the tile products of the stage at `qa` that overlap p and ds of the
  // next tile, issued and committed: at D = 64 both, at D = 128 the first
  // block of P^T dO
  auto issue_parts = [&](uint32_t qa) {
    tf_product_rs<NQ, 64, QtT>(part_v, ph, pl, qa + 2 * Lay::kQ + Lay::kQt);
    if constexpr (kPair) tf_product_rs<NQ, 64, QtT>(part_k, dsh, dsl, qa + 2 * Lay::kQ);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };
  // once they are done: add them in, and at D = 128 run the other three
  // blocks one after another
  auto add_parts = [&](uint32_t qa) {
    wg_fence_acc(part_v);
    fold(dv, 0);
    if constexpr (kPair) {
      wg_fence_acc(part_k);
      tf_add(dk, part_k);
    } else {
#pragma unroll
      for (int i = 1; i < 4; ++i) {
        wg_fence_acc(part_v);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        if (i < 2)
          tf_product_rs<NQ, 64, QtT>(part_v, ph, pl, qa + 2 * Lay::kQ + Lay::kQt, 64);
        else
          tf_product_rs<NQ, 64, QtT>(part_v, dsh, dsl, qa + 2 * Lay::kQ, 64 * (i - 2));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        wg_fence_acc(part_v);
        fold(i < 2 ? dv : dk, i & 1);
      }
    }
  };

  b9_turn_first(pp, wg);
  mbar_wait(kv_bar, 0);
  mbar_wait(full, 0);
  mbar_wait(zd_full, 0);
  b9_turn_wait(pp, wg);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  tf_product_ss<D, NQ, KT, QT>(s, base, row0, q_at(0));
  tf_product_ss<D, NQ, KT, QT>(dp, base + Lay::kKV, row0, q_at(0) + Lay::kQ);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  b9_turn_pass(pp, wg, false);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_fence_acc(s);
  wg_fence_acc(dp);
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
    b9_turn_wait(pp, wg);
    wg_fence_acc(part_v);
    if constexpr (kPair) wg_fence_acc(part_k);
    fence_frags();
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    tf_product_ss<D, NQ, KT, QT>(s, base, row0, q_at(st));
    tf_product_ss<D, NQ, KT, QT>(dp, base + Lay::kKV, row0, q_at(st) + Lay::kQ);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    issue_parts(q_at(pst));
    b9_turn_pass(pp, wg, false);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S^T, dP^T of tile t
    wg_fence_acc(s);
    wg_fence_acc(dp);
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
    b9_turn_wait(pp, wg);
    wg_fence_acc(part_v);
    if constexpr (kPair) wg_fence_acc(part_k);
    fence_frags();
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    issue_parts(last);
    b9_turn_pass(pp, wg, true);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_frags();
    add_parts(last);
  }
  const size_t off = (size_t)bh * a.Lk * D;
  tf_store<D>(dk, a.dk + off, k0 + row0, a.Lk);
  tf_store<D>(dv, a.dv + off, k0 + row0, a.Lk);
}

template <int D, int WG, int NQ, int ST, bool kMask>
__global__ void __launch_bounds__(TfKvLayout<D, WG, NQ, ST>::kThreads, 1)
flash_bwd_dkdv_f32_sm90_kernel(const __grid_constant__ CUtensorMap tmap_q,
                               const __grid_constant__ CUtensorMap tmap_k,
                               const __grid_constant__ CUtensorMap tmap_v,
                               const __grid_constant__ CUtensorMap tmap_do,
                               const __grid_constant__ CUtensorMap tmap_qt,
                               const __grid_constant__ CUtensorMap tmap_dot, TfBwdArgs a) {
  using Lay = TfKvLayout<D, WG, NQ, ST>;
  extern __shared__ unsigned char tf_smem[];
  const uint32_t raw = wg_smem_addr(tf_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's 1024-byte atom
  unsigned char* basep = tf_smem + (base - raw);
  const uint32_t ring = base + Lay::kRing;
  const uint32_t kv_bar = base + Lay::kBars;
  const uint32_t full = kv_bar + 8, zd_full = full + 8 * ST, empty = zd_full + 8 * ST;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * 64 * WG;
  const int n_tiles = (a.Lq + NQ - 1) / NQ;
  // warpgroups whose 64 keys all lie past Lk compute nothing
  const int active = min(WG, (a.Lk - k0 + 63) / 64);
  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);            // the producer's arrive; the copies' bytes
      mbar_init(zd_full + 8 * s, 32);        // the producer warp's z and di stores
      mbar_init(empty + 8 * s, 4 * active);  // one arrive per warp of an active consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WG) {
    if constexpr (WG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(tf_producer_regs(WG)));
    if (warp == 4 * WG) {  // the producer warp: one thread copies, every lane stores z and di
      const int lane = tid & 31;
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_bar, 2 * Lay::kKV);
        tf_load<typename Lay::KTile>(base, &tmap_k, kv_bar, 0, k0, bh);
        tf_load<typename Lay::KTile>(base + Lay::kKV, &tmap_v, kv_bar, 0, k0, bh);
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
          tf_load<typename Lay::QTile>(qd, &tmap_q, full + 8 * s, 0, t * NQ, bh);
          tf_load<typename Lay::QTile>(qd + Lay::kQ, &tmap_do, full + 8 * s, 0, t * NQ, bh);
          tf_load<typename Lay::QtTile>(qd + 2 * Lay::kQ, &tmap_qt, full + 8 * s, t * NQ, 0, bh);
          tf_load<typename Lay::QtTile>(qd + 2 * Lay::kQ + Lay::kQt, &tmap_dot, full + 8 * s,
                                        t * NQ, 0, bh);
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
    if constexpr (WG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(tf_consumer_regs(WG)));
    if (warp / 4 < active)
      tf_kv_consume<D, WG, NQ, ST, kMask>(a, base, basep, n_tiles, k0, bh, active == 2);
  }
}

// A dQ consumer warpgroup: warpgroup wg owns q rows q0 + 64 wg .. + 63 of
// (b, h) = bh.  Per key tile t it starts S = Q K_t^T and dP = dO V_t^T, then
// dQ += dS_{t-1} K_{t-1}; computes tile t's ds while the latter runs; then
// releases tile t-1's stage and splits ds.
template <int D, int WG, int NK, int ST, bool kMask>
__device__ __forceinline__ void tf_q_consume(const TfBwdArgs& a, uint32_t base, int n_tiles,
                                             int q0, int bh, bool pp) {
  using Lay = TfQLayout<D, WG, NK, ST>;
  using QT = typename Lay::QTile;
  using KT = typename Lay::KTile;
  using KtT = typename Lay::KtTile;
  const uint32_t ring = base + Lay::kRing;
  const uint32_t q_bar = base + Lay::kBars;
  const uint32_t full = q_bar + 8, empty = full + 8 * ST;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int row0 = 64 * wg;
  // z and di of this thread's rows r0 and r0 + 8 (0 past Lq: computed, not stored)
  const int r0 = q0 + row0 + (warp & 3) * 16 + (lane >> 2);
  const float* zb = a.z + (size_t)bh * a.Lq;
  const float* dib = a.di + (size_t)bh * a.Lq;
  const float z0 = r0 < a.Lq ? zb[r0] : 0.0f, z1 = r0 + 8 < a.Lq ? zb[r0 + 8] : 0.0f;
  const float di0 = r0 < a.Lq ? dib[r0] : 0.0f, di1 = r0 + 8 < a.Lq ? dib[r0 + 8] : 0.0f;
  float dq[D / 2], part[D / 2];  // the running dq; one tile's dS K
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
  float s[NK / 2], dp[NK / 2];
  uint32_t dsh[NK / 8][4], dsl[NK / 8][4];
  // a stage's planes: K, V, K^T
  auto k_at = [&](int st) { return ring + st * Lay::kStage; };

  b9_turn_first(pp, wg);
  mbar_wait(q_bar, 0);
  mbar_wait(full, 0);
  b9_turn_wait(pp, wg);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  tf_product_ss<D, NK, QT, KT>(s, base, row0, k_at(0));
  tf_product_ss<D, NK, QT, KT>(dp, base + Lay::kQ, row0, k_at(0) + Lay::kK);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  b9_turn_pass(pp, wg, false);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_fence_acc(s);
  wg_fence_acc(dp);
  if (kMask && n_tiles == 1)
    b9_q_ds<NK, true>(s, dp, z0, z1, di0, di1, a.scale, a.Lk);
  else
    b9_q_ds<NK, false>(s, dp, z0, z1, di0, di1, a.scale, NK);
  tf_split_frag<NK>(s, dsh, dsl);

  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % ST, pst = (t - 1) % ST;
    mbar_wait(full + 8 * st, (t / ST) & 1);
    b9_turn_wait(pp, wg);
    wg_fence_acc(part);
    wg_fence_frag(dsh);
    wg_fence_frag(dsl);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    tf_product_ss<D, NK, QT, KT>(s, base, row0, k_at(st));
    tf_product_ss<D, NK, QT, KT>(dp, base + Lay::kQ, row0, k_at(st) + Lay::kK);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    tf_product_rs<NK, D, KtT>(part, dsh, dsl, k_at(pst) + 2 * Lay::kK);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    b9_turn_pass(pp, wg, false);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S, dP of tile t
    wg_fence_acc(s);
    wg_fence_acc(dp);
    if (kMask && t == n_tiles - 1)
      b9_q_ds<NK, true>(s, dp, z0, z1, di0, di1, a.scale, a.Lk - t * NK);
    else
      b9_q_ds<NK, false>(s, dp, z0, z1, di0, di1, a.scale, NK);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // dQ of tile t - 1
    wg_fence_acc(part);
    wg_fence_frag(dsh);
    wg_fence_frag(dsl);
    if ((tid & 127) == 0) mbar_arrive(empty + 8 * pst);
    tf_add(dq, part);
    tf_split_frag<NK>(s, dsh, dsl);
  }
  {
    b9_turn_wait(pp, wg);
    wg_fence_acc(part);
    wg_fence_frag(dsh);
    wg_fence_frag(dsl);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    tf_product_rs<NK, D, KtT>(part, dsh, dsl, k_at((n_tiles - 1) % ST) + 2 * Lay::kK);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    b9_turn_pass(pp, wg, true);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(part);
    tf_add(dq, part);
  }
  tf_store<D>(dq, a.dq + (size_t)bh * a.Lq * D, q0 + row0, a.Lq);
}

template <int D, int WG, int NK, int ST, bool kMask>
__global__ void __launch_bounds__(TfQLayout<D, WG, NK, ST>::kThreads, 1)
flash_bwd_dq_f32_sm90_kernel(const __grid_constant__ CUtensorMap tmap_q,
                             const __grid_constant__ CUtensorMap tmap_k,
                             const __grid_constant__ CUtensorMap tmap_v,
                             const __grid_constant__ CUtensorMap tmap_do,
                             const __grid_constant__ CUtensorMap tmap_kt, TfBwdArgs a) {
  using Lay = TfQLayout<D, WG, NK, ST>;
  extern __shared__ unsigned char tf_smem[];
  const uint32_t base = (wg_smem_addr(tf_smem) + 1023u) & ~1023u;
  const uint32_t ring = base + Lay::kRing;
  const uint32_t q_bar = base + Lay::kBars;
  const uint32_t full = q_bar + 8, empty = full + 8 * ST;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * 64 * WG;
  const int n_tiles = (a.Lk + NK - 1) / NK;
  const int active = min(WG, (a.Lq - q0 + 63) / 64);
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, active);  // one arrive per active consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WG) {
    if constexpr (WG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(tf_producer_regs(WG)));
    if (tid == 128 * WG) {  // the producer thread
      mbar_arrive_expect_tx(q_bar, 2 * Lay::kQ);
      tf_load<typename Lay::QTile>(base, &tmap_q, q_bar, 0, q0, bh);
      tf_load<typename Lay::QTile>(base + Lay::kQ, &tmap_do, q_bar, 0, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        mbar_wait(empty + 8 * s, ((t / ST) & 1) ^ 1);
        const uint32_t kd = ring + s * Lay::kStage;
        mbar_arrive_expect_tx(full + 8 * s, Lay::kStage);
        tf_load<typename Lay::KTile>(kd, &tmap_k, full + 8 * s, 0, t * NK, bh);
        tf_load<typename Lay::KTile>(kd + Lay::kK, &tmap_v, full + 8 * s, 0, t * NK, bh);
        tf_load<typename Lay::KtTile>(kd + 2 * Lay::kK, &tmap_kt, full + 8 * s, t * NK, 0, bh);
      }
    }
  } else {
    if constexpr (WG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(tf_consumer_regs(WG)));
    if (warp / 4 < active) tf_q_consume<D, WG, NK, ST, kMask>(a, base, n_tiles, q0, bh, active == 2);
  }
}

// Hold the backward's part of the plan to these bodies at head dim D and to
// the shapes, then run the pre-pass into scratch (and di), the dK/dV kernel
// and the dQ kernel.
template <int D, int KWG, int NQ, int KST, int QWG, int NK, int QST>
int launch_flash_bwd_f32_sm90(const F32Plan& p, const float* q, const float* k, const float* v,
                              const float* o, const float* dout, float* scratch,
                              const TfBwdArgs& a, int B, int H, cudaStream_t stream) {
  using KvLay = TfKvLayout<D, KWG, NQ, KST>;
  using QLay = TfQLayout<D, QWG, NK, QST>;
  const long long bh = (long long)B * H;
  const int Lq = a.Lq, Lk = a.Lk;
  const long long kv[10] = {64 * KWG, NQ, KST, KvLay::kThreads, (long long)KvLay::kSmem,
                            (Lk + 64 * KWG - 1) / (64 * KWG), bh, Lq % NQ != 0, D, 1};
  const long long qq[10] = {64 * QWG, NK, QST, QLay::kThreads, (long long)QLay::kSmem,
                            (Lq + 64 * QWG - 1) / (64 * QWG), bh, Lk % NK != 0, D, 1};
  const int lqp = (Lq + 7) / 8 * 8, lkp = (Lk + 7) / 8 * 8;
  bool ok = p.body == 0 && scratch != nullptr && bh <= 65535 && p.lq_pitch == lqp &&
            p.lk_pitch == lkp;
  for (int i = 0; ok && i < 10; ++i) ok = p.dkdv[i] == kv[i] && p.dq[i] == qq[i];
  // each kernel's maps, its own boxes over the same planes: the dK/dV
  // kernel's q, k, v, do ("rows") and q^T, do^T ("cols"), the dQ kernel's
  // q, k, v, do and k^T
  for (int i = 0; ok && i < 4; ++i) ok = p.map[kMapQq + i].offset == p.map[kMapKq + i].offset;
  CUtensorMap kvm[6], qm[5];
  ok = ok && tf_encode(&kvm[0], scratch, p.bwd_scratch, p.map[kMapKq], bh, Lq, D, 32, NQ) &&
       tf_encode(&kvm[1], scratch, p.bwd_scratch, p.map[kMapKk], bh, Lk, D, 32, 64 * KWG) &&
       tf_encode(&kvm[2], scratch, p.bwd_scratch, p.map[kMapKv], bh, Lk, D, 32, 64 * KWG) &&
       tf_encode(&kvm[3], scratch, p.bwd_scratch, p.map[kMapKdo], bh, Lq, D, 32, NQ) &&
       tf_encode(&kvm[4], scratch, p.bwd_scratch, p.map[kMapKqt], bh, D, lqp, KvLay::QtTile::kChunkCols, D) &&
       tf_encode(&kvm[5], scratch, p.bwd_scratch, p.map[kMapKdot], bh, D, lqp, KvLay::QtTile::kChunkCols, D) &&
       tf_encode(&qm[0], scratch, p.bwd_scratch, p.map[kMapQq], bh, Lq, D, 32, 64 * QWG) &&
       tf_encode(&qm[1], scratch, p.bwd_scratch, p.map[kMapQk], bh, Lk, D, 32, NK) &&
       tf_encode(&qm[2], scratch, p.bwd_scratch, p.map[kMapQv], bh, Lk, D, 32, NK) &&
       tf_encode(&qm[3], scratch, p.bwd_scratch, p.map[kMapQdo], bh, Lq, D, 32, 64 * QWG) &&
       tf_encode(&qm[4], scratch, p.bwd_scratch, p.map[kMapQkt], bh, D, lkp, QLay::KtTile::kChunkCols, D);
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
  cudaError_t err = (cudaError_t)tf_prep(jobs, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_f32_sm90_kernel<D, KWG, NQ, KST, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)KvLay::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkdv_f32_sm90_kernel<D, KWG, NQ, KST, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)KvLay::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_f32_sm90_kernel<D, QWG, NK, QST, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)QLay::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_f32_sm90_kernel<D, QWG, NK, QST, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)QLay::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 kv_grid((unsigned)kv[5], (unsigned)bh), q_grid((unsigned)qq[5], (unsigned)bh);
  if (kv[7])
    flash_bwd_dkdv_f32_sm90_kernel<D, KWG, NQ, KST, true><<<kv_grid, KvLay::kThreads,
                                                            KvLay::kSmem, stream>>>(
        kvm[0], kvm[1], kvm[2], kvm[3], kvm[4], kvm[5], a);
  else
    flash_bwd_dkdv_f32_sm90_kernel<D, KWG, NQ, KST, false><<<kv_grid, KvLay::kThreads,
                                                             KvLay::kSmem, stream>>>(
        kvm[0], kvm[1], kvm[2], kvm[3], kvm[4], kvm[5], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (qq[7])
    flash_bwd_dq_f32_sm90_kernel<D, QWG, NK, QST, true>
        <<<q_grid, QLay::kThreads, QLay::kSmem, stream>>>(qm[0], qm[1], qm[2], qm[3], qm[4], a);
  else
    flash_bwd_dq_f32_sm90_kernel<D, QWG, NK, QST, false>
        <<<q_grid, QLay::kThreads, QLay::kSmem, stream>>>(qm[0], qm[1], qm[2], qm[3], qm[4], a);
  return (int)cudaGetLastError();
}

}  // namespace
