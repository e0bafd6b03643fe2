// The float32 head-major flash-attention forward designed for Hopper
// (sm_90a) as split TF32 on the tensor cores, for head dims 256 and 512:
// csrc/flash_fwd.cu gvq_flash_fwd_hm_f32 at those D (64 and 128 run
// csrc/flash_fwd_f32_sm90.cuh, whose numerics and pre-pass this body
// shares).
//
// Replaces the TPU kernel behind the forward of
// vqvae_from_gaussian_vae_tpu/ops/flash_attention.py (flash_attention and
// _fwd -> the upstream Pallas _flash_attention_impl) at those D, float32 at
// the global matmul precision: o = softmax(q k^T * scale) v per (batch,
// head), z = m + ln(sum) of each row where asked for.  Numerics as the
// D = 64 body: float32 scores in three TF32 passes (csrc/flash_f32_sm90.cuh),
// the accurate expf, p kept in float32 and split for P V (three passes),
// each tile's P V added into O on the CUDA cores, 1/sum once at the end.
//
// What bounds it on an H100: the tensor cores.  At (4, 2, 1024, 1024, 256)
// a launch is 8.6e9 FLOP of the function, 2.6e10 of TF32 issue in three
// passes: 0.052 ms at 495 TFLOP/s, against 34 MB of q, k, v, o (0.010 ms)
// and the pre-pass's 25 MB read and 50 MB written.
//
// The design, against shared memory.  Every operand is two float32 planes
// (hi, lo), so a resident 64-row Q tile over all of D is 128 KB at D = 256
// and 256 KB at 512, beyond a block's 227 KB with a ring beside it.
// 1. A block owns 64 q rows of one (b, h) and C of D's columns (TwFwdLayout:
//    C = 128); the D / C blocks of a q tile form a cluster along the grid's
//    z.  Its share of Q (both planes) is copied once; a producer thread
//    keeps a ring of the share's K and V^T tiles (NK keys) in flight with
//    TMA on full / empty mbarriers.
// 2. Each block forms the partial S = Q K^T over its C columns (wgmma
//    m64n{NK}k8 .tf32, three passes) and tw_exchange sums the D / C
//    partials in rank order over the cluster by st.async: every block holds
//    the same bits of S and runs the same online softmax (f9_softmax of
//    flash_fwd_sm90.cuh) on them.
// 3. O (64 x C, this block's columns, 64 registers a thread) += P V: P
//    split in registers into .RS fragments, B = the share of V^T, N = C.
//    Tile t's S and tile t-1's P V are issued back to back, and the
//    exchange and softmax of tile t run while P V runs.
// 4. Rank 0 writes z; each block stores its columns of o.
// One consumer warpgroup and a producer warpgroup (256 threads); the
// consumer's registers: O 64, one tile's P V 64, S NK / 2, P's fragments
// NK / 2.
//
// Ragged shapes as the D = 64 body: TMA's zero fill past Lq and Lk (and the
// pre-pass's zeros past Lk in V^T); a zero-filled key scores -inf before
// the row max in the last tile (kMask); rows past Lq are computed on zeros
// and not stored.
#pragma once

#include "flash_fwd_f32_sm90.cuh"

namespace {

// Shared memory, from a 1024-byte-aligned base: the share of Q, the ring's
// stages (a share of K and of V^T each), the exchange of the partial
// scores, then the mbarriers (Q full; per stage K full, V full, empty; the
// exchange's two).
template <int D, int C, int NK, int ST>
struct TwFwdLayout {
  static constexpr int kSplits = D / C;  // blocks of a cluster
  using QTile = TfTile<64, C>;
  using KTile = TfTile<NK, C>;
  using VTile = TfTile<C, NK>;  // V^T, the share's rows
  using X = TwExchange<NK / 2, kSplits>;
  static constexpr int kThreads = 256;
  static constexpr uint32_t kQ = 2 * QTile::kBytes;
  static constexpr uint32_t kK = 2 * KTile::kBytes;
  static constexpr uint32_t kStage = kK + 2 * VTile::kBytes;
  static constexpr uint32_t kX = kQ + ST * kStage;
  static constexpr uint32_t kBars = kX + X::kBytes;
  static constexpr size_t kSmem = kBars + (3 + 3 * ST) * 8 + 1024;  // + alignment slack
};

template <int D, int C, int NK, int ST, bool kMask>
__device__ __forceinline__ void tw_fwd_consume(const TfFwdArgs& a, uint32_t base,
                                               const unsigned char* basep, int n_tiles, int q0,
                                               int c0, int bh, uint32_t rank) {
  using Lay = TwFwdLayout<D, C, NK, ST>;
  using QT = typename Lay::QTile;
  using KT = typename Lay::KTile;
  using VT = typename Lay::VTile;
  constexpr int N = Lay::kSplits;
  const uint32_t ring = base + Lay::kQ;
  const uint32_t q_bar = base + Lay::kBars;
  const uint32_t k_full = q_bar + 8, v_full = k_full + 8 * ST, empty = v_full + 8 * ST;
  const uint32_t x_bars = empty + 8 * ST;
  const unsigned char* xp = basep + Lay::kX;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float o[C / 2], pv[C / 2];  // the running output; one tile's P V
#pragma unroll
  for (int i = 0; i < C / 2; ++i) o[i] = 0.0f;
  float s[NK / 2];
  uint32_t ph[NK / 8][4], pl[NK / 8][4];
  float m0 = -INFINITY, m1 = -INFINITY;  // running maxima of rows r and r + 8
  float l0 = 0.0f, l1 = 0.0f;            // this thread's shares of their sums
  // o = (o + pv) * alpha, alpha.x on rows r, alpha.y on r + 8
  auto fold = [&](float2 alpha) {
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      o[4 * j] = (o[4 * j] + pv[4 * j]) * alpha.x;
      o[4 * j + 1] = (o[4 * j + 1] + pv[4 * j + 1]) * alpha.x;
      o[4 * j + 2] = (o[4 * j + 2] + pv[4 * j + 2]) * alpha.y;
      o[4 * j + 3] = (o[4 * j + 3] + pv[4 * j + 3]) * alpha.y;
    }
  };

  mbar_wait(q_bar, 0);
  mbar_wait(k_full, 0);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  tf_product_ss<C, NK, QT, KT>(s, base, 0, ring);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_fence_acc(s);
  tw_exchange<NK / 2, N>(s, base + Lay::kX, xp, x_bars, rank, 0);
  if (kMask && n_tiles == 1)
    f9_softmax<true>(s, m0, m1, l0, l1, a.scale, a.Lk);
  else
    f9_softmax<false>(s, m0, m1, l0, l1, a.scale, NK);
  tf_split_frag<NK>(s, ph, pl);

  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % ST, pst = (t - 1) % ST;
    mbar_wait(k_full + 8 * st, (t / ST) & 1);
    mbar_wait(v_full + 8 * pst, ((t - 1) / ST) & 1);
    wg_fence_acc(pv);
    wg_fence_frag(ph);
    wg_fence_frag(pl);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    tf_product_ss<C, NK, QT, KT>(s, base, 0, ring + st * Lay::kStage);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    tf_product_rs<NK, C, VT>(pv, ph, pl, ring + pst * Lay::kStage + Lay::kK);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S of tile t
    wg_fence_acc(s);
    tw_exchange<NK / 2, N>(s, base + Lay::kX, xp, x_bars, rank, t);
    const float2 alpha = kMask && t == n_tiles - 1
                             ? f9_softmax<true>(s, m0, m1, l0, l1, a.scale, a.Lk - t * NK)
                             : f9_softmax<false>(s, m0, m1, l0, l1, a.scale, NK);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // P V of tile t - 1
    wg_fence_acc(pv);
    wg_fence_frag(ph);
    wg_fence_frag(pl);
    fold(alpha);
    if (tid == 0) mbar_arrive(empty + 8 * pst);
    tf_split_frag<NK>(s, ph, pl);
  }
  {
    const int last = (n_tiles - 1) % ST;
    mbar_wait(v_full + 8 * last, ((n_tiles - 1) / ST) & 1);
    wg_fence_acc(pv);
    wg_fence_frag(ph);
    wg_fence_frag(pl);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    tf_product_rs<NK, C, VT>(pv, ph, pl, ring + last * Lay::kStage + Lay::kK);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(pv);
    fold(make_float2(1.0f, 1.0f));
  }

  // the rows' sums from the quad's shares (the same bits in every block of
  // the cluster); 1/sum once; rows past Lq are not stored
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  tw_store<C>(o, a.o + (size_t)bh * a.Lq * D + c0, D, q0, a.Lq, 1.0f / l0, 1.0f / l1);
  if (rank == 0 && a.z != nullptr && (lane & 3) == 0) {
    const int r0 = q0 + warp * 16 + (lane >> 2);
    float* zb = a.z + (size_t)bh * a.Lq;
    if (r0 < a.Lq) zb[r0] = m0 + logf(l0);
    if (r0 + 8 < a.Lq) zb[r0 + 8] = m1 + logf(l1);
  }
}

template <int D, int C, int NK, int ST, bool kMask>
__global__ void __launch_bounds__(256, 1)
flash_fwd_f32_wide_kernel(const __grid_constant__ CUtensorMap tmap_q,
                          const __grid_constant__ CUtensorMap tmap_k,
                          const __grid_constant__ CUtensorMap tmap_vt, TfFwdArgs a) {
  using Lay = TwFwdLayout<D, C, NK, ST>;
  extern __shared__ unsigned char tf_smem[];
  const uint32_t raw = wg_smem_addr(tf_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's 1024-byte atom
  const unsigned char* basep = tf_smem + (base - raw);
  const uint32_t ring = base + Lay::kQ;
  const uint32_t q_bar = base + Lay::kBars;
  const uint32_t k_full = q_bar + 8, v_full = k_full + 8 * ST, empty = v_full + 8 * ST;
  const uint32_t x_bars = empty + 8 * ST;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const uint32_t rank = gvq::cluster_rank();  // blockIdx.z: the cluster lies along z
  const int c0 = C * (int)rank;
  const int n_tiles = (a.Lk + NK - 1) / NK;
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + 8 * s, 1);  // the producer's arrive; the copies' bytes
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);   // the consumer warpgroup's arrive
    }
    mbar_init(x_bars, 1);  // the arming arrive; the other blocks' bytes
    mbar_init(x_bars + 8, 1);
  }
  tw_start();

  if (tid >= 128) {
    if (tid == 128) {  // the producer thread
      mbar_arrive_expect_tx(q_bar, Lay::kQ);
      tf_load<typename Lay::QTile>(base, &tmap_q, q_bar, c0, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        mbar_wait(empty + 8 * s, ((t / ST) & 1) ^ 1);  // a fresh stage passes
        const uint32_t kd = ring + s * Lay::kStage;
        mbar_arrive_expect_tx(k_full + 8 * s, Lay::kK);
        tf_load<typename Lay::KTile>(kd, &tmap_k, k_full + 8 * s, c0, t * NK, bh);
        mbar_arrive_expect_tx(v_full + 8 * s, Lay::kStage - Lay::kK);
        tf_load<typename Lay::VTile>(kd + Lay::kK, &tmap_vt, v_full + 8 * s, t * NK, c0, bh);
      }
    }
  } else {
    tw_fwd_consume<D, C, NK, ST, kMask>(a, base, basep, n_tiles, q0, c0, bh, rank);
  }
}

// Hold the forward's part of the plan to this body at head dim D and
// tiling (C, NK, ST) and to the shapes, run the pre-pass into scratch (q, k
// "rows", v "cols") and launch the kernel.
template <int D, int C, int NK, int ST>
int launch_flash_fwd_f32_wide(const F32Plan& p, const float* q, const float* k, const float* v,
                              float* o, float* z, float* scratch, int B, int H, int Lq, int Lk,
                              float scale, cudaStream_t stream) {
  using Lay = TwFwdLayout<D, C, NK, ST>;
  static_assert(Lay::kSmem <= 232448, "a block's shared memory");
  const long long bh = (long long)B * H;
  const long long f[10] = {64, NK, ST, Lay::kThreads, (long long)Lay::kSmem, (Lq + 63) / 64, bh,
                           Lk % NK != 0, C, D / C};
  bool ok = p.body == 1 && scratch != nullptr && bh <= 65535 && p.lk_pitch == (Lk + 7) / 8 * 8;
  for (int i = 0; ok && i < 10; ++i) ok = p.fwd[i] == f[i];
  CUtensorMap maps[3];
  ok = ok &&
       tf_encode(&maps[0], scratch, p.fwd_scratch, p.map[kMapFq], bh, Lq, D, 32, 64) &&
       tf_encode(&maps[1], scratch, p.fwd_scratch, p.map[kMapFk], bh, Lk, D, 32, NK) &&
       tf_encode(&maps[2], scratch, p.fwd_scratch, p.map[kMapFvt], bh, D, (int)p.lk_pitch,
                 Lay::VTile::kChunkCols, C);
  if (!ok) return (int)cudaErrorInvalidValue;
  TfJobs jobs{};
  jobs.n = 3;
  jobs.job[0] = tf_job(kTfRows, q, nullptr, scratch + p.map[kMapFq].offset, bh, Lq, D, 0);
  jobs.job[1] = tf_job(kTfRows, k, nullptr, scratch + p.map[kMapFk].offset, bh, Lk, D, 0);
  jobs.job[2] = tf_job(kTfCols, v, nullptr, scratch + p.map[kMapFvt].offset, bh, Lk, D,
                       (int)p.lk_pitch);
  const int err = tf_prep(jobs, stream);
  if (err != 0) return err;
  const TfFwdArgs a{o, z, Lq, Lk, scale};
  const dim3 grid((unsigned)f[5], (unsigned)bh, D / C);
  return f[7] ? tw_launch(flash_fwd_f32_wide_kernel<D, C, NK, ST, true>, grid, Lay::kThreads,
                          Lay::kSmem, D / C, stream, maps[0], maps[1], maps[2], a)
              : tw_launch(flash_fwd_f32_wide_kernel<D, C, NK, ST, false>, grid, Lay::kThreads,
                          Lay::kSmem, D / C, stream, maps[0], maps[1], maps[2], a);
}

}  // namespace
