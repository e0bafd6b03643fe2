// The float32 head-major flash-attention forward designed for Hopper
// (sm_90a) as split TF32 on the tensor cores, for head dims 64 and 128:
// csrc/flash_fwd.cu gvq_flash_fwd_hm_f32 at those D (256 and 512 run its
// wide form, csrc/flash_fwd_f32_sm90_wide.cuh).
//
// Replaces the TPU kernel behind the forward of
// vqvae_from_gaussian_vae_tpu/ops/flash_attention.py (flash_attention and
// _fwd -> the upstream Pallas _flash_attention_impl), which runs float32
// at the global matmul precision: o = softmax(q k^T * scale) v per (batch,
// head), z = m + ln(sum) of each row where asked for.  Numerics: float32
// scores (three TF32 passes, csrc/flash_f32_sm90.cuh), scaled in float32;
// the accurate expf; p kept in float32 and split for the P V product (three
// passes); the row sum over the float32 p; 1/sum applied once at the end.
//
// What bounds it on an H100: the tensor cores.  At (1, 12, 8192, 64) a
// launch is 2.06e11 FLOP of the function, 6.2e11 of TF32 issue in three
// passes: 1.25 ms at 495 TFLOP/s, against 101 MB of q, k, v, o (0.03 ms)
// and the pre-pass's 50 MB read and 151 MB written.
//
// The design, against a CUDA-core kernel's one shared-memory load per FMA:
// 1. The pre-pass (tf_prep_kernel, one launch) writes q and k as "rows"
//    planes and v as a "cols" plane (V^T, keys permuted in 8s): every
//    wgmma operand then arrives by TMA in the layout its product reads.
// 2. S = Q K^T is wgmma.m64n{keys}k8 .tf32 in three passes, both operands
//    K-major in shared memory; S stays in the accumulator's registers and
//    the online softmax runs there (f9_softmax of flash_fwd_sm90.cuh).
// 3. O += P V: P split in registers into .RS fragments (tf_split_frag), B =
//    V^T.  Each tile's P V starts from a zero accumulator and is added into
//    O, which stays in registers, on the CUDA cores: the tensor cores'
//    float32 sums truncate, and one chain over all keys drifts with L
//    toward the 1e-4 bar.
// 4. One producer thread keeps a ring of K and V^T tiles (both planes) in
//    flight with TMA and full / empty mbarriers; Q (both planes) is copied
//    once.  Each consumer warpgroup issues tile t's S and tile t-1's P V
//    back to back and runs tile t's softmax while P V runs.
// Tiles (TfFwdLayout, mirrored in flash_f32_plan), the fastest of those
// tried on an H100: two consumer warpgroups (128 q rows) at both head dims
// and a 3-stage ring of 32-key tiles at D = 64 (Q 64 KB + 3 x 32 KB) or
// 16-key tiles at D = 128 (Q 128 KB + 3 x 32 KB); the ring's depth mattered
// most.  setmaxnreg gives the consumers 232 registers.
//
// Ragged shapes: TMA's zero fill past Lq and Lk (and the pre-pass's zeros
// past Lk in V^T); a zero-filled key scores -inf before the row max in the
// last tile (kMask); rows past Lq are computed on zeros and not stored.
#pragma once

#include "flash_f32_sm90.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

template <int D, int WG, int NK, int ST>
struct TfFwdLayout {
  using QTile = TfTile<64 * WG, D>;
  using KTile = TfTile<NK, D>;
  using VTile = TfTile<D, NK>;  // V^T
  static constexpr int kThreads = 128 * (WG + 1);
  static constexpr uint32_t kQ = 2 * QTile::kBytes;
  static constexpr uint32_t kK = 2 * KTile::kBytes;
  static constexpr uint32_t kStage = kK + 2 * VTile::kBytes;
  static constexpr uint32_t kBars = kQ + ST * kStage;  // Q full; per stage K full, V full, empty
  static constexpr size_t kSmem = kBars + (1 + 3 * ST) * 8 + 1024;  // + alignment slack
};

struct TfFwdArgs {
  float* o;
  float* z;  // (B, H, Lq), or null
  int Lq, Lk;
  float scale;
};

template <int D, int WG, int NK, int ST, bool kMask>
__device__ __forceinline__ void tf_fwd_consume(const TfFwdArgs& a, uint32_t base, int n_tiles,
                                               int q0, int bh) {
  using Lay = TfFwdLayout<D, WG, NK, ST>;
  using QT = typename Lay::QTile;
  using KT = typename Lay::KTile;
  using VT = typename Lay::VTile;
  const uint32_t ring = base + Lay::kQ;
  const uint32_t q_bar = base + Lay::kBars;
  const uint32_t k_full = q_bar + 8, v_full = k_full + 8 * ST, empty = v_full + 8 * ST;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  // a tile's P V runs by blocks of DH columns of D: all of D at 64; at 128
  // two blocks one after the other, so that O, one block's P V and P fit
  // the registers
  constexpr int DH = D == 128 ? 64 : D;
  float o[D / 2], pv[DH / 2];  // the running output; one block of a tile's P V
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float s[NK / 2];
  uint32_t ph[NK / 8][4], pl[NK / 8][4];
  // o (block hh) = (o + pv) * alpha, alpha.x on rows r, alpha.y on r + 8
  auto fold = [&](int hh, float2 alpha) {
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      float* oj = o + hh * (DH / 2) + 4 * j;
      oj[0] = (oj[0] + pv[4 * j]) * alpha.x;
      oj[1] = (oj[1] + pv[4 * j + 1]) * alpha.x;
      oj[2] = (oj[2] + pv[4 * j + 2]) * alpha.y;
      oj[3] = (oj[3] + pv[4 * j + 3]) * alpha.y;
    }
  };
  // the P V blocks after the first, each issued, waited for and folded in
  auto rest = [&](uint32_t va, float2 alpha) {
#pragma unroll
    for (int hh = 1; hh < D / DH; ++hh) {
      wg_fence_acc(pv);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      tf_product_rs<NK, DH, VT>(pv, ph, pl, va, hh * DH);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      wg_fence_acc(pv);
      fold(hh, alpha);
    }
  };
  float m0 = -INFINITY, m1 = -INFINITY;  // running maxima of rows r and r + 8
  float l0 = 0.0f, l1 = 0.0f;            // this thread's shares of their sums

  mbar_wait(q_bar, 0);
  mbar_wait(k_full, 0);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  tf_product_ss<D, NK, QT, KT>(s, base, 64 * wg, ring);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_fence_acc(s);
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
    tf_product_ss<D, NK, QT, KT>(s, base, 64 * wg, ring + st * Lay::kStage);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    tf_product_rs<NK, DH, VT>(pv, ph, pl, ring + pst * Lay::kStage + Lay::kK);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S of tile t
    wg_fence_acc(s);
    const float2 alpha = kMask && t == n_tiles - 1
                             ? f9_softmax<true>(s, m0, m1, l0, l1, a.scale, a.Lk - t * NK)
                             : f9_softmax<false>(s, m0, m1, l0, l1, a.scale, NK);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // P V of tile t - 1
    wg_fence_acc(pv);
    wg_fence_frag(ph);
    wg_fence_frag(pl);
    fold(0, alpha);
    rest(ring + pst * Lay::kStage + Lay::kK, alpha);
    if ((tid & 127) == 0) mbar_arrive(empty + 8 * pst);
    tf_split_frag<NK>(s, ph, pl);
  }
  {
    const int last = (n_tiles - 1) % ST;
    mbar_wait(v_full + 8 * last, ((n_tiles - 1) / ST) & 1);
    wg_fence_acc(pv);
    wg_fence_frag(ph);
    wg_fence_frag(pl);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    tf_product_rs<NK, DH, VT>(pv, ph, pl, ring + last * Lay::kStage + Lay::kK);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(pv);
    fold(0, make_float2(1.0f, 1.0f));
    rest(ring + last * Lay::kStage + Lay::kK, make_float2(1.0f, 1.0f));
  }

  // the rows' sums from the quad's shares; 1/sum once; rows past Lq are
  // not stored
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  tf_store<D>(o, a.o + (size_t)bh * a.Lq * D, q0 + wg * 64, a.Lq, 1.0f / l0, 1.0f / l1);
  if (a.z != nullptr && (lane & 3) == 0) {
    const int r0 = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
    float* zb = a.z + (size_t)bh * a.Lq;
    if (r0 < a.Lq) zb[r0] = m0 + logf(l0);
    if (r0 + 8 < a.Lq) zb[r0 + 8] = m1 + logf(l1);
  }
}

template <int D, int WG, int NK, int ST, bool kMask>
__global__ void __launch_bounds__(TfFwdLayout<D, WG, NK, ST>::kThreads, 1)
flash_fwd_f32_sm90_kernel(const __grid_constant__ CUtensorMap tmap_q,
                          const __grid_constant__ CUtensorMap tmap_k,
                          const __grid_constant__ CUtensorMap tmap_vt, TfFwdArgs a) {
  using Lay = TfFwdLayout<D, WG, NK, ST>;
  extern __shared__ unsigned char tf_smem[];
  const uint32_t base = (wg_smem_addr(tf_smem) + 1023u) & ~1023u;  // the swizzle's 1024-byte atom
  const uint32_t ring = base + Lay::kQ;
  const uint32_t q_bar = base + Lay::kBars;
  const uint32_t k_full = q_bar + 8, v_full = k_full + 8 * ST, empty = v_full + 8 * ST;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * 64 * WG;
  const int n_tiles = (a.Lk + NK - 1) / NK;
  // warpgroups whose 64 rows all lie past Lq compute nothing
  const int active = min(WG, (a.Lq - q0 + 63) / 64);
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + 8 * s, 1);      // the producer's arrive; the copies' bytes
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, active);  // one arrive per active consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if / else over warpgroups that never reconverges; with two
  // consumer warpgroups setmaxnreg moves the producer's registers to them
  if (warp >= 4 * WG) {
    if constexpr (WG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(tf_producer_regs(WG)));
    if (tid == 128 * WG) {  // the producer thread
      mbar_arrive_expect_tx(q_bar, Lay::kQ);
      tf_load<typename Lay::QTile>(base, &tmap_q, q_bar, 0, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        mbar_wait(empty + 8 * s, ((t / ST) & 1) ^ 1);  // a fresh stage passes
        const uint32_t kd = ring + s * Lay::kStage;
        mbar_arrive_expect_tx(k_full + 8 * s, Lay::kK);
        tf_load<typename Lay::KTile>(kd, &tmap_k, k_full + 8 * s, 0, t * NK, bh);
        mbar_arrive_expect_tx(v_full + 8 * s, Lay::kStage - Lay::kK);
        tf_load<typename Lay::VTile>(kd + Lay::kK, &tmap_vt, v_full + 8 * s, t * NK, 0, bh);
      }
    }
  } else {
    if constexpr (WG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(tf_consumer_regs(WG)));
    if (warp / 4 < active) tf_fwd_consume<D, WG, NK, ST, kMask>(a, base, n_tiles, q0, bh);
  }
}

template <int D, int WG, int NK, int ST, bool kMask>
int launch_tf_fwd(const CUtensorMap (&m)[3], const TfFwdArgs& a, dim3 grid, cudaStream_t stream) {
  using Lay = TfFwdLayout<D, WG, NK, ST>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_sm90_kernel<D, WG, NK, ST, kMask>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Lay::kSmem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_f32_sm90_kernel<D, WG, NK, ST, kMask>
      <<<grid, Lay::kThreads, Lay::kSmem, stream>>>(m[0], m[1], m[2], a);
  return (int)cudaGetLastError();
}

// Hold the forward's part of the plan to this body at head dim D and to
// the shapes, run the pre-pass into scratch (q, k "rows", v "cols") and
// launch the kernel.
template <int D, int WG, int NK, int ST>
int launch_flash_fwd_f32_sm90(const F32Plan& p, const float* q, const float* k, const float* v,
                              float* o, float* z, float* scratch, int B, int H, int Lq, int Lk,
                              float scale, cudaStream_t stream) {
  using Lay = TfFwdLayout<D, WG, NK, ST>;
  const long long bh = (long long)B * H;
  const long long f[10] = {64 * WG, NK, ST, Lay::kThreads, (long long)Lay::kSmem,
                           (Lq + 64 * WG - 1) / (64 * WG), bh, Lk % NK != 0, D, 1};
  bool ok = p.body == 0 && scratch != nullptr && bh <= 65535 && p.lk_pitch == (Lk + 7) / 8 * 8;
  for (int i = 0; ok && i < 10; ++i) ok = p.fwd[i] == f[i];
  CUtensorMap maps[3];
  ok = ok &&
       tf_encode(&maps[0], scratch, p.fwd_scratch, p.map[kMapFq], bh, Lq, D, 32, 64 * WG) &&
       tf_encode(&maps[1], scratch, p.fwd_scratch, p.map[kMapFk], bh, Lk, D, 32, NK) &&
       tf_encode(&maps[2], scratch, p.fwd_scratch, p.map[kMapFvt], bh, D, (int)p.lk_pitch,
                 Lay::VTile::kChunkCols, D);
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
  const dim3 grid((unsigned)f[5], (unsigned)bh);
  return f[7] ? launch_tf_fwd<D, WG, NK, ST, true>(maps, a, grid, stream)
              : launch_tf_fwd<D, WG, NK, ST, false>(maps, a, grid, stream);
}

}  // namespace
