// The bf16 flash-attention forward body designed for Hopper (sm_90a), for
// head dims 256 and 512: every shipped bf16 forward entry of
// csrc/flash_fwd.cu at those D (gvq_flash_fwd, gvq_flash_fwd_res,
// gvq_flash_fwd_qkv, gvq_flash_fwd_qkv_res, gvq_flash_fwd_hm).  D = 64 and
// 128 run csrc/flash_fwd_sm90.cuh, whose softmax, plan and argument struct
// this body shares.
//
// Replaces the TPU kernels vqvae_from_gaussian_vae_tpu/ops/flash_blc.py
// _fwd_impl (the unpacked forward, body _fwd_kernel) and _fwd_res_call (the
// form with z), and the head-major forward of
// vqvae_from_gaussian_vae_tpu/ops/flash_attention.py at those D:
// o = softmax(q k^T * scale) v per (batch, head), and z = m + ln(sum) of
// each row where asked for.  Numerics follow the TPU kernel: scores in
// fp32, scaled in fp32; p rounded to bf16 before the P.V product, which
// accumulates in fp32; the row sum over the fp32 p; 1/sum applied once at
// the end; expf.
//
// What bounds it on an H100: the UNet AttnBlock at the 32x32 level (B=16,
// L=1024, H=1, D=512) is 3.44e10 FLOP a launch (0.035 ms at the bf16 peak)
// against 67 MB of device memory.  Each block re-reads its (b, h)'s K and V
// through L2: with 64 q rows a block that is 16 passes of 2 MB a sample,
// 512 MB a launch, which makes L2's bandwidth the likely limit.
//
// The design, against the register budget.  flash_fwd_sm90.cuh keeps a
// 64-row x D float32 output accumulator in one warpgroup's registers; at
// D = 512 that is 256 registers a thread, over the limit of 255.  Here:
// 1. A block owns 64 q rows of one (b, h) and has two consumer warpgroups.
//    Warpgroup w holds columns w D/2 .. of the output: 64 x D/2 float32,
//    128 registers a thread at D = 512 (O += P V is wgmma.m64n{D/2}k16,
//    A = P from registers, the .RS form, B = its half of V, MN-major).
// 2. Each warpgroup forms the whole score tile S = Q K^T (64 x 64 keys,
//    wgmma.m64n64k16, both operands K-major in shared memory) rather than
//    half of it: 1.5x the products of a split, but no exchange through
//    shared memory and no barrier between the warpgroups.  The two run the
//    same instructions on the same operands, so they hold the same bits of
//    S and of the running max, sum and rescale: their halves of o agree
//    and z (written by warpgroup 0) is that of either.
// 3. K and V come through TMA: one thread of the producer warpgroup copies
//    Q once and the K tiles, another the V tiles, each on its own full /
//    empty mbarriers, so a K tile is refilled as soon as both warpgroups'
//    S products have read it and a V tile when both P V products have.
//    Stages (64 keys x D each for K and for V): one at D = 512 (Q 64 KB +
//    K 64 KB + V 64 KB), two at D = 256.  setmaxnreg gives the consumers
//    240 registers a thread (an SM sub-partition holds a warp of each
//    warpgroup): a consumer's O, S and P take 176 at D = 512.  The score
//    product's descriptors are formed afresh for each tile from one opaque
//    base (wg_opaque): held across tiles, D / 8 of them at 64 bits each
//    would not fit.
// 4. Per key tile a warpgroup issues tile t's Q K^T and tile t-1's P V back
//    to back, and runs tile t's softmax while the P V product runs, as in
//    flash_fwd_sm90.cuh.
//
// Ragged shapes as flash_fwd_sm90.cuh: TMA's zero fill past Lq and Lk, a
// zero-filled key scored -inf before the row max in the last tile (kMask),
// rows past Lq computed on zeros and not stored.
#pragma once

#include "flash_fwd_sm90.cuh"

namespace {

constexpr int kFwRows = 64;      // q rows a block
constexpr int kFwKeys = 64;      // keys a K or V tile
constexpr int kFwThreads = 384;  // two consumer warpgroups + the producer warpgroup

// K and V stages: one at D = 512, two at D = 256 (ops/flash_attention.py
// WIDE_STAGES is the same rule)
__host__ __device__ constexpr int fw_stages(int d) { return d == 512 ? 1 : 2; }

// Shared memory, from a 1024-byte-aligned base: the Q tile, the K stages,
// the V stages, then the mbarriers (Q full; per stage K full, V full, K
// empty, V empty).  A tile of `rows` x D is D / 64 chunks of rows x 128
// bytes (64 columns each), as the 128-byte swizzle lays them.
template <int D>
struct FwLayout {
  static constexpr int kStages = fw_stages(D);
  static constexpr int kChunks = D / 64;
  static constexpr int kHalf = D / 2;  // output columns a consumer warpgroup owns
  static constexpr uint32_t kChunkQ = kFwRows * 128;
  static constexpr uint32_t kChunkKV = kFwKeys * 128;
  static constexpr uint32_t kQ = kChunks * kChunkQ;
  static constexpr uint32_t kKV = kChunks * kChunkKV;
  static constexpr uint32_t kK = kQ;                       // stage s at kK + s kKV
  static constexpr uint32_t kV = kQ + kStages * kKV;       // stage s at kV + s kKV
  static constexpr uint32_t kBars = kV + kStages * kKV;
  static constexpr size_t kSmem = kBars + (1 + 4 * kStages) * 8 + 1024;  // + alignment slack
};

// S = Q K^T for the block's 64 rows and a 64-key tile: D / 16 k-steps, each
// 16 columns = 32 bytes inside a chunk's 128-byte rows (a descriptor's
// address field counts 16-byte units)
template <int D>
__device__ __forceinline__ void fw_qk(float (&s)[32], uint32_t qa, uint32_t ka) {
  using Lay = FwLayout<D>;
  const uint64_t da = wg_opaque(wg_desc(qa, 16, 1024)), db = wg_opaque(wg_desc(ka, 16, 1024));
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<64>(s, da + ((kk >> 2) * Lay::kChunkQ + (kk & 3) * 32) / 16,
                 db + ((kk >> 2) * Lay::kChunkKV + (kk & 3) * 32) / 16, kk > 0);
}

// O (this warpgroup's half) += P V over a 64-key tile: 4 k-steps of 16 keys
// (16 rows of V, 2048 bytes); va is the half's first 64-column chunk, the
// next ones kChunkKV apart (the descriptor's LBO)
template <int D>
__device__ __forceinline__ void fw_pv(float (&o)[D / 4], const uint32_t (&p)[4][4], uint32_t va) {
  using Lay = FwLayout<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<D / 2>(o, p[kk], wg_desc(va + kk * 2048, Lay::kChunkKV, 1024));
}

// A consumer warpgroup's whole life: warpgroup wg (threadIdx.x / 128) keeps
// output columns wg D/2 .. of q rows q0 .. q0 + 63 of (b, h) = bh.  Per key
// tile t: S = Q K_t^T and O += P_{t-1} V_{t-1} issued back to back; K_t's
// stage released once S is in registers; tile t's softmax while the P V
// product runs; V_{t-1}'s stage released, O rescaled and p rounded once it
// has.  Every mbarrier wait comes before the wgmma.fence of the products
// that need it.
template <int D, bool kMask>
__device__ __forceinline__ void fw_consume(const F9Args& a, uint32_t base, int n_tiles, int q0,
                                           int bh) {
  using Lay = FwLayout<D>;
  constexpr int S = Lay::kStages;
  const uint32_t q_bar = base + Lay::kBars;
  const uint32_t k_full = q_bar + 8, v_full = k_full + 8 * S;
  const uint32_t k_empty = v_full + 8 * S, v_empty = k_empty + 8 * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const bool leader = (tid & 127) == 0;
  const uint32_t k_ring = base + Lay::kK;
  const uint32_t v_ring = base + Lay::kV + wg * (Lay::kHalf / 64) * Lay::kChunkKV;
  float o[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) o[i] = 0.0f;
  float s[32];
  uint32_t p[4][4];
  float m0 = -INFINITY, m1 = -INFINITY;  // running maxima of rows r and r + 8
  float l0 = 0.0f, l1 = 0.0f;            // this thread's shares of their sums

  mbar_wait(q_bar, 0);
  mbar_wait(k_full, 0);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  fw_qk<D>(s, base, k_ring);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_fence_acc(s);
  if (leader) mbar_arrive(k_empty);
  if (kMask && n_tiles == 1)
    f9_softmax<true>(s, m0, m1, l0, l1, a.scale, a.Lk);
  else
    f9_softmax<false>(s, m0, m1, l0, l1, a.scale, kFwKeys);
  f9_round_p(s, p);

  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % S, pst = (t - 1) % S;
    mbar_wait(k_full + 8 * st, (t / S) & 1);
    mbar_wait(v_full + 8 * pst, ((t - 1) / S) & 1);
    wg_fence_acc(o);
    wg_fence_frag(p);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    fw_qk<D>(s, base, k_ring + st * Lay::kKV);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fw_pv<D>(o, p, v_ring + pst * Lay::kKV);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // S of tile t
    wg_fence_acc(s);
    if (leader) mbar_arrive(k_empty + 8 * st);
    const float2 alpha =
        kMask && t == n_tiles - 1
            ? f9_softmax<true>(s, m0, m1, l0, l1, a.scale, a.Lk - t * kFwKeys)
            : f9_softmax<false>(s, m0, m1, l0, l1, a.scale, kFwKeys);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // P V of tile t - 1
    wg_fence_acc(o);
    wg_fence_frag(p);
    if (leader) mbar_arrive(v_empty + 8 * pst);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
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
    fw_pv<D>(o, p, v_ring + last * Lay::kKV);
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
  const int r0 = q0 + (warp & 3) * 16 + (lane >> 2);
  const int c0 = wg * Lay::kHalf + 2 * (lane & 3);
  bf16* ob = a.o + b * a.so_b + h * a.so_h + c0;
  const bool in0 = r0 < a.Lq, in1 = r0 + 8 < a.Lq;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    if (in0)
      *reinterpret_cast<uint32_t*>(ob + r0 * a.so_row + 8 * j) =
          pack_bf16x2(o[4 * j] * i0, o[4 * j + 1] * i0);
    if (in1)
      *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * a.so_row + 8 * j) =
          pack_bf16x2(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
  }
  if (a.z != nullptr && wg == 0 && (lane & 3) == 0) {
    float* zb = a.z + (size_t)bh * a.Lq;
    if (in0) zb[r0] = m0 + logf(l0);
    if (in1) zb[r0 + 8] = m1 + logf(l1);
  }
}

template <int D, bool kMask>
__global__ void __launch_bounds__(kFwThreads, 1)
flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tmap_q,
                      const __grid_constant__ CUtensorMap tmap_k,
                      const __grid_constant__ CUtensorMap tmap_v, F9Args a) {
  using Lay = FwLayout<D>;
  constexpr int S = Lay::kStages;
  extern __shared__ unsigned char fw_smem[];
  const uint32_t base = (wg_smem_addr(fw_smem) + 1023u) & ~1023u;  // the swizzle's 1024-byte atom
  const uint32_t q_bar = base + Lay::kBars;
  const uint32_t k_full = q_bar + 8, v_full = k_full + 8 * S;  // + 8 s for stage s
  const uint32_t k_empty = v_full + 8 * S, v_empty = k_empty + 8 * S;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kFwRows;
  const int n_tiles = (a.Lk + kFwKeys - 1) / kFwKeys;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full + 8 * s, 1);   // the producer's arrive; the copies' bytes
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 2);  // one arrive per consumer warpgroup
      mbar_init(v_empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if / else over warpgroups that never reconverges, so that
  // setmaxnreg moves the producer warpgroup's registers to the consumers
  if (warp >= 8) {  // producer warpgroup: thread 256 copies Q and K, thread 288 V
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 256 || tid == 288) {
      const int b = bh / a.H, h = bh - b * a.H;
      // the box of a tile whose rows start at `row`, chunk c (columns 64 c ..)
      auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int c, int row) {
        if (a.row_dim == 1)
          tma_load_4d(dst, map, bar, 64 * c, row, h, b);
        else
          tma_load_4d(dst, map, bar, 64 * c, h, row, b);
      };
      const bool is_k = tid == 256;
      const CUtensorMap* map = is_k ? &tmap_k : &tmap_v;
      const uint32_t ring = base + (is_k ? Lay::kK : Lay::kV);
      const uint32_t full = is_k ? k_full : v_full, empty = is_k ? k_empty : v_empty;
      if (is_k) {
        mbar_arrive_expect_tx(q_bar, Lay::kQ);
#pragma unroll
        for (int c = 0; c < Lay::kChunks; ++c) load(base + c * Lay::kChunkQ, &tmap_q, q_bar, c, q0);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S;
        mbar_wait(empty + 8 * s, ((t / S) & 1) ^ 1);  // a fresh stage passes
        mbar_arrive_expect_tx(full + 8 * s, Lay::kKV);
#pragma unroll
        for (int c = 0; c < Lay::kChunks; ++c)
          load(ring + s * Lay::kKV + c * Lay::kChunkKV, map, full + 8 * s, c, t * kFwKeys);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    fw_consume<D, kMask>(a, base, n_tiles, q0, bh);
  }
}

template <int D, bool kMask>
int launch_fw(const CUtensorMap (&maps)[3], const F9Args& a, dim3 grid, cudaStream_t stream) {
  const size_t smem = FwLayout<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wide_kernel<D, kMask>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_wide_kernel<D, kMask><<<grid, kFwThreads, smem, stream>>>(maps[0], maps[1], maps[2],
                                                                      a);
  return (int)cudaGetLastError();
}

// The plan (ops/flash_attention.py flash_fwd_plan, body 2) held to this
// body and the entry's shapes by fwd_plan_args (flash_fwd_sm90.cuh), then
// the launch.
inline int launch_flash_fwd_wide(const FwdPlan& p, const bf16* const (&bases)[3], bf16* o,
                                 float* z, int B, int H, int Lq, int Lk, int D, float scale,
                                 cudaStream_t stream) {
  CUtensorMap maps[3];
  F9Args a;
  if ((D != 256 && D != 512) ||
      !fwd_plan_args(p, 2, kFwRows, kFwKeys, fw_stages(D), kFwThreads,
                     D == 512 ? FwLayout<512>::kSmem : FwLayout<256>::kSmem, bases, o, z, B, H,
                     Lq, Lk, D, scale, maps, &a))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)p.grid_x, (unsigned)p.grid_y);
  if (D == 512)
    return p.key_mask ? launch_fw<512, true>(maps, a, grid, stream)
                      : launch_fw<512, false>(maps, a, grid, stream);
  return p.key_mask ? launch_fw<256, true>(maps, a, grid, stream)
                    : launch_fw<256, false>(maps, a, grid, stream);
}

}  // namespace
