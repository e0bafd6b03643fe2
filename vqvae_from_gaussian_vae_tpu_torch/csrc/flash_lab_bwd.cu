// The backward flash lab on Hopper (sm_90a): the shipped bf16 backward body
// of csrc/flash_bwd_sm90.cuh (the di pre-pass b9_di_kernel, the dK/dV block
// b9_kv_block and the dQ block b9_q_block, the body of every bf16 backward
// entry at D = 64 and 128) at knobs the shipped entries do not use.
//
// Replaces scripts/exp_flash_bwd_variants.py:49 _control_kernel and :103
// run (pallas_call at :131), a microbenchmark that no model calls: the
// backward at explicit tilings, here (block rows, streamed tile rows,
// stages): 128 keys (dK/dV) or q rows (dQ) a block over two consumer
// warpgroups, NQ-row q tiles streamed by the dK/dV kernel and 2 NQ-key
// tiles by the dQ kernel (the shipped pairing at D = 64 and at D = 128),
// STAGES of them in flight; and a no-softmax control, the body's CONTROL
// knob (no exp, no z read, no di pre-pass, no ds elementwise: dv = bf16(s)^T
// do, dk = bf16(dp)^T q, dq = bf16(dp) k, s = q k^T and dp = do v^T
// unscaled).
//
// At the lab's shape, (B=16, L=1024, H=12, D=64) bf16 on separate
// token-major (B, L, H*D) tensors (the strides of gvq_flash_bwd), the five
// products the function needs are 1.29e11 FLOP against 202 MB: tensor-core
// bound, 0.130 ms at the bf16 peak.  The body's split into a dK/dV kernel
// and a dQ kernel recomputes s and do v^T, so it runs seven products
// (1.80e11 FLOP), the control included.  Any L >= 1 is taken: TMA's zero
// fill is the ragged edge, masked in the last q tile (dK/dV) and key tile
// (dQ).  The launch plan comes from ops/flash_lab.py lab_bwd_plan (BwdPlan
// of csrc/flash_bwd_sm90.cuh); only the combinations listed there are
// compiled, and any other returns cudaErrorInvalidValue and runs nothing.
#include "flash_bwd_sm90.cuh"

namespace {

template <bool kMask, int NQ, int STAGES, bool CONTROL>
__global__ void __launch_bounds__(kB9Threads, 1)
flash_lab_dkdv_kernel(const __grid_constant__ CUtensorMap tmap_q,
                      const __grid_constant__ CUtensorMap tmap_k,
                      const __grid_constant__ CUtensorMap tmap_v,
                      const __grid_constant__ CUtensorMap tmap_do, B9Args a) {
  b9_kv_block<64, kMask, B9Knobs<NQ, STAGES, CONTROL>>(&tmap_q, &tmap_k, &tmap_v, &tmap_do, a);
}

template <bool kMask, int NQ, int STAGES, bool CONTROL>
__global__ void __launch_bounds__(kB9Threads, 1)
flash_lab_dq_kernel(const __grid_constant__ CUtensorMap tmap_q,
                    const __grid_constant__ CUtensorMap tmap_k,
                    const __grid_constant__ CUtensorMap tmap_v,
                    const __grid_constant__ CUtensorMap tmap_do, B9Args a) {
  b9_q_block<64, kMask, B9Knobs<NQ, STAGES, CONTROL>>(&tmap_q, &tmap_k, &tmap_v, &tmap_do, a);
}

// Hold the plan to this combination's layouts and the shapes, then launch
// the di pre-pass (none in the control), the dK/dV kernel and the dQ kernel
template <int NQ, int STAGES, bool CONTROL>
int lab_bwd(const BwdPlan& p, const bf16* const (&bases)[4], const B9Args& a, const bf16* o,
            int B, cudaStream_t s) {
  using Kn = B9Knobs<NQ, STAGES, CONTROL>;
  using KvLay = B9KvLayout<64, Kn>;
  using QLay = B9QLayout<64, Kn>;
  CUtensorMap maps[4];
  if (p.row_dim != 2 || !bwd_plan_maps(p, bases, a, B, 64, 1, kB9Rows, Kn::kNQ, Kn::kNK, STAGES,
                                       KvLay::kSmem, QLay::kSmem, 1, maps))
    return (int)cudaErrorInvalidValue;
  if (!CONTROL) {
    const long long c = (long long)a.H * 64;
    const int err = launch_b9_di<64>(o, bases[3], a.di, Strides{a.Lq * c, 64, c}, B, a.Lq, a.H, s);
    if (err != 0) return err;
  }
  const dim3 kv_grid((unsigned)p.kv_grid_x, (unsigned)p.kv_grid_y);
  const dim3 q_grid((unsigned)p.q_grid_x, (unsigned)p.q_grid_y);
  int err = p.q_mask
                ? b9_launch(flash_lab_dkdv_kernel<true, NQ, STAGES, CONTROL>, kv_grid,
                            KvLay::kSmem, 1, maps, a, s)
                : b9_launch(flash_lab_dkdv_kernel<false, NQ, STAGES, CONTROL>, kv_grid,
                            KvLay::kSmem, 1, maps, a, s);
  if (err != 0) return err;
  return p.key_mask ? b9_launch(flash_lab_dq_kernel<true, NQ, STAGES, CONTROL>, q_grid,
                                QLay::kSmem, 1, maps, a, s)
                    : b9_launch(flash_lab_dq_kernel<false, NQ, STAGES, CONTROL>, q_grid,
                                QLay::kSmem, 1, maps, a, s);
}

}  // namespace

// q, k, v, o, do, dq, dk, dv: (B, L, H*D) bf16, contiguous, 16-byte
// aligned; z (B, H, L) float32 from gvq_flash_fwd_res; di (B, H, L) float32
// scratch; D = 64; any L >= 1.  (rows, tile, stages, control) is one of the
// compiled combinations; `plan` is its lab_bwd_plan.  The control reads
// neither o nor z nor di.
extern "C" int gvq_flash_lab_bwd(const void* q, const void* k, const void* v, const void* o,
                                 const void* z, const void* dout, void* di, void* dq, void* dk,
                                 void* dv, int B, int L, int H, int D, float scale, int rows,
                                 int tile, int stages, int control, const long long* plan,
                                 void* stream) {
  if (D != 64 || B <= 0 || H <= 0 || L <= 0 || rows != kB9Rows || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  BwdPlan p;
  memcpy(&p, plan, sizeof p);
  const long long c = (long long)H * D;
  const B9Args a{static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                 static_cast<const float*>(z), static_cast<float*>(di), L * c, D, c, L * c, D, c,
                 L, L, H, 2, scale};
  const bf16* const bases[4] = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v), static_cast<const bf16*>(dout)};
  const bf16* op = static_cast<const bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GVQ_LAB_BWD(T, S, C)                                            \
  if (tile == T && stages == S && (control != 0) == C) \
    return lab_bwd<T, S, C>(p, bases, a, op, B, s);
  GVQ_LAB_BWD(64, 3, false)  // the shipped tiling at D = 64
  GVQ_LAB_BWD(64, 2, false)
  GVQ_LAB_BWD(32, 3, false)
  GVQ_LAB_BWD(32, 4, false)
  GVQ_LAB_BWD(64, 3, true)   // the control
#undef GVQ_LAB_BWD
  return (int)cudaErrorInvalidValue;
}
