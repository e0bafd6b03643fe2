// The backward flash lab on Hopper (sm_90a): the wmma bf16 backward bodies
// of csrc/flash_bwd.cuh, which no shipped entry runs (those take the wgmma
// bodies of csrc/flash_bwd_sm90.cuh and csrc/flash_bwd_sm90_wide.cuh).
//
// Replaces scripts/exp_flash_bwd_variants.py:49 _control_kernel and :103
// run (pallas_call at :131), a microbenchmark that no model calls: the
// backward at explicit tilings, here (tile rows T, warps, pipe
// depth), the pipe depth being the streamed q tiles (in dk/dv) or K/V tiles
// (in dq) in flight; and a no-softmax control, here the CONTROL flag of the
// same two kernels (no exp, no z read, no di pre-pass, no ds elementwise:
// dv = bf16(s)^T do, dk = bf16(dp)^T q, dq = bf16(dp) k).
//
// At the lab's shape, (B=16, L=1024, H=12, D=64) bf16 on separate
// token-major (B, L, H*D) tensors (the strides of gvq_flash_bwd), the five
// products the function needs are 1.29e11 FLOP against 202 MB: tensor-core
// bound, 0.130 ms at the bf16 peak.  The port's split into a dk/dv kernel
// and a dq kernel recomputes s and do v^T, so it runs seven products
// (1.80e11 FLOP), the control included.  Only the combinations listed in
// ops/flash_lab.py are compiled (full tiles only: L a multiple of T); any
// other returns cudaErrorInvalidValue and runs nothing.
#include "flash_bwd.cuh"

// q, k, v, o, do, dq, dk, dv: (B, L, H*D) bf16; z (B, H, L) float32 from
// gvq_flash_fwd_res; di (B, H, L) float32 scratch.  All contiguous; D = 64;
// L a multiple of `rows`.  The control reads neither o nor z nor di.
extern "C" int gvq_flash_lab_bwd(const void* q, const void* k, const void* v, const void* o,
                                 const void* z, const void* dout, void* di, void* dq, void* dk,
                                 void* dv, int B, int L, int H, int D, float scale, int rows,
                                 int warps, int pipe, int control, void* stream) {
  if (D != 64 || B <= 0 || H <= 0 || L <= 0 || rows <= 0 || L % rows != 0)
    return (int)cudaErrorInvalidValue;
  const long long c = (long long)H * D;
  const Strides tm{L * c, D, c};
  const BwdArgs g{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                  static_cast<const float*>(z), static_cast<const float*>(di),
                  static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                  tm, tm, tm, tm, tm, L, L, H, scale};
  const bf16* op = static_cast<const bf16*>(o);
  float* dip = static_cast<float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GVQ_LAB_BWD(R, W, P, C)                                          \
  if (rows == R && warps == W && pipe == P && (control != 0) == C) \
    return launch_flash_bwd<64, R, W, false, P, C>(g, op, dip, B, s);
  GVQ_LAB_BWD(64, 8, 1, false)  // the shipped tiling
  GVQ_LAB_BWD(64, 8, 2, false)
  GVQ_LAB_BWD(32, 8, 1, false)
  GVQ_LAB_BWD(32, 4, 1, false)
  GVQ_LAB_BWD(64, 8, 1, true)   // the control
#undef GVQ_LAB_BWD
  return (int)cudaErrorInvalidValue;
}
