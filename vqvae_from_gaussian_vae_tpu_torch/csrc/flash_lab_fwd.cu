// The forward flash labs on Hopper (sm_90a): the bf16 forward body of
// csrc/flash_fwd.cuh at settings the shipped entries do not use.
//
// Replaces two TPU kernels, both microbenchmarks that no model calls:
//   scripts/exp_flash_variants.py:54 make_kernel (pallas_call at :142): the
//     packed-layout forward under a softmax policy and a head-pipeline
//     depth.  Here each policy is a POLICY value of the body, and the depth
//     is its K/V stage depth: 1, one K-or-V buffer as the shipped entries
//     run; 2, cp.async copies of the next K or V tile into a second buffer
//     while the current tile's product runs.  On the TPU the depth bought
//     MXU/VPU overlap across heads; on Hopper the overlap to buy is load
//     latency against tensor-core work.
//   scripts/exp_flash_fwd_tilings.py:32 run (pallas_call at :44): the
//     shipped body at explicit (heads per block, q rows per block, warps).
//
// Both run at the labs' shape, (B=16, L=1024, H=12, D=64) bf16, on three
// separate token-major (B, L, H*D) tensors (the unpacked strides of
// gvq_flash_fwd): 5.15e10 FLOP against 101 MB a launch, tensor-core bound
// (0.052 ms at the bf16 peak).  Only the combinations listed in
// ops/flash_lab.py are compiled (full tiles only: L a multiple of the q rows
// and of 64); any other returns cudaErrorInvalidValue and runs nothing.
#include "flash_fwd.cuh"

namespace {

template <int BQ, int WARPS, int HPB, int POLICY, int STAGES>
int lab_fwd(const FwdArgs& g, int B, cudaStream_t s) {
  return launch_flash_fwd<64, false, BQ, WARPS, HPB, POLICY, STAGES>(g, B, s);
}

}  // namespace

// q, k, v, o: (B, L, H*D) bf16, contiguous; D = 64; L a multiple of 64 and
// of `rows`; H a multiple of `hpb`.  (policy, stages, hpb, rows, warps) is
// one of the compiled combinations.
extern "C" int gvq_flash_lab_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                 int L, int H, int D, float scale, int policy, int stages,
                                 int hpb, int rows, int warps, void* stream) {
  if (D != 64 || B <= 0 || H <= 0 || L <= 0 || rows <= 0 || L % kFkv != 0 || L % rows != 0)
    return (int)cudaErrorInvalidValue;
  const long long c = (long long)H * D;
  const FwdArgs g{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<bf16*>(o), nullptr,
                  {L * c, D, c}, {L * c, D, c}, {L * c, D, c}, L, L, H, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GVQ_LAB_FWD(P, S, HP, R, W)                                                 \
  if (policy == P && stages == S && hpb == HP && rows == R && warps == W) \
    return lab_fwd<R, W, HP, P, S>(g, B, s);
  // B15: the softmax policies and the stage depth, at the shipped tiling
  GVQ_LAB_FWD(kBase, 1, 1, 32, 8)
  GVQ_LAB_FWD(kMatOnly, 1, 1, 32, 8)
  GVQ_LAB_FWD(kNoMax, 1, 1, 32, 8)
  GVQ_LAB_FWD(kExp2, 1, 1, 32, 8)
  GVQ_LAB_FWD(kTileMax, 1, 1, 32, 8)
  GVQ_LAB_FWD(kBase, 2, 1, 32, 8)
  GVQ_LAB_FWD(kChunk, 1, 1, 32, 8)
  GVQ_LAB_FWD(kSbf16, 1, 1, 32, 8)
  // B16: the shipped body at the JAX lab's 256-row tilings (16 warps)
  GVQ_LAB_FWD(kBase, 1, 12, 256, 16)
  GVQ_LAB_FWD(kBase, 1, 4, 256, 16)
  GVQ_LAB_FWD(kBase, 1, 6, 256, 16)
  GVQ_LAB_FWD(kBase, 1, 2, 256, 16)
#undef GVQ_LAB_FWD
  return (int)cudaErrorInvalidValue;
}
