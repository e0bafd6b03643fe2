// The forward flash labs on Hopper (sm_90a): the shipped bf16 forward body
// of csrc/flash_fwd_sm90.cuh (f9_block, the body of every bf16 forward entry
// at D = 64 and 128) at knobs the shipped entries do not use.
//
// Replaces two TPU kernels, both microbenchmarks that no model calls:
//   scripts/exp_flash_variants.py:54 make_kernel (pallas_call at :142): the
//     packed-layout forward under a softmax policy and a pipeline depth.
//     Here each policy is the body's POLICY knob (kF9Base is the shipped
//     softmax; the others replace f9_softmax, or the tile loop for kF9Chunk)
//     and the depth is the score tiles in flight: 1, the shipped order
//     (tile t's Q K^T issued beside tile t-1's P V); 2, tile t+1's Q K^T
//     issued before tile t's softmax runs.  On the TPU the depth bought
//     MXU/VPU overlap across heads; here it buys softmax work beside two
//     products instead of one.
//   scripts/exp_flash_fwd_tilings.py:32 run (pallas_call at :44): the
//     shipped body at explicit (heads per block, q rows per block), here
//     (heads per block, q rows = 64 per consumer warpgroup, keys a tile);
//     a block walks its heads one after another, its ring of K and V tiles
//     flowing across each head boundary.
//
// Both run at the labs' shape, (B=16, L=1024, H=12, D=64) bf16, on three
// separate token-major (B, L, H*D) tensors (the unpacked strides of
// gvq_flash_fwd): 5.15e10 FLOP against 101 MB a launch, tensor-core bound
// (0.052 ms at the bf16 peak).  Any L >= 1 is taken, as the shipped body
// takes it: TMA's zero fill is the q edge, and the last key tile of a
// ragged L masks its keys past L (kMask).  The launch plan comes from
// ops/flash_lab.py lab_fwd_plan (FwdPlan of csrc/flash_fwd_sm90.cuh, its
// grid's y B * H / heads); only the combinations listed there are compiled,
// and any other returns cudaErrorInvalidValue and runs nothing.
#include "flash_fwd_sm90.cuh"

namespace {

template <bool kMask, int WG, int KEYS, int HEADS, int POLICY, int DEPTH>
__global__ void __launch_bounds__(128 * (WG + 1), 1)
flash_lab_fwd_kernel(const __grid_constant__ CUtensorMap tmap_q,
                     const __grid_constant__ CUtensorMap tmap_k,
                     const __grid_constant__ CUtensorMap tmap_v, F9Args a) {
  f9_block<64, kMask, F9Knobs<WG, KEYS, HEADS, POLICY, DEPTH>>(&tmap_q, &tmap_k, &tmap_v, a);
}

template <bool kMask, int WG, int KEYS, int HEADS, int POLICY, int DEPTH>
int launch_lab_fwd(const CUtensorMap (&maps)[3], const F9Args& a, dim3 grid, cudaStream_t s) {
  using Lay = F9Layout<64, F9Knobs<WG, KEYS, HEADS, POLICY, DEPTH>>;
  auto kernel = flash_lab_fwd_kernel<kMask, WG, KEYS, HEADS, POLICY, DEPTH>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lay::kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, Lay::kThreads, Lay::kSmem, s>>>(maps[0], maps[1], maps[2], a);
  return (int)cudaGetLastError();
}

// Hold the plan to this combination's layout and the shapes, then launch
template <int WG, int KEYS, int HEADS, int POLICY, int DEPTH>
int lab_fwd(const FwdPlan& p, const bf16* const (&bases)[3], bf16* o, int B, int L, int H,
            float scale, cudaStream_t s) {
  using Lay = F9Layout<64, F9Knobs<WG, KEYS, HEADS, POLICY, DEPTH>>;
  CUtensorMap maps[3];
  F9Args a;
  if (p.row_dim != 2 || !fwd_plan_args(p, 1, Lay::kRows, KEYS, kF9Stages, Lay::kThreads,
                                       Lay::kSmem, bases, o, nullptr, B, H, L, L, 64, scale,
                                       maps, &a, HEADS))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)p.grid_x, (unsigned)p.grid_y);
  return p.key_mask ? launch_lab_fwd<true, WG, KEYS, HEADS, POLICY, DEPTH>(maps, a, grid, s)
                    : launch_lab_fwd<false, WG, KEYS, HEADS, POLICY, DEPTH>(maps, a, grid, s);
}

}  // namespace

// q, k, v, o: (B, L, H*D) bf16, contiguous, 16-byte aligned; D = 64; any
// L >= 1; H a multiple of `hpb`.  (policy, depth, hpb, rows, keys) is one of
// the compiled combinations; `plan` is its lab_fwd_plan.  kF9Exp2 runs on
// scores scaled by scale log2 e, rounded once to float32 here.
extern "C" int gvq_flash_lab_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                 int L, int H, int D, float scale, int policy, int depth,
                                 int hpb, int rows, int keys, const long long* plan,
                                 void* stream) {
  if (D != 64 || B <= 0 || H <= 0 || L <= 0 || plan == nullptr) return (int)cudaErrorInvalidValue;
  FwdPlan p;
  memcpy(&p, plan, sizeof p);
  const bf16* const bases[3] = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v)};
  bf16* out = static_cast<bf16*>(o);
  const float sc = policy == kF9Exp2 ? (float)((double)scale * 1.4426950408889634) : scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GVQ_LAB_FWD(P, DEP, HP, R, KEYS)                                                   \
  if (policy == P && depth == DEP && hpb == HP && rows == R && keys == KEYS)               \
    return lab_fwd<R / 64, KEYS, HP, P, DEP>(p, bases, out, B, L, H, sc, s);
  // B15: the softmax policies at the shipped tiling (1, 192, 128); depth 2
  // at two consumer warpgroups, whose 232 registers a thread hold two
  // 64-float score tiles (three warpgroups have 160)
  GVQ_LAB_FWD(kF9Base, 1, 1, 192, 128)
  GVQ_LAB_FWD(kF9MatOnly, 1, 1, 192, 128)
  GVQ_LAB_FWD(kF9NoMax, 1, 1, 192, 128)
  GVQ_LAB_FWD(kF9Exp2, 1, 1, 192, 128)
  GVQ_LAB_FWD(kF9TileMax, 1, 1, 192, 128)
  GVQ_LAB_FWD(kF9Base, 2, 1, 128, 128)
  GVQ_LAB_FWD(kF9Chunk, 1, 1, 192, 128)
  GVQ_LAB_FWD(kF9Sbf16, 1, 1, 192, 128)
  // B16: depth 2's tiling at depth 1, and the JAX lab's 256-row tilings
  // (four consumer warpgroups, 640 threads, 112 registers a consumer thread:
  // 64-key tiles, whose score tile is 32 floats) with their one-head twin
  GVQ_LAB_FWD(kF9Base, 1, 1, 128, 128)
  GVQ_LAB_FWD(kF9Base, 1, 1, 256, 64)
  GVQ_LAB_FWD(kF9Base, 1, 12, 256, 64)
  GVQ_LAB_FWD(kF9Base, 1, 4, 256, 64)
  GVQ_LAB_FWD(kF9Base, 1, 6, 256, 64)
  GVQ_LAB_FWD(kF9Base, 1, 2, 256, 64)
#undef GVQ_LAB_FWD
  return (int)cudaErrorInvalidValue;
}
