// Flash-attention backward on token-major bf16 tensors, for Hopper (sm_90a).
//
// Replaces the TPU kernel of vqvae_from_gaussian_vae_tpu/ops/flash_blc.py
// _bwd_impl -> pl.pallas_call (body _bwd_kernel), reached from two entries:
//   gvq_flash_bwd_qkv  <- _bwd_call_packed (the ViT: q, k, v read in place
//                         from the (B, L, 3C) QKV projection output)
//   gvq_flash_bwd      <- _bwd_call (the UNet AttnBlock: separate (B, L, C)
//                         q, k, v; H=1, D=512 on the main path)
// Per head, with s = q k^T * scale and the forward's log-normaliser z
// (csrc/flash_fwd.cu, gvq_flash_fwd_qkv_res / gvq_flash_fwd_res):
//
//   p  = exp(s - z)                      (no max or sum pass)
//   di = rowsum(do * o)                  (float32)
//   ds = p * (do v^T - di) * scale       (rounded to bf16)
//   dq = ds k,  dk = ds^T q,  dv = bf16(p)^T do   (float32 accumulation)
//
// The inputs have one token stride and the outputs another, so the packed
// entry reads q, k and v at channel offsets 0, C and 2C of the projection
// (stride 3C) and writes dq | dk | dv into ONE (B, L, 3C) tensor at the same
// offsets, which the projection's backward reads as it is (the JAX package
// concatenates three (B, L, C) arrays); the unpacked entry has stride C
// both ways and three outputs.
//
// What bounds it on an H100: the five products.  At the ViT shape (B=16,
// L=1024, H=12, D=64) that is 1.29e11 FLOP against ~200 MB of traffic, at
// the UNet shape (B=16, L=1024, H=1, D=512) 8.6e10 FLOP against ~100 MB:
// tensor-core bound both (0.13 and 0.087 ms at the bf16 dense peak).  The
// TPU kernel keeps a head group's whole K and V in VMEM and accumulates
// dk, dv across q blocks in scratch; a block here has at most 227 KB of
// shared memory and no order across blocks, so both sides are tiled and
// the work is split in two kernels with no float atomics (the gradients
// are bit-reproducible): one over (K/V tile, b, h) that streams the q tiles
// and accumulates dk and dv, and one over (q tile, b, h) that streams K/V
// and accumulates dq.  Each recomputes s and do v^T.  di comes from a
// small pre-pass.
//
// The head-major entry gvq_flash_bwd_hm replaces the backward of
// vqvae_from_gaussian_vae_tpu/ops/flash_attention.py (_bwd: the upstream
// Pallas _flash_attention_bwd_dkv, then the lean dq pass _bwd_dq_lean) on
// (B, H, L, D) tensors, with q's length Lq apart from k's Lk.  A partial
// last tile loads zero rows, and its rows and columns past Lq or Lk get
// p = 0 and ds = 0; the rows of dk, dv past Lk and of dq past Lq are not
// written.
//
// Which body runs, by head dim: every bf16 entry takes the launch plan of
// ops/flash_attention.py flash_bwd_plan (an int64 array, BwdPlan), which
// names the body and holds the tensor maps of q, k, v and do; the entry
// holds it to its shapes before it encodes them.  D = 64 and 128 take the
// wgmma body of csrc/flash_bwd_sm90.cuh (128 keys or q rows a block, two
// warpgroups of 64 rows, the whole head dim in each); D = 256 and 512 the
// wide wgmma body of csrc/flash_bwd_sm90_wide.cuh (64 keys or q rows a
// block, the head dim's columns split over two warpgroups and, for dK/dV
// at D = 512, over two blocks).  Both are TMA rings, scores, P and dS in
// registers; each header says what it does about its costs.  The backward
// lab (csrc/flash_lab_bwd.cu) instantiates flash_bwd_sm90.cuh at its knobs.
//
// gvq_flash_bwd_hm_f32 is the head-major backward for float32 tensors (the
// JAX op runs float32 too), held to the plain version within 1e-4 of its
// largest value: a pre-pass that writes the operands' TF32 pairs and di,
// then dK/dV and dQ kernels, each product three TF32 wgmma passes on the
// tensor cores, float32-accurate whatever
// torch.backends.cuda.matmul.allow_tf32 says, by the bodies of
// csrc/flash_bwd_f32_sm90.cuh at D = 64 and 128 and their wide form
// csrc/flash_bwd_f32_sm90_wide.cuh at D = 256 and 512 (a block owns a share
// of D's columns, a cluster of blocks the whole row tile).  Both take the
// launch plan of ops/flash_attention.py flash_f32_plan (F32Plan), which
// names the body and its tilings.
#include "flash_bwd_f32_sm90.cuh"
#include "flash_bwd_f32_sm90_wide.cuh"
#include "flash_bwd_sm90.cuh"
#include "flash_bwd_sm90_wide.cuh"

namespace {

// The shipped launches of flash_bwd_sm90.cuh's kernels (here, so that the
// lab's sources, which include the body, compile none of them)
template <int D, bool kQMask, bool kKeyMask>
int launch_b9(const CUtensorMap (&m)[4], const B9Args& a, dim3 kv_grid, dim3 q_grid,
              cudaStream_t stream) {
  const int err = b9_launch(flash_bwd_dkdv_sm90_kernel<D, kQMask>, kv_grid,
                            B9KvLayout<D>::kSmem, 1, m, a, stream);
  if (err != 0) return err;
  return b9_launch(flash_bwd_dq_sm90_kernel<D, kKeyMask>, q_grid, B9QLayout<D>::kSmem, 1, m, a,
                   stream);
}

template <int D>
int launch_b9_masks(const CUtensorMap (&m)[4], const B9Args& a, const BwdPlan& p,
                    cudaStream_t stream) {
  const dim3 kv_grid((unsigned)p.kv_grid_x, (unsigned)p.kv_grid_y);
  const dim3 q_grid((unsigned)p.q_grid_x, (unsigned)p.q_grid_y);
  if (p.q_mask)
    return p.key_mask ? launch_b9<D, true, true>(m, a, kv_grid, q_grid, stream)
                      : launch_b9<D, true, false>(m, a, kv_grid, q_grid, stream);
  return p.key_mask ? launch_b9<D, false, true>(m, a, kv_grid, q_grid, stream)
                    : launch_b9<D, false, false>(m, a, kv_grid, q_grid, stream);
}

// Hold the plan to this body and the entry's shapes (bwd_plan_maps), then
// launch the di pre-pass (o and do as sdo says; di into a.di), the dK/dV
// kernel and the dQ kernel.
inline int launch_flash_bwd_sm90(const BwdPlan& p, const bf16* const (&bases)[4], const B9Args& a,
                                 const bf16* o, Strides sdo, int B, int D, cudaStream_t stream) {
  const int nq = b9_q_tile(D), nk = b9_k_tile(D);
  const long long kv_smem = D == 64 ? B9KvLayout<64>::kSmem : B9KvLayout<128>::kSmem;
  const long long q_smem = D == 64 ? B9QLayout<64>::kSmem : B9QLayout<128>::kSmem;
  CUtensorMap maps[4];
  if ((D != 64 && D != 128) || !bwd_plan_maps(p, bases, a, B, D, 1, kB9Rows, nq, nk, kB9Stages,
                                               kv_smem, q_smem, 1, maps))
    return (int)cudaErrorInvalidValue;
  const int err = D == 64 ? launch_b9_di<64>(o, bases[3], a.di, sdo, B, a.Lq, a.H, stream)
                          : launch_b9_di<128>(o, bases[3], a.di, sdo, B, a.Lq, a.H, stream);
  if (err != 0) return err;
  return D == 64 ? launch_b9_masks<64>(maps, a, p, stream)
                 : launch_b9_masks<128>(maps, a, p, stream);
}


// Route a backward by its plan over the maps of bases[] (q, k, v, do),
// whose coordinates put the row at a.row_dim (1 head-major, 2
// token-major): D = 64 and 128 to the wgmma body, D = 256 and 512 to the
// wide one; o and do (as sdo says) feed the di pre-pass.
int bwd_entry(const B9Args& a, const bf16* const (&bases)[4], const void* o, Strides sdo, int B,
              int D, const long long* plan, void* stream) {
  if (B <= 0 || a.H <= 0 || a.Lq <= 0 || a.Lk <= 0 || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  BwdPlan p;
  memcpy(&p, plan, sizeof p);
  const bf16* op = static_cast<const bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 || D == 128) return launch_flash_bwd_sm90(p, bases, a, op, sdo, B, D, s);
  if (D == 256 || D == 512) return launch_flash_bwd_wide(p, bases, a, op, sdo, B, D, s);
  return (int)cudaErrorInvalidValue;
}

// the wide body at D = 256 or 512, at its tilings (TwTiles)
template <int D>
int launch_f32_bwd_wide(const F32Plan& p, const float* q, const float* k, const float* v,
                        const float* o, const float* dout, float* scratch, const TfBwdArgs& a,
                        int B, int H, cudaStream_t s) {
  using T = TwTiles<D>;
  return launch_flash_bwd_f32_wide<D, T::kDkdv[0], T::kDkdv[1], T::kDkdv[2], T::kDq[0],
                                   T::kDq[1], T::kDq[2]>(p, q, k, v, o, dout, scratch, a, B, H,
                                                         s);
}

}  // namespace

// qkv (B, L, 3C) bf16: q | k | v along channels, C = H * D; o and do (B, L,
// C) bf16; z (B, H, L) float32 from gvq_flash_fwd_qkv_res; di (B, H, L)
// float32 scratch; dqkv (B, L, 3C) bf16 gets dq | dk | dv.  All contiguous,
// 16-byte aligned.  L a multiple of 64, D 64, 128, 256 or 512.  plan: the
// launch plan (BwdPlan, kBwdPlanLen int64).
extern "C" int gvq_flash_bwd_qkv(const void* qkv, const void* o, const void* z, const void* dout,
                                 void* di, void* dqkv, int B, int L, int H, int D, float scale,
                                 const long long* plan, void* stream) {
  if (L % 64 != 0) return (int)cudaErrorInvalidValue;
  const bf16* in = static_cast<const bf16*>(qkv);
  bf16* out = static_cast<bf16*>(dqkv);
  const long long c = (long long)H * D, c3 = 3 * c;
  const B9Args a{out, out + c, out + 2 * c, static_cast<const float*>(z),
                 static_cast<float*>(di), L * c3, D, c3, L * c3, D, c3, L, L, H, 2, scale};
  const bf16* const bases[4] = {in, in, in, static_cast<const bf16*>(dout)};
  return bwd_entry(a, bases, o, Strides{L * c, D, c}, B, D, plan, stream);
}

// The unpacked entry: q, k, v, o, do, dq, dk, dv (B, L, H*D) bf16; z (B, H,
// L) float32 from gvq_flash_fwd_res; di (B, H, L) float32 scratch.  All
// contiguous; the same shape rules and plan.
extern "C" int gvq_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* z, const void* dout, void* di, void* dq, void* dk,
                             void* dv, int B, int L, int H, int D, float scale,
                             const long long* plan, void* stream) {
  if (L % 64 != 0) return (int)cudaErrorInvalidValue;
  const long long c = (long long)H * D;
  const B9Args a{static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                 static_cast<const float*>(z), static_cast<float*>(di), L * c, D, c, L * c, D, c,
                 L, L, H, 2, scale};
  const bf16* const bases[4] = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v), static_cast<const bf16*>(dout)};
  return bwd_entry(a, bases, o, Strides{L * c, D, c}, B, D, plan, stream);
}

// The head-major entry (replaces vqvae_from_gaussian_vae_tpu/ops/flash_attention.py
// _bwd: the upstream Pallas _flash_attention_bwd_dkv and the lean dq pass
// _bwd_dq_lean): q, o, do, dq (B, H, Lq, D) and k, v, dk, dv (B, H, Lk, D)
// bf16; z (B, H, Lq) float32 from gvq_flash_fwd_hm; di (B, H, Lq) float32
// scratch.  All contiguous, 16-byte aligned; any Lq, Lk >= 1; D 64, 128, 256
// or 512; the plan as above.
extern "C" int gvq_flash_bwd_hm(const void* q, const void* k, const void* v, const void* o,
                                const void* z, const void* dout, void* di, void* dq, void* dk,
                                void* dv, int B, int H, int Lq, int Lk, int D, float scale,
                                const long long* plan, void* stream) {
  const long long hq = (long long)Lq * D, hk = (long long)Lk * D;
  const B9Args a{static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                 static_cast<const float*>(z), static_cast<float*>(di), H * hq, hq, D,
                 H * hk, hk, D, Lq, Lk, H, 1, scale};
  const bf16* const bases[4] = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v), static_cast<const bf16*>(dout)};
  return bwd_entry(a, bases, o, Strides{H * hq, hq, D}, B, D, plan, stream);
}

// The float32 head-major entry (the same op as gvq_flash_bwd_hm, for
// float32 tensors): q, o, do, dq (B, H, Lq, D) and k, v, dk, dv (B, H, Lk, D)
// float32; z (B, H, Lq) float32 from gvq_flash_fwd_hm_f32; di (B, H, Lq)
// float32 scratch; scratch the plan's bwd_scratch floats for the pre-pass.
// All contiguous, 16-byte aligned; any Lq, Lk >= 1; D 64, 128, 256 or 512.
// plan: the launch plan (F32Plan, kF32PlanLen int64), whose body and
// tiles must be this D's.
extern "C" int gvq_flash_bwd_hm_f32(const void* q, const void* k, const void* v, const void* o,
                                    const void* z, const void* dout, void* di, void* dq,
                                    void* dk, void* dv, void* scratch, int B, int H, int Lq,
                                    int Lk, int D, float scale, const long long* plan,
                                    void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  F32Plan p;
  memcpy(&p, plan, sizeof p);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* dof = static_cast<const float*>(dout);
  float* sf = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TfBwdArgs a{static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                    static_cast<const float*>(z), static_cast<float*>(di), Lq, Lk, scale};
  // tiles (dK/dV: warpgroups, q rows a tile, stages; dQ: warpgroups, keys
  // a tile, stages) as flash_f32_plan's
  if (D == 64)
    return launch_flash_bwd_f32_sm90<64, 2, 16, 3, 1, 32, 3>(p, qf, kf, vf, of, dof, sf, a, B, H,
                                                             s);
  if (D == 128)
    return launch_flash_bwd_f32_sm90<128, 1, 8, 3, 1, 16, 2>(p, qf, kf, vf, of, dof, sf, a, B, H,
                                                             s);
  if (D == 256) return launch_f32_bwd_wide<256>(p, qf, kf, vf, of, dof, sf, a, B, H, s);
  if (D == 512) return launch_f32_bwd_wide<512>(p, qf, kf, vf, of, dof, sf, a, B, H, s);
  return (int)cudaErrorInvalidValue;
}
