// Flash-attention forward on token-major (B, L, H*D) bf16 tensors, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel vqvae_from_gaussian_vae_tpu/ops/flash_blc.py
// (_fwd_impl -> pl.pallas_call, body _fwd_kernel): softmax(q k^T * scale) v
// per head, read straight from the (B, L, H*D) layout with no head-major
// transpose and no (B, H, L, L) score tensor in device memory.
//
// Numerics follow the TPU kernel: scores accumulate in fp32 and are scaled
// in fp32; p is rounded to bf16 before the P.V product, which accumulates
// in fp32; the row sum is taken over the fp32 p; the 1/sum normaliser is
// applied once at the end.
//
// What bounds it on an H100: at the UNet's AttnBlock shape (B=16, L=1024,
// H=1, D=512) one launch is 3.4e10 FLOP over 4 x 16.8 MB, so it is
// tensor-core bound.  The TPU kernel keeps a head's whole K and V on chip;
// at D=512 that is 1 MB each, far beyond 227 KB of shared memory, so both
// bodies run an online softmax over K/V tiles.
//
// The packed entry (gvq_flash_fwd_qkv, for the ViT's attention) reads q, k
// and v in place from the (B, L, 3C) QKV projection output: the input token
// stride (3C) and the q/k/v base offsets (0, C, 2C) are separate from the
// output's stride (C).  At the ViT shape (B=16, L=1024, H=12, D=64) one
// launch is 5.15e10 FLOP over 101 MB, so it is tensor-core bound too (52 us
// at the bf16 peak); it runs on the wgmma body.
//
// The training entries (gvq_flash_fwd_qkv_res, replacing flash_blc.py
// _fwd_res_call_packed, and gvq_flash_fwd_res, replacing _fwd_res_call for
// the UNet's unpacked D=512 attention) also write the per-(row, head)
// log-normaliser z = m + ln(sum) in float32, laid out (B, H, L), which the
// backward (csrc/flash_bwd.cu) turns back into p = exp(s - z) with no max or
// sum pass.  The online softmax already holds m and the row sum, so z costs
// one store per row; the inference entries pass no z pointer and skip it.
//
// The head-major entry (gvq_flash_fwd_hm, replacing the forward of
// vqvae_from_gaussian_vae_tpu/ops/flash_attention.py, the upstream Pallas
// _flash_attention_impl) runs the same bodies on (B, H, L, D) tensors with
// q's length Lq apart from k's and v's Lk: the bodies read either layout
// through their tensor maps.  Any Lq, Lk >= 1 is taken: a q row past Lq
// loads zeros and is not stored; a key column past Lk loads zeros and
// scores -inf before the row max.  At (B=1, H=12, L=8192, D=64) a launch
// is 2.1e11 FLOP over 50 MB: tensor-core bound (0.21 ms at the bf16 peak).
//
// Which body runs, by head dim: D = 64 and 128 take the wgmma body of
// csrc/flash_fwd_sm90.cuh (TMA ring, scores and output in registers, 192
// q rows at D = 64 and 128 at D = 128 against 128-key tiles); D = 256 and
// 512 take the wgmma body of csrc/flash_fwd_sm90_wide.cuh (64 q rows
// against 64-key tiles, the output's columns split over two consumer
// warpgroups).  Each says what it does about the costs of the wmma body
// these entries ran before (deleted; the labs of csrc/flash_lab_fwd.cu
// instantiate flash_fwd_sm90.cuh at their knobs).  Every bf16 entry takes the
// launch plan of ops/flash_attention.py flash_fwd_plan (an int64 array,
// FwdPlan): it names the body and the tensor maps' dims, byte strides,
// boxes and element offsets, which the entry holds to its shapes before it
// encodes them.
//
// gvq_flash_fwd_hm_f32 is the head-major op for float32 tensors (the JAX op
// runs float32 too), held to the plain version within 1e-4 of its largest
// value: split TF32 on the tensor cores (each product three TF32 wgmma
// passes, float32-accurate whatever torch.backends.cuda.matmul.allow_tf32
// says, after a pre-pass that writes the operands' TF32 pairs), by the body
// of csrc/flash_fwd_f32_sm90.cuh at D = 64 and 128 and its wide form
// csrc/flash_fwd_f32_sm90_wide.cuh at D = 256 and 512 (a block owns a share
// of D's columns, a cluster of blocks the whole row tile).  Both take the
// launch plan of ops/flash_attention.py flash_f32_plan (F32Plan), which
// names the body and its tiling.
#include "flash_fwd_f32_sm90.cuh"
#include "flash_fwd_f32_sm90_wide.cuh"
#include "flash_fwd_sm90.cuh"
#include "flash_fwd_sm90_wide.cuh"

namespace {

// The shipped launches of flash_fwd_sm90.cuh's kernel (here, so that the
// lab's sources, which include the body, compile none of them)
template <int D, bool kMask>
int launch_f9(const CUtensorMap (&maps)[3], const F9Args& a, dim3 grid, cudaStream_t stream) {
  const size_t smem = F9Layout<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D, kMask>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_sm90_kernel<D, kMask><<<grid, F9Layout<D>::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], a);
  return (int)cudaGetLastError();
}

inline int launch_flash_fwd_sm90(const FwdPlan& p, const bf16* const (&bases)[3], bf16* o,
                                 float* z, int B, int H, int Lq, int Lk, int D, float scale,
                                 cudaStream_t stream) {
  CUtensorMap maps[3];
  F9Args a;
  if ((D != 64 && D != 128) ||
      !(D == 64 ? fwd_plan_args(p, 1, F9Layout<64>::kRows, kF9Keys, kF9Stages,
                                F9Layout<64>::kThreads, F9Layout<64>::kSmem, bases, o, z, B, H,
                                Lq, Lk, D, scale, maps, &a)
                : fwd_plan_args(p, 1, F9Layout<128>::kRows, kF9Keys, kF9Stages,
                                F9Layout<128>::kThreads, F9Layout<128>::kSmem, bases, o, z, B,
                                H, Lq, Lk, D, scale, maps, &a)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)p.grid_x, (unsigned)p.grid_y);
  if (D == 64)
    return p.key_mask ? launch_f9<64, true>(maps, a, grid, stream)
                      : launch_f9<64, false>(maps, a, grid, stream);
  return p.key_mask ? launch_f9<128, true>(maps, a, grid, stream)
                    : launch_f9<128, false>(maps, a, grid, stream);
}

// Route a launch by its plan over the plan's maps of bases[] (q, k, v, or
// the packed projection three times): D = 64 and 128 to
// flash_fwd_sm90.cuh, D = 256 and 512 to flash_fwd_sm90_wide.cuh.
int flash_entry(const bf16* const (&bases)[3], bf16* o, float* z, int B, int H, int Lq, int Lk,
                int D, float scale, const long long* plan, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  FwdPlan p;
  memcpy(&p, plan, sizeof p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 || D == 128) return launch_flash_fwd_sm90(p, bases, o, z, B, H, Lq, Lk, D, scale, s);
  if (D == 256 || D == 512) return launch_flash_fwd_wide(p, bases, o, z, B, H, Lq, Lk, D, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The token-major entries: o (B, L, H*D); L a multiple of 64.
int token_major_entry(const bf16* const (&bases)[3], bf16* o, float* z, int B, int L, int H,
                      int D, float scale, const long long* plan, void* stream) {
  if (L % 64 != 0) return (int)cudaErrorInvalidValue;
  return flash_entry(bases, o, z, B, H, L, L, D, scale, plan, stream);
}

// the wide body at D = 256 or 512, at its tiling (TwTiles)
template <int D>
int launch_f32_fwd_wide(const F32Plan& p, const float* q, const float* k, const float* v,
                        float* o, float* z, float* scratch, int B, int H, int Lq, int Lk,
                        float scale, cudaStream_t s) {
  using T = TwTiles<D>;
  return launch_flash_fwd_f32_wide<D, T::kFwd[0], T::kFwd[1], T::kFwd[2]>(
      p, q, k, v, o, z, scratch, B, H, Lq, Lk, scale, s);
}

}  // namespace

// q, k, v, o: (B, L, H*D) bf16, contiguous, 16-byte aligned.  L must be a
// multiple of 64 and D one of 64, 128, 256, 512.  plan: the launch plan
// (FwdPlan, kPlanLen int64).
extern "C" int gvq_flash_fwd(const void* q, const void* k, const void* v, void* o, int B,
                             int L, int H, int D, float scale, const long long* plan,
                             void* stream) {
  const bf16* const bases[3] = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v)};
  return token_major_entry(bases, static_cast<bf16*>(o), nullptr, B, L, H, D, scale, plan,
                           stream);
}

// The training form of the unpacked entry: also writes z (B, H, L) float32,
// z = m + ln(sum) of each row's scaled scores.  Same shape rules.
extern "C" int gvq_flash_fwd_res(const void* q, const void* k, const void* v, void* o, void* z,
                                 int B, int L, int H, int D, float scale, const long long* plan,
                                 void* stream) {
  if (z == nullptr) return (int)cudaErrorInvalidValue;
  const bf16* const bases[3] = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v)};
  return token_major_entry(bases, static_cast<bf16*>(o), static_cast<float*>(z), B, L, H, D,
                           scale, plan, stream);
}

// The packed entry (replaces flash_blc.py _fwd_call_packed): q, k and v are
// read in place from the contiguous (B, L, 3C) QKV projection output, q | k
// | v along channels (C = H*D), at token stride 3C and channel offsets 0, C
// and 2C; o is (B, L, C).  No q/k/v copy exists.  Same shape rules.
extern "C" int gvq_flash_fwd_qkv(const void* qkv, void* o, int B, int L, int H, int D,
                                 float scale, const long long* plan, void* stream) {
  const bf16* p = static_cast<const bf16*>(qkv);
  const bf16* const bases[3] = {p, p, p};
  return token_major_entry(bases, static_cast<bf16*>(o), nullptr, B, L, H, D, scale, plan,
                           stream);
}

// The training form of the packed entry: also writes z (B, H, L) float32,
// z = m + ln(sum) of each row's scaled scores.  Same shape rules.
extern "C" int gvq_flash_fwd_qkv_res(const void* qkv, void* o, void* z, int B, int L, int H,
                                     int D, float scale, const long long* plan, void* stream) {
  const bf16* p = static_cast<const bf16*>(qkv);
  if (z == nullptr) return (int)cudaErrorInvalidValue;
  const bf16* const bases[3] = {p, p, p};
  return token_major_entry(bases, static_cast<bf16*>(o), static_cast<float*>(z), B, L, H, D,
                           scale, plan, stream);
}

// The head-major entry (replaces vqvae_from_gaussian_vae_tpu/ops/flash_attention.py
// _fwd / flash_attention -> the upstream _flash_attention_impl): q, o (B, H,
// Lq, D) and k, v (B, H, Lk, D) bf16, contiguous, any Lq, Lk >= 1 (the last
// q and k tiles may be partial).  z (B, H, Lq) float32 is written where it is
// not null (the training form).  Row stride D, head stride L * D, each with
// its own L for q and for k, v.
extern "C" int gvq_flash_fwd_hm(const void* q, const void* k, const void* v, void* o, void* z,
                                int B, int H, int Lq, int Lk, int D, float scale,
                                const long long* plan, void* stream) {
  const bf16* const bases[3] = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v)};
  return flash_entry(bases, static_cast<bf16*>(o), static_cast<float*>(z), B, H, Lq, Lk, D, scale,
                     plan, stream);
}

// The float32 head-major entry (the same op as gvq_flash_fwd_hm, for
// float32 tensors): q, o (B, H, Lq, D) and k, v (B, H, Lk, D) float32,
// contiguous, 16-byte aligned, any Lq, Lk >= 1, D 64, 128, 256 or 512; z
// (B, H, Lq) float32 where not null; scratch the plan's fwd_scratch floats
// for the pre-pass.  plan: the launch plan (F32Plan, kF32PlanLen int64),
// whose body and tiles must be this D's.
extern "C" int gvq_flash_fwd_hm_f32(const void* q, const void* k, const void* v, void* o,
                                    void* z, void* scratch, int B, int H, int Lq, int Lk, int D,
                                    float scale, const long long* plan, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  F32Plan p;
  memcpy(&p, plan, sizeof p);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* zf = static_cast<float*>(z);
  float* sf = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // tiles (consumer warpgroups, keys a tile, stages) as flash_f32_plan's
  if (D == 64)
    return launch_flash_fwd_f32_sm90<64, 2, 32, 3>(p, qf, kf, vf, of, zf, sf, B, H, Lq, Lk, scale,
                                                   s);
  if (D == 128)
    return launch_flash_fwd_f32_sm90<128, 2, 16, 3>(p, qf, kf, vf, of, zf, sf, B, H, Lq, Lk,
                                                    scale, s);
  if (D == 256)
    return launch_f32_fwd_wide<256>(p, qf, kf, vf, of, zf, sf, B, H, Lq, Lk, scale, s);
  if (D == 512)
    return launch_f32_fwd_wide<512>(p, qf, kf, vf, of, zf, sf, B, H, Lq, Lk, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Message for an error code returned by any gvq_* entry point.
extern "C" const char* gvq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
