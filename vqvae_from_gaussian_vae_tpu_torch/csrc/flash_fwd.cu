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
// at D=512 that is 1 MB each, far beyond 227 KB of shared memory, so this
// kernel runs an online softmax over 64-row K/V tiles.  The fp32 output
// accumulator of a q tile is D floats per row, so the q tile is 32 rows:
// Q tile (32 x D bf16), one K-or-V tile (64 x D bf16, K and V take turns),
// the fp32 accumulator (32 x D), scores and probabilities all fit in
// ~176 KB of shared memory at D=512.  Products run on bf16 tensor cores
// through nvcuda::wmma; the accumulator lives in shared memory so the
// per-row rescale of the online softmax is a plain elementwise pass.
//
// The packed entry (gvq_flash_fwd_qkv, for the ViT's attention) runs the
// same kernel with q, k and v read in place from the (B, L, 3C) QKV
// projection output: the input token stride (3C) and the q/k/v base
// offsets (0, C, 2C) are separate from the output's stride (C).  At the ViT
// shape (B=16, L=1024, H=12, D=64) one launch is 5.15e10 FLOP over 101 MB,
// so it is tensor-core bound too (52 us at the bf16 peak).
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
// _flash_attention_impl) runs the same kernel on (B, H, L, D) tensors with
// q's length Lq apart from k's and v's Lk.  Every tensor's batch, head and
// row strides are kernel arguments, so one body serves both layouts.  Any
// Lq, Lk >= 1 is taken: a q row past Lq loads zeros and is not stored; a key
// column past Lk loads zeros and scores -inf before the row max.  At
// (B=1, H=12, L=8192, D=64) a launch is 2.1e11 FLOP over 50 MB: tensor-core
// bound (0.21 ms at the bf16 peak).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kFq = 32;        // query rows per block
constexpr int kFkv = 64;       // key / value rows per tile
constexpr int kFThreads = 256;
constexpr int kLdS = kFkv + 4; // f32 pitch of the score tile
constexpr int kLdP = kFkv + 8; // bf16 pitch of the probability tile

template <int D>
struct FlashLayout {
  static constexpr int kLdQ = D + 8;  // bf16 pitch of the Q and K/V tiles
  static constexpr int kLdO = D + 4;  // f32 pitch of the accumulator
  static constexpr size_t kQ = 0;
  static constexpr size_t kKV = kQ + (size_t)kFq * kLdQ * sizeof(bf16);
  static constexpr size_t kO = kKV + (size_t)kFkv * kLdQ * sizeof(bf16);
  static constexpr size_t kS = kO + (size_t)kFq * kLdO * sizeof(float);
  static constexpr size_t kP = kS + (size_t)kFq * kLdS * sizeof(float);
  static constexpr size_t kStats = kP + (size_t)kFq * kLdP * sizeof(bf16);
  static constexpr size_t kBytes = kStats + 3 * kFq * sizeof(float);
};

// Where one of q, k, v, o lies: element (b, h, row, d) sits at
// b * Strides::b + h * Strides::h + row * Strides::row + d.
struct Strides {
  long long b, h, row;
};

struct FwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* z;         // (B, H, Lq) float32, or null for the inference form
  Strides sq, skv, so;
  int Lq, Lk, H;
  float scale;
};

// kTail: the last q tile or K/V tile may be partial (Lq % 32 or Lk % 64);
// a launch of full tiles compiles the row and column checks out
template <int D, bool kTail>
__global__ void __launch_bounds__(kFThreads) flash_fwd_kernel(FwdArgs g) {
  using namespace nvcuda;
  using Lay = FlashLayout<D>;
  constexpr int LDQ = Lay::kLdQ;
  constexpr int LDO = Lay::kLdO;
  constexpr int CPR = D / 8;          // 16-byte chunks per row
  constexpr int OCOLS = D / 16 / 4;   // accumulator column fragments per warp

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + Lay::kQ);
  bf16* KVs = reinterpret_cast<bf16*>(smem + Lay::kKV);
  float* Os = reinterpret_cast<float*>(smem + Lay::kO);
  float* Ss = reinterpret_cast<float*>(smem + Lay::kS);
  bf16* Ps = reinterpret_cast<bf16*>(smem + Lay::kP);
  float* row_m = reinterpret_cast<float*>(smem + Lay::kStats);
  float* row_l = row_m + kFq;
  float* row_a = row_l + kFq;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int Lq = g.Lq, Lk = g.Lk;
  const int b = blockIdx.y / g.H;
  const int h = blockIdx.y % g.H;
  const int q0 = blockIdx.x * kFq;
  const bf16* qb = g.q + b * g.sq.b + h * g.sq.h;
  const bf16* kb = g.k + b * g.skv.b + h * g.skv.h;
  const bf16* vb = g.v + b * g.skv.b + h * g.skv.h;
  bf16* ob = g.o + b * g.so.b + h * g.so.h;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // a q row past Lq loads zeros and is never stored
  for (int e = tid; e < kFq * CPR; e += kFThreads) {
    const int r = e / CPR, c = (e % CPR) * 8;
    *reinterpret_cast<uint4*>(Qs + r * LDQ + c) =
        !kTail || q0 + r < Lq ? *reinterpret_cast<const uint4*>(qb + (q0 + r) * g.sq.row + c)
                              : zero;
  }
  for (int e = tid; e < kFq * D; e += kFThreads) Os[(e / D) * LDO + e % D] = 0.0f;
  if (tid < kFq) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.0f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < Lk; k0 += kFkv) {
    // a key row past Lk loads zeros (its score is masked below)
    for (int e = tid; e < kFkv * CPR; e += kFThreads) {
      const int r = e / CPR, c = (e % CPR) * 8;
      *reinterpret_cast<uint4*>(KVs + r * LDQ + c) =
          !kTail || k0 + r < Lk ? *reinterpret_cast<const uint4*>(kb + (k0 + r) * g.skv.row + c)
                                : zero;
    }
    __syncthreads();

    {  // S = Q K^T: warp w owns the 16 x 16 score block (w / 4, w % 4)
      const int fr = warp >> 2, fc = warp & 3;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
      wmma::fill_fragment(sacc, 0.0f);
#pragma unroll 4
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + fr * 16 * LDQ + kk, LDQ);
        wmma::load_matrix_sync(fb, KVs + fc * 16 * LDQ + kk, LDQ);
        wmma::mma_sync(sacc, fa, fb, sacc);
      }
      wmma::store_matrix_sync(Ss + fr * 16 * kLdS + fc * 16, sacc, kLdS, wmma::mem_row_major);
    }
    __syncthreads();

    // V takes the K buffer (zero rows past Lk: p is 0 there, and 0 * v must
    // not meet stale data); the online-softmax update runs on S meanwhile
    for (int e = tid; e < kFkv * CPR; e += kFThreads) {
      const int r = e / CPR, c = (e % CPR) * 8;
      *reinterpret_cast<uint4*>(KVs + r * LDQ + c) =
          !kTail || k0 + r < Lk ? *reinterpret_cast<const uint4*>(vb + (k0 + r) * g.skv.row + c)
                                : zero;
    }
    {  // 8 threads per row, 8 scores each; a key column past Lk scores -inf
       // before the row max, so it adds exactly 0 to the row sum (every tile
       // holds at least one column below Lk, so the max stays finite)
      const int r = tid >> 3, part = tid & 7;
      float sv[8];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = part * 8 + i;
        sv[i] = !kTail || k0 + col < Lk ? Ss[r * kLdS + col] * g.scale : -INFINITY;
        mx = fmaxf(mx, sv[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = expf(sv[i] - m_new);
        sum += p;
        Ps[r * kLdP + part * 8 + i] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    if (k0 > 0) {
      for (int e = tid; e < kFq * D; e += kFThreads) {
        const int r = e / D;
        Os[r * LDO + e % D] *= row_a[r];
      }
      __syncthreads();
    }

    {  // O += P V: warp w owns rows (w & 1) and OCOLS column blocks
      const int fr = warp & 1;
      const int cb = (warp >> 1) * OCOLS;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[OCOLS];
#pragma unroll
      for (int c = 0; c < OCOLS; ++c)
        wmma::load_matrix_sync(oacc[c], Os + fr * 16 * LDO + (cb + c) * 16, LDO,
                               wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kFkv; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::load_matrix_sync(pa, Ps + fr * 16 * kLdP + kk, kLdP);
#pragma unroll
        for (int c = 0; c < OCOLS; ++c) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, KVs + kk * LDQ + (cb + c) * 16, LDQ);
          wmma::mma_sync(oacc[c], pa, vf, oacc[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < OCOLS; ++c)
        wmma::store_matrix_sync(Os + fr * 16 * LDO + (cb + c) * 16, oacc[c], LDO,
                                wmma::mem_row_major);
    }
    __syncthreads();
  }

  for (int e = tid; e < kFq * CPR; e += kFThreads) {
    const int r = e / CPR, c = (e % CPR) * 8;
    if (kTail && q0 + r >= Lq) continue;
    const float inv = 1.0f / row_l[r];
    uint4 packed;
    uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      __nv_bfloat162 r2 = __floats2bfloat162_rn(Os[r * LDO + c + i] * inv,
                                               Os[r * LDO + c + i + 1] * inv);
      pk[i >> 1] = *reinterpret_cast<uint32_t*>(&r2);
    }
    *reinterpret_cast<uint4*>(ob + (q0 + r) * g.so.row + c) = packed;
  }
  if (g.z != nullptr && tid < kFq && (!kTail || q0 + tid < Lq))
    g.z[(size_t)blockIdx.y * Lq + q0 + tid] = row_m[tid] + logf(row_l[tid]);
}

template <int D, bool kTail>
int launch_flash(const FwdArgs& g, int B, cudaStream_t stream) {
  const size_t smem = FlashLayout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, kTail>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.Lq + kFq - 1) / kFq, B * g.H);
  flash_fwd_kernel<D, kTail><<<grid, kFThreads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <int D>
int launch_flash(const FwdArgs& g, int B, cudaStream_t stream) {
  return g.Lq % kFq != 0 || g.Lk % kFkv != 0 ? launch_flash<D, true>(g, B, stream)
                                              : launch_flash<D, false>(g, B, stream);
}

int flash_entry(const FwdArgs& g, int B, int D, void* stream) {
  if (B <= 0 || g.H <= 0 || g.Lq <= 0 || g.Lk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_flash<64>(g, B, s);
    case 128: return launch_flash<128>(g, B, s);
    case 256: return launch_flash<256>(g, B, s);
    case 512: return launch_flash<512>(g, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The token-major entries: q, k, v at token stride in_stride (head h at
// channel h * D), o (B, L, H*D); L a multiple of 64.
int token_major_entry(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* z, int B,
                      int L, int H, int D, int in_stride, float scale, void* stream) {
  if (L % kFkv != 0) return (int)cudaErrorInvalidValue;
  const long long is = in_stride, os = (long long)H * D;
  const FwdArgs g{q, k, v, o, z, {L * is, D, is}, {L * is, D, is}, {L * os, D, os},
                  L, L, H, scale};
  return flash_entry(g, B, D, stream);
}

}  // namespace

// q, k, v, o: (B, L, H*D) bf16, contiguous.  L must be a multiple of 64 and
// D one of 64, 128, 256, 512.
extern "C" int gvq_flash_fwd(const void* q, const void* k, const void* v, void* o, int B,
                             int L, int H, int D, float scale, void* stream) {
  return token_major_entry(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), static_cast<bf16*>(o), nullptr, B, L, H,
                           D, H * D, scale, stream);
}

// The training form of the unpacked entry: also writes z (B, H, L) float32,
// z = m + ln(sum) of each row's scaled scores.  Same shape rules.
extern "C" int gvq_flash_fwd_res(const void* q, const void* k, const void* v, void* o, void* z,
                                 int B, int L, int H, int D, float scale, void* stream) {
  if (z == nullptr) return (int)cudaErrorInvalidValue;
  return token_major_entry(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), static_cast<bf16*>(o),
                           static_cast<float*>(z), B, L, H, D, H * D, scale, stream);
}

// The packed entry (replaces flash_blc.py _fwd_call_packed): q, k and v are
// read in place from the contiguous (B, L, 3C) QKV projection output, q | k
// | v along channels (C = H*D), at token stride 3C and channel offsets 0, C
// and 2C; o is (B, L, C).  No q/k/v copy exists.  Same shape rules.
extern "C" int gvq_flash_fwd_qkv(const void* qkv, void* o, int B, int L, int H, int D,
                                 float scale, void* stream) {
  const bf16* p = static_cast<const bf16*>(qkv);
  const size_t c = (size_t)H * D;
  return token_major_entry(p, p + c, p + 2 * c, static_cast<bf16*>(o), nullptr, B, L, H, D,
                           3 * H * D, scale, stream);
}

// The training form of the packed entry: also writes z (B, H, L) float32,
// z = m + ln(sum) of each row's scaled scores.  Same shape rules.
extern "C" int gvq_flash_fwd_qkv_res(const void* qkv, void* o, void* z, int B, int L, int H,
                                     int D, float scale, void* stream) {
  const bf16* p = static_cast<const bf16*>(qkv);
  const size_t c = (size_t)H * D;
  if (z == nullptr) return (int)cudaErrorInvalidValue;
  return token_major_entry(p, p + c, p + 2 * c, static_cast<bf16*>(o), static_cast<float*>(z), B,
                           L, H, D, 3 * H * D, scale, stream);
}

// The head-major entry (replaces vqvae_from_gaussian_vae_tpu/ops/flash_attention.py
// _fwd / flash_attention -> the upstream _flash_attention_impl): q, o (B, H,
// Lq, D) and k, v (B, H, Lk, D) bf16, contiguous, any Lq, Lk >= 1 (the last
// q and k tiles may be partial).  z (B, H, Lq) float32 is written where it is
// not null (the training form).  Row stride D, head stride L * D, each with
// its own L for q and for k, v.
extern "C" int gvq_flash_fwd_hm(const void* q, const void* k, const void* v, void* o, void* z,
                                int B, int H, int Lq, int Lk, int D, float scale, void* stream) {
  const long long d = D, hq = (long long)Lq * D, hk = (long long)Lk * D;
  const FwdArgs g{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(z),
                  {H * hq, hq, d}, {H * hk, hk, d}, {H * hq, hq, d}, Lq, Lk, H, scale};
  return flash_entry(g, B, D, stream);
}

// Message for an error code returned by any gvq_* entry point.
extern "C" const char* gvq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
