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

template <int D>
__global__ void __launch_bounds__(kFThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int L, int H, float scale) {
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
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * kFq;
  const size_t rs = (size_t)H * D;  // token stride
  const size_t base = (size_t)b * L * rs + (size_t)h * D;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  bf16* ob = o + base;

  for (int e = tid; e < kFq * CPR; e += kFThreads) {
    const int r = e / CPR, c = (e % CPR) * 8;
    *reinterpret_cast<uint4*>(Qs + r * LDQ + c) =
        *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * rs + c);
  }
  for (int e = tid; e < kFq * D; e += kFThreads) Os[(e / D) * LDO + e % D] = 0.0f;
  if (tid < kFq) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.0f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < L; k0 += kFkv) {
    for (int e = tid; e < kFkv * CPR; e += kFThreads) {
      const int r = e / CPR, c = (e % CPR) * 8;
      *reinterpret_cast<uint4*>(KVs + r * LDQ + c) =
          *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * rs + c);
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

    // V takes the K buffer; the online-softmax update runs on S meanwhile
    for (int e = tid; e < kFkv * CPR; e += kFThreads) {
      const int r = e / CPR, c = (e % CPR) * 8;
      *reinterpret_cast<uint4*>(KVs + r * LDQ + c) =
          *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * rs + c);
    }
    {  // 8 threads per row, 8 scores each
      const int r = tid >> 3, part = tid & 7;
      float sv[8];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sv[i] = Ss[r * kLdS + part * 8 + i] * scale;
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
    const float inv = 1.0f / row_l[r];
    uint4 packed;
    uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      __nv_bfloat162 r2 = __floats2bfloat162_rn(Os[r * LDO + c + i] * inv,
                                               Os[r * LDO + c + i + 1] * inv);
      pk[i >> 1] = *reinterpret_cast<uint32_t*>(&r2);
    }
    *reinterpret_cast<uint4*>(ob + (size_t)(q0 + r) * rs + c) = packed;
  }
}

template <int D>
int launch_flash(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int L, int H,
                 float scale, cudaStream_t stream) {
  const size_t smem = FlashLayout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(L / kFq, B * H);
  flash_fwd_kernel<D><<<grid, kFThreads, smem, stream>>>(q, k, v, o, L, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, L, H*D) bf16, contiguous.  L must be a multiple of 64 and
// D one of 64, 128, 256, 512.
extern "C" int gvq_flash_fwd(const void* q, const void* k, const void* v, void* o, int B,
                             int L, int H, int D, float scale, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || L % kFkv != 0) return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_flash<64>(qp, kp, vp, op, B, L, H, scale, s);
    case 128: return launch_flash<128>(qp, kp, vp, op, B, L, H, scale, s);
    case 256: return launch_flash<256>(qp, kp, vp, op, B, L, H, scale, s);
    case 512: return launch_flash<512>(qp, kp, vp, op, B, L, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Message for an error code returned by any gvq_* entry point.
extern "C" const char* gvq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
