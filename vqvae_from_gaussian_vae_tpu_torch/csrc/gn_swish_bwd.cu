// GroupNorm + swish backward for Hopper (sm_90a).
//
// Replaces the TPU kernel vqvae_from_gaussian_vae_tpu/ops/gn_swish_bwd.py
// (_gn_swish_bwd_pallas -> pl.pallas_call, body _bwd_kernel), the backward
// of y = swish(GN(x) * gamma + beta) behind the custom VJP gn_swish.  From
// x and dy (B, HW, C), the forward's saved per-(sample, channel) mean and
// rstd (B, C) float32, and gamma, beta (C,) float32:
//
//   xhat = (x - mean) * rstd,  hpre = xhat * gamma + beta,  sig = sigmoid(hpre)
//   dh = dy * sig * (1 + hpre * (1 - sig))                (the swish backward)
//   s1[b, c] = sum_hw dh * xhat,  s2[b, c] = sum_hw dh
//   c2[b, g] = mean over (hw, c in g) of gamma * dh * xhat = sum_{c in g} gamma s1 / n
//   c1[b, g] = sum_{c in g} gamma s2 / n,   n = HW * C / G
//   dx = (dh * gamma - c1 - xhat * c2) * rstd             (in x's dtype)
//   dgamma = sum_b s1,  dbeta = sum_b s2                  (float32)
//
// As the TPU kernel does, dh is recomputed rather than stored: pass 1 reads
// x and dy and takes the per-(b, c) sums over fixed row bands, each block's
// row slots added in a fixed order into one float32 partial per band; a
// finalize kernel sums the bands in order and forms c1, c2 per group (each
// channel sums its group's channels in the same order); a third sums
// dgamma, dbeta over b in order; pass 2 reads x and dy again and writes dx.
// No float atomics anywhere: dx, dgamma and dbeta repeat bit for bit.
//
// What bounds it on an H100: a few tens of FLOP per element against 2 bytes
// read of x and of dy in each pass and 2 written (bf16), so bytes bound it;
// the least traffic (x and dy read once, dx written once) at the sd3unet
// sites is 50 MB at 32x32x512 to 805 MB at 256x256x128 (bs=16).  Pass 2
// rereads x and dy (5 traversals instead of the 3 of the bound), the price
// of not storing dh; each thread streams 8 channels a row through 16-byte
// loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGnThreads = 256;

template <typename T>
struct Vec8;

template <>
struct Vec8<float> {
  __device__ static void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *(reinterpret_cast<float4*>(p) + 1) = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <>
struct Vec8<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = a;
  }
};

// The per-channel operands of a thread's 8 channels, and the recomputed
// xhat and dh of one row's 8 elements
struct ChanParams {
  float mean[8], rstd[8], gamma[8], beta[8];

  __device__ void load(const float* m, const float* r, const float* g, const float* b) {
    Vec8<float>::load(m, mean);
    Vec8<float>::load(r, rstd);
    Vec8<float>::load(g, gamma);
    Vec8<float>::load(b, beta);
  }

  __device__ void recompute(const float* x, const float* dy, float* xhat, float* dh) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      xhat[e] = (x[e] - mean[e]) * rstd[e];
      const float hpre = xhat[e] * gamma[e] + beta[e];
      const float sig = 1.0f / (1.0f + expf(-hpre));
      dh[e] = dy[e] * (sig * (1.0f + hpre * (1.0f - sig)));
    }
  }
};

// Threads of a block: tpr = C / 8 per row (8 channels each), row slots =
// 256 / tpr rows at a time; slot s walks rows r0 + s, r0 + s + slots, ...
// of its band.
struct Layout {
  int tpr, slots, slot, cc, r0, r1;

  __device__ Layout(int HW, int C, int rows_per_band) {
    tpr = C / 8;
    slots = kGnThreads / tpr;
    slot = threadIdx.x / tpr;
    cc = (threadIdx.x % tpr) * 8;
    r0 = blockIdx.x * rows_per_band;
    r1 = min(r0 + rows_per_band, HW);
  }
  __device__ bool active() const { return slot < slots; }
};

// pass 1: partial[b, band, 0 / 1, c] = sums of dh * xhat / dh over the band
template <typename T>
__global__ void __launch_bounds__(kGnThreads)
gn_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ mean, const float* __restrict__ rstd,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   float* __restrict__ partial, int HW, int C, int rows_per_band) {
  extern __shared__ float red[];  // (slots, 2, C)
  const int b = blockIdx.y;
  const Layout lay(HW, C, rows_per_band);
  if (lay.active()) {
    ChanParams p;
    p.load(mean + (size_t)b * C + lay.cc, rstd + (size_t)b * C + lay.cc, gamma + lay.cc,
           beta + lay.cc);
    float s1[8] = {}, s2[8] = {};
    for (int row = lay.r0 + lay.slot; row < lay.r1; row += lay.slots) {
      const size_t off = ((size_t)b * HW + row) * C + lay.cc;
      float xv[8], dv[8], xhat[8], dh[8];
      Vec8<T>::load(x + off, xv);
      Vec8<T>::load(dy + off, dv);
      p.recompute(xv, dv, xhat, dh);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s1[e] += dh[e] * xhat[e];
        s2[e] += dh[e];
      }
    }
    Vec8<float>::store(red + (size_t)(lay.slot * 2) * C + lay.cc, s1);
    Vec8<float>::store(red + (size_t)(lay.slot * 2 + 1) * C + lay.cc, s2);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C; i += kGnThreads) {
    const int q = i / C, c = i % C;
    float acc = 0.0f;
    for (int s = 0; s < lay.slots; ++s) acc += red[(size_t)(s * 2 + q) * C + c];
    partial[(((size_t)b * gridDim.x + blockIdx.x) * 2 + q) * C + c] = acc;
  }
}

// sums[b, q, c] = sum over bands (ascending) of partial[b, band, q, c];
// consts[b, 0, c] = c1, consts[b, 1, c] = c2 of c's group
__global__ void __launch_bounds__(kGnThreads)
gn_bwd_finalize_kernel(const float* __restrict__ partial, const float* __restrict__ gamma,
                       float* __restrict__ sums, float* __restrict__ consts, int bands, int C,
                       int G, float inv_n) {
  extern __shared__ float gs[];  // (2, C): gamma * s1, gamma * s2
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += kGnThreads) {
    float a1 = 0.0f, a2 = 0.0f;
    for (int p = 0; p < bands; ++p) {
      a1 += partial[(((size_t)b * bands + p) * 2) * C + c];
      a2 += partial[(((size_t)b * bands + p) * 2 + 1) * C + c];
    }
    sums[((size_t)b * 2) * C + c] = a1;
    sums[((size_t)b * 2 + 1) * C + c] = a2;
    gs[c] = a1 * gamma[c];
    gs[C + c] = a2 * gamma[c];
  }
  __syncthreads();
  const int cg = C / G;
  for (int c = threadIdx.x; c < C; c += kGnThreads) {
    const int g0 = (c / cg) * cg;
    float t1 = 0.0f, t2 = 0.0f;
    for (int k = 0; k < cg; ++k) {
      t1 += gs[g0 + k];
      t2 += gs[C + g0 + k];
    }
    consts[((size_t)b * 2) * C + c] = t2 * inv_n;      // c1
    consts[((size_t)b * 2 + 1) * C + c] = t1 * inv_n;  // c2
  }
}

// dgamma[c] = sum_b sums[b, 0, c], dbeta[c] = sum_b sums[b, 1, c], b ascending
__global__ void gn_bwd_params_kernel(const float* __restrict__ sums, float* __restrict__ dgamma,
                                     float* __restrict__ dbeta, int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float g = 0.0f, be = 0.0f;
  for (int b = 0; b < B; ++b) {
    g += sums[((size_t)b * 2) * C + c];
    be += sums[((size_t)b * 2 + 1) * C + c];
  }
  dgamma[c] = g;
  dbeta[c] = be;
}

// pass 2: dx = (dh * gamma - c1 - xhat * c2) * rstd
template <typename T>
__global__ void __launch_bounds__(kGnThreads)
gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ mean, const float* __restrict__ rstd,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const float* __restrict__ consts, T* __restrict__ dx, int HW, int C,
                    int rows_per_band) {
  const int b = blockIdx.y;
  const Layout lay(HW, C, rows_per_band);
  if (!lay.active()) return;
  ChanParams p;
  p.load(mean + (size_t)b * C + lay.cc, rstd + (size_t)b * C + lay.cc, gamma + lay.cc,
         beta + lay.cc);
  float c1[8], c2[8];
  Vec8<float>::load(consts + ((size_t)b * 2) * C + lay.cc, c1);
  Vec8<float>::load(consts + ((size_t)b * 2 + 1) * C + lay.cc, c2);
  for (int row = lay.r0 + lay.slot; row < lay.r1; row += lay.slots) {
    const size_t off = ((size_t)b * HW + row) * C + lay.cc;
    float xv[8], dv[8], xhat[8], dh[8], out[8];
    Vec8<T>::load(x + off, xv);
    Vec8<T>::load(dy + off, dv);
    p.recompute(xv, dv, xhat, dh);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = (dh[e] * p.gamma[e] - c1[e] - xhat[e] * c2[e]) * p.rstd[e];
    Vec8<T>::store(dx + off, out);
  }
}

template <typename T>
int launch_gn_swish_bwd(const T* x, const T* dy, const float* mean, const float* rstd,
                        const float* gamma, const float* beta, float* scratch, T* dx,
                        float* dgamma, float* dbeta, int B, int HW, int C, int G, int bands,
                        int rows_per_band, cudaStream_t stream) {
  float* partial = scratch;                        // (B, bands, 2, C)
  float* sums = partial + (size_t)B * bands * 2 * C;  // (B, 2, C)
  float* consts = sums + (size_t)B * 2 * C;         // (B, 2, C)
  const int slots = kGnThreads / (C / 8);
  const dim3 grid(bands, B);
  gn_bwd_sums_kernel<T><<<grid, kGnThreads, (size_t)slots * 2 * C * sizeof(float), stream>>>(
      x, dy, mean, rstd, gamma, beta, partial, HW, C, rows_per_band);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_bwd_finalize_kernel<<<B, kGnThreads, 2 * C * sizeof(float), stream>>>(
      partial, gamma, sums, consts, bands, C, G, 1.0f / ((float)HW * (float)(C / G)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_bwd_params_kernel<<<(C + 255) / 256, 256, 0, stream>>>(sums, dgamma, dbeta, B, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_bwd_apply_kernel<T><<<grid, kGnThreads, 0, stream>>>(x, dy, mean, rstd, gamma, beta, consts,
                                                          dx, HW, C, rows_per_band);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx (B, HW, C) of one dtype (0 float32, 1 bf16); mean, rstd (B, C),
// gamma, beta, dgamma, dbeta (C,) float32; scratch float32 of B * (bands +
// 2) * 2 * C.  All contiguous; C a multiple of 8 and of G, at most 2048;
// bands * rows_per_band must cover HW.
extern "C" int gvq_gn_swish_bwd(const void* x, const void* dy, const float* mean,
                                const float* rstd, const float* gamma, const float* beta,
                                float* scratch, void* dx, float* dgamma, float* dbeta, int B,
                                int HW, int C, int G, int bands, int rows_per_band, int dtype,
                                void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || C % 8 != 0 || C > 8 * kGnThreads || G <= 0 || C % G != 0 ||
      bands <= 0 || rows_per_band <= 0 || (long long)bands * rows_per_band < HW)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_gn_swish_bwd(static_cast<const float*>(x), static_cast<const float*>(dy), mean,
                               rstd, gamma, beta, scratch, static_cast<float*>(dx), dgamma, dbeta,
                               B, HW, C, G, bands, rows_per_band, s);
  if (dtype == 1)
    return launch_gn_swish_bwd(static_cast<const __nv_bfloat16*>(x),
                               static_cast<const __nv_bfloat16*>(dy), mean, rstd, gamma, beta,
                               scratch, static_cast<__nv_bfloat16*>(dx), dgamma, dbeta, B, HW, C,
                               G, bands, rows_per_band, s);
  return (int)cudaErrorInvalidValue;
}
