// Row LayerNorm and the fused residual add + LayerNorm, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of vqvae_from_gaussian_vae_tpu/ops/layer_norm.py:
// _ln_fwd_2d (body _ln_fwd_kernel), _ln_add_fwd_2d (_ln_add_fwd_kernel),
// _ln_bwd_2d (_ln_bwd_kernel) and _ln_add_bwd_2d (_ln_add_bwd_kernel).  Over
// the last axis of an (R, C) array:
//
//   y = (x - mean) * rsqrt(var + eps) * gamma + beta
//   add variant: s = round_io(x + d); y = LN(s); both written
//
// with float32 statistics, the variance as the mean of (x - mean)^2 (two
// passes over the row held in registers, not E[x^2] - mean^2), and the
// add variant's statistics taken from the ROUNDED s, as the TPU kernel does.
//
// The backward saves nothing from the forward: it recomputes mean and rstd
// from the saved input (x, or the add variant's s), then
//
//   xhat = (x - mean) * rstd,  wdy = dy * gamma
//   dx = (wdy - mean(wdy) - xhat * mean(wdy * xhat)) * rstd  (+ ds_in)
//   dgamma = sum_rows dy * xhat,  dbeta = sum_rows dy   (float32)
//
// dgamma and dbeta are reduced without float atomics, so they are
// bit-reproducible: each lane keeps float32 partials of its own columns over
// the rows its warp walks, the block's warps add theirs into shared memory
// in a fixed order, each block writes one (2, C) partial, and a second
// kernel sums the block partials per column in block order.
//
// What bounds it on an H100: a few FLOP per element against 2 bytes read
// and 2 written (bf16), so it is bound by bytes: at the ViT shape (16384,
// 768) bf16 one LN moves 50 MB (15 us at 3.35 TB/s), one LN-add 101 MB, one
// LN backward 75 MB and one LN-add backward 101 MB.  The design does nothing
// but stream: one warp per row, the row held in registers through 16-byte
// loads (three uint4 a lane at C = 768 in bf16), the reductions by warp
// shuffles, no second read of x.  Eight rows (warps) a block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kMaxC = 4096;       // at most 128 floats of a row in a lane's registers
constexpr int kMaxPerLane = kMaxC / 32;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;  // elements per 16-byte chunk
  __device__ static float to_f(float v) { return v; }
  __device__ static float from_f(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from_f(float v) { return __float2bfloat16_rn(v); }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// NCH: 16-byte chunks a lane holds (chunk j*32 + lane of the row's C / kVec)
template <typename T, int NCH, bool ADD>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ d, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ s_out, T* __restrict__ y, int R,
              int C, float eps) {
  constexpr int V = Io<T>::kVec;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const int nch = C / V;
  const size_t off = (size_t)row * C;

  float v[NCH * V];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int ch = j * 32 + lane;
    if (ch < nch) {
      alignas(16) T xe[V];
      *reinterpret_cast<uint4*>(xe) = *reinterpret_cast<const uint4*>(x + off + (size_t)ch * V);
      if (ADD) {
        alignas(16) T de[V];
        *reinterpret_cast<uint4*>(de) = *reinterpret_cast<const uint4*>(d + off + (size_t)ch * V);
#pragma unroll
        for (int i = 0; i < V; ++i) xe[i] = Io<T>::from_f(Io<T>::to_f(xe[i]) + Io<T>::to_f(de[i]));
        *reinterpret_cast<uint4*>(s_out + off + (size_t)ch * V) = *reinterpret_cast<uint4*>(xe);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) v[j * V + i] = Io<T>::to_f(xe[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[j * V + i] = 0.0f;
    }
  }

  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < NCH * V; ++i) sum += v[i];
  const float mean = warp_sum(sum) / (float)C;

  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    if (j * 32 + lane < nch) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float c = v[j * V + i] - mean;
        sq += c * c;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)C + eps);

#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int ch = j * 32 + lane;
    if (ch < nch) {
      alignas(16) float g[V];
      alignas(16) float b[V];
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        *reinterpret_cast<float4*>(g + i) = *reinterpret_cast<const float4*>(gamma + ch * V + i);
        *reinterpret_cast<float4*>(b + i) = *reinterpret_cast<const float4*>(beta + ch * V + i);
      }
      alignas(16) T ye[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        ye[i] = Io<T>::from_f((v[j * V + i] - mean) * rstd * g[i] + b[i]);
      *reinterpret_cast<uint4*>(y + off + (size_t)ch * V) = *reinterpret_cast<uint4*>(ye);
    }
  }
}

template <typename T, int NCH, bool ADD>
int launch_ln(const void* x, const void* d, const float* g, const float* b, void* s, void* y,
              int R, int C, float eps, cudaStream_t stream) {
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock);
  ln_fwd_kernel<T, NCH, ADD><<<grid, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(d), g, b, static_cast<T*>(s),
      static_cast<T*>(y), R, C, eps);
  return (int)cudaGetLastError();
}

// the smallest chunk count from a fixed set that covers C
template <typename T, bool ADD>
int dispatch(const void* x, const void* d, const float* g, const float* b, void* s, void* y,
             int R, int C, float eps, cudaStream_t st) {
  constexpr int V = Io<T>::kVec;
  const int need = (C / V + 31) / 32;
#define GVQ_LN_CASE(N)                                                           \
  if (N * V <= kMaxPerLane && need <= N)                                         \
    return launch_ln<T, (N * V <= kMaxPerLane ? N : 1), ADD>(x, d, g, b, s, y, R, C, eps, st);
  GVQ_LN_CASE(1)
  GVQ_LN_CASE(2)
  GVQ_LN_CASE(3)
  GVQ_LN_CASE(4)
  GVQ_LN_CASE(6)
  GVQ_LN_CASE(8)
  GVQ_LN_CASE(12)
  GVQ_LN_CASE(16)
  GVQ_LN_CASE(24)
  GVQ_LN_CASE(32)
#undef GVQ_LN_CASE
  return (int)cudaErrorInvalidValue;
}

template <bool ADD>
int ln_entry(const void* x, const void* d, const void* g, const void* b, void* s, void* y, int R,
             int C, int dtype, float eps, void* stream) {
  if (R <= 0 || C <= 0 || C % 8 != 0 || C > kMaxC) return (int)cudaErrorInvalidValue;
  const float* gp = static_cast<const float*>(g);
  const float* bp = static_cast<const float*>(b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float, ADD>(x, d, gp, bp, s, y, R, C, eps, st);
    case 1: return dispatch<__nv_bfloat16, ADD>(x, d, gp, bp, s, y, R, C, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// backward

constexpr int kMaxBwdBlocks = 264;  // two blocks on each of the H100's 132 SMs

// One warp per row, rows strided over the grid; ADD adds ds_in to dx.
// part: (gridDim.x, 2, C) float32, the block's (dgamma, dbeta) partial.
template <typename T, int NCH, bool ADD>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma, const T* __restrict__ dy,
              const T* __restrict__ ds_in, T* __restrict__ dx, float* __restrict__ part, int R,
              int C, float eps) {
  constexpr int V = Io<T>::kVec;
  extern __shared__ float red[];  // (2, C): this block's dgamma, dbeta
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nch = C / V;

  float pg[NCH * V], pb[NCH * V];
#pragma unroll
  for (int i = 0; i < NCH * V; ++i) pg[i] = pb[i] = 0.0f;

  for (int row = blockIdx.x * kRowsPerBlock + warp; row < R; row += gridDim.x * kRowsPerBlock) {
    const size_t off = (size_t)row * C;
    float v[NCH * V], g[NCH * V];
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int ch = j * 32 + lane;
      if (ch < nch) {
        alignas(16) T xe[V];
        alignas(16) T de[V];
        *reinterpret_cast<uint4*>(xe) = *reinterpret_cast<const uint4*>(x + off + (size_t)ch * V);
        *reinterpret_cast<uint4*>(de) = *reinterpret_cast<const uint4*>(dy + off + (size_t)ch * V);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          v[j * V + i] = Io<T>::to_f(xe[i]);
          g[j * V + i] = Io<T>::to_f(de[i]);  // dy for now
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[j * V + i] = g[j * V + i] = 0.0f;
      }
    }

    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < NCH * V; ++i) sum += v[i];
    const float mean = warp_sum(sum) / (float)C;
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (j * 32 + lane < nch) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float c = v[j * V + i] - mean;
          sq += c * c;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / (float)C + eps);

    // v becomes xhat; the row sums of wdy and wdy * xhat
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int ch = j * 32 + lane;
      if (ch < nch) {
        alignas(16) float ga[V];
#pragma unroll
        for (int i = 0; i < V; i += 4)
          *reinterpret_cast<float4*>(ga + i) = *reinterpret_cast<const float4*>(gamma + ch * V + i);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xh = (v[j * V + i] - mean) * rstd;
          const float dyv = g[j * V + i];
          const float wdy = dyv * ga[i];
          v[j * V + i] = xh;
          s1 += wdy;
          s2 += wdy * xh;
          pg[j * V + i] += dyv * xh;
          pb[j * V + i] += dyv;
          g[j * V + i] = wdy;  // g now holds wdy
        }
      }
    }
    const float c1 = warp_sum(s1) / (float)C;
    const float c2 = warp_sum(s2) / (float)C;

#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int ch = j * 32 + lane;
      if (ch < nch) {
        alignas(16) T out[V];
        alignas(16) T se[V];
        if (ADD)
          *reinterpret_cast<uint4*>(se) =
              *reinterpret_cast<const uint4*>(ds_in + off + (size_t)ch * V);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float d = (g[j * V + i] - c1 - v[j * V + i] * c2) * rstd;
          if (ADD) d += Io<T>::to_f(se[i]);
          out[i] = Io<T>::from_f(d);
        }
        *reinterpret_cast<uint4*>(dx + off + (size_t)ch * V) = *reinterpret_cast<uint4*>(out);
      }
    }
  }

  // the block's partial: its warps add in warp order
  for (int e = threadIdx.x; e < 2 * C; e += blockDim.x) red[e] = 0.0f;
  __syncthreads();
  for (int w = 0; w < kRowsPerBlock; ++w) {
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int ch = j * 32 + lane;
        if (ch < nch) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            red[ch * V + i] += pg[j * V + i];
            red[C + ch * V + i] += pb[j * V + i];
          }
        }
      }
    }
    __syncthreads();
  }
  float* pout = part + (size_t)blockIdx.x * 2 * C;
  for (int e = threadIdx.x; e < 2 * C; e += blockDim.x) pout[e] = red[e];
}

// out[e] = sum over blocks of part[b, e], in block order
__global__ void ln_param_reduce_kernel(const float* __restrict__ part, int nblocks, int n,
                                       float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.0f;
  for (int b = 0; b < nblocks; ++b) acc += part[(size_t)b * n + e];
  out[e] = acc;
}

template <typename T, int NCH, bool ADD>
int launch_ln_bwd(const void* x, const float* g, const void* dy, const void* ds_in, void* dx,
                  float* part, float* dgb, int R, int C, int nblocks, float eps,
                  cudaStream_t stream) {
  const size_t smem = 2 * (size_t)C * sizeof(float);
  ln_bwd_kernel<T, NCH, ADD><<<nblocks, kRowsPerBlock * 32, smem, stream>>>(
      static_cast<const T*>(x), g, static_cast<const T*>(dy), static_cast<const T*>(ds_in),
      static_cast<T*>(dx), part, R, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_param_reduce_kernel<<<(2 * C + 255) / 256, 256, 0, stream>>>(part, nblocks, 2 * C, dgb);
  return (int)cudaGetLastError();
}

template <typename T, bool ADD>
int dispatch_bwd(const void* x, const float* g, const void* dy, const void* ds_in, void* dx,
                 float* part, float* dgb, int R, int C, int nblocks, float eps, cudaStream_t st) {
  constexpr int V = Io<T>::kVec;
  const int need = (C / V + 31) / 32;
#define GVQ_LN_BWD_CASE(N)                                                              \
  if (N * V <= kMaxPerLane && need <= N)                                                \
    return launch_ln_bwd<T, (N * V <= kMaxPerLane ? N : 1), ADD>(x, g, dy, ds_in, dx, part, \
                                                                 dgb, R, C, nblocks, eps, st);
  GVQ_LN_BWD_CASE(1)
  GVQ_LN_BWD_CASE(2)
  GVQ_LN_BWD_CASE(3)
  GVQ_LN_BWD_CASE(4)
  GVQ_LN_BWD_CASE(6)
  GVQ_LN_BWD_CASE(8)
  GVQ_LN_BWD_CASE(12)
  GVQ_LN_BWD_CASE(16)
  GVQ_LN_BWD_CASE(24)
  GVQ_LN_BWD_CASE(32)
#undef GVQ_LN_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

template <bool ADD>
int ln_bwd_entry(const void* x, const void* g, const void* dy, const void* ds_in, void* dx,
                 void* part, void* dgb, int R, int C, int nblocks, int dtype, float eps,
                 void* stream) {
  if (R <= 0 || C <= 0 || C % 8 != 0 || C > kMaxC || nblocks <= 0 || nblocks > kMaxBwdBlocks)
    return (int)cudaErrorInvalidValue;
  const float* gp = static_cast<const float*>(g);
  float* pp = static_cast<float*>(part);
  float* op = static_cast<float*>(dgb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_bwd<float, ADD>(x, gp, dy, ds_in, dx, pp, op, R, C, nblocks, eps, st);
    case 1:
      return dispatch_bwd<__nv_bfloat16, ADD>(x, gp, dy, ds_in, dx, pp, op, R, C, nblocks, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (R, C) contiguous, dtype 0 = float32, 1 = bf16; gamma, beta: (C,)
// float32.  C a multiple of 8, at most 4096; every pointer 16-byte aligned.
extern "C" int gvq_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                  int R, int C, int dtype, float eps, void* stream) {
  return ln_entry<false>(x, nullptr, gamma, beta, nullptr, y, R, C, dtype, eps, stream);
}

// The add variant: s = x + d rounded to the IO dtype, y = LN(s); x, d, s, y
// (R, C) of one dtype.
extern "C" int gvq_layer_norm_add_fwd(const void* x, const void* d, const void* gamma,
                                      const void* beta, void* s, void* y, int R, int C,
                                      int dtype, float eps, void* stream) {
  return ln_entry<true>(x, d, gamma, beta, s, y, R, C, dtype, eps, stream);
}

// LN backward: x (the forward's input), dy, dx (R, C) of one dtype; gamma
// (C,) float32; part (nblocks, 2, C) float32 scratch; dgb (2, C) float32
// gets (dgamma, dbeta).  nblocks in [1, 264], the grid the rows are strided
// over (the caller picks it: min(ceil(R / 8), 264)).
extern "C" int gvq_layer_norm_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                                  void* part, void* dgb, int R, int C, int nblocks, int dtype,
                                  float eps, void* stream) {
  return ln_bwd_entry<false>(x, gamma, dy, nullptr, dx, part, dgb, R, C, nblocks, dtype, eps,
                             stream);
}

// LN-add backward: s (the forward's rounded sum), dy and ds_in (the
// cotangents of y and s) -> dx = LN'(s) dy + ds_in, the gradient of both x
// and d.  Same layout rules as gvq_layer_norm_bwd.
extern "C" int gvq_layer_norm_add_bwd(const void* s, const void* gamma, const void* dy,
                                      const void* ds_in, void* dx, void* part, void* dgb, int R,
                                      int C, int nblocks, int dtype, float eps, void* stream) {
  return ln_bwd_entry<true>(s, gamma, dy, ds_in, dx, part, dgb, R, C, nblocks, dtype, eps, stream);
}
