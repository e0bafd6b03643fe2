// What the conv bodies share: the bf16 alias; swish (the float32 fused
// GroupNorm + swish conv kernel) and the GroupNorm + swish transform of 8
// bf16 channels (conv_igemm_sm90.cuh mode kIgSameGn's A operand); and the
// ordered reduce of the resample forwards' per-block GroupNorm statistics.
//
// The implicit-GEMM bodies are conv_igemm_sm90.cuh (every forward and
// input gradient of the resamples and the fused GroupNorm + swish conv)
// and conv_wgrad.cuh (the weight gradients).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Everything below has internal linkage: several sources include this
// header and are linked into one library.
namespace gvq {
namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float swish(float h) { return h / (1.0f + __expf(-h)); }

// swish(x * scale + shift) on 8 bf16 channels in float32, rounded to bf16
// (scale, shift: 8 consecutive float32, 16-byte aligned).  The division is
// the fast one (__fdividef, about 2 ulp of float32): its error is far below
// the bf16 rounding that follows, and the transform's instructions are what
// kIgSameGn's products wait for.
__device__ __forceinline__ uint4 gn_swish_bf16x8(uint4 a, const float* scale,
                                                 const float* shift) {
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(scale));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(scale) + 1);
  const float4 t0 = __ldg(reinterpret_cast<const float4*>(shift));
  const float4 t1 = __ldg(reinterpret_cast<const float4*>(shift) + 1);
  const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float sh[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
  uint4 out;
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(&a);
  uint32_t* po = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pa[i]));
    const float h0 = f.x * sc[2 * i] + sh[2 * i], h1 = f.y * sc[2 * i + 1] + sh[2 * i + 1];
    __nv_bfloat162 r = __floats2bfloat162_rn(__fdividef(h0, 1.0f + __expf(-h0)),
                                             __fdividef(h1, 1.0f + __expf(-h1)));
    po[i] = *reinterpret_cast<uint32_t*>(&r);
  }
  return out;
}

// stats[b, q, o] = sum over p of partial[b, p, q, o], p ascending
__global__ void conv_stats_reduce_kernel(const float* __restrict__ partial,
                                         float* __restrict__ stats, int B, int P, int O) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * 2 * O) return;
  const int o = idx % O;
  const int q = (idx / O) % 2;
  const int b = idx / (2 * O);
  float acc = 0.0f;
  for (int p = 0; p < P; ++p) acc += partial[(((size_t)b * P + p) * 2 + q) * O + o];
  stats[idx] = acc;
}

}  // namespace
}  // namespace gvq
