// Fused GroupNorm + swish + 3x3 "same" conv (+ residual) for Hopper (sm_90a).
//
// Replaces the TPU kernel vqvae_from_gaussian_vae_tpu/ops/fused_gn_conv.py
// (_fused_gn_swish_conv -> pl.pallas_call, body _kernel): from x (B, H, W, C)
// and the per-(sample, channel) GroupNorm affine (scale, shift), computed
// outside as the JAX package does (gn_affine), it forms swish(x * scale +
// shift) in float32, pads that with zeros, convolves it with w (3, 3, C, O),
// adds the float32 bias and an optional residual (B, H, W, O), and rounds
// once to x's dtype.
//
// bf16 (gvq_fused_gn_conv): the Hopper implicit-GEMM body
// (conv_igemm_sm90.cuh, mode kIgSameGn).  As the TPU kernel transforms a
// band of rows once and runs its taps over it, a block transforms its 8 x
// 16 tile's halo box of (8 + 2) x (16 + 2) pixels once per 64-channel K
// step, in shared memory (TMA brings the box with zero fill; the transform
// writes 0 off the image and past C, so the padding applies after it), and
// the nine taps read shifted windows of it into register A fragments for
// wgmma, the weights streaming through a TMA ring as HWIO lies; bias and
// residual are added to the float32 accumulators and rounded once.  The
// normalised activation never goes through device memory.
//
// float32 (gvq_fused_gn_conv_f32): a plain SIMT kernel (CUDA-core FMAs, no
// TF32) on a 64-pixel x 64-channel output tile per block, each thread a
// 4 x 4 block of outputs, the same transform on each staged A element.  It
// serves the float32 engine, held to the plain version within 1e-4; it is
// not on the bf16 path and is not tuned.
//
// What bounds it on an H100: 2 * 9 * C * O FLOP per output pixel, 7.7e10
// to 6.2e11 FLOP per launch at the sd3unet shapes (bs=16), against 34 to
// 806 MB of traffic (x in, y out, the residual), so the tensor cores bound
// every shape; beside them, two MUFU operations (exp, reciprocal) for each
// transformed element, 1.4 transforms an input element for each N tile.
#include "conv_igemm_sm90.cuh"

namespace gvq {
namespace {

constexpr int kF32BM = 64;  // output pixels per block
constexpr int kF32BN = 64;  // output channels per block
constexpr int kF32BK = 16;  // input channels per K step

__global__ void __launch_bounds__(256)
fused_gn_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                         const float* __restrict__ shift, const float* __restrict__ w,
                         const float* __restrict__ bias, const float* __restrict__ res,
                         float* __restrict__ y, int H, int W, int C, int O) {
  __shared__ __align__(16) float As[kF32BK][kF32BM + 4];  // k-major: 4 pixels per read
  __shared__ __align__(16) float Bs[kF32BK][kF32BN];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kF32BM;
  const int n0 = blockIdx.z * kF32BN;
  const int M = H * W;
  const int ty = tid >> 4, tx = tid & 15;  // outputs (m0 + 4 ty + i, n0 + 4 tx + j)
  float acc[4][4] = {};

  // staging: A is 64 pixels x 16 channels (pixel tid / 4, channels 4 * (tid % 4)),
  // B is 16 channels x 64 outputs (row tid / 16, columns 4 * (tid % 16))
  const int ap = tid >> 2, ac = (tid & 3) * 4;
  const int am = m0 + ap;
  const int amh = am < M ? am / W : 0, amw = am < M ? am % W : 0;
  const int bk = tid >> 4, bn = (tid & 15) * 4;
  const float* sc = scale + (size_t)b * C;
  const float* sh = shift + (size_t)b * C;

  for (int t = 0; t < 9; ++t) {
    const int r = amh + t / 3 - 1, s = amw + t % 3 - 1;
    const bool in = am < M && r >= 0 && r < H && s >= 0 && s < W;
    for (int c0 = 0; c0 < C; c0 += kF32BK) {
      float av[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (in && c0 + ac < C) {  // C % 4 == 0: a chunk is all in or all out
        const float4 v = *reinterpret_cast<const float4*>(
            x + (((size_t)b * H + r) * W + s) * C + c0 + ac);
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) av[e] = swish(vv[e] * sc[c0 + ac + e] + sh[c0 + ac + e]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) As[ac + e][ap] = av[e];
      float4 bv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (c0 + bk < C && n0 + bn < O)
        bv = *reinterpret_cast<const float4*>(w + ((size_t)t * C + c0 + bk) * O + n0 + bn);
      *reinterpret_cast<float4*>(&Bs[bk][bn]) = bv;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kF32BK; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[k][4 * ty]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][4 * tx]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  const int n = n0 + 4 * tx;
  if (n >= O) return;  // O % 4 == 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) break;
    const size_t off = ((size_t)b * M + m) * O + n;
    float4 out;
    float* po = reinterpret_cast<float*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      po[j] = acc[i][j] + bias[n + j];
      if (res != nullptr) po[j] += res[off + j];
    }
    *reinterpret_cast<float4*>(y + off) = out;
  }
}

// bf16: x (B, H, W, C), scale, shift (B, C) float32, w (3, 3, C, O), bias
// (O,) float32, res (B, H, W, O) or null, y (B, H, W, O); C a multiple of
// 32, O of 8, every pointer on 16 bytes.
inline int launch_gn_conv(const bf16* x, const float* scale, const float* shift, const bf16* w,
                          const float* bias, const bf16* res, bf16* y, int B, int H, int W, int C,
                          int O, cudaStream_t stream) {
  IgemmArgs a{};
  long long blocks = 0;
  if (C % 32 != 0 || O % 8 != 0 || scale == nullptr || shift == nullptr || bias == nullptr ||
      !igemm_args(&a, B, H, W, O, C, 1, &blocks, kIgGnTileH, kIgGnTileW))
    return (int)cudaErrorInvalidValue;
  a.bias = bias;
  a.out = y;
  a.scale = scale;
  a.shift = shift;
  a.res = res;
  CUtensorMap tx, tw;
  if (!ig_nhwc_map(&tx, x, B, H, W, C, kIgGnTileH + 2, kIgGnTileW + 2, 1) ||
      !ig_weight_map(&tw, w, C, O, 64, 3))
    return (int)cudaErrorInvalidValue;
  return (int)(igemm_tile_n(O) == 256
                   ? launch_igemm_sm90<kIgSameGn, 256, AGn>(tx, tx, tw, a, blocks, stream)
                   : launch_igemm_sm90<kIgSameGn, 128, AGn>(tx, tx, tw, a, blocks, stream));
}

}  // namespace
}  // namespace gvq

// x (B, H, W, C) bf16; scale, shift (B, C) float32; w (3, 3, C, O) bf16;
// bias (O,) float32; res (B, H, W, O) bf16 or null; y (B, H, W, O) bf16.
// All contiguous and on 16 bytes; C a multiple of 32, O of 8.
extern "C" int gvq_fused_gn_conv(const void* x, const float* scale, const float* shift,
                                 const void* w, const float* bias, const void* res, void* y,
                                 int B, int H, int W, int C, int O, void* stream) {
  return gvq::launch_gn_conv(static_cast<const gvq::bf16*>(x), scale, shift,
                             static_cast<const gvq::bf16*>(w), bias,
                             static_cast<const gvq::bf16*>(res), static_cast<gvq::bf16*>(y), B, H,
                             W, C, O, static_cast<cudaStream_t>(stream));
}

// The same in float32: x (B, H, W, C), w (3, 3, C, O), res (B, H, W, O) or
// null, y (B, H, W, O); C and O multiples of 4.
extern "C" int gvq_fused_gn_conv_f32(const float* x, const float* scale, const float* shift,
                                     const float* w, const float* bias, const float* res,
                                     float* y, int B, int H, int W, int C, int O,
                                     void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || C % 4 != 0 || O % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H * W + gvq::kF32BM - 1) / gvq::kF32BM, B,
                  (O + gvq::kF32BN - 1) / gvq::kF32BN);
  gvq::fused_gn_conv_f32_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, scale, shift, w, bias, res, y, H, W, C, O);
  return (int)cudaGetLastError();
}
