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
// float32 (gvq_fused_gn_conv_f32): split TF32 on the tensor cores over the
// same structure (conv_gn_f32_sm90.cuh): a weight pre-pass writes the TF32
// hi and lo planes of the weights K-major, then 8 x 16 pixel tiles of 64
// output channels, the halo box of each 32-channel K step transformed once
// into hi and lo planes, three wgmma passes a product, each K step's
// products added into the running sum on the CUDA cores.  It serves the
// float32 engine, held to the plain version within 1e-4.
//
// What bounds it on an H100: 2 * 9 * C * O FLOP per output pixel, 7.7e10
// to 6.2e11 FLOP per launch at the sd3unet shapes (bs=16), against 34 to
// 806 MB of traffic (x in, y out, the residual), so the tensor cores bound
// every shape; beside them, two MUFU operations (exp, reciprocal) for each
// transformed element, 1.4 transforms an input element for each N tile.
#include "conv_gn_f32_sm90.cuh"  // includes conv_igemm_sm90.cuh

namespace gvq {
namespace {

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
// null, y (B, H, W, O); wt: a (9, 2, O, C) float32 scratch for the
// weights' TF32 planes; C and O multiples of 4, every pointer on 16 bytes.
extern "C" int gvq_fused_gn_conv_f32(const float* x, const float* scale, const float* shift,
                                     const float* w, const float* bias, const float* res,
                                     float* y, float* wt, int B, int H, int W, int C, int O,
                                     void* stream) {
  return gvq::launch_gn_conv_f32(x, scale, shift, w, bias, res, y, wt, B, H, W, C, O,
                                 static_cast<cudaStream_t>(stream));
}
