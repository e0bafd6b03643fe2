// Weight gradient of the resblock's stride-1 "same" 3x3 conv for Hopper
// (sm_90a).
//
// Replaces the TPU kernel vqvae_from_gaussian_vae_tpu/ops/conv3x3_train.py
// (_conv3x3_wgrad -> pl.pallas_call, body _wgrad_kernel), reached from the
// custom VJP conv3x3_same_wg's backward: dw (3, 3, C, O) float32 =
// sum over b, h, w of xpad[b, h + r, w + s, :]^T . g[b, h, w, :], x and g
// bf16, xpad x with a one-pixel zero border.  The forward conv and the input
// gradient stay the framework's (cuDNN), as they stay XLA's in the JAX
// package.
//
// It runs the weight-gradient body of the resample backward (conv_wgrad.cuh,
// mode kWgSame): wgmma on bf16 with float32 accumulators in registers, fed
// by a ring of TMA copies; the border taps read the copies' zero fill, not
// a padded copy of x.  Float32 partials over fixed runs of spatial tiles
// and an ordered second pass, so two runs give the same bits (no float
// atomics).
//
// What bounds it on an H100: 2 * 9 * C * O FLOP per pixel, 7.7e10 to
// 6.2e11 FLOP per launch at the sd3unet shapes (bs=16), against 34 to
// 537 MB of traffic (x and g in), so the tensor cores bound every shape.
#include "conv_wgrad.cuh"

// x (B, H, W, C) bf16; g (B, H, W, O) bf16; partial (splits, 9, C, O)
// float32 scratch; dw (9, C, O) float32.  C and O multiples of 8; x and
// g 16-byte aligned; splits * chunk must cover the B * H * W pixels' spatial
// tiles (conv_wgrad.cuh wgrad_tile).
extern "C" int gvq_conv3x3_wgrad(const void* x, const void* g, void* partial, void* dw, int B,
                                 int H, int W, int C, int O, int splits, int chunk,
                                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  return gvq::launch_wgrad<gvq::kWgSame>(
      static_cast<const gvq::bf16*>(x), static_cast<const gvq::bf16*>(g),
      static_cast<float*>(partial), static_cast<float*>(dw), B, H, W, C, O, H, W, H, W, splits,
      chunk, static_cast<cudaStream_t>(stream));
}
