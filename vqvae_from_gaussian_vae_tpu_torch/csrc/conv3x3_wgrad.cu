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
// It runs the fixed-order weight-gradient body of the resample backward
// (conv_wgrad.cuh, mode kWgSame): one (C tile, O tile, tap, pixel chunk)
// GEMM per block on bf16 tensor cores with float32 accumulators, float32
// partials over fixed pixel chunks and an ordered second pass, so two runs
// give the same bits (no float atomics); the border taps read zeros from
// masked loads, not from a padded copy of x.
//
// What bounds it on an H100: 2 * 9 * C * O FLOP per pixel, 7.7e10 to
// 6.2e11 FLOP per launch at the sd3unet shapes (bs=16), against 34 to
// 537 MB of traffic (x and g in), so the tensor cores bound every shape.
#include "conv_wgrad.cuh"

// x (B, H, W, C) bf16; g (B, H, W, O) bf16; partial (splits, 9, C, O)
// float32 scratch; dw (9, C, O) float32.  C and O multiples of 8;
// splits * chunk must cover B * H * W pixels.
extern "C" int gvq_conv3x3_wgrad(const void* x, const void* g, void* partial, void* dw, int B,
                                 int H, int W, int C, int O, int splits, int chunk,
                                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  gvq::WgradArgs a{};
  a.x = static_cast<const gvq::bf16*>(x);
  a.g = static_cast<const gvq::bf16*>(g);
  a.partial = static_cast<float*>(partial);
  a.B = B;
  a.H = H;
  a.W = W;
  a.C = C;
  a.O = O;
  a.Hg = H;
  a.Wg = W;
  a.Mh = H;
  a.Mw = W;
  a.chunk = chunk;
  return gvq::launch_wgrad<gvq::kWgSame>(a, splits, static_cast<float*>(dw),
                                         static_cast<cudaStream_t>(stream));
}
