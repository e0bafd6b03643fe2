// Fused stride-2 3x3 downsample conv for Hopper (sm_90a).
//
// Replaces the TPU kernel vqvae_from_gaussian_vae_tpu/ops/downsample_conv.py
// (_downsample_conv -> pl.pallas_call, body _kernel): (0,1)-padded stride-2
// 3x3 conv + bias, an optional fused residual `x + add`, and per-sample
// per-channel (sum, sum of squares) of the bf16-rounded output for the next
// GroupNorm.
//
// What bounds it on an H100: every level is 7.7e10 FLOP per launch at
// bs=16.  At 256x256x128 the op reads x and add (2 x 268 MB) and writes
// 67 MB, and at 128x128x256 half of that, so there the bytes bound is the
// larger; at 64x64x512 the tensor-core bound is.  The design does the 9
// taps as an implicit GEMM on bf16 tensor cores (conv_igemm.cuh) without
// materialising an im2col or the padded input, and fuses the add into the
// operand load and the statistics into the epilogue, so neither x + add nor
// a separate statistics pass over y goes through device memory.
#include "conv_igemm.cuh"

extern "C" int gvq_downsample_conv(const void* x, const void* add, const void* w,
                                   const float* bias, void* y, float* partial,
                                   float* stats, int B, int H, int W, int C, int O,
                                   void* stream) {
  if (H % 2 != 0 || W % 2 != 0) return (int)cudaErrorInvalidValue;
  gvq::ConvArgs g;
  g.x = static_cast<const gvq::bf16*>(x);
  g.add = static_cast<const gvq::bf16*>(add);
  g.w = static_cast<const gvq::bf16*>(w);
  g.bias = bias;
  g.y = static_cast<gvq::bf16*>(y);
  g.partial = partial;
  g.B = B;
  g.H = H;
  g.W = W;
  g.C = C;
  g.O = O;
  g.Mh = H / 2;
  g.Mw = W / 2;
  g.n_mt = (g.Mh * g.Mw + gvq::kConvBM - 1) / gvq::kConvBM;
  return gvq::launch_conv<false>(g, stats, static_cast<cudaStream_t>(stream));
}
