// Fused nearest-x2 upsample + 3x3 conv for Hopper (sm_90a).
//
// Replaces the TPU kernel vqvae_from_gaussian_vae_tpu/ops/upsample_conv.py
// (_upsample_conv_hwbc -> pl.pallas_call, body _kernel_hwbc).  Nearest x2
// duplicates pixels, so the 3x3 conv over the upsampled image equals four
// 2x2 "phase" convs over the low-resolution input with tap-group kernels
// k22[di, dj, a, b] (computed once by the Python wrapper): 16/36 of the
// naive FLOPs, and the 4x upsampled input never exists in device memory.
// Phase (di, dj) output pixel (i, j) lands at y[2i+di, 2j+dj]; rows and
// columns outside the input are zero halos.  Bias, an optional fused
// residual `x + add`, and per-sample per-channel (sum, sum of squares) of
// the bf16-rounded output complete the op, as on the TPU.
//
// What bounds it on an H100: 1.4e11 to 5.5e11 FLOP per launch against at
// most ~0.6 GB of traffic, so it is tensor-core bound.  The design runs
// each phase as its own implicit GEMM (M = low-res pixels, K = 4 taps x C)
// on bf16 tensor cores (conv_igemm.cuh), with the phase index in the grid
// so the four phases of a tile share the input through L2.
#include "conv_igemm.cuh"

extern "C" int gvq_upsample_conv(const void* x, const void* add, const void* k22,
                                 const float* bias, void* y, float* partial,
                                 float* stats, int B, int H, int W, int C, int O,
                                 void* stream) {
  gvq::ConvArgs g;
  g.x = static_cast<const gvq::bf16*>(x);
  g.add = static_cast<const gvq::bf16*>(add);
  g.w = static_cast<const gvq::bf16*>(k22);
  g.bias = bias;
  g.y = static_cast<gvq::bf16*>(y);
  g.partial = partial;
  g.B = B;
  g.H = H;
  g.W = W;
  g.C = C;
  g.O = O;
  g.Mh = H;
  g.Mw = W;
  g.n_mt = (H * W + gvq::kConvBM - 1) / gvq::kConvBM;
  g.out_h = 2 * H;
  g.out_w = 2 * W;
  return gvq::launch_conv<gvq::kUpFwd>(g, stats, static_cast<cudaStream_t>(stream));
}
