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
// most ~0.8 GB of traffic, so it is tensor-core bound.  It runs the Hopper
// implicit-GEMM body (conv_igemm_sm90.cuh, mode kIgUpFwd): M = one phase's
// low-resolution pixels in 128-pixel spatial tiles, N = O, K = 4 taps x C
// in 64-channel steps; wgmma fed by TMA boxes of x (and add) through maps
// that step by 1, whose zero fill is the halo, and of k22 as it lies
// (N-major B); x + add summed in float32 and rounded once in registers
// (the register-A form); the four phases of a tile run together so they
// share its input through L2; the epilogue adds the bias, rounds, takes
// the statistics of the rounded tile and stores at the phase's pixels.  No
// split-K and no float atomics: y and the statistics repeat bit for bit.
#include "conv_igemm_sm90.cuh"

namespace gvq {
namespace {

// x, add (or null) (B, H, W, C), k22 (2, 2, 2, 2, C, O), bias (O,)
// float32; y (B, 2H, 2W, O); partial (B, 4 tiles, 2, O) scratch; stats
// (B, 2, O).  C a multiple of 32, O of 128, every pointer on 16 bytes.
inline int launch_upsample_fwd(const bf16* x, const bf16* add, const bf16* k22, const float* bias,
                               bf16* y, float* partial, float* stats, int B, int H, int W, int C,
                               int O, cudaStream_t stream) {
  IgemmArgs a{};
  long long blocks = 0;
  if (C % 32 != 0 || O % 128 != 0 || !igemm_args(&a, B, H, W, O, C, 4, &blocks))
    return (int)cudaErrorInvalidValue;
  a.bias = bias;
  a.out = y;
  a.partial = partial;
  const int bn = igemm_tile_n(O);
  CUtensorMap tx, tadd, tw;
  if (!ig_nhwc_map(&tx, x, B, H, W, C, a.tile_h, a.tile_w, 1) ||
      !ig_nhwc_map(&tadd, add != nullptr ? add : x, B, H, W, C, a.tile_h, a.tile_w, 1) ||
      !ig_weight_map(&tw, k22, C, O, 64, 4))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (add != nullptr)
    err = bn == 256 ? launch_igemm_sm90<kIgUpFwd, 256, AAdd>(tx, tadd, tw, a, blocks, stream)
                    : launch_igemm_sm90<kIgUpFwd, 128, AAdd>(tx, tadd, tw, a, blocks, stream);
  else
    err = bn == 256 ? launch_igemm_sm90<kIgUpFwd, 256, AIdentity>(tx, tx, tw, a, blocks, stream)
                    : launch_igemm_sm90<kIgUpFwd, 128, AIdentity>(tx, tx, tw, a, blocks, stream);
  if (err != cudaSuccess) return (int)err;
  const int total = B * 2 * O;
  conv_stats_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(partial, stats, B,
                                                                    4 * a.tiles, O);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gvq

// x, add (or null) (B, H, W, C) bf16; k22 (2, 2, 2, 2, C, O) bf16 in (di,
// dj, a, b) order; bias (O,) float32 (bf16-rounded values); y (B, 2H, 2W,
// O) bf16; partial (B, 4 tiles, 2, O) float32 scratch, tiles the spatial
// tiles of the (H, W) grid (conv_igemm_sm90.cuh igemm_tile); stats (B, 2,
// O) float32.  C a multiple of 32, O of 128, every pointer on 16 bytes.
extern "C" int gvq_upsample_conv(const void* x, const void* add, const void* k22,
                                 const float* bias, void* y, float* partial,
                                 float* stats, int B, int H, int W, int C, int O,
                                 void* stream) {
  return gvq::launch_upsample_fwd(
      static_cast<const gvq::bf16*>(x), static_cast<const gvq::bf16*>(add),
      static_cast<const gvq::bf16*>(k22), bias, static_cast<gvq::bf16*>(y), partial, stats, B, H,
      W, C, O, static_cast<cudaStream_t>(stream));
}
