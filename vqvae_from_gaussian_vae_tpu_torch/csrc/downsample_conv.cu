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
// taps as an implicit GEMM on wgmma fed by TMA copies (conv_igemm_sm90.cuh,
// mode kIgDownFwd: the maps on x and add step by 2, their zero fill is the
// pad) without materialising an im2col or the padded input, and fuses the
// add into the A operand (summed in registers, the wgmma register form)
// and the statistics into the epilogue, so neither x + add nor a separate
// statistics pass over y goes through device memory.
#include "conv_igemm_sm90.cuh"

namespace gvq {
namespace {

// The forward: x, add (or null) (B, H, W, C), w HWIO (3, 3, C, O), bias
// (O,) float32; y (B, H/2, W/2, O); partial (B, tiles, 2, O) scratch;
// stats (B, 2, O).  C a multiple of 32, O of 128, H and W even, every
// pointer on 16 bytes.
inline int launch_downsample_fwd(const bf16* x, const bf16* add, const bf16* w, const float* bias,
                                 bf16* y, float* partial, float* stats, int B, int H, int W, int C,
                                 int O, cudaStream_t stream) {
  IgemmArgs a{};
  long long blocks = 0;
  if (H % 2 != 0 || W % 2 != 0 || C % 32 != 0 || O % 128 != 0 ||
      !igemm_args(&a, B, H / 2, W / 2, O, C, 1, &blocks))
    return (int)cudaErrorInvalidValue;
  a.bias = bias;
  a.out = y;
  a.partial = partial;
  const int bn = igemm_tile_n(O);
  CUtensorMap tx, tadd, tw;
  if (!ig_nhwc_map(&tx, x, B, H, W, C, a.tile_h, a.tile_w, 2) ||
      !ig_nhwc_map(&tadd, add != nullptr ? add : x, B, H, W, C, a.tile_h, a.tile_w, 2) ||
      !ig_weight_map(&tw, w, C, O, 64, 3))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (add != nullptr)
    err = bn == 256 ? launch_igemm_sm90<kIgDownFwd, 256, AAdd>(tx, tadd, tw, a, blocks, stream)
                    : launch_igemm_sm90<kIgDownFwd, 128, AAdd>(tx, tadd, tw, a, blocks, stream);
  else
    err = bn == 256 ? launch_igemm_sm90<kIgDownFwd, 256, AIdentity>(tx, tx, tw, a, blocks, stream)
                    : launch_igemm_sm90<kIgDownFwd, 128, AIdentity>(tx, tx, tw, a, blocks, stream);
  if (err != cudaSuccess) return (int)err;
  const int total = B * 2 * O;
  conv_stats_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(partial, stats, B, a.tiles, O);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gvq

// x, add (or null) (B, H, W, C) bf16; w HWIO (3, 3, C, O) bf16; bias (O,)
// float32 (bf16-rounded values); y (B, H/2, W/2, O) bf16; partial (B,
// tiles, 2, O) float32 scratch, tiles the spatial tiles of the (H/2, W/2)
// grid (conv_igemm_sm90.cuh igemm_tile); stats (B, 2, O) float32.  C a
// multiple of 32, O of 128, H and W even, every pointer on 16 bytes.
extern "C" int gvq_downsample_conv(const void* x, const void* add, const void* w,
                                   const float* bias, void* y, float* partial,
                                   float* stats, int B, int H, int W, int C, int O,
                                   void* stream) {
  return gvq::launch_downsample_fwd(
      static_cast<const gvq::bf16*>(x), static_cast<const gvq::bf16*>(add),
      static_cast<const gvq::bf16*>(w), bias, static_cast<gvq::bf16*>(y), partial, stats, B, H,
      W, C, O, static_cast<cudaStream_t>(stream));
}
