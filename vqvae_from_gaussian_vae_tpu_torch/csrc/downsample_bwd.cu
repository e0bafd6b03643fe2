// Backward of the fused stride-2 3x3 downsample conv for Hopper (sm_90a).
//
// Replaces the TPU kernels of vqvae_from_gaussian_vae_tpu/ops/downsample_conv.py
// reached from the custom VJP's backward (_downsample_bwd_pallas_t):
//   gvq_downsample_dgrad  <- _downsample_dgrad -> pl.pallas_call (body _dgrad_kernel)
//   gvq_downsample_wgrad  <- _downsample_wgrad -> pl.pallas_call (body _wgrad_kernel)
// The wrapper folds the statistics cotangent into g (float32, then bf16) and
// sums dbias before these run, as the JAX backward does.
//
// dgrad: dx (B, H, W, C) from g (B, H/2, W/2, O) and w, the 4 parity
// phases of shifted g . w[r, s]^T (9 taps over the phases: 4, 2, 2, 1),
// interleaved into dx; negative g rows and columns (the top row of band 0
// in the TPU kernel) are zero.  It runs the forward's implicit-GEMM body
// (conv_igemm_sm90.cuh, mode kIgDownDgrad): M = low-resolution pixels of
// one phase, N = C, K = the phase's taps x O, wgmma fed by TMA copies of g
// (negative coordinates zero-filled) and of w as it lies (HWIO: dgrad's B
// is K-major), float32 accumulators, no zero-stuffed or padded copy of g;
// the longest phase's blocks first.
//
// wgrad: dw (9, C, O) float32, the strided input views x[2i+r, 2j+s]
// against g over all B * H/2 * W/2 pixels (conv_wgrad.cuh, mode kWgDown:
// wgmma fed by TMA copies whose tensor map on x steps by 2 in rows and
// columns; the (0,1) pad is the copies' zero fill): float32 partials over
// fixed runs of spatial tiles and an ordered second pass, no atomics, so
// two runs give the same bits.
//
// What bounds them on an H100: each is 7.7e10 FLOP per launch at the three
// encoder shapes (bs=16), against 67 to 337 MB of traffic (dgrad: g in, dx
// out; wgrad: x and g in), so the tensor cores bound the 64x64x512 level
// and the bytes the 256x256x128 one.
#include "conv_igemm_sm90.cuh"
#include "conv_wgrad.cuh"

namespace gvq {
namespace {

// dgrad: g (B, Ho, Wo, O), w HWIO (3, 3, C, O); dx (B, 2 Ho, 2 Wo, C).  O a
// multiple of 32, C of 8, every pointer on 16 bytes.
inline int launch_downsample_dgrad(const bf16* g, const bf16* w, bf16* dx, int B, int Ho, int Wo,
                                   int O, int C, cudaStream_t stream) {
  IgemmArgs a{};
  long long blocks = 0;
  if (O % 32 != 0 || C % 8 != 0 || !igemm_args(&a, B, Ho, Wo, C, O, 4, &blocks))
    return (int)cudaErrorInvalidValue;
  a.out = dx;
  const int bn = igemm_tile_n(C);
  CUtensorMap tg, tw;
  if (!ig_nhwc_map(&tg, g, B, Ho, Wo, O, a.tile_h, a.tile_w, 1) ||
      !ig_weight_map(&tw, w, C, O, bn, 3))
    return (int)cudaErrorInvalidValue;
  return (int)(bn == 256
                   ? launch_igemm_sm90<kIgDownDgrad, 256, AIdentity>(tg, tg, tw, a, blocks, stream)
                   : launch_igemm_sm90<kIgDownDgrad, 128, AIdentity>(tg, tg, tw, a, blocks, stream));
}

}  // namespace
}  // namespace gvq

// g (B, Ho, Wo, O) bf16; w HWIO (3, 3, C, O) bf16; dx (B, 2 Ho, 2 Wo, C)
// bf16.  All contiguous and on 16 bytes; O a multiple of 32, C of 8.
extern "C" int gvq_downsample_dgrad(const void* g, const void* w, void* dx, int B, int Ho,
                                    int Wo, int O, int C, void* stream) {
  return gvq::launch_downsample_dgrad(static_cast<const gvq::bf16*>(g),
                                      static_cast<const gvq::bf16*>(w),
                                      static_cast<gvq::bf16*>(dx), B, Ho, Wo, O, C,
                                      static_cast<cudaStream_t>(stream));
}

// x (B, H, W, C) bf16 (the forward's input, x + add summed and rounded
// where the forward had one); g (B, H/2, W/2, O) bf16; partial (splits, 9,
// C, O) float32 scratch; dw (9, C, O) float32.  H, W even; C and O
// multiples of 8; x and g 16-byte aligned; splits * chunk must cover the
// spatial tiles of B * H/2 * W/2 pixels (conv_wgrad.cuh wgrad_tile).
extern "C" int gvq_downsample_wgrad(const void* x, const void* g, void* partial, void* dw, int B,
                                    int H, int W, int C, int O, int splits, int chunk,
                                    void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H % 2 != 0 || W % 2 != 0) return (int)cudaErrorInvalidValue;
  return gvq::launch_wgrad<gvq::kWgDown>(
      static_cast<const gvq::bf16*>(x), static_cast<const gvq::bf16*>(g),
      static_cast<float*>(partial), static_cast<float*>(dw), B, H, W, C, O, H / 2, W / 2, H / 2,
      W / 2, splits, chunk, static_cast<cudaStream_t>(stream));
}
