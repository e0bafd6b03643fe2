// Backward of the fused nearest-x2 upsample + 3x3 conv for Hopper (sm_90a).
//
// Replaces the TPU kernels of vqvae_from_gaussian_vae_tpu/ops/upsample_conv.py
// reached from the custom VJP's backward (_upsample_bwd_pallas_t):
//   gvq_upsample_dgrad  <- _upsample_dgrad -> pl.pallas_call (body _dgrad_kernel_hwbc)
//   gvq_upsample_wgrad  <- _upsample_wgrad -> pl.pallas_call (body _wgrad_kernel_hwbc)
// The wrapper folds the statistics cotangent into g, sums dbias, and maps
// the phase-kernel gradient dk22 back to dw (the VJP of phase_kernels, a
// fixed sum of tap groups), as the JAX backward does outside its kernels.
//
// The adjoint of nearest x2 + 3x3 conv is a 4x4 stride-2 conv, which
// splits into 16 low-resolution taps: 16/36 of the naive FLOPs, and no
// high-resolution intermediate.
//
// dgrad: dx (B, H, W, C) = sum over (di, dj, a, b) of the shifted
// cotangent phase g[2(i-dr)+di, 2(j-dc)+dj] . k22[di, dj, a, b]^T
// (dr = di+a-1, dc = dj+b-1; zero where i-dr or j-dc leaves the image: the
// two masked rows at each end of the TPU kernel's band).  The Hopper
// implicit-GEMM body (conv_igemm_sm90.cuh, mode kIgUpDgrad): M =
// low-resolution pixels in 128-pixel spatial tiles, N = C, K = 16 taps x
// O in 64-channel steps; wgmma fed by TMA boxes of g through a map that
// steps by 2 in rows and columns (the halo is the copies' zero fill) and of
// k22 as it lies (K-major B), float32 accumulators, no split-K and no
// atomics: dx repeats bit for bit.
//
// wgrad: dk22 (16, C, O) float32 = the x tiles of the forward against the
// cotangent phases over all B * H * W low-resolution pixels
// (conv_wgrad.cuh, mode kWgUp: wgmma fed by TMA copies whose tensor map on
// g steps by 2 in rows and columns, one phase per tap): fixed-order
// float32 partials and a second pass, no atomics, bit-reproducible.
//
// What bounds them on an H100: 1.4e11, 5.5e11 and 5.5e11 FLOP per launch
// at the decoder shapes (bs=16) against at most ~0.7 GB of traffic: the
// tensor cores (0.14, 0.56 and 0.56 ms at the bf16 peak).
#include "conv_igemm_sm90.cuh"
#include "conv_wgrad.cuh"

namespace gvq {
namespace {

// dgrad: g (B, 2H, 2W, O), k22 (16, C, O); dx (B, H, W, C).  O a multiple
// of 32, C of 8, every pointer on 16 bytes.
inline int launch_upsample_dgrad(const bf16* g, const bf16* k22, bf16* dx, int B, int H, int W,
                                 int O, int C, cudaStream_t stream) {
  IgemmArgs a{};
  long long blocks = 0;
  if (O % 32 != 0 || C % 8 != 0 || !igemm_args(&a, B, H, W, C, O, 1, &blocks))
    return (int)cudaErrorInvalidValue;
  a.out = dx;
  const int bn = igemm_tile_n(C);
  CUtensorMap tg, tw;
  if (!ig_nhwc_map(&tg, g, B, 2 * H, 2 * W, O, a.tile_h, a.tile_w, 2) ||
      !ig_weight_map(&tw, k22, C, O, bn, 4))
    return (int)cudaErrorInvalidValue;
  return (int)(bn == 256
                   ? launch_igemm_sm90<kIgUpDgrad, 256, AIdentity>(tg, tg, tw, a, blocks, stream)
                   : launch_igemm_sm90<kIgUpDgrad, 128, AIdentity>(tg, tg, tw, a, blocks, stream));
}

}  // namespace
}  // namespace gvq

// g (B, 2H, 2W, O) bf16; k22 (2, 2, 2, 2, C, O) bf16 in (di, dj, a, b)
// order; dx (B, H, W, C) bf16.  All contiguous and on 16 bytes; O a
// multiple of 32, C of 8.
extern "C" int gvq_upsample_dgrad(const void* g, const void* k22, void* dx, int B, int H, int W,
                                  int O, int C, void* stream) {
  return gvq::launch_upsample_dgrad(static_cast<const gvq::bf16*>(g),
                                    static_cast<const gvq::bf16*>(k22),
                                    static_cast<gvq::bf16*>(dx), B, H, W, O, C,
                                    static_cast<cudaStream_t>(stream));
}

// x (B, H, W, C) bf16 (x + add summed and rounded where the forward had
// one); g (B, 2H, 2W, O) bf16; partial (splits, 16, C, O) float32 scratch;
// dk22 (16, C, O) float32 in (di, dj, a, b) order.  C and O multiples of 8;
// x and g 16-byte aligned; splits * chunk must cover the spatial tiles of
// B * H * W pixels (conv_wgrad.cuh wgrad_tile).
extern "C" int gvq_upsample_wgrad(const void* x, const void* g, void* partial, void* dk22, int B,
                                  int H, int W, int C, int O, int splits, int chunk,
                                  void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  return gvq::launch_wgrad<gvq::kWgUp>(
      static_cast<const gvq::bf16*>(x), static_cast<const gvq::bf16*>(g),
      static_cast<float*>(partial), static_cast<float*>(dk22), B, H, W, C, O, 2 * H, 2 * W, H, W,
      splits, chunk, static_cast<cudaStream_t>(stream));
}
