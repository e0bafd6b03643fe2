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
// two masked rows at each end of the TPU kernel's band).  The forward's
// implicit-GEMM body (conv_igemm.cuh, mode kUpDgrad): M = low-resolution
// pixels, N = C, K = 16 taps x O.
//
// wgrad: dk22 (16, C, O) float32 = the x tiles of the forward against the
// cotangent phases over all B * H * W low-resolution pixels
// (conv_wgrad.cuh, mode kWgUp: wgmma fed by TMA copies whose tensor map on
// g steps by 2 in rows and columns, one phase per tap): fixed-order
// float32 partials and a second pass, no atomics, bit-reproducible.
//
// What bounds them on an H100: 1.4e11, 5.5e11 and 5.5e11 FLOP per launch
// at the decoder shapes (bs=16) against at most ~0.7 GB of traffic: the
// tensor cores.
#include "conv_wgrad.cuh"

// g (B, 2H, 2W, O) bf16; k22t (16, O, C) bf16 (k22[di, dj, a, b]^T);
// dx (B, H, W, C) bf16.  All contiguous; O a multiple of 32, C of 8.
extern "C" int gvq_upsample_dgrad(const void* g, const void* k22t, void* dx, int B, int H, int W,
                                  int O, int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  gvq::ConvArgs a{};
  a.x = static_cast<const gvq::bf16*>(g);
  a.w = static_cast<const gvq::bf16*>(k22t);
  a.y = static_cast<gvq::bf16*>(dx);
  a.B = B;
  a.H = 2 * H;
  a.W = 2 * W;
  a.C = O;
  a.O = C;
  a.Mh = H;
  a.Mw = W;
  a.n_mt = (H * W + gvq::kConvBM - 1) / gvq::kConvBM;
  a.out_h = H;
  a.out_w = W;
  return gvq::launch_dgrad<gvq::kUpDgrad>(a, static_cast<cudaStream_t>(stream));
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
