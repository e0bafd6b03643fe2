// Weight-gradient core shared by the resample backward kernels
// (downsample_bwd.cu, upsample_bwd.cu) and the resblock conv's
// (conv3x3_wgrad.cu).
//
// All three weight gradients are the same reduction: for each tap t,
//
//   dW[t] (C x O) = sum over pixels p of X_t[p, :]^T . G[p, :]
//
// where p runs over one pixel grid per sample (B * Mh * Mw rows in all), G
// is the cotangent at p's output position and X_t the forward input at p's
// tap-shifted position (zero outside the image):
//
//   down (kWgDown): 9 taps (r, s); p = (b, i, j) over the (H/2, W/2)
//       output grid; X_t[p] = x[b, 2i + r, 2j + s] (row H and column W are
//       the (0,1) pad), G[p] = g[b, i, j].
//   up   (kWgUp):  16 taps (di, dj, a, bb); p = (b, i, j) over the
//       low-resolution (H, W) grid; X_t[p] = x[b, i + di + a - 1,
//       j + dj + bb - 1], G[p] = g[b, 2i + di, 2j + dj] (the phase-kernel
//       gradient dk22; the wrapper maps it back to dw).
//   same (kWgSame): 9 taps (r, s) of the stride-1 "same" conv; p = (b, i,
//       j) over the (H, W) grid; X_t[p] = x[b, i + r - 1, j + s - 1] (zero
//       outside the image), G[p] = g[b, i, j].  C and O need not be equal:
//       the (C, O) tiles are masked at both edges.
//
// A GEMM with M = C, N = O and a long K (up to 1,048,576 pixels at bs=16:
// the resblock conv at 256x256).
// Blocks take a 128 x 128 (C, O) tile of one tap and one fixed chunk of the
// pixels ("split"), accumulate on bf16 tensor cores (nvcuda::wmma, float32
// accumulators) and write their float32 partial to (splits, taps, C, O); a
// second kernel sums the splits of each element in ascending order.  No
// float atomics: the result repeats bit for bit.  Each K step loads 32
// pixels x 128 channels of X_t and of G into shared memory, with the next
// step's loads issued into registers before the current step's MMAs, as
// the forward body does (conv_igemm.cuh).
#pragma once

#include "conv_igemm.cuh"

namespace gvq {
namespace {

constexpr int kWgLD = kConvBN + 8;  // smem pitch (bf16) of both K-major tiles
constexpr size_t kWgSmemAB = 2 * (size_t)kConvBK * kWgLD * sizeof(bf16);
constexpr size_t kWgSmem = kWgSmemAB > kConvSmemC ? kWgSmemAB : kConvSmemC;

enum WgradMode { kWgDown = 0, kWgUp = 1, kWgSame = 2 };

__host__ __device__ constexpr int wgrad_taps(int mode) { return mode == kWgUp ? 16 : 9; }

struct WgradArgs {
  const bf16* x;   // forward input (B, H, W, C)
  const bf16* g;   // cotangent (B, Hg, Wg, O)
  float* partial;  // (splits, taps, C, O)
  int B, H, W, C, O;
  int Hg, Wg;
  int Mh, Mw;      // pixel grid of one sample the reduction runs over
  int chunk;       // pixels per split, a multiple of kConvBK
};

template <int MODE>
__global__ void __launch_bounds__(kConvThreads)
conv_wgrad_kernel(WgradArgs g) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);   // BK pixels x 128 input channels
  bf16* Bs = As + kConvBK * kWgLD;            // BK pixels x 128 output channels
  float* Cs = reinterpret_cast<float*>(smem); // 128 x LDC, reused after the K loop

  constexpr int TAPS = wgrad_taps(MODE);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int warp_m = warp >> 1;  // 0..3: 32 input channels
  const int warp_n = warp & 1;   // 0..1: 64 output channels
  const int n_ct = (g.C + kConvBM - 1) / kConvBM;
  const int c0 = (blockIdx.x % n_ct) * kConvBM;
  const int o0 = (blockIdx.x / n_ct) * kConvBN;
  const int t = blockIdx.y;
  const int split = blockIdx.z;

  // tap geometry: x at (xm * i + xr, xm * j + xc), g at (gm * i + gr, gm * j + gc)
  int xm, xr, xc, gm, gr, gc;
  if (MODE == kWgUp) {
    const int di = t >> 3, dj = (t >> 2) & 1;
    xm = 1, xr = di + ((t >> 1) & 1) - 1, xc = dj + (t & 1) - 1;
    gm = 2, gr = di, gc = dj;
  } else if (MODE == kWgSame) {
    xm = 1, xr = t / 3 - 1, xc = t % 3 - 1;
    gm = 1, gr = 0, gc = 0;
  } else {
    xm = 2, xr = t / 3, xc = t % 3;
    gm = 1, gr = 0, gc = 0;
  }
  const long long per_sample = (long long)g.Mh * g.Mw;
  const long long p_total = per_sample * g.B;
  const long long p0 = (long long)split * g.chunk;
  const long long p1 = p0 + g.chunk < p_total ? p0 + g.chunk : p_total;
  const int ksteps = p1 > p0 ? (int)((p1 - p0 + kConvBK - 1) / kConvBK) : 0;

  // each thread loads 2 chunks of 8 channels of X_t and of G per K step:
  // pixel row id >> 4 (0..31), channels (id & 15) * 8
  uint4 ra[2], rb[2];
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  auto load_tile = [&](int ks) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kConvThreads;
      const int col = (id & 15) * 8;
      const long long p = p0 + (long long)ks * kConvBK + (id >> 4);
      ra[i] = zero4;
      rb[i] = zero4;
      if (p < p1) {
        const int b = (int)(p / per_sample);
        const int rem = (int)(p % per_sample);
        const int i0 = rem / g.Mw, j0 = rem % g.Mw;
        const int r = xm * i0 + xr, s = xm * j0 + xc;
        if (c0 + col < g.C && r >= 0 && r < g.H && s >= 0 && s < g.W)
          ra[i] = *reinterpret_cast<const uint4*>(
              g.x + (((size_t)b * g.H + r) * g.W + s) * g.C + c0 + col);
        if (o0 + col < g.O)
          rb[i] = *reinterpret_cast<const uint4*>(
              g.g + (((size_t)b * g.Hg + gm * i0 + gr) * g.Wg + gm * j0 + gc) * g.O + o0 + col);
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  if (ksteps > 0) load_tile(0);
  for (int ks = 0; ks < ksteps; ++ks) {
    __syncthreads();  // the previous step's MMAs are done with As / Bs
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kConvThreads;
      *reinterpret_cast<uint4*>(As + (id >> 4) * kWgLD + (id & 15) * 8) = ra[i];
      *reinterpret_cast<uint4*>(Bs + (id >> 4) * kWgLD + (id & 15) * 8) = rb[i];
    }
    __syncthreads();
    if (ks + 1 < ksteps) load_tile(ks + 1);
#pragma unroll
    for (int kk = 0; kk < kConvBK; kk += 16) {
      // A = X_t^T: element (c, p) sits at As[p * LD + c], a column-major tile
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + kk * kWgLD + warp_m * 32 + i * 16, kWgLD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kWgLD + warp_n * 64 + j * 16, kWgLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  __syncthreads();  // Cs aliases As / Bs
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (warp_m * 32 + i * 16) * kConvLDC + warp_n * 64 + j * 16,
                              acc[i][j], kConvLDC, wmma::mem_row_major);
  __syncthreads();

  float* dst = g.partial + ((size_t)split * TAPS + t) * g.C * g.O;
  for (int id = tid; id < kConvBM * (kConvBN / 4); id += kConvThreads) {
    const int m = id / (kConvBN / 4);
    const int n = (id % (kConvBN / 4)) * 4;
    if (c0 + m < g.C && o0 + n < g.O)
      *reinterpret_cast<float4*>(dst + (size_t)(c0 + m) * g.O + o0 + n) =
          *reinterpret_cast<const float4*>(Cs + m * kConvLDC + n);
  }
}

// out[e] = sum over s of partial[s, e], s ascending
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                    int splits, size_t n) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += partial[(size_t)s * n + idx];
  out[idx] = acc;
}

// partial: (splits, taps, C, O) float32 scratch; out: (taps, C, O) float32
template <int MODE>
inline int launch_wgrad(const WgradArgs& g, int splits, float* out, cudaStream_t stream) {
  constexpr int TAPS = wgrad_taps(MODE);
  if (g.C % 8 != 0 || g.O % 8 != 0 || g.C <= 0 || g.O <= 0 || splits <= 0 ||
      g.chunk <= 0 || g.chunk % kConvBK != 0 ||
      (long long)splits * g.chunk < (long long)g.B * g.Mh * g.Mw)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = ((g.C + kConvBM - 1) / kConvBM) * ((g.O + kConvBN - 1) / kConvBN);
  cudaError_t err = cudaFuncSetAttribute(conv_wgrad_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kWgSmem);
  if (err != cudaSuccess) return (int)err;
  conv_wgrad_kernel<MODE><<<dim3(n_tiles, TAPS, splits), kConvThreads, kWgSmem, stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)TAPS * g.C * g.O;
  wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(g.partial, out, splits, n);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gvq
