// Implicit-GEMM 3x3 convolution core (wmma) of the upsample's forward
// (upsample_conv.cu) and of the fused GroupNorm + swish + conv
// (fused_gn_conv.cu).  The downsample's forward and input gradient and the
// upsample's input gradient run the Hopper body, conv_igemm_sm90.cuh.
//
// Both ops are a sum of small-tap convolutions over an NHWC bf16 input, so
// one kernel body serves them, picked by MODE:
//
//   M = output pixels of one sample (of one phase, where the op has phases),
//   N = output channels, K = taps x input channels.
//
//   kUpFwd: 4 taps per phase (di, dj); output pixel (2*mh+di, 2*mw+dj)
//       reads input (mh + di + a - 1, mw + dj + b - 1), a, b in 0..1, with
//       zero halos outside the image; the weights are the phase kernels
//       k22[di, dj, a, b] computed once by the wrapper.
//   kSameGn: the stride-1 "same" 3x3 conv, 9 taps: output pixel (mh, mw)
//       reads input (mh + a - 1, mw + b - 1), a, b in 0..2.  A prologue
//       takes each loaded bf16 A chunk to float32, applies the per-(sample,
//       channel) GroupNorm affine x * scale + shift and swish, and rounds to
//       bf16 before the MMAs.  A tap outside the image contributes 0 AFTER
//       the transform (the conv pads the normalised activation, not x), so
//       the prologue writes zeros there rather than transforming the zero
//       the load filled in.  The epilogue adds the float32 bias and, with
//       ADD, the residual `add` (B, H, W, O), and rounds once; no stats.
//
// The weights are laid out (taps, K channels, N channels).
//
// Work per block: a 128-pixel x 128-channel output tile of one sample,
// 8 warps in a 4 x 2 grid, each warp 32 x 64 on bf16 tensor cores through
// nvcuda::wmma (16x16x16, fp32 accumulators).  The K loop walks taps x
// 32-channel slices; the next slice's global loads are issued into
// registers before the current slice's MMAs, so load latency overlaps
// compute (single shared buffer, no cp.async / TMA yet).
//
// Epilogue: accumulators go through shared memory, get the bias, round to
// bf16 and are stored (kSameGn: bias, residual, one rounding).  The GroupNorm statistics (sum, sum of squares) are
// taken over the ROUNDED bf16 values, as the TPU kernels do, per block and
// channel, into a partial buffer (B, P, 2, O); a second kernel reduces the
// P partials of each (sample, channel) in a fixed order, so results repeat
// bit for bit (no float atomics).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

// Everything below has internal linkage: several sources include this
// header and are linked into one library.
namespace gvq {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kConvBM = 128;          // output pixels per block
constexpr int kConvBN = 128;          // output channels per block
constexpr int kConvBK = 32;           // input channels per K step
constexpr int kConvThreads = 256;
constexpr int kConvLDA = kConvBK + 8;  // smem pitch (bf16) of the A tile
constexpr int kConvLDB = kConvBN + 8;  // smem pitch (bf16) of the B tile
constexpr int kConvLDC = kConvBN + 4;  // smem pitch (f32) of the C tile

constexpr size_t kConvSmemAB =
    (size_t)kConvBM * kConvLDA * sizeof(bf16) + (size_t)kConvBK * kConvLDB * sizeof(bf16);
constexpr size_t kConvSmemC = (size_t)kConvBM * kConvLDC * sizeof(float);
constexpr size_t kConvSmem = kConvSmemAB > kConvSmemC ? kConvSmemAB : kConvSmemC;

// the values of the modes the Hopper body took over (0, 2, 3) stay unused,
// so the kernels' mangled names do not move
enum ConvMode { kUpFwd = 1, kSameGn = 4 };

__host__ __device__ constexpr bool conv_is_fwd(int mode) {
  return mode == kUpFwd;
}

__host__ __device__ constexpr int conv_phases(int mode) {
  return mode == kUpFwd ? 4 : 1;
}

struct ConvArgs {
  const bf16* x;      // input (B, H, W, C)
  const bf16* add;    // (B, H, W, C) or null (forward modes); kSameGn: the residual (B, H, W, O)
  const bf16* w;      // (taps, C, O): HWIO or k22
  const float* bias;  // (O,) bf16-rounded values held as f32 (forward modes); f32 (kSameGn)
  const float* scale; // (B, C) GroupNorm affine (kSameGn only)
  const float* shift; // (B, C)
  bf16* y;            // output (B, out_h, out_w, O)
  float* partial;     // (B, P, 2, O) per-block statistics (forward modes)
  int B, H, W, C, O;
  int Mh, Mw;         // M grid of one sample (and one phase)
  int n_mt;           // M tiles per sample (and phase)
  int out_h, out_w;
};

__device__ __forceinline__ uint4 add_bf16x8(uint4 a, uint4 b) {
  // x + add rounded once to bf16, as the TPU kernel's bf16 add does
  uint4 out;
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
  uint32_t* po = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 va = *reinterpret_cast<const __nv_bfloat162*>(&pa[i]);
    __nv_bfloat162 vb = *reinterpret_cast<const __nv_bfloat162*>(&pb[i]);
    float2 fa = __bfloat1622float2(va);
    float2 fb = __bfloat1622float2(vb);
    __nv_bfloat162 s = __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
    po[i] = *reinterpret_cast<uint32_t*>(&s);
  }
  return out;
}

__device__ __forceinline__ float swish(float h) { return h / (1.0f + __expf(-h)); }

// kSameGn's prologue on 8 channels: swish(x * scale + shift) in float32,
// rounded to bf16 (scale, shift: 8 consecutive float32, 16-byte aligned)
__device__ __forceinline__ uint4 gn_swish_bf16x8(uint4 a, const float* scale,
                                                 const float* shift) {
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(scale));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(scale) + 1);
  const float4 t0 = __ldg(reinterpret_cast<const float4*>(shift));
  const float4 t1 = __ldg(reinterpret_cast<const float4*>(shift) + 1);
  const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float sh[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
  uint4 out;
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(&a);
  uint32_t* po = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pa[i]));
    __nv_bfloat162 r = __floats2bfloat162_rn(swish(f.x * sc[2 * i] + sh[2 * i]),
                                             swish(f.y * sc[2 * i + 1] + sh[2 * i + 1]));
    po[i] = *reinterpret_cast<uint32_t*>(&r);
  }
  return out;
}

template <int MODE, bool ADD>
__global__ void __launch_bounds__(kConvThreads)
conv_igemm_kernel(ConvArgs g) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);   // BM x LDA
  bf16* Bs = As + kConvBM * kConvLDA;         // BK x LDB
  float* Cs = reinterpret_cast<float*>(smem); // BM x LDC, reused after the K loop
  __shared__ float red_s[kConvBN];
  __shared__ float red_ss[kConvBN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int warp_m = warp >> 1;  // 0..3: 32-row slab
  const int warp_n = warp & 1;   // 0..1: 64-column slab
  constexpr bool FWD = conv_is_fwd(MODE);
  constexpr bool GN = MODE == kSameGn;
  constexpr bool ADD_IN = ADD && !GN;   // x + add summed into the operand
  constexpr bool ADD_OUT = ADD && GN;   // the residual summed into the output
  constexpr bool BIAS = FWD || GN;
  const int mt = blockIdx.x;
  const int b = blockIdx.y;
  const int n_nt = (g.O + kConvBN - 1) / kConvBN;
  const int phase = (int)blockIdx.z / n_nt;
  const int nt = (int)blockIdx.z % n_nt;
  const int di = phase >> 1, dj = phase & 1;
  const int n0 = nt * kConvBN;
  const int m_total = g.Mh * g.Mw;
  const int taps = GN ? 9 : 4;
  const int kc_steps = g.C / kConvBK;
  const int ksteps = taps * kc_steps;

  // A tile: 128 pixels x 32 channels = 512 chunks of 8 channels, 2 per thread
  int a_mh[2], a_mw[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = tid + i * kConvThreads;
    const int m = mt * kConvBM + (id >> 2);
    a_ok[i] = m < m_total;
    a_mh[i] = a_ok[i] ? m / g.Mw : 0;
    a_mw[i] = a_ok[i] ? m % g.Mw : 0;
  }

  uint4 ra[2], rb[2], radd[2];
  bool a_in[2];  // the chunk lies in the image (kSameGn: transform it, else write 0)
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  auto load_tile = [&](int ks) {
    const int t = ks / kc_steps;
    const int c0 = (ks % kc_steps) * kConvBK;
    // input pixel (r, s) = (mh + dr, mw + dc), and the weight tap
    int dr, dc, wtap = t;
    if (GN) {
      dr = t / 3 - 1, dc = t % 3 - 1;
    } else {  // kUpFwd
      dr = di + (t >> 1) - 1, dc = dj + (t & 1) - 1, wtap = phase * 4 + t;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kConvThreads;
      const int cpart = id & 3;
      const int r = a_mh[i] + dr;
      const int s = a_mw[i] + dc;
      const bool ok = a_ok[i] && r >= 0 && r < g.H && s >= 0 && s < g.W;
      a_in[i] = ok;
      if (ok) {
        const size_t off = (((size_t)b * g.H + r) * g.W + s) * g.C + c0 + cpart * 8;
        ra[i] = *reinterpret_cast<const uint4*>(g.x + off);
        if (ADD_IN) radd[i] = *reinterpret_cast<const uint4*>(g.add + off);
      } else {
        ra[i] = zero4;
        if (ADD_IN) radd[i] = zero4;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kConvThreads;
      const int k = id >> 4;          // 16 chunks per 128-wide row
      const int col = (id & 15) * 8;
      rb[i] = n0 + col < g.O ? *reinterpret_cast<const uint4*>(
                                   g.w + ((size_t)wtap * g.C + c0 + k) * g.O + n0 + col)
                             : zero4;
    }
  };

  auto store_tile = [&](int ks) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kConvThreads;
      uint4 v = ra[i];
      if (ADD_IN) v = add_bf16x8(v, radd[i]);
      if (GN) {
        const int c = (ks % kc_steps) * kConvBK + (id & 3) * 8;
        v = a_in[i] ? gn_swish_bf16x8(v, g.scale + (size_t)b * g.C + c,
                                      g.shift + (size_t)b * g.C + c)
                    : zero4;
      }
      *reinterpret_cast<uint4*>(As + (id >> 2) * kConvLDA + (id & 3) * 8) = v;
      *reinterpret_cast<uint4*>(Bs + (id >> 4) * kConvLDB + (id & 15) * 8) = rb[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load_tile(0);
  for (int ks = 0; ks < ksteps; ++ks) {
    __syncthreads();  // the previous step's MMAs are done with As / Bs
    store_tile(ks);
    __syncthreads();
    if (ks + 1 < ksteps) load_tile(ks + 1);
#pragma unroll
    for (int kk = 0; kk < kConvBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (warp_m * 32 + i * 16) * kConvLDA + kk, kConvLDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * kConvLDB + warp_n * 64 + j * 16, kConvLDB);
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

  // (bias,) bf16 rounding, store; Cs keeps the rounded value for the stats
  constexpr bool INTERLEAVE = conv_phases(MODE) == 4;  // output pixel (2 mh + di, 2 mw + dj)
  for (int id = tid; id < kConvBM * (kConvBN / 8); id += kConvThreads) {
    const int p = id >> 4;
    const int cc = (id & 15) * 8;
    const int m = mt * kConvBM + p;
    float* crow = Cs + p * kConvLDC + cc;
    if (m < m_total && n0 + cc < g.O) {
      const int mh = m / g.Mw, mw = m % g.Mw;
      const int oh = INTERLEAVE ? 2 * mh + di : mh;
      const int ow = INTERLEAVE ? 2 * mw + dj : mw;
      uint4 packed;
      uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
      const size_t out_off = (((size_t)b * g.out_h + oh) * g.out_w + ow) * g.O + n0 + cc;
      float res[8];
      if (ADD_OUT) {
        const uint4 rv = *reinterpret_cast<const uint4*>(g.add + out_off);
        const __nv_bfloat162* r2v = reinterpret_cast<const __nv_bfloat162*>(&rv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(r2v[e]);
          res[2 * e] = f.x;
          res[2 * e + 1] = f.y;
        }
      }
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const float b0 = BIAS ? g.bias[n0 + cc + e] : 0.0f;
        const float b1 = BIAS ? g.bias[n0 + cc + e + 1] : 0.0f;
        float v0 = crow[e] + b0, v1 = crow[e + 1] + b1;
        if (ADD_OUT) v0 += res[e], v1 += res[e + 1];
        __nv_bfloat162 r2 = __floats2bfloat162_rn(v0, v1);
        float2 back = __bfloat1622float2(r2);
        crow[e] = back.x;
        crow[e + 1] = back.y;
        pk[e >> 1] = *reinterpret_cast<uint32_t*>(&r2);
      }
      *reinterpret_cast<uint4*>(g.y + out_off) = packed;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) crow[e] = 0.0f;
    }
  }
  if (!FWD) return;
  __syncthreads();

  // per-block channel statistics: two threads per column, fixed order
  const int col = tid & (kConvBN - 1);
  const int half = tid >> 7;
  float s = 0.0f, ss = 0.0f;
  for (int r = half * (kConvBM / 2); r < (half + 1) * (kConvBM / 2); ++r) {
    const float v = Cs[r * kConvLDC + col];
    s += v;
    ss += v * v;
  }
  if (half == 1) {
    red_s[col] = s;
    red_ss[col] = ss;
  }
  __syncthreads();
  if (half == 0) {
    s += red_s[col];
    ss += red_ss[col];
    const size_t slot = (size_t)b * (conv_phases(MODE) * g.n_mt) + (size_t)phase * g.n_mt + mt;
    g.partial[(slot * 2 + 0) * g.O + n0 + col] = s;
    g.partial[(slot * 2 + 1) * g.O + n0 + col] = ss;
  }
}

// stats[b, q, o] = sum over p of partial[b, p, q, o], p ascending
__global__ void conv_stats_reduce_kernel(const float* __restrict__ partial,
                                         float* __restrict__ stats, int B, int P, int O) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * 2 * O) return;
  const int o = idx % O;
  const int q = (idx / O) % 2;
  const int b = idx / (2 * O);
  float acc = 0.0f;
  for (int p = 0; p < P; ++p) acc += partial[(((size_t)b * P + p) * 2 + q) * O + o];
  stats[idx] = acc;
}

template <int MODE, bool ADD>
inline cudaError_t launch_igemm(const ConvArgs& g, cudaStream_t stream) {
  const dim3 grid(g.n_mt, g.B, conv_phases(MODE) * ((g.O + kConvBN - 1) / kConvBN));
  cudaError_t err = cudaFuncSetAttribute(conv_igemm_kernel<MODE, ADD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kConvSmem);
  if (err != cudaSuccess) return err;
  conv_igemm_kernel<MODE, ADD><<<grid, kConvThreads, kConvSmem, stream>>>(g);
  return cudaGetLastError();
}

// the forward modes: the conv with its epilogue, then the statistics reduce
template <int MODE>
inline int launch_conv(const ConvArgs& g, float* stats, cudaStream_t stream) {
  static_assert(conv_is_fwd(MODE), "launch_conv runs the forward modes");
  if (g.C % kConvBK != 0 || g.O % kConvBN != 0 || g.n_mt <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = g.add != nullptr ? launch_igemm<MODE, true>(g, stream)
                                     : launch_igemm<MODE, false>(g, stream);
  if (err != cudaSuccess) return (int)err;
  const int total = g.B * 2 * g.O;
  conv_stats_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      g.partial, stats, g.B, conv_phases(MODE) * g.n_mt, g.O);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gvq
