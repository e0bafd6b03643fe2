// LayerNorm-prologue matmul and plain matmul + bias, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of the microbenchmark scripts/exp_ln_matmul.py
// (no model calls them):
//   _pallas_fused (:64, pallas_call at :67, body _fused_kernel): for each row
//     of x, float32 mean, variance as the mean of (x - mean)^2, rstd =
//     rsqrt(var + eps); xn = bf16((x - mean) * rstd * g + b); out =
//     bf16(xn @ W + wb) with float32 sums -> gvq_ln_matmul;
//   _pallas_mm (:81, pallas_call at :84, body _mm_kernel): out = bf16(y @ W
//     + wb) with float32 sums -> gvq_matmul_bias.
// Each rounds twice at most: xn once to bf16 before the product (the fused
// kernel), the output once after the float32 bias add.
//
// What bounds it on an H100: at the lab's (16384, 768) @ (768, 2304) one
// launch is 5.8e10 FLOP against 104 MB (x, W, g, b, wb read once, out
// written once), so the tensor cores bound it: 0.059 ms at the bf16 peak
// (0.078 ms at N = 3072).
//
// The TPU block holds its whole (bm, 768) x and the whole W in VMEM.  A
// Hopper block cannot: W alone is 3.5 MB at N = 2304, and (bm, N) float32
// accumulators are 2.4 MB at bm = 256.  What stays is what the fusion is for:
// the normalised activation never leaves the SM.  A block owns `bm` rows and
// every column of them, as the TPU block does, and walks them in 128-row
// sub-tiles.  For each sub-tile it computes the rows' statistics (one warp a
// row, the row in registers, two passes) and writes the normalised bf16
// rows, the whole K = C extent of them, into shared memory once: 128 x
// (768 + 8) bf16 = 198,656 bytes.  It then walks N in 128-column tiles, each
// one a K loop over 32-row tiles of W streamed by cp.async through a
// three-stage ring (26,112 bytes), on bf16 tensor cores through
// nvcuda::wmma (16x16x16, float32 accumulators; 8 warps in a 4 x 2 grid, a
// warp 32 x 64).  The epilogue stages each 16 x 16 accumulator through a
// per-warp scratch in the ring, adds the float32 bias, rounds once and
// stores 16 bytes a lane.  Keeping the normalised rows resident (rather than
// a statistics pre-pass and a transform of every loaded A tile, as the
// conv core's kSameGn prologue does) normalises each row once for all N / 128
// column tiles instead of once per tile, and reads x from device memory once.
// Its price is one block an SM (224,768 bytes at C = 768), so the grid is
// R / bm blocks: 128 at bm = 128, 16 at the TPU's bm = 1024.
//
// The plain matmul + bias is the same body with the prologue a copy.
//
// Limits: C a multiple of 32 up to 768 (the resident rows fill shared
// memory), N a multiple of 8 (16-byte rows; the last column tile is masked),
// any R (rows past R load zeros and are not stored), bm a positive multiple
// of 128.  Anything else returns cudaErrorInvalidValue and runs nothing.
//
// This file shares no header with the shipped kernels, so their register
// allocation cannot move with it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSub = 128;     // rows of one sub-tile (resident, normalised)
constexpr int kBN = 128;      // output columns per tile
constexpr int kBK = 32;       // K rows of W per stage
constexpr int kStages = 3;    // cp.async ring depth for W
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 768;
constexpr int kLdB = kBN + 8;  // bf16 pitch of a W stage
constexpr int kLdE = 20;       // f32 pitch of a warp's 16 x 16 epilogue scratch
constexpr int kMaxChunks = kMaxC / 8 / 32;  // 16-byte chunks of a row per lane
constexpr size_t kRingBytes = (size_t)kStages * kBK * kLdB * sizeof(bf16);
static_assert((size_t)kWarps * 16 * kLdE * sizeof(float) <= kRingBytes,
              "the epilogue scratch lives in the W ring");

__host__ __device__ constexpr int lda_of(int C) { return C + 8; }  // bf16 pitch of the rows

__host__ __device__ constexpr size_t smem_bytes(int C) {
  return (size_t)kSub * lda_of(C) * sizeof(bf16) + kRingBytes;
}

struct LnMmArgs {
  const bf16* x;     // (R, C): x (LN) or the normalised y (plain)
  const float* g;    // (C,) LN scale (LN only)
  const float* b;    // (C,) LN shift (LN only)
  const bf16* w;     // (C, N)
  const float* wb;   // (N,)
  bf16* out;         // (R, N)
  int R, C, N, bm;
  float eps;
};

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;  // 0: nothing is read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows r0 .. r0 + 127 of x into As (pitch lda), each warp 16 rows: LN
// normalises them (float32 statistics, one bf16 rounding), else a copy.
// Rows at or past R are zeros.
template <bool LN>
__device__ __forceinline__ void fill_rows(const LnMmArgs& g, bf16* As, int lda, int r0, int warp,
                                          int lane) {
  const int nch = g.C / 8;
  for (int rr = warp * (kSub / kWarps); rr < (warp + 1) * (kSub / kWarps); ++rr) {
    const int row = r0 + rr;
    bf16* dst = As + (size_t)rr * lda;
    if (row >= g.R) {
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        const int ch = j * 32 + lane;
        if (ch < nch) *reinterpret_cast<uint4*>(dst + ch * 8) = make_uint4(0u, 0u, 0u, 0u);
      }
      continue;
    }
    const bf16* src = g.x + (size_t)row * g.C;
    uint4 raw[kMaxChunks];
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int ch = j * 32 + lane;
      raw[j] = ch < nch ? *reinterpret_cast<const uint4*>(src + ch * 8)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
    if (!LN) {
#pragma unroll
      for (int j = 0; j < kMaxChunks; ++j) {
        const int ch = j * 32 + lane;
        if (ch < nch) *reinterpret_cast<uint4*>(dst + ch * 8) = raw[j];
      }
      continue;
    }
    float v[kMaxChunks * 8];
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        v[j * 8 + 2 * e] = f.x;
        v[j * 8 + 2 * e + 1] = f.y;
      }
    }
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxChunks * 8; ++i) sum += v[i];  // absent chunks are 0
    const float mean = warp_sum(sum) / (float)g.C;
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      if (j * 32 + lane < nch) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float c = v[j * 8 + e] - mean;
          sq += c * c;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / (float)g.C + g.eps);
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const int ch = j * 32 + lane;
      if (ch >= nch) continue;
      const float4* gp = reinterpret_cast<const float4*>(g.g + ch * 8);
      const float4* bp = reinterpret_cast<const float4*>(g.b + ch * 8);
      const float4 g0 = __ldg(gp), g1 = __ldg(gp + 1), b0 = __ldg(bp), b1 = __ldg(bp + 1);
      const float gs[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      uint4 packed;
      uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const float y0 = (v[j * 8 + e] - mean) * rstd * gs[e] + bs[e];
        const float y1 = (v[j * 8 + e + 1] - mean) * rstd * gs[e + 1] + bs[e + 1];
        __nv_bfloat162 r = __floats2bfloat162_rn(y0, y1);
        pk[e >> 1] = *reinterpret_cast<uint32_t*>(&r);
      }
      *reinterpret_cast<uint4*>(dst + ch * 8) = packed;
    }
  }
}

template <bool LN>
__global__ void __launch_bounds__(kThreads, 1) ln_matmul_kernel(LnMmArgs g) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = lda_of(g.C);
  bf16* As = reinterpret_cast<bf16*>(smem);                                // kSub x lda
  bf16* ring = As + (size_t)kSub * lda;                                    // kStages x kBK x kLdB
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp >> 1;  // 0..3: 32-row slab
  const int warp_n = warp & 1;   // 0..1: 64-column slab
  float* scratch = reinterpret_cast<float*>(ring) + warp * 16 * kLdE;
  const int ksteps = g.C / kBK;
  const int n_tiles = (g.N + kBN - 1) / kBN;
  const int row_end = min(g.R, (int)blockIdx.x * g.bm + g.bm);

  for (int r0 = blockIdx.x * g.bm; r0 < row_end; r0 += kSub) {
    fill_rows<LN>(g, As, lda, r0, warp, lane);
    __syncthreads();

    for (int nt = 0; nt < n_tiles; ++nt) {
      const int n0 = nt * kBN;
      // W rows k0 .. k0 + 31, columns n0 .. n0 + 127: 512 chunks, 2 a thread
      auto load_w = [&](int ks, int stage) {
        bf16* Bs = ring + (size_t)stage * kBK * kLdB;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int id = tid + i * kThreads;
          const int k = id >> 4, col = (id & 15) * 8;
          const bool ok = n0 + col < g.N;
          const bf16* src = ok ? g.w + (size_t)(ks * kBK + k) * g.N + n0 + col : g.w;
          cp_async16_zfill(Bs + k * kLdB + col, src, ok);
        }
      };

      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < ksteps) load_w(s, s);
        cp_async_commit();
      }
      for (int ks = 0; ks < ksteps; ++ks) {
        cp_async_wait<kStages - 2>();  // stage ks is in (this thread's copies)
        __syncthreads();               // ... everyone's; and stage ks - 1 is consumed
        if (ks + kStages - 1 < ksteps) load_w(ks + kStages - 1, (ks + kStages - 1) % kStages);
        cp_async_commit();
        const bf16* Bs = ring + (size_t)(ks % kStages) * kBK * kLdB;
        const bf16* Ak = As + ks * kBK;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(fa[i], Ak + (size_t)(warp_m * 32 + i * 16) * lda + kk, lda);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wmma::load_matrix_sync(fb[j], Bs + kk * kLdB + warp_n * 64 + j * 16, kLdB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // every MMA is done with the ring: it becomes the scratch

      // epilogue: one 16 x 16 accumulator at a time; lane -> row lane / 2,
      // 8 columns from (lane & 1) * 8: bias in float32, one rounding
      const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::store_matrix_sync(scratch, acc[i][j], kLdE, wmma::mem_row_major);
          __syncwarp();
          const int row = r0 + warp_m * 32 + i * 16 + er;
          const int col = n0 + warp_n * 64 + j * 16 + ec;
          if (row < g.R && col < g.N) {
            const float* s = scratch + er * kLdE + ec;
            const float4 b0 = __ldg(reinterpret_cast<const float4*>(g.wb + col));
            const float4 b1 = __ldg(reinterpret_cast<const float4*>(g.wb + col) + 1);
            const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
            uint4 packed;
            uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
            for (int e = 0; e < 8; e += 2) {
              __nv_bfloat162 r = __floats2bfloat162_rn(s[e] + bs[e], s[e + 1] + bs[e + 1]);
              pk[e >> 1] = *reinterpret_cast<uint32_t*>(&r);
            }
            *reinterpret_cast<uint4*>(g.out + (size_t)row * g.N + col) = packed;
          }
          __syncwarp();
        }
      }
      __syncthreads();  // the scratch is free for the next tile's W stages
    }
  }
}

template <bool LN>
int launch(const LnMmArgs& g, cudaStream_t stream) {
  if (g.R <= 0 || g.C <= 0 || g.C % kBK != 0 || g.C > kMaxC || g.N <= 0 || g.N % 8 != 0 ||
      g.bm <= 0 || g.bm % kSub != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(g.C);
  cudaError_t err = cudaFuncSetAttribute(ln_matmul_kernel<LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (g.R + g.bm - 1) / g.bm;
  ln_matmul_kernel<LN><<<blocks, kThreads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (R, C) bf16; g, b: (C,) float32; w: (C, N) bf16; wb: (N,) float32;
// out: (R, N) bf16; all contiguous and 16-byte aligned.  bm: the rows one
// block owns, a multiple of 128.
extern "C" int gvq_ln_matmul(const void* x, const void* g, const void* b, const void* w,
                             const void* wb, void* out, int R, int C, int N, int bm, float eps,
                             void* stream) {
  const LnMmArgs a{static_cast<const bf16*>(x), static_cast<const float*>(g),
                   static_cast<const float*>(b), static_cast<const bf16*>(w),
                   static_cast<const float*>(wb), static_cast<bf16*>(out), R, C, N, bm, eps};
  return launch<true>(a, static_cast<cudaStream_t>(stream));
}

// y: (R, C) bf16; w, wb, out, bm as above.
extern "C" int gvq_matmul_bias(const void* y, const void* w, const void* wb, void* out, int R,
                               int C, int N, int bm, void* stream) {
  const LnMmArgs a{static_cast<const bf16*>(y), nullptr, nullptr, static_cast<const bf16*>(w),
                   static_cast<const float*>(wb), static_cast<bf16*>(out), R, C, N, bm, 0.0f};
  return launch<false>(a, static_cast<cudaStream_t>(stream));
}
