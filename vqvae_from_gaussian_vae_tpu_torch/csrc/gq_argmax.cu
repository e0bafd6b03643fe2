// Fused score product + first-max argmax for the Gaussian-quant search, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel vqvae_from_gaussian_vae_tpu/ops/gq_pallas.py
// (gq_argmax_pallas -> pl.pallas_call, body _kernel): for each row r,
// argmax over n of (A B)[r, n], A = (R, K) row statistics, B = (K, N)
// codebook features, without writing the (R, N) score matrix anywhere.
//
// What bounds it on an H100: 2*R*K*N FLOP (6.9e10 at R=16384, K=32,
// N=65536) over ~10 MB of operands, in fp32 -- TF32 or bf16 tensor cores
// would flip indices -- so it is bound by the fp32 CUDA-core rate.  The
// design keeps each thread's two rows of A (2 x K floats) in registers and
// streams B through shared memory one 256-code tile at a time, transposed
// so a code's K features are one broadcast float4 read shared by the warp:
// each shared load feeds 8 FMAs.
//
// 16384 rows are too few to fill 132 SMs, so the codes are split into
// chunks across blockIdx.y and a second kernel merges the per-chunk
// (value, index) pairs.  Ties keep the FIRST maximum, as torch.argmax and
// the TPU kernel do: each thread visits its chunk's codes in ascending
// order with a strict `>`, and the merge visits chunks in ascending order
// with a strict `>`.  Columns at or beyond N are never visited, so padding
// cannot win.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kGqThreads = 256;
constexpr int kGqRows = 2 * kGqThreads;  // two rows per thread
constexpr int kGqTileN = 256;            // codes per shared-memory tile

template <int K>
__global__ void __launch_bounds__(kGqThreads)
gq_chunk_kernel(const float* __restrict__ a, const float* __restrict__ b, int R, int N,
                int chunk, float* __restrict__ pval, int* __restrict__ pidx) {
  constexpr int KP = K + 4;  // pitch keeps float4 alignment, spreads the stores
  __shared__ __align__(16) float bs[kGqTileN * KP];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kGqRows + tid;
  const int r1 = r0 + kGqThreads;
  float a0[K], a1[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    a0[k] = r0 < R ? a[(size_t)r0 * K + k] : 0.0f;
    a1[k] = r1 < R ? a[(size_t)r1 * K + k] : 0.0f;
  }
  float best0 = -INFINITY, best1 = -INFINITY;
  int idx0 = 0, idx1 = 0;
  const int c_begin = blockIdx.y * chunk;
  const int c_end = min(N, c_begin + chunk);
  for (int t0 = c_begin; t0 < c_end; t0 += kGqTileN) {
    const int nt = min(kGqTileN, c_end - t0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < K * kGqTileN; e += kGqThreads) {
      const int k = e / kGqTileN, j = e % kGqTileN;
      bs[j * KP + k] = j < nt ? b[(size_t)k * N + t0 + j] : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      const float4* col = reinterpret_cast<const float4*>(bs + j * KP);
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int q = 0; q < K / 4; ++q) {
        const float4 v = col[q];
        s0 = fmaf(a0[4 * q + 0], v.x, s0);
        s1 = fmaf(a1[4 * q + 0], v.x, s1);
        s0 = fmaf(a0[4 * q + 1], v.y, s0);
        s1 = fmaf(a1[4 * q + 1], v.y, s1);
        s0 = fmaf(a0[4 * q + 2], v.z, s0);
        s1 = fmaf(a1[4 * q + 2], v.z, s1);
        s0 = fmaf(a0[4 * q + 3], v.w, s0);
        s1 = fmaf(a1[4 * q + 3], v.w, s1);
      }
      if (s0 > best0) {
        best0 = s0;
        idx0 = t0 + j;
      }
      if (s1 > best1) {
        best1 = s1;
        idx1 = t0 + j;
      }
    }
  }
  if (r0 < R) {
    pval[(size_t)blockIdx.y * R + r0] = best0;
    pidx[(size_t)blockIdx.y * R + r0] = idx0;
  }
  if (r1 < R) {
    pval[(size_t)blockIdx.y * R + r1] = best1;
    pidx[(size_t)blockIdx.y * R + r1] = idx1;
  }
}

__global__ void gq_merge_kernel(const float* __restrict__ pval, const int* __restrict__ pidx,
                                int R, int n_chunks, int* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float best = pval[r];
  int idx = pidx[r];
  for (int c = 1; c < n_chunks; ++c) {
    const float v = pval[(size_t)c * R + r];
    if (v > best) {  // strict: the earlier chunk keeps a tie
      best = v;
      idx = pidx[(size_t)c * R + r];
    }
  }
  out[r] = idx;
}

}  // namespace

// a (R, K) f32, b (K, N) f32 -> out (R,) int32.  pval / pidx are
// (n_chunks, R) scratch; chunk * n_chunks >= N and every chunk is non-empty.
extern "C" int gvq_gq_argmax(const float* a, const float* b, float* pval, int* pidx, int* out,
                             int R, int N, int K, int chunk, int n_chunks, void* stream) {
  if (R <= 0 || N <= 0 || chunk <= 0 || n_chunks <= 0 || (long long)chunk * (n_chunks - 1) >= N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + kGqRows - 1) / kGqRows, n_chunks);
  switch (K) {
    case 8:
      gq_chunk_kernel<8><<<grid, kGqThreads, 0, s>>>(a, b, R, N, chunk, pval, pidx);
      break;
    case 16:
      gq_chunk_kernel<16><<<grid, kGqThreads, 0, s>>>(a, b, R, N, chunk, pval, pidx);
      break;
    case 32:
      gq_chunk_kernel<32><<<grid, kGqThreads, 0, s>>>(a, b, R, N, chunk, pval, pidx);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gq_merge_kernel<<<(R + 255) / 256, 256, 0, s>>>(pval, pidx, R, n_chunks, out);
  return (int)cudaGetLastError();
}
