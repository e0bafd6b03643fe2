// Pieces shared by the SIMT bodies of the float32 head-major flash kernels
// (csrc/flash_fwd.cu gvq_flash_fwd_hm_f32, csrc/flash_bwd.cu
// gvq_flash_bwd_hm_f32) at head dims 256 and 512: plain code on CUDA cores,
// fmaf products in float32, 256 threads a block, float32 tiles in shared
// memory at pitch D + 1 (so that 16 neighbouring rows fall in 16 banks).
// D = 64 and 128 run the split-TF32 tensor-core bodies instead
// (csrc/flash_f32_sm90.cuh); both are float32-accurate.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kF32Threads = 256;

// The (ROWS x D) output tile a thread owns: RO rows rg * RO + i by CO
// columns cg + j * CG (a warp's lanes take neighbouring columns), with
// cg = threadIdx.x % CG and rg = threadIdx.x / CG.
template <int D, int ROWS>
struct F32Own {
  static constexpr int CG = D >= 256 ? 32 : 16;
  static constexpr int CO = D / CG;
  static constexpr int RG = kF32Threads / CG;
  static constexpr int RO = ROWS / RG;
  static_assert(RO >= 1 && RO * RG == ROWS, "the output tile must split over 256 threads");
};

// ROWS rows of D floats from src (row stride `stride`) into dst (pitch
// D + 1); a row at or past `valid` is zeros
template <int D, int ROWS>
__device__ __forceinline__ void load_f32_rows(float* dst, const float* src, long long stride,
                                              int valid) {
  for (int e = threadIdx.x; e < ROWS * D; e += kF32Threads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = r < valid ? src[r * stride + c] : 0.0f;
  }
}

// acc[i][j] = sum_d A[r_i][d] B[c_j][d] over two T x D tiles (pitch D + 1):
// the thread's products are rows r_i = (threadIdx.x / 16) * N + i and
// columns c_j = threadIdx.x % 16 + 16 j, N = T / 16
template <int D, int T>
__device__ __forceinline__ void f32_abt(const float* A, const float* B, float (&acc)[T / 16][T / 16]) {
  constexpr int N = T / 16;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[N], b[N];
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = A[(ty * N + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < N; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// store a thread's RO x CO output tile to the rows of dst (row stride D)
// below `valid`
template <int D, int ROWS>
__device__ __forceinline__ void store_f32_own(float* dst, const float (&acc)[F32Own<D, ROWS>::RO][F32Own<D, ROWS>::CO],
                                              int valid) {
  using Own = F32Own<D, ROWS>;
  const int cg = threadIdx.x % Own::CG, rg = threadIdx.x / Own::CG;
#pragma unroll
  for (int i = 0; i < Own::RO; ++i) {
    const int r = rg * Own::RO + i;
    if (r >= valid) continue;
#pragma unroll
    for (int j = 0; j < Own::CO; ++j) dst[(size_t)r * D + cg + j * Own::CG] = acc[i][j];
  }
}

}  // namespace
