// What a persistent, cooperatively launched grid needs, shared by the
// GroupNorm + swish backward (csrc/gn_swish_bwd.cu) and the LayerNorm
// backward (csrc/layer_norm.cu):
//
// - a 1-D bulk copy of global memory into shared memory that completes on
//   an mbarrier (cp.async.bulk: 16-byte aligned ends, a multiple of 16
//   bytes);
// - a barrier across the grid (GridBarrier), whose blocks the cooperative
//   launch keeps resident together;
// - a fixed-order sum of columns over rows of partials (ordered_column_sum),
//   so that a reduction across blocks repeats bit for bit without float
//   atomics.
//
// The barrier counts arrivals on a pair of 64-bit counters that belong to
// one stream (ops/grid_sync.py:grid_counters; zero when made, at words 0
// and 16 of their buffer, on cache lines of their own).  Between calls the
// low 32 bits of both are zero: a call reads its generation (the high bits)
// when it starts, each block adds one to counter k & 1 at phase k, and
// phase k is complete when that counter reaches the generation + (k / 2 +
// 1) * blocks.  After its last phase the first block adds what takes both
// counters' low bits back to zero, a carry into the generation, so that
// the next call on the stream finds them as this one did; calls on another
// stream use other counters.  Phases k and k + 1 may be in flight together
// (a block may arrive at k + 1 before it waits on k), never k and k + 2 (a
// block arrives at k + 2 only after its wait on k returned).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Phase marks for labs/trace_norm_bwd.py, which builds these sources on its
// own with GVQ_TRACE defined: thread 0 of each block writes (id,
// clock64()) at each mark, in order, into the buffer the lab sets
// (kTraceMarks pairs a block), and the lab charges the cycles since the
// previous mark to the mark's id.  In every other build a mark is nothing.
#ifdef GVQ_TRACE
#define GVQ_TRACE_BEGIN() int gvq_mark_ = 0
#define GVQ_MARK(id)                                                                      \
  do {                                                                                    \
    if (threadIdx.x == 0 && gvq::trace_buf != nullptr && gvq_mark_ < gvq::kTraceMarks) {  \
      long long* m_ = gvq::trace_buf + 2 * ((size_t)blockIdx.x * gvq::kTraceMarks + gvq_mark_++); \
      m_[0] = (id);                                                                       \
      m_[1] = clock64();                                                                  \
    }                                                                                     \
  } while (0)
#else
#define GVQ_TRACE_BEGIN() (void)0
#define GVQ_MARK(id) (void)0
#endif

namespace gvq {
namespace {

#ifdef GVQ_TRACE
constexpr int kTraceMarks = 2048;
__device__ long long* trace_buf;

// the trace buffer of this source's kernels (null: none)
inline int trace_set(void* buf) {
  return (int)cudaMemcpyToSymbol(trace_buf, &buf, sizeof(buf));
}
#endif

constexpr int kCounterStride = 16;  // 128 bytes between the two counters

// bytes of global memory at src into shared memory at dst, completing on
// the mbarrier at bar (whose expected bytes the caller armed)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire_gpu(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed_gpu(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_gpu(unsigned long long* p, unsigned long long v) {
  asm volatile("red.release.gpu.global.add.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

struct GridBarrier {
  unsigned long long* ctr;
  unsigned long long gen[2];  // read by thread 0, which alone arrives and waits

  // every thread; thread 0 reads the call's generation before any arrival
  __device__ explicit GridBarrier(unsigned long long* counters) : ctr(counters) {
    gen[0] = gen[1] = 0;
    if (threadIdx.x == 0) {
      gen[0] = ld_relaxed_gpu(ctr) & ~0xffffffffull;
      gen[1] = ld_relaxed_gpu(ctr + kCounterStride) & ~0xffffffffull;
    }
  }

  // after this block's writes of phase k (all its threads)
  __device__ void arrive(int k) {
    __syncthreads();
    if (threadIdx.x == 0) red_release_gpu(ctr + (k & 1) * kCounterStride, 1ull);
  }

  // until every block has arrived at phase k (all threads); what they
  // wrote before arriving is visible after it
  __device__ void wait(int k) {
    if (threadIdx.x == 0) {
      const unsigned long long* c = ctr + (k & 1) * kCounterStride;
      const unsigned long long target =
          gen[k & 1] + (unsigned long long)((k >> 1) + 1) * gridDim.x;
      while (ld_acquire_gpu(c) < target) {
      }
    }
    __syncthreads();
  }

  // after this block's wait on the last of `phases` phases (0 .. phases - 1)
  __device__ void finish(int phases) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      for (int p = 0; p < 2; ++p) {
        const unsigned long long n = (unsigned long long)((phases + 1 - p) / 2) * gridDim.x;
        red_release_gpu(ctr + p * kCounterStride, (1ull << 32) - n);
      }
    }
  }
};

// acc + base[p * stride] for p in [p0, p1), added in ascending order; the
// loads go out eight at a time, so a run costs a round trip to L2 per
// eight parts
__device__ __forceinline__ float run_sum(const float* base, int stride, int p0, int p1) {
  float acc = 0.0f;
  for (int p = p0; p < p1; p += 8) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = p + k < p1 ? __ldcg(base + (size_t)(p + k) * stride) : 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (p + k < p1) acc += v[k];
  }
  return acc;
}

// out[c] = the sum over p in [0, parts) of base[p * stride + c], c in [0,
// cols), by the block's threads in a fixed order (ops/grid_sync.py
// ordered_column_sum is its model).  tpc threads a column, the largest power
// of two with tpc * cols <= blockDim.x: a column's parts fall into tpc runs
// of ceil(parts / tpc) consecutive parts, one thread adds a run's parts in
// ascending order, then a column's lanes in a warp (min(tpc, 32) of them)
// add their runs' sums by a butterfly (offsets 1, 2, 4, ...: a fixed tree
// whose every lane ends with the same bits), and where tpc > 32 the
// column's warps' sums are added in warp order.  base is in global memory
// (read through L2), out in global or shared memory; scratch holds
// blockDim.x / 32 floats of shared memory.  Ends with the block
// synchronised.
__device__ void ordered_column_sum(const float* base, int stride, int parts, int cols, float* out,
                                   float* scratch) {
  const int nt = blockDim.x, t = threadIdx.x;
  if (cols <= 0) return;
  if (cols * 2 > nt) {
    for (int c = t; c < cols; c += nt) out[c] = run_sum(base + c, stride, 0, parts);
    __syncthreads();
    return;
  }
  int tpc = 1;
  while (tpc * 2 * cols <= nt) tpc *= 2;
  const int c = t / tpc, run = t % tpc, len = (parts + tpc - 1) / tpc;
  float acc = 0.0f;
  if (c < cols) acc = run_sum(base + c, stride, min(parts, run * len), min(parts, (run + 1) * len));
  for (int o = 1; o < min(tpc, 32); o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (tpc <= 32) {
    if (c < cols && run == 0) out[c] = acc;
  } else {
    if ((t & 31) == 0) scratch[t >> 5] = acc;
    __syncthreads();
    if (c < cols && run == 0) {
      float sum = 0.0f;
      for (int w = 0; w < tpc / 32; ++w) sum += scratch[(t >> 5) + w];
      out[c] = sum;
    }
  }
  __syncthreads();
}

}  // namespace
}  // namespace gvq
