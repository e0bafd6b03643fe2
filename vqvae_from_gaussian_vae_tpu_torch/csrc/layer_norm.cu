// Row LayerNorm and the fused residual add + LayerNorm, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of vqvae_from_gaussian_vae_tpu/ops/layer_norm.py:
// _ln_fwd_2d (body _ln_fwd_kernel), _ln_add_fwd_2d (_ln_add_fwd_kernel),
// _ln_bwd_2d (_ln_bwd_kernel) and _ln_add_bwd_2d (_ln_add_bwd_kernel).  Over
// the last axis of an (R, C) array:
//
//   y = (x - mean) * rsqrt(var + eps) * gamma + beta
//   add variant: s = round_io(x + d); y = LN(s); both written
//
// with float32 statistics, the variance as the mean of (x - mean)^2 (two
// passes over the row held in registers, not E[x^2] - mean^2), and the
// add variant's statistics taken from the ROUNDED s, as the TPU kernel does.
//
// The backward saves nothing from the forward: it recomputes mean and rstd
// from the saved input (x, or the add variant's s), then
//
//   xhat = (x - mean) * rstd,  wdy = dy * gamma
//   dx = (wdy - mean(wdy) - xhat * mean(wdy * xhat)) * rstd  (+ ds_in)
//   dgamma = sum_rows dy * xhat,  dbeta = sum_rows dy   (float32)
//
// What bounds it on an H100: a few FLOP per element against 2 bytes read
// and 2 written (bf16), so it is bound by bytes: at the ViT shape (16384,
// 768) bf16 one LN moves 50 MB (15 us at 3.35 TB/s), one LN-add 101 MB, one
// LN backward 75 MB and one LN-add backward 101 MB.
//
// The forward does nothing but stream: one warp per row, the row held in
// registers through 16-byte loads (three uint4 a lane at C = 768 in bf16),
// the reductions by warp shuffles, no second read of x.  Eight rows (warps)
// a block.
//
// The backward is one cooperative launch of a persistent grid
// (ops/layer_norm.py:ln_bwd_plan) whose block j owns rows [R j / grid, R (j
// + 1) / grid).  It streams them in slabs of `rows` rows through a ring of
// two to four shared-memory stages: one 1-D bulk copy a tensor a slab (x or
// s, dy and, for the add variant, ds_in), completing on the stage's
// mbarrier, the next slabs in flight behind the one being reduced.  A block
// is 16 warps (8 where a row is wide: C > 2048 in bf16, 1024 in float32),
// and a warp takes a row of the slab: x from shared memory into registers (only x: dy and ds_in
// are read from the stage where needed), the statistics and the two row
// means by warp shuffles, dx to global memory with 16-byte stores.  Then
// the block's threads, each the owner of a few column pairs, add the slab's
// dy * xhat and dy into their own dgamma and dbeta partials from the same
// stage (each row's mean and rstd left in shared memory), so a lane carries
// no per-column accumulators through the row work.  At the end each block
// writes its (2, C) partial, the grid meets at one barrier
// (csrc/grid_sync.cuh), and each block sums a slice of the columns over the
// grid's partials in block order into dgamma and dbeta.  No float atomics:
// dx, dgamma and dbeta repeat bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "grid_sync.cuh"
#include "sm90.cuh"

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kMaxC = 4096;       // at most 128 floats of a row in a lane's registers
constexpr int kMaxPerLane = kMaxC / 32;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;  // elements per 16-byte chunk
  __device__ static float to_f(float v) { return v; }
  __device__ static float from_f(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 from_f(float v) { return __float2bfloat16_rn(v); }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// NCH: 16-byte chunks a lane holds (chunk j*32 + lane of the row's C / kVec)
template <typename T, int NCH, bool ADD>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ d, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ s_out, T* __restrict__ y, int R,
              int C, float eps) {
  constexpr int V = Io<T>::kVec;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const int nch = C / V;
  const size_t off = (size_t)row * C;

  float v[NCH * V];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int ch = j * 32 + lane;
    if (ch < nch) {
      alignas(16) T xe[V];
      *reinterpret_cast<uint4*>(xe) = *reinterpret_cast<const uint4*>(x + off + (size_t)ch * V);
      if (ADD) {
        alignas(16) T de[V];
        *reinterpret_cast<uint4*>(de) = *reinterpret_cast<const uint4*>(d + off + (size_t)ch * V);
#pragma unroll
        for (int i = 0; i < V; ++i) xe[i] = Io<T>::from_f(Io<T>::to_f(xe[i]) + Io<T>::to_f(de[i]));
        *reinterpret_cast<uint4*>(s_out + off + (size_t)ch * V) = *reinterpret_cast<uint4*>(xe);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) v[j * V + i] = Io<T>::to_f(xe[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[j * V + i] = 0.0f;
    }
  }

  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < NCH * V; ++i) sum += v[i];
  const float mean = warp_sum(sum) / (float)C;

  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    if (j * 32 + lane < nch) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float c = v[j * V + i] - mean;
        sq += c * c;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)C + eps);

#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int ch = j * 32 + lane;
    if (ch < nch) {
      alignas(16) float g[V];
      alignas(16) float b[V];
#pragma unroll
      for (int i = 0; i < V; i += 4) {
        *reinterpret_cast<float4*>(g + i) = *reinterpret_cast<const float4*>(gamma + ch * V + i);
        *reinterpret_cast<float4*>(b + i) = *reinterpret_cast<const float4*>(beta + ch * V + i);
      }
      alignas(16) T ye[V];
#pragma unroll
      for (int i = 0; i < V; ++i)
        ye[i] = Io<T>::from_f((v[j * V + i] - mean) * rstd * g[i] + b[i]);
      *reinterpret_cast<uint4*>(y + off + (size_t)ch * V) = *reinterpret_cast<uint4*>(ye);
    }
  }
}

template <typename T, int NCH, bool ADD>
int launch_ln(const void* x, const void* d, const float* g, const float* b, void* s, void* y,
              int R, int C, float eps, cudaStream_t stream) {
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock);
  ln_fwd_kernel<T, NCH, ADD><<<grid, kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(d), g, b, static_cast<T*>(s),
      static_cast<T*>(y), R, C, eps);
  return (int)cudaGetLastError();
}

// the smallest chunk count from a fixed set that covers C
template <typename T, bool ADD>
int dispatch(const void* x, const void* d, const float* g, const float* b, void* s, void* y,
             int R, int C, float eps, cudaStream_t st) {
  constexpr int V = Io<T>::kVec;
  const int need = (C / V + 31) / 32;
#define GVQ_LN_CASE(N)                                                           \
  if (N * V <= kMaxPerLane && need <= N)                                         \
    return launch_ln<T, (N * V <= kMaxPerLane ? N : 1), ADD>(x, d, g, b, s, y, R, C, eps, st);
  GVQ_LN_CASE(1)
  GVQ_LN_CASE(2)
  GVQ_LN_CASE(3)
  GVQ_LN_CASE(4)
  GVQ_LN_CASE(6)
  GVQ_LN_CASE(8)
  GVQ_LN_CASE(12)
  GVQ_LN_CASE(16)
  GVQ_LN_CASE(24)
  GVQ_LN_CASE(32)
#undef GVQ_LN_CASE
  return (int)cudaErrorInvalidValue;
}

template <bool ADD>
int ln_entry(const void* x, const void* d, const void* g, const void* b, void* s, void* y, int R,
             int C, int dtype, float eps, void* stream) {
  if (R <= 0 || C <= 0 || C % 8 != 0 || C > kMaxC) return (int)cudaErrorInvalidValue;
  const float* gp = static_cast<const float*>(g);
  const float* bp = static_cast<const float*>(b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float, ADD>(x, d, gp, bp, s, y, R, C, eps, st);
    case 1: return dispatch<__nv_bfloat16, ADD>(x, d, gp, bp, s, y, R, C, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// backward

constexpr int kMaxBwdStages = 4;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may have

// Threads of a backward block: 16 warps where a lane's NCH * kVec floats
// of x leave each thread 128 registers, else 8
template <typename T, int NCH>
struct BwdThreads {
  static constexpr int value = NCH * Io<T>::kVec <= 64 ? 512 : 256;
};

// The launch plan (ops/layer_norm.py LnBwdPlan.as_array, in this order):
// blocks, threads, rows a slab, stages of the ring, shared memory
struct LnBwdPlan {
  long long grid, threads, rows, stages, smem;
};

// Shared memory of a plan: the stages (each `rows` rows of x, dy and, for
// the add variant, ds_in), each row's (mean, rstd), gamma, the ordered
// sum's scratch (a float a warp) and the stages' mbarriers.
// ops/layer_norm.py:ln_bwd_smem mirrors it.
struct LnBwdSmem {
  int stage_bytes, stats, gamma, scr, bars, total;

  __host__ __device__ LnBwdSmem(int C, int esize, bool add, int rows, int stages) {
    stage_bytes = (rows * C * esize * (add ? 3 : 2) + 127) / 128 * 128;
    stats = stages * stage_bytes;
    gamma = stats + (rows * 8 + 15) / 16 * 16;
    scr = gamma + C * 4;
    bars = scr + 64;
    total = bars + stages * 8;
  }
};

// NCH: 16-byte chunks of a row a lane holds (chunk j*32 + lane of C / kVec);
// ADD adds ds_in to dx.  part: (gridDim.x, 2, C) float32, each block's
// (dgamma, dbeta) partial; dgb (2, C) float32.
template <typename T, int NCH, bool ADD>
__global__ void __launch_bounds__(BwdThreads<T, NCH>::value, 1)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma, const T* __restrict__ dy,
              const T* __restrict__ ds_in, T* __restrict__ dx, float* __restrict__ part,
              float* __restrict__ dgb, unsigned long long* counters, int R, int C, float eps,
              int rows, int stages) {
  constexpr int V = Io<T>::kVec;
  constexpr int kThreads = BwdThreads<T, NCH>::value, kWarps = kThreads / 32;
  constexpr int KP = (NCH * V * 16 + kThreads - 1) / kThreads;  // column pairs a thread owns
  using Pair = typename std::conditional<sizeof(T) == 2, __nv_bfloat162, float2>::type;
  extern __shared__ __align__(128) uint8_t smem[];
  const LnBwdSmem lay(C, (int)sizeof(T), ADD, rows, stages);
  float2* stats = reinterpret_cast<float2*>(smem + lay.stats);
  float* gs = reinterpret_cast<float*>(smem + lay.gamma);
  float* scr = reinterpret_cast<float*>(smem + lay.scr);
  const uint32_t bar0 = gvq::wg_smem_addr(smem + lay.bars);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nch = C / V;
  gvq::GridBarrier gbar(counters);
  const int r_begin = (int)((long long)R * blockIdx.x / gridDim.x);
  const int r_end = (int)((long long)R * (blockIdx.x + 1) / gridDim.x);
  const int slabs = (r_end - r_begin + rows - 1) / rows;
  const size_t plane = (size_t)rows * C;  // elements of one tensor in a stage

  // slab i into stage i % stages (thread 0)
  auto fetch = [&](int i) {
    const int r0 = r_begin + i * rows, n = min(rows, r_end - r0);
    const uint32_t bytes = (uint32_t)(n * C * sizeof(T)), bar = bar0 + 8 * (i % stages);
    const uint32_t dst = gvq::wg_smem_addr(smem + (i % stages) * lay.stage_bytes);
    gvq::mbar_arrive_expect_tx(bar, bytes * (ADD ? 3 : 2));
    gvq::bulk_load(dst, x + (size_t)r0 * C, bytes, bar);
    gvq::bulk_load(dst + plane * sizeof(T), dy + (size_t)r0 * C, bytes, bar);
    if (ADD) gvq::bulk_load(dst + 2 * plane * sizeof(T), ds_in + (size_t)r0 * C, bytes, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) gvq::mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < stages && i < slabs; ++i) fetch(i);
  }
  for (int i = tid; i < C; i += kThreads) gs[i] = gamma[i];
  __syncthreads();

  float pg[KP][2], pb[KP][2];
#pragma unroll
  for (int k = 0; k < KP; ++k) pg[k][0] = pg[k][1] = pb[k][0] = pb[k][1] = 0.0f;

  GVQ_TRACE_BEGIN();
  GVQ_MARK(0);
  for (int i = 0; i < slabs; ++i) {
    const int r0 = r_begin + i * rows, n = min(rows, r_end - r0);
    gvq::mbar_wait(bar0 + 8 * (i % stages), (i / stages) & 1);
    GVQ_MARK(1);
    const T* xs = reinterpret_cast<const T*>(smem + (i % stages) * lay.stage_bytes);
    const T* dys = xs + plane;
    const T* dss = dys + plane;

    // a warp a row: statistics, the row means of wdy and wdy * xhat, dx
    for (int rr = warp; rr < n; rr += kWarps) {
      const T* xr = xs + (size_t)rr * C;
      const T* dr = dys + (size_t)rr * C;
      float v[NCH * V];
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int ch = j * 32 + lane;
        if (ch < nch) {
          alignas(16) T xe[V];
          *reinterpret_cast<uint4*>(xe) = *reinterpret_cast<const uint4*>(xr + ch * V);
#pragma unroll
          for (int e = 0; e < V; ++e) v[j * V + e] = Io<T>::to_f(xe[e]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) v[j * V + e] = 0.0f;
        }
      }
      float sum = 0.0f;
#pragma unroll
      for (int e = 0; e < NCH * V; ++e) sum += v[e];
      const float mean = warp_sum(sum) / (float)C;
      float sq = 0.0f;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        if (j * 32 + lane < nch) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float c = v[j * V + e] - mean;
            sq += c * c;
          }
        }
      }
      const float rstd = rsqrtf(warp_sum(sq) / (float)C + eps);
      GVQ_MARK(7);

      // v becomes xhat; the row sums of wdy and wdy * xhat
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int ch = j * 32 + lane;
        if (ch < nch) {
          alignas(16) T de[V];
          alignas(16) float ga[V];
          *reinterpret_cast<uint4*>(de) = *reinterpret_cast<const uint4*>(dr + ch * V);
#pragma unroll
          for (int e = 0; e < V; e += 4)
            *reinterpret_cast<float4*>(ga + e) = *reinterpret_cast<const float4*>(gs + ch * V + e);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float xh = (v[j * V + e] - mean) * rstd;
            const float wdy = Io<T>::to_f(de[e]) * ga[e];
            v[j * V + e] = xh;
            s1 += wdy;
            s2 += wdy * xh;
          }
        }
      }
      const float c1 = warp_sum(s1) / (float)C;
      const float c2 = warp_sum(s2) / (float)C;
      GVQ_MARK(8);

      T* out_row = dx + (size_t)(r0 + rr) * C;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int ch = j * 32 + lane;
        if (ch < nch) {
          alignas(16) T de[V];
          alignas(16) T se[V];
          alignas(16) T out[V];
          alignas(16) float ga[V];
          *reinterpret_cast<uint4*>(de) = *reinterpret_cast<const uint4*>(dr + ch * V);
          if (ADD)
            *reinterpret_cast<uint4*>(se) =
                *reinterpret_cast<const uint4*>(dss + (size_t)rr * C + ch * V);
#pragma unroll
          for (int e = 0; e < V; e += 4)
            *reinterpret_cast<float4*>(ga + e) = *reinterpret_cast<const float4*>(gs + ch * V + e);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            float d = (Io<T>::to_f(de[e]) * ga[e] - c1 - v[j * V + e] * c2) * rstd;
            if (ADD) d += Io<T>::to_f(se[e]);
            out[e] = Io<T>::from_f(d);
          }
          *reinterpret_cast<uint4*>(out_row + ch * V) = *reinterpret_cast<uint4*>(out);
        }
      }
      if (lane == 0) stats[rr] = make_float2(mean, rstd);
    }
    __syncthreads();
    GVQ_MARK(2);

    // column owners: thread tid owns the pairs tid + k * kThreads and adds
    // the slab's rows in order
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int c = 2 * (tid + k * kThreads);
      if (c < C) {
        for (int rr = 0; rr < n; ++rr) {
          const float2 st = stats[rr];
          const Pair xp = *reinterpret_cast<const Pair*>(xs + (size_t)rr * C + c);
          const Pair dp = *reinterpret_cast<const Pair*>(dys + (size_t)rr * C + c);
          const float x0 = Io<T>::to_f(xp.x), x1 = Io<T>::to_f(xp.y);
          const float d0 = Io<T>::to_f(dp.x), d1 = Io<T>::to_f(dp.y);
          pg[k][0] += d0 * ((x0 - st.x) * st.y);
          pg[k][1] += d1 * ((x1 - st.x) * st.y);
          pb[k][0] += d0;
          pb[k][1] += d1;
        }
      }
    }
    __syncthreads();  // every thread is done with the stage
    GVQ_MARK(3);
    if (tid == 0 && i + stages < slabs) fetch(i + stages);
  }

  // the block's partial, then the grid's columns in block order
  float* pout = part + (size_t)blockIdx.x * 2 * C;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int c = 2 * (tid + k * kThreads);
    if (c < C) {
      __stcg(pout + c, pg[k][0]);
      __stcg(pout + c + 1, pg[k][1]);
      __stcg(pout + C + c, pb[k][0]);
      __stcg(pout + C + c + 1, pb[k][1]);
    }
  }
  gbar.arrive(0);
  gbar.wait(0);
  GVQ_MARK(5);
  const int per = (2 * C + gridDim.x - 1) / gridDim.x;
  const int col0 = min(2 * C, (int)blockIdx.x * per), col1 = min(2 * C, col0 + per);
  gvq::ordered_column_sum(part + col0, 2 * C, gridDim.x, col1 - col0, dgb + col0, scr);
  gbar.finish(1);
  GVQ_MARK(6);
}

template <typename T, int NCH, bool ADD>
int launch_ln_bwd(const void* x, const float* g, const void* dy, const void* ds_in, void* dx,
                  float* part, float* dgb, unsigned long long* counters, int R, int C,
                  const LnBwdPlan& p, float eps, cudaStream_t stream) {
  auto kernel = ln_bwd_kernel<T, NCH, ADD>;
  constexpr int kThreads = BwdThreads<T, NCH>::value;
  if (p.threads != kThreads) return (int)cudaErrorInvalidValue;
  const int smem = (int)p.smem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if (p.grid > (long long)per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  const T* dsp = static_cast<const T*>(ds_in);
  T* dxp = static_cast<T*>(dx);
  int rows = (int)p.rows, stages = (int)p.stages;
  void* args[] = {&xp, &g, &dyp, &dsp, &dxp, &part, &dgb, &counters, &R, &C, &eps, &rows, &stages};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)p.grid), dim3(kThreads),
                                    args, (size_t)smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the smallest chunk count from the forward's set that covers C
template <typename T, bool ADD>
int dispatch_bwd(const void* x, const float* g, const void* dy, const void* ds_in, void* dx,
                 float* part, float* dgb, unsigned long long* counters, int R, int C,
                 const LnBwdPlan& p, float eps, cudaStream_t st) {
  constexpr int V = Io<T>::kVec;
  const int need = (C / V + 31) / 32;
#define GVQ_LN_BWD_CASE(N)                                                                    \
  if (N * V <= kMaxPerLane && need <= N)                                                      \
    return launch_ln_bwd<T, (N * V <= kMaxPerLane ? N : 1), ADD>(x, g, dy, ds_in, dx, part, dgb, \
                                                                 counters, R, C, p, eps, st);
  GVQ_LN_BWD_CASE(1)
  GVQ_LN_BWD_CASE(2)
  GVQ_LN_BWD_CASE(3)
  GVQ_LN_BWD_CASE(4)
  GVQ_LN_BWD_CASE(6)
  GVQ_LN_BWD_CASE(8)
  GVQ_LN_BWD_CASE(12)
  GVQ_LN_BWD_CASE(16)
  GVQ_LN_BWD_CASE(24)
  GVQ_LN_BWD_CASE(32)
#undef GVQ_LN_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

template <bool ADD>
int ln_bwd_entry(const void* x, const void* g, const void* dy, const void* ds_in, void* dx,
                 void* part, void* dgb, void* counters, int R, int C, const long long* plan,
                 int dtype, float eps, void* stream) {
  if (R <= 0 || C <= 0 || C % 8 != 0 || C > kMaxC || plan == nullptr || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const LnBwdPlan p{plan[0], plan[1], plan[2], plan[3], plan[4]};
  const int esize = dtype == 0 ? 4 : 2;
  if (p.grid <= 0 || p.grid > R || p.rows <= 0 || p.stages < 2 ||
      p.stages > kMaxBwdStages || p.rows * C * esize * (ADD ? 3 : 2) >= (1 << 20))
    return (int)cudaErrorInvalidValue;
  const LnBwdSmem lay(C, esize, ADD, (int)p.rows, (int)p.stages);
  if (p.smem != lay.total || lay.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  const float* gp = static_cast<const float*>(g);
  float* pp = static_cast<float*>(part);
  float* op = static_cast<float*>(dgb);
  unsigned long long* cp = static_cast<unsigned long long*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bwd<float, ADD>(x, gp, dy, ds_in, dx, pp, op, cp, R, C, p, eps, st);
  return dispatch_bwd<__nv_bfloat16, ADD>(x, gp, dy, ds_in, dx, pp, op, cp, R, C, p, eps, st);
}

}  // namespace

// x, y: (R, C) contiguous, dtype 0 = float32, 1 = bf16; gamma, beta: (C,)
// float32.  C a multiple of 8, at most 4096; every pointer 16-byte aligned.
extern "C" int gvq_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                  int R, int C, int dtype, float eps, void* stream) {
  return ln_entry<false>(x, nullptr, gamma, beta, nullptr, y, R, C, dtype, eps, stream);
}

// The add variant: s = x + d rounded to the IO dtype, y = LN(s); x, d, s, y
// (R, C) of one dtype.
extern "C" int gvq_layer_norm_add_fwd(const void* x, const void* d, const void* gamma,
                                      const void* beta, void* s, void* y, int R, int C,
                                      int dtype, float eps, void* stream) {
  return ln_entry<true>(x, d, gamma, beta, s, y, R, C, dtype, eps, stream);
}

// LN backward: x (the forward's input), dy, dx (R, C) of one dtype; gamma
// (C,) float32; part (grid, 2, C) float32 scratch; dgb (2, C) float32 gets
// (dgamma, dbeta); counters: the stream's grid barrier counters
// (ops/grid_sync.py).  plan: 5 int64, LnBwdPlan.as_array
// (ops/layer_norm.py:ln_bwd_plan).  One cooperative launch.
extern "C" int gvq_layer_norm_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                                  void* part, void* dgb, void* counters, int R, int C,
                                  const long long* plan, int dtype, float eps, void* stream) {
  return ln_bwd_entry<false>(x, gamma, dy, nullptr, dx, part, dgb, counters, R, C, plan, dtype,
                             eps, stream);
}

// LN-add backward: s (the forward's rounded sum), dy and ds_in (the
// cotangents of y and s) -> dx = LN'(s) dy + ds_in, the gradient of both x
// and d.  Same layout rules as gvq_layer_norm_bwd.
extern "C" int gvq_layer_norm_add_bwd(const void* s, const void* gamma, const void* dy,
                                      const void* ds_in, void* dx, void* part, void* dgb,
                                      void* counters, int R, int C, const long long* plan,
                                      int dtype, float eps, void* stream) {
  return ln_bwd_entry<true>(s, gamma, dy, ds_in, dx, part, dgb, counters, R, C, plan, dtype, eps,
                            stream);
}

#ifdef GVQ_TRACE
extern "C" int gvq_trace_set_ln(void* buf) { return gvq::trace_set(buf); }
#endif
