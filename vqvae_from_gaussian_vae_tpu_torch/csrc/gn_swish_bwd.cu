// GroupNorm + swish backward for Hopper (sm_90a).
//
// Replaces the TPU kernel vqvae_from_gaussian_vae_tpu/ops/gn_swish_bwd.py
// (_gn_swish_bwd_pallas -> pl.pallas_call, body _bwd_kernel), the backward
// of y = swish(GN(x) * gamma + beta) behind the custom VJP gn_swish.  From
// x and dy (B, HW, C), the forward's saved per-(sample, channel) mean and
// rstd (B, C) float32, and gamma, beta (C,) float32:
//
//   xhat = (x - mean) * rstd,  hpre = xhat * gamma + beta,  sig = sigmoid(hpre)
//   dh = dy * sig * (1 + hpre * (1 - sig))                (the swish backward)
//   s1[b, c] = sum_hw dh * xhat,  s2[b, c] = sum_hw dh
//   c2[b, g] = mean over (hw, c in g) of gamma * dh * xhat = sum_{c in g} gamma s1 / n
//   c1[b, g] = sum_{c in g} gamma s2 / n,   n = HW * C / G
//   dx = (dh * gamma - c1 - xhat * c2) * rstd             (in x's dtype)
//   dgamma = sum_b s1,  dbeta = sum_b s2                  (float32)
//
// What bounds it on an H100: a few tens of FLOP per element (two of them
// on the SFU: the exponential and the reciprocal of the sigmoid) against 2
// bytes of x and of dy read and 2 of dx written (bf16), so bytes bound it;
// the least traffic (x and dy read once, dx written once) at the sd3unet
// sites is 50 MB at 32x32x512 to 805 MB at 256x256x128 (bs=16).  As the TPU
// kernel does, dh is recomputed rather than stored, so pass 2 reads x and
// dy again.
//
// The design: one cooperative launch of a persistent grid
// (ops/gn_swish_bwd.py:gn_bwd_plan), whose blocks stream at the rate of
// the card's memory and meet at one grid barrier between the passes.
//
// - A sample's rows are cut into cpu chunks, one a block; a wave is upw
//   samples (every sample where B <= 132, one wave).
// - Each thread takes 16 bytes of channels of a row (8 bf16, 4 float32: a
//   warp's accesses are contiguous) and walks its chunk's rows, with 128
//   bytes of x and of dy in flight through a ring of cp.async copies in
//   shared memory.  Pass 1 reads with an L2 evict_last policy; pass 2 reads
//   each thread's rows last first with evict_first, so that its first reads
//   find what pass 1 left in L2 (all of it where x and dy fit there,
//   32x32x512 at bs=16), and stores dx with evict_first.
// - Pass 1: the block sums its threads' s1, s2 in a fixed order (row slots
//   of a warp by butterfly where a warp holds whole rows, then warps or row
//   slots in order) and writes them (for dgamma, dbeta) and their
//   gamma-weighted group sums (for c1, c2) as the chunk's partials.
// - A grid barrier a wave (csrc/grid_sync.cuh), split in two: a block
//   arrives at wave w + 1 (after pass 1 of w + 1) before it waits on wave w.
// - Pass 2: each block of a sample sums the sample's chunk partials in the
//   same fixed order (ordered_column_sum), so they all hold the same c1
//   and c2, then writes dx with 16-byte stores.
// - After the last wave's barrier, before its pass 2, dgamma and dbeta:
//   each block sums a slice of the channels over every chunk partial in
//   (sample, chunk) order.
// No float atomics anywhere: dx, dgamma and dbeta repeat bit for bit.
//
// Keeping x and dy on chip between the passes (in shared memory, or in L2
// in waves that fit it) reads them from HBM once, but pays each wave's
// barrier and partial sums, round trips that queue behind the streamed
// bytes: on an H100 both lost to this form at every sd3unet site
// (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"
#include "sm90.cuh"

namespace {

using gvq::GridBarrier;
using gvq::ordered_column_sum;
using gvq::wg_smem_addr;

constexpr int kGnThreads = 512;
constexpr int kGnPartialSets = 4;  // group partials by wave: w % 4 (see the loop)
constexpr int kPipeBytes = 128;    // bytes of a tensor a thread has in flight
constexpr int kMaxC = 2048;        // 16 bytes of channels a thread, at most 512 threads a row
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may have

// 16 bytes to global memory, not kept in L1, with an L2 eviction policy
__device__ __forceinline__ void st_hint(void* p, uint4 v, uint64_t pol) {
  asm volatile(
      "st.global.L1::no_allocate.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(p),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(pol)
      : "memory");
}

// 16 bytes of global memory into shared memory, asynchronously, with an L2
// eviction policy; completion by commit group (cp_async_commit, cp_async_wait)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint64_t pol) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "l"(pol)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// until at most N of this thread's commit groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint64_t l2_policy_evict_last() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// n floats (a multiple of 4) as float4s
template <int n>
__device__ __forceinline__ void load_floats(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < n / 4; ++i) {
    const float4 a = *(reinterpret_cast<const float4*>(p) + i);
    v[4 * i] = a.x, v[4 * i + 1] = a.y, v[4 * i + 2] = a.z, v[4 * i + 3] = a.w;
  }
}

template <int n>
__device__ __forceinline__ void store_floats(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < n / 4; ++i)
    *(reinterpret_cast<float4*>(p) + i) =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// 16 bytes of IO elements (a thread's channels of a row): N = 8 bf16 or 4
// float32, converted to and from float
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* v) { load_floats<4>(p, v); }
  __device__ static void store(float* p, const float* v, uint64_t pol) {
    st_hint(p, make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                          __float_as_uint(v[3])), pol);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v, uint64_t pol) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    st_hint(p, a, pol);
  }
};

// The launch plan (ops/gn_swish_bwd.py GnBwdPlan.as_array, in this order)
struct GnPlan {
  long long grid, threads, rows, cpu, upw, waves, smem;
};

// Shared memory of a block: each thread's rows in flight (kPipeBytes of x
// and of dy), the block reduction's rows of 2 * C sums (16 warps' where a
// warp holds whole rows, else every row slot's), the block's 2 * C sums,
// the sample's 2 * G constants, gamma, and the ordered sum's scratch (a
// float a warp).  ops/gn_swish_bwd.py:gn_smem mirrors it.
struct GnSmem {
  int red, blk, grp, gs, scr, total;

  __host__ __device__ GnSmem(int C, int G, int esize) {
    const int tpr = C / (16 / esize);  // threads a row
    const int groups = tpr <= 32 && 32 % tpr == 0 ? kGnThreads / 32 : kGnThreads / tpr;
    red = kGnThreads * 2 * kPipeBytes;
    blk = red + groups * 2 * C * 4;
    grp = blk + 2 * C * 4;
    gs = grp + (2 * G + 3) / 4 * 16;
    scr = gs + C * 4;
    total = scr + kGnThreads / 32 * 4;
  }
};

struct GnArgs {
  const void* x;
  const void* dy;
  const float* mean;
  const float* rstd;
  const float* gamma;
  const float* beta;
  void* dx;
  float* dgb;    // (2, C): dgamma, dbeta
  float* gpart;  // (4, grid, 2, G): each chunk's gamma-weighted group sums, by wave % 4
  float* cpart;  // (B, cpu, 2, C): each chunk's per-channel sums
  unsigned long long* counters;
  int B, HW, C, G;
  int rows, cpu, upw, waves;
};

// the chunk a block owns in a wave: rows [r0, r1) of sample b
struct Task {
  bool valid;
  int b, q, r0, r1, first;  // first: the sample's first block

  __device__ Task(const GnArgs& a, int w) {
    const int j = blockIdx.x;
    b = w * a.upw + j / a.cpu;
    q = j % a.cpu;
    first = j - q;
    r0 = q * a.rows;
    r1 = min(r0 + a.rows, a.HW);
    valid = j < a.upw * a.cpu && b < a.B && r0 < r1;
  }
};

// a thread's N channels (16 bytes of a row): its row slot, its first channel
template <int N>
struct Lanes {
  int tpr, rslots, slot, cc;
  bool active, shfl;

  __device__ explicit Lanes(int C) {
    tpr = C / N;
    rslots = kGnThreads / tpr;
    slot = threadIdx.x / tpr;
    cc = (threadIdx.x % tpr) * N;
    active = slot < rslots;
    shfl = tpr <= 32 && 32 % tpr == 0;
  }
};

template <int N>
struct ChanParams {
  float mean[N], rstd[N], gamma[N], beta[N];

  // gs: gamma in shared memory
  __device__ void load(const GnArgs& a, const float* gs, int b, int c) {
    load_floats<N>(a.mean + (size_t)b * a.C + c, mean);
    load_floats<N>(a.rstd + (size_t)b * a.C + c, rstd);
    load_floats<N>(a.beta + c, beta);
    load_floats<N>(gs + c, gamma);
  }

  __device__ void recompute(const float* x, const float* dy, float* xhat, float* dh) const {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      xhat[e] = (x[e] - mean[e]) * rstd[e];
      const float hpre = xhat[e] * gamma[e] + beta[e];
      const float sig = __fdividef(1.0f, 1.0f + __expf(-hpre));
      dh[e] = dy[e] * (sig * (1.0f + hpre * (1.0f - sig)));
    }
  }
};

// body(r, xv, dv) with the N channels at cc of x and dy (chunk rows from
// x, dy, C apart) in each of this thread's rows r = slot, slot + step, ...
// < n, in order (last first where `reverse`), read from global memory with
// the L2 policy pol through a ring of kPipe rows at pipe in shared memory
// (thread t's 16 bytes of a row at ((row % kPipe) * 2 + tensor) * kGnThreads
// + t, so that a warp's are contiguous), kPipe - 1 rows ahead
template <typename T, class Body>
__device__ void walk_rows(const T* x, const T* dy, int C, int n, int slot, int step, int cc,
                          uint64_t pol, const uint8_t* pipe, bool reverse, Body&& body) {
  constexpr int N = Vec<T>::N, kPipe = kPipeBytes / 16;
  const int mine = slot < n ? (n - slot + step - 1) / step : 0;
  const uint32_t base = wg_smem_addr(pipe) + 16 * threadIdx.x;
  auto piece = [&](int k, int tensor) { return (k * 2 + tensor) * kGnThreads * 16; };
  auto row = [&](int i) { return slot + (reverse ? mine - 1 - i : i) * step; };
  auto fetch = [&](int i) {
    if (i < mine) {
      const int r = row(i), k = i % kPipe;
      cp_async16(base + piece(k, 0), x + (size_t)r * C + cc, pol);
      cp_async16(base + piece(k, 1), dy + (size_t)r * C + cc, pol);
    }
    cp_async_commit();
  };
  for (int i = 0; i < kPipe - 1; ++i) fetch(i);
  const T* own = reinterpret_cast<const T*>(pipe + 16 * threadIdx.x);
  for (int i = 0; i < mine; ++i) {
    fetch(i + kPipe - 1);
    cp_async_wait<kPipe - 1>();
    const int k = i % kPipe;
    float xv[N], dv[N];
    Vec<T>::load(own + piece(k, 0) / (int)sizeof(T), xv);
    Vec<T>::load(own + piece(k, 1) / (int)sizeof(T), dv);
    body(row(i), xv, dv);
  }
  cp_async_wait<0>();
}

template <typename T>
__global__ void __launch_bounds__(kGnThreads, 1) gn_swish_bwd_kernel(const GnArgs a) {
  constexpr int N = Vec<T>::N;
  extern __shared__ __align__(128) uint8_t smem[];
  const GnSmem lay(a.C, a.G, (int)sizeof(T));
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* blk = reinterpret_cast<float*>(smem + lay.blk);
  float* grp = reinterpret_cast<float*>(smem + lay.grp);
  float* gs = reinterpret_cast<float*>(smem + lay.gs);  // gamma
  float* scr = reinterpret_cast<float*>(smem + lay.scr);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cg = a.C / a.G;
  const float inv_n = 1.0f / ((float)a.HW * (float)cg);
  const Lanes<N> ln(a.C);
  GridBarrier gbar(a.counters);
  GVQ_TRACE_BEGIN();

  // pass 1 of wave w: this chunk's sums, then its partials
  auto pass1 = [&](int w) {
    const Task t(a, w);
    if (!t.valid) return;
    const size_t off = ((size_t)t.b * a.HW + t.r0) * a.C;
    float s1[N] = {}, s2[N] = {};
    if (ln.active) {
      ChanParams<N> p;
      p.load(a, gs, t.b, ln.cc);
      // pass 1 keeps x and dy in L2 for pass 2
      walk_rows(static_cast<const T*>(a.x) + off, static_cast<const T*>(a.dy) + off, a.C,
                t.r1 - t.r0, ln.slot, ln.rslots, ln.cc, l2_policy_evict_last(), smem, false,
                [&](int, float* xv, float* dv) {
                  float xhat[N], dh[N];
                  p.recompute(xv, dv, xhat, dh);
#pragma unroll
                  for (int e = 0; e < N; ++e) {
                    s1[e] += dh[e] * xhat[e];
                    s2[e] += dh[e];
                  }
                });
    }
    GVQ_MARK(1);
    // the block's sums: row slots of a warp by butterfly where a warp holds
    // whole rows, then warps (or row slots) in order
    int group = ln.slot;
    bool writer = ln.active;
    if (ln.shfl) {
      for (int o = ln.tpr; o < 32; o <<= 1) {
#pragma unroll
        for (int e = 0; e < N; ++e) {
          s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], o);
          s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], o);
        }
      }
      group = warp;
      writer = lane < ln.tpr;
    }
    if (writer) {
      store_floats<N>(red + (size_t)group * 2 * a.C + ln.cc, s1);
      store_floats<N>(red + (size_t)group * 2 * a.C + a.C + ln.cc, s2);
    }
    __syncthreads();
    const int ngroups = ln.shfl ? kGnThreads / 32 : ln.rslots;
    for (int i = tid; i < 2 * a.C; i += kGnThreads) {
      float acc = 0.0f;
      for (int g = 0; g < ngroups; ++g) acc += red[(size_t)g * 2 * a.C + i];
      blk[i] = acc;
      __stcg(a.cpart + ((size_t)t.b * a.cpu + t.q) * 2 * a.C + i, acc);
    }
    __syncthreads();
    // gamma-weighted group sums: [0] from s1 (for c2), [1] from s2 (for c1)
    float* gp = a.gpart + ((size_t)(w % kGnPartialSets) * gridDim.x + blockIdx.x) * 2 * a.G;
    for (int i = tid; i < 2 * a.G; i += kGnThreads) {
      const int k = i / a.G, g0 = (i % a.G) * cg;
      float acc = 0.0f;
      for (int c = 0; c < cg; ++c) acc += gs[g0 + c] * blk[k * a.C + g0 + c];
      __stcg(gp + i, acc);
    }
  };

  // pass 2 of wave w, after the barrier of wave w: the sample's constants
  // (its chunks' group sums in a fixed order), then dx
  auto pass2 = [&](int w) {
    const Task t(a, w);
    if (!t.valid) return;
    const float* gp = a.gpart + ((size_t)(w % kGnPartialSets) * gridDim.x + t.first) * 2 * a.G;
    ordered_column_sum(gp, 2 * a.G, a.cpu, 2 * a.G, grp, scr);
    GVQ_MARK(5);
    if (!ln.active) return;
    ChanParams<N> p;
    p.load(a, gs, t.b, ln.cc);
    float c1[N], c2[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int g = (ln.cc + e) / cg;
      c1[e] = grp[a.G + g] * inv_n;
      c2[e] = grp[g] * inv_n;
    }
    const size_t off = ((size_t)t.b * a.HW + t.r0) * a.C;
    T* dx = static_cast<T*>(a.dx) + off;
    // pass 2 lets x, dy (read last first, where pass 1 left them) and dx go first
    const uint64_t drop = l2_policy_evict_first();
    walk_rows(static_cast<const T*>(a.x) + off, static_cast<const T*>(a.dy) + off, a.C,
              t.r1 - t.r0, ln.slot, ln.rslots, ln.cc, drop, smem, true,
              [&](int r, float* xv, float* dv) {
                float xhat[N], dh[N], out[N];
                p.recompute(xv, dv, xhat, dh);
#pragma unroll
                for (int e = 0; e < N; ++e)
                  out[e] = (dh[e] * p.gamma[e] - c1[e] - xhat[e] * c2[e]) * p.rstd[e];
                Vec<T>::store(dx + (size_t)r * a.C + ln.cc, out, drop);
              });
  };

  GVQ_MARK(0);
  for (int i = tid; i < a.C; i += kGnThreads) gs[i] = a.gamma[i];
  __syncthreads();
  pass1(0);
  gbar.arrive(0);
  GVQ_MARK(2);
  for (int w = 0; w < a.waves; ++w) {
    if (w + 1 < a.waves) {
      pass1(w + 1);
      gbar.arrive(w + 1);
      GVQ_MARK(2);
    }
    gbar.wait(w);
    GVQ_MARK(3);
    if (w + 1 == a.waves) {
      // every chunk's channel sums are in: dgamma, dbeta, a slice of the 2C
      // columns a block, over (sample, chunk)
      const int per = (2 * a.C + gridDim.x - 1) / gridDim.x;
      const int col0 = min(2 * a.C, blockIdx.x * per), col1 = min(2 * a.C, col0 + per);
      ordered_column_sum(a.cpart + col0, 2 * a.C, a.B * a.cpu, col1 - col0, a.dgb + col0, scr);
      gbar.finish(a.waves);
      GVQ_MARK(4);
    }
    pass2(w);
    GVQ_MARK(6);
  }
}

// the plan is one this kernel runs on this shape
bool plan_fits(const GnPlan& p, int B, int HW, int C, int G, int esize) {
  if (p.threads != kGnThreads || p.rows <= 0 || p.upw <= 0 || p.upw > B ||
      p.cpu != (HW + p.rows - 1) / p.rows || p.grid != p.upw * p.cpu ||
      p.waves != (B + p.upw - 1) / p.upw)
    return false;
  const GnSmem lay(C, G, esize);
  return p.smem == lay.total && lay.total <= kMaxSmem;
}

template <typename T>
int launch(GnArgs a, const GnPlan& plan, cudaStream_t stream) {
  auto kernel = gn_swish_bwd_kernel<T>;
  const int smem = (int)plan.smem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGnThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if (plan.grid > (long long)per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)plan.grid),
                                    dim3(kGnThreads), args, (size_t)smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx (B, HW, C) of one dtype (0 float32, 1 bf16); mean, rstd (B, C),
// gamma, beta (C,) float32; dgb (2, C) float32 gets (dgamma, dbeta).
// scratch: float32 of 4 * grid * 2 * G + B * cpu * 2 * C (the chunks' group
// partials, then their channel partials); counters: the stream's grid
// barrier counters (ops/grid_sync.py).  plan: 7 int64, GnBwdPlan.as_array
// (ops/gn_swish_bwd.py:gn_bwd_plan).  All contiguous, 16-byte aligned; C a
// multiple of 8 and of G, at most 2048.  One cooperative launch.
extern "C" int gvq_gn_swish_bwd(const void* x, const void* dy, const float* mean,
                                const float* rstd, const float* gamma, const float* beta,
                                float* scratch, void* dx, float* dgb, void* counters, int B,
                                int HW, int C, int G, const long long* plan, int dtype,
                                void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || C % 8 != 0 || C > kMaxC || G <= 0 || C % G != 0 ||
      plan == nullptr || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const GnPlan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6]};
  if (!plan_fits(p, B, HW, C, G, dtype == 0 ? 4 : 2)) return (int)cudaErrorInvalidValue;
  GnArgs a{x, dy, mean, rstd, gamma, beta, dx, dgb, scratch,
           scratch + (size_t)kGnPartialSets * p.grid * 2 * G,
           static_cast<unsigned long long*>(counters), B, HW, C, G,
           (int)p.rows, (int)p.cpu, (int)p.upw, (int)p.waves};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, p, s) : launch<__nv_bfloat16>(a, p, s);
}

#ifdef GVQ_TRACE
extern "C" int gvq_trace_set_gn(void* buf) { return gvq::trace_set(buf); }
#endif
