// The wmma bf16 flash-attention backward bodies (the pre-Hopper
// mma.sync-era fragments), instantiated by the backward lab alone
// (csrc/flash_lab_bwd.cu, B17), which prices their knobs.  No shipped entry
// runs them: the bf16 entries of csrc/flash_bwd.cu (gvq_flash_bwd_qkv,
// gvq_flash_bwd, gvq_flash_bwd_hm) take the wgmma body of
// csrc/flash_bwd_sm90.cuh at D = 64 and 128 and the wide wgmma body of
// csrc/flash_bwd_sm90_wide.cuh at D = 256 and 512.
//
// Template knobs (each a compile-time constant; the lab's combinations are
// listed in ops/flash_lab.py):
//   T        tile rows, of q and of k/v
//   WARPS    warps per block
//   PIPE     streamed tile pairs in flight: 1 (plain copies, then the
//            products) or 2 (the next pair copied by cp.async into a second
//            pair of buffers while the current pair's products run)
//   CONTROL  the lab's no-softmax control: no exp, no z read, no di pre-pass,
//            no ds elementwise; p = s and ds = dp only rounded to bf16, so
//            dv = bf16(s)^T do, dk = bf16(dp)^T q, dq = bf16(dp) k from the
//            same seven products
#pragma once

#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace nvcuda;

template <int D, int T, int PIPE = 1>
struct BwdLayout {
  static constexpr int kLdS = T + 4;  // f32 pitch of the score tiles
  static constexpr int kLdP = T + 8;  // bf16 pitch of the p / ds tiles
  static constexpr int kLdT = D + 8;  // bf16 pitch of the q, k, v, do tiles
  static constexpr int kLdA = D + 4;  // f32 pitch of the output staging tile
  static constexpr size_t kTile = (size_t)T * kLdT * sizeof(bf16);
  static constexpr size_t kA = 0;                 // first input tile
  static constexpr size_t kB = kA + kTile;        // second
  static constexpr size_t kC = kB + kTile;        // third
  static constexpr size_t kD = kC + kTile;        // fourth
  static constexpr size_t kS = kD + kTile;        // s, f32
  static constexpr size_t kDP = kS + (size_t)T * kLdS * sizeof(float);   // do v^T, f32
  static constexpr size_t kP = kDP + (size_t)T * kLdS * sizeof(float);   // bf16(p)
  static constexpr size_t kDS = kP + (size_t)T * kLdP * sizeof(bf16);    // bf16(ds)
  static constexpr size_t kAcc = kDS + (size_t)T * kLdP * sizeof(bf16);  // output staging
  static constexpr size_t kRow = kAcc + (size_t)T * kLdA * sizeof(float);  // z, di
  // PIPE = 2: a second pair of streamed tiles (q and do, or k and v)
  static constexpr size_t kNext = kRow + 2 * T * sizeof(float);
  static constexpr size_t kBytes = kNext + (size_t)(PIPE - 1) * 2 * kTile;
  // blocks an SM can hold by shared memory (at most 2 are asked for): at
  // D = 64 two fit, and __launch_bounds__ then keeps registers to 128 a
  // thread so that two do
  static constexpr int kMinBlocks = 2 * kBytes <= 232448 ? 2 : 1;
};

struct BwdArgs {
  const bf16* q;       // (B, H, Lq, D) as sq says
  const bf16* k;       // (B, H, Lk, D) as skv says, and v
  const bf16* v;
  const bf16* dout;    // as sdo says, and o
  const float* z;      // (B, H, Lq)
  const float* di;     // (B, H, Lq)
  bf16* dq;            // as sdq says
  bf16* dk;            // as sdkv says, and dv
  bf16* dv;
  Strides sq, skv, sdo, sdq, sdkv;
  int Lq, Lk, H;
  float scale;
};

// the first `rows` rows of a T-row tile from src (row stride `stride`); the
// rest are zeros.  kTail: a tile may be partial (a launch of full tiles
// compiles the row and column checks out, here and below).  kAsync: by
// cp.async (the caller commits and waits)
template <int D, int T, int THREADS, bool kTail, bool kAsync = false>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long stride,
                                          int rows) {
  constexpr int LDT = BwdLayout<D, T>::kLdT;
  constexpr int CPR = D / 8;
  for (int e = threadIdx.x; e < T * CPR; e += THREADS) {
    const int r = e / CPR, c = (e % CPR) * 8;
    if constexpr (kAsync) {
      if (!kTail || r < rows)
        cp_async16(dst + r * LDT + c, src + r * stride + c);
      else
        *reinterpret_cast<uint4*>(dst + r * LDT + c) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      *reinterpret_cast<uint4*>(dst + r * LDT + c) =
          !kTail || r < rows ? *reinterpret_cast<const uint4*>(src + r * stride + c)
                             : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// out1 = A1 B1^T and out2 = A2 B2^T (T x T, f32, pitch kLdS) with A, B (T x D)
// bf16 tiles.  A warp's task is CPT (at most 2) adjacent fragments of one
// fragment row of one product: the A fragment of each k step is loaded once
// for both, and their MMA chains are independent.  With 8 warps and 64-row
// tiles each warp takes two tasks; with 16 warps and 32-row tiles there are
// 8 one-fragment tasks and the other 8 warps wait.
template <int D, int T, int WARPS>
__device__ __forceinline__ void tiles_abt(const bf16* a1, const bf16* b1, float* out1,
                                          const bf16* a2, const bf16* b2, float* out2) {
  using Lay = BwdLayout<D, T>;
  constexpr int LDT = Lay::kLdT;
  constexpr int RF = T / 16;
  constexpr int SHARE = 2 * RF * RF / WARPS;
  constexpr int CPT = SHARE < 1 ? 1 : (SHARE > 2 ? 2 : SHARE);  // fragments of a task
  constexpr int GROUPS = RF / CPT;
  constexpr int TASKS = 2 * RF * GROUPS;
  for (int task = threadIdx.x >> 5; task < TASKS; task += WARPS) {
    const bool second = task >= RF * GROUPS;
    const int fr = (task / GROUPS) % RF, fc0 = (task % GROUPS) * CPT;
    const bf16* a = (second ? a2 : a1) + fr * 16 * LDT;
    const bf16* b = (second ? b2 : b1) + fc0 * 16 * LDT;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) wmma::fill_fragment(acc[c], 0.0f);
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, a + kk, LDT);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, b + c * 16 * LDT + kk, LDT);
        wmma::mma_sync(acc[c], fa, fb, acc[c]);
      }
    }
    float* out = (second ? out2 : out1) + fr * 16 * Lay::kLdS + fc0 * 16;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      wmma::store_matrix_sync(out + c * 16, acc[c], Lay::kLdS, wmma::mem_row_major);
  }
}

// p = exp(s * scale - z), ds = p (dp - di) scale, both rounded to bf16; a
// q row past `rows` or a key column past `cols` (a partial tile) gets p = 0
// and ds = 0, so it adds nothing to dq, dk or dv.  CONTROL (the lab's
// no-softmax control): p = s and ds = dp, unscaled, only rounded
template <int T, int THREADS, bool kTail, bool CONTROL = false>
__device__ __forceinline__ void probs_and_ds(const float* S, const float* dP, const float* z,
                                             const float* di, float scale, int rows, int cols,
                                             bf16* P, bf16* dS) {
  constexpr int LDS = T + 4, LDP = T + 8;
  for (int e = threadIdx.x; e < T * T; e += THREADS) {
    const int r = e / T, c = e % T;
    const bool in = !kTail || (r < rows && c < cols);
    float p, ds;
    if constexpr (CONTROL) {
      p = in ? S[r * LDS + c] : 0.0f;
      ds = in ? dP[r * LDS + c] : 0.0f;
    } else {
      p = in ? expf(S[r * LDS + c] * scale - z[r]) : 0.0f;
      ds = in ? p * (dP[r * LDS + c] - di[r]) * scale : 0.0f;
    }
    if (P != nullptr) P[r * LDP + c] = __float2bfloat16(p);
    dS[r * LDP + c] = __float2bfloat16(ds);
  }
}

// write NF accumulator fragments (rows fr, columns cb..cb+NF-1 of a T x D
// tile) through the f32 staging tile to the first `rows` rows of dst (T x D
// bf16, row stride `stride`)
template <int D, int T, int THREADS, int NF, bool kTail>
__device__ __forceinline__ void write_out(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[NF], float* stage, int fr, int cb,
    bf16* dst, long long stride, int rows) {
  constexpr int LDA = BwdLayout<D, T>::kLdA;
  constexpr int CPR = D / 8;
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(stage + fr * 16 * LDA + (cb + f) * 16, acc[f], LDA,
                            wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < T * CPR; e += THREADS) {
    const int r = e / CPR, c = (e % CPR) * 8;
    if (kTail && r >= rows) continue;
    uint4 packed;
    uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      __nv_bfloat162 v2 = __floats2bfloat162_rn(stage[r * LDA + c + i], stage[r * LDA + c + i + 1]);
      pk[i >> 1] = *reinterpret_cast<uint32_t*>(&v2);
    }
    *reinterpret_cast<uint4*>(dst + r * stride + c) = packed;
  }
  __syncthreads();
}

// di[b, h, l] = sum_d do[b, h, l, d] * o[b, h, l, d] (o and do as s says),
// one thread a row; neighbouring threads take the index of the smaller
// stride (the head in the token-major layouts, the row in the head-major one)
__global__ void flash_bwd_di_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                    float* __restrict__ di, Strides s, int B, int L, int H,
                                    int D) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * L * H) return;
  int b, h, l;
  if (s.h < s.row) {
    h = (int)(idx % H);
    l = (int)((idx / H) % L);
    b = (int)(idx / ((size_t)H * L));
  } else {
    l = (int)(idx % L);
    h = (int)((idx / L) % H);
    b = (int)(idx / ((size_t)H * L));
  }
  const long long off = b * s.b + h * s.h + l * s.row;
  float acc = 0.0f;
  for (int d = 0; d < D; d += 8) {
    alignas(16) bf16 oe[8];
    alignas(16) bf16 de[8];
    *reinterpret_cast<uint4*>(oe) = *reinterpret_cast<const uint4*>(o + off + d);
    *reinterpret_cast<uint4*>(de) = *reinterpret_cast<const uint4*>(dout + off + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += __bfloat162float(oe[i]) * __bfloat162float(de[i]);
  }
  di[((size_t)b * H + h) * L + l] = acc;
}

// The accumulator fragments a warp owns in a T x D output: row fragment
// warp % RF, NF consecutive column fragments from (warp / RF) * NF
template <int D, int T, int WARPS>
struct OutFrags {
  static constexpr int RF = T / 16;
  static constexpr int NF = RF * (D / 16) / WARPS;
  static_assert(NF * WARPS == RF * (D / 16), "the output fragments must split evenly");
};

// dk and dv of one T-row K/V tile of one (b, h): stream the q tiles.  PIPE
// = 2: the next q and do tiles are copied by cp.async into a second pair of
// buffers while the current pair's products run
template <int D, int T, int WARPS, bool kTail, int PIPE = 1, bool CONTROL = false>
__global__ void __launch_bounds__(WARPS * 32, (BwdLayout<D, T, PIPE>::kMinBlocks))
flash_bwd_dkdv_kernel(BwdArgs g) {
  constexpr int THREADS = WARPS * 32;
  using Lay = BwdLayout<D, T, PIPE>;
  constexpr int LDT = Lay::kLdT;
  constexpr int RF = OutFrags<D, T, WARPS>::RF;
  constexpr int NF = OutFrags<D, T, WARPS>::NF;
  static_assert(PIPE == 1 || PIPE == 2, "one or two streamed tile pairs");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + Lay::kA);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Lay::kB);
  bf16* Qs0 = reinterpret_cast<bf16*>(smem + Lay::kC);
  bf16* dOs0 = reinterpret_cast<bf16*>(smem + Lay::kD);
  bf16* Qs1 = reinterpret_cast<bf16*>(smem + Lay::kNext);
  bf16* dOs1 = reinterpret_cast<bf16*>(smem + Lay::kNext + Lay::kTile);
  float* Ss = reinterpret_cast<float*>(smem + Lay::kS);
  float* dPs = reinterpret_cast<float*>(smem + Lay::kDP);
  bf16* Ps = reinterpret_cast<bf16*>(smem + Lay::kP);
  bf16* dSs = reinterpret_cast<bf16*>(smem + Lay::kDS);
  float* stage = reinterpret_cast<float*>(smem + Lay::kAcc);
  float* zs = reinterpret_cast<float*>(smem + Lay::kRow);
  float* dis = zs + T;

  const int warp = threadIdx.x >> 5;
  const int Lq = g.Lq, Lk = g.Lk, H = g.H;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * T;
  const int krows = min(T, Lk - k0);  // a partial last K/V tile
  const bf16* qb = g.q + b * g.sq.b + h * g.sq.h;
  const bf16* dob = g.dout + b * g.sdo.b + h * g.sdo.h;
  const float* zb = g.z + (size_t)blockIdx.y * Lq;
  const float* dib = g.di + (size_t)blockIdx.y * Lq;
  const long long kv_off = b * g.skv.b + h * g.skv.h + k0 * g.skv.row;

  load_tile<D, T, THREADS, kTail>(Ks, g.k + kv_off, g.skv.row, krows);
  load_tile<D, T, THREADS, kTail>(Vs, g.v + kv_off, g.skv.row, krows);
  if constexpr (PIPE == 2) {
    load_tile<D, T, THREADS, kTail, true>(Qs0, qb, g.sq.row, min(T, Lq));
    load_tile<D, T, THREADS, kTail, true>(dOs0, dob, g.sdo.row, min(T, Lq));
    cp_async_commit();
  }

  const int fr = warp % RF, cb = (warp / RF) * NF;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[NF], dv[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::fill_fragment(dk[f], 0.0f);
    wmma::fill_fragment(dv[f], 0.0f);
  }

  for (int q0 = 0; q0 < Lq; q0 += T) {
    const int qrows = min(T, Lq - q0);
    const bool odd = PIPE == 2 && ((q0 / T) & 1);
    bf16* Qs = odd ? Qs1 : Qs0;
    bf16* dOs = odd ? dOs1 : dOs0;
    if constexpr (PIPE == 1) {
      load_tile<D, T, THREADS, kTail>(Qs, qb + q0 * g.sq.row, g.sq.row, qrows);
      load_tile<D, T, THREADS, kTail>(dOs, dob + q0 * g.sdo.row, g.sdo.row, qrows);
    } else {
      cp_async_wait_all();
    }
    if constexpr (!CONTROL) {
      if (threadIdx.x < T) {
        const bool in = !kTail || (int)threadIdx.x < qrows;
        zs[threadIdx.x] = in ? zb[q0 + threadIdx.x] : 0.0f;
        dis[threadIdx.x] = in ? dib[q0 + threadIdx.x] : 0.0f;
      }
    }
    __syncthreads();
    if constexpr (PIPE == 2) {
      // the other pair was last read before the previous tile's final barrier
      if (q0 + T < Lq) {
        load_tile<D, T, THREADS, kTail, true>(odd ? Qs0 : Qs1, qb + (q0 + T) * g.sq.row,
                                              g.sq.row, min(T, Lq - q0 - T));
        load_tile<D, T, THREADS, kTail, true>(odd ? dOs0 : dOs1, dob + (q0 + T) * g.sdo.row,
                                              g.sdo.row, min(T, Lq - q0 - T));
        cp_async_commit();
      }
    }
    tiles_abt<D, T, WARPS>(Qs, Ks, Ss, dOs, Vs, dPs);  // s and do v^T (q x kv), unscaled
    __syncthreads();
    probs_and_ds<T, THREADS, kTail, CONTROL>(Ss, dPs, zs, dis, g.scale, qrows, T, Ps, dSs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < T; kk += 16) {  // over the q rows of the tile
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pt, dst;
      wmma::load_matrix_sync(pt, Ps + kk * Lay::kLdP + fr * 16, Lay::kLdP);    // p^T (kv x q)
      wmma::load_matrix_sync(dst, dSs + kk * Lay::kLdP + fr * 16, Lay::kLdP);  // ds^T
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fdo, fq;
        wmma::load_matrix_sync(fdo, dOs + kk * LDT + (cb + f) * 16, LDT);
        wmma::load_matrix_sync(fq, Qs + kk * LDT + (cb + f) * 16, LDT);
        wmma::mma_sync(dv[f], pt, fdo, dv[f]);
        wmma::mma_sync(dk[f], dst, fq, dk[f]);
      }
    }
    __syncthreads();
  }

  // the rows of dk and dv past Lk are not written
  const long long out_off = b * g.sdkv.b + h * g.sdkv.h + k0 * g.sdkv.row;
  write_out<D, T, THREADS, NF, kTail>(dk, stage, fr, cb, g.dk + out_off, g.sdkv.row, krows);
  write_out<D, T, THREADS, NF, kTail>(dv, stage, fr, cb, g.dv + out_off, g.sdkv.row, krows);
}

// dq of one T-row q tile of one (b, h): stream the K/V tiles (PIPE = 2: the
// next pair by cp.async into a second pair of buffers, as above)
template <int D, int T, int WARPS, bool kTail, int PIPE = 1, bool CONTROL = false>
__global__ void __launch_bounds__(WARPS * 32, (BwdLayout<D, T, PIPE>::kMinBlocks))
flash_bwd_dq_kernel(BwdArgs g) {
  constexpr int THREADS = WARPS * 32;
  using Lay = BwdLayout<D, T, PIPE>;
  constexpr int LDT = Lay::kLdT;
  constexpr int RF = OutFrags<D, T, WARPS>::RF;
  constexpr int NF = OutFrags<D, T, WARPS>::NF;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + Lay::kA);
  bf16* dOs = reinterpret_cast<bf16*>(smem + Lay::kB);
  bf16* Ks0 = reinterpret_cast<bf16*>(smem + Lay::kC);
  bf16* Vs0 = reinterpret_cast<bf16*>(smem + Lay::kD);
  bf16* Ks1 = reinterpret_cast<bf16*>(smem + Lay::kNext);
  bf16* Vs1 = reinterpret_cast<bf16*>(smem + Lay::kNext + Lay::kTile);
  float* Ss = reinterpret_cast<float*>(smem + Lay::kS);
  float* dPs = reinterpret_cast<float*>(smem + Lay::kDP);
  bf16* dSs = reinterpret_cast<bf16*>(smem + Lay::kDS);
  float* stage = reinterpret_cast<float*>(smem + Lay::kAcc);
  float* zs = reinterpret_cast<float*>(smem + Lay::kRow);
  float* dis = zs + T;

  const int warp = threadIdx.x >> 5;
  const int Lq = g.Lq, Lk = g.Lk, H = g.H;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * T;
  const int qrows = min(T, Lq - q0);  // a partial last q tile
  const bf16* kb = g.k + b * g.skv.b + h * g.skv.h;
  const bf16* vb = g.v + b * g.skv.b + h * g.skv.h;

  load_tile<D, T, THREADS, kTail>(Qs, g.q + b * g.sq.b + h * g.sq.h + q0 * g.sq.row, g.sq.row,
                                  qrows);
  load_tile<D, T, THREADS, kTail>(dOs, g.dout + b * g.sdo.b + h * g.sdo.h + q0 * g.sdo.row,
                                  g.sdo.row, qrows);
  if constexpr (!CONTROL) {
    if (threadIdx.x < T) {
      const bool in = !kTail || (int)threadIdx.x < qrows;
      zs[threadIdx.x] = in ? g.z[(size_t)blockIdx.y * Lq + q0 + threadIdx.x] : 0.0f;
      dis[threadIdx.x] = in ? g.di[(size_t)blockIdx.y * Lq + q0 + threadIdx.x] : 0.0f;
    }
  }
  if constexpr (PIPE == 2) {
    load_tile<D, T, THREADS, kTail, true>(Ks0, kb, g.skv.row, min(T, Lk));
    load_tile<D, T, THREADS, kTail, true>(Vs0, vb, g.skv.row, min(T, Lk));
    cp_async_commit();
  }

  const int fr = warp % RF, cb = (warp / RF) * NF;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(dq[f], 0.0f);

  for (int k0 = 0; k0 < Lk; k0 += T) {
    const int krows = min(T, Lk - k0);
    const bool odd = PIPE == 2 && ((k0 / T) & 1);
    bf16* Ks = odd ? Ks1 : Ks0;
    bf16* Vs = odd ? Vs1 : Vs0;
    if constexpr (PIPE == 1) {
      load_tile<D, T, THREADS, kTail>(Ks, kb + k0 * g.skv.row, g.skv.row, krows);
      load_tile<D, T, THREADS, kTail>(Vs, vb + k0 * g.skv.row, g.skv.row, krows);
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    if constexpr (PIPE == 2) {
      if (k0 + T < Lk) {
        load_tile<D, T, THREADS, kTail, true>(odd ? Ks0 : Ks1, kb + (k0 + T) * g.skv.row,
                                              g.skv.row, min(T, Lk - k0 - T));
        load_tile<D, T, THREADS, kTail, true>(odd ? Vs0 : Vs1, vb + (k0 + T) * g.skv.row,
                                              g.skv.row, min(T, Lk - k0 - T));
        cp_async_commit();
      }
    }
    tiles_abt<D, T, WARPS>(Qs, Ks, Ss, dOs, Vs, dPs);
    __syncthreads();
    // a key column past Lk gets p = 0
    probs_and_ds<T, THREADS, kTail, CONTROL>(Ss, dPs, zs, dis, g.scale, qrows, krows, nullptr,
                                             dSs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < T; kk += 16) {  // over the kv rows of the tile
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fds;
      wmma::load_matrix_sync(fds, dSs + fr * 16 * Lay::kLdP + kk, Lay::kLdP);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fk;
        wmma::load_matrix_sync(fk, Ks + kk * LDT + (cb + f) * 16, LDT);
        wmma::mma_sync(dq[f], fds, fk, dq[f]);
      }
    }
    __syncthreads();
  }
  write_out<D, T, THREADS, NF, kTail>(dq, stage, fr, cb,
                               g.dq + b * g.sdq.b + h * g.sdq.h + q0 * g.sdq.row, g.sdq.row,
                               qrows);
}

// The di pre-pass (skipped by the control, which reads no di), then dk/dv,
// then dq, over (tiles, B * H) grids.
template <int D, int T, int WARPS, bool kTail, int PIPE = 1, bool CONTROL = false>
int launch_flash_bwd(const BwdArgs& g, const bf16* o, float* di, int B, cudaStream_t stream) {
  const size_t smem = BwdLayout<D, T, PIPE>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, T, WARPS, kTail, PIPE, CONTROL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, T, WARPS, kTail, PIPE, CONTROL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if constexpr (!CONTROL) {
    const size_t rows = (size_t)B * g.Lq * g.H;
    flash_bwd_di_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(o, g.dout, di, g.sdo,
                                                                            B, g.Lq, g.H, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  flash_bwd_dkdv_kernel<D, T, WARPS, kTail, PIPE, CONTROL>
      <<<dim3((g.Lk + T - 1) / T, B * g.H), WARPS * 32, smem, stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D, T, WARPS, kTail, PIPE, CONTROL>
      <<<dim3((g.Lq + T - 1) / T, B * g.H), WARPS * 32, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace
