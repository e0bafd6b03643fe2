// Flash-attention backward on token-major bf16 tensors, for Hopper (sm_90a).
//
// Replaces the TPU kernel of vqvae_from_gaussian_vae_tpu/ops/flash_blc.py
// _bwd_impl -> pl.pallas_call (body _bwd_kernel), reached from two entries:
//   gvq_flash_bwd_qkv  <- _bwd_call_packed (the ViT: q, k, v read in place
//                         from the (B, L, 3C) QKV projection output)
//   gvq_flash_bwd      <- _bwd_call (the UNet AttnBlock: separate (B, L, C)
//                         q, k, v; H=1, D=512 on the main path)
// Per head, with s = q k^T * scale and the forward's log-normaliser z
// (csrc/flash_fwd.cu, gvq_flash_fwd_qkv_res / gvq_flash_fwd_res):
//
//   p  = exp(s - z)                      (no max or sum pass)
//   di = rowsum(do * o)                  (float32)
//   ds = p * (do v^T - di) * scale       (rounded to bf16)
//   dq = ds k,  dk = ds^T q,  dv = bf16(p)^T do   (float32 accumulation)
//
// The inputs have one token stride and the outputs another, so the packed
// entry reads q, k and v at channel offsets 0, C and 2C of the projection
// (stride 3C) and writes dq | dk | dv into ONE (B, L, 3C) tensor at the same
// offsets, which the projection's backward reads as it is (the JAX package
// concatenates three (B, L, C) arrays); the unpacked entry has stride C
// both ways and three outputs.
//
// What bounds it on an H100: the five products.  At the ViT shape (B=16,
// L=1024, H=12, D=64) that is 1.29e11 FLOP against ~200 MB of traffic, at
// the UNet shape (B=16, L=1024, H=1, D=512) 8.6e10 FLOP against ~100 MB:
// tensor-core bound both (0.13 and 0.087 ms at the bf16 dense peak).  The
// TPU kernel keeps a head group's whole K and V in VMEM and accumulates
// dk, dv across q blocks in scratch; a block here has at most 227 KB of
// shared memory and no order across blocks, so both sides are tiled and
// the work is split in two kernels with no float atomics (the gradients
// are bit-reproducible): one over (K/V tile, b, h) that streams the q tiles
// and accumulates dk and dv in tensor-core fragments, and one over
// (q tile, b, h) that streams K/V and accumulates dq.  Each recomputes s and
// do v^T, so the pair runs seven products instead of five.  di comes from a
// small pre-pass.  Products run on bf16 tensor cores through nvcuda::wmma
// with float32 accumulators; the elementwise steps read the float32 score
// tiles from shared memory.
//
// The head-major entry gvq_flash_bwd_hm replaces the backward of
// vqvae_from_gaussian_vae_tpu/ops/flash_attention.py (_bwd: the upstream
// Pallas _flash_attention_bwd_dkv, then the lean dq pass _bwd_dq_lean) on
// (B, H, L, D) tensors, with q's length Lq apart from k's Lk.  Every tensor's
// batch, head and row strides are kernel arguments.  A partial last tile
// loads zero rows, and its rows and columns past Lq or Lk get p = 0 and
// ds = 0; the rows of dk, dv past Lk and of dq past Lq are not written.
//
// Tiling: D = 64 and 128 take 64-row tiles and 8 warps.  At D = 512 four
// D-wide bf16 tiles (K, V, Q, dO) of 64 rows and the float32 output staging
// tile would need ~450 KB, so D = 512 takes 32-row tiles (~209 KB of shared
// memory) and 16 warps: each warp then holds 4 + 4 accumulator fragments of
// dk and dv (64 registers) instead of 16, under the 128 registers a thread
// of a 512-thread block may use.  The score tiles (32 x 32) are 8 fragments,
// computed by 8 warps while the others wait (tiles_abt).  D = 256 takes
// 32-row tiles too (~113 KB, two blocks an SM) and 8 warps: 4 + 4 fragments a
// warp again, under the 128 registers that two 256-thread blocks leave each
// thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

template <int D, int T>
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
  static constexpr size_t kBytes = kRow + 2 * T * sizeof(float);
  // blocks an SM can hold by shared memory (at most 2 are asked for): at
  // D = 64 two fit, and __launch_bounds__ then keeps registers to 128 a
  // thread so that two do
  static constexpr int kMinBlocks = 2 * kBytes <= 232448 ? 2 : 1;
};

// Where a tensor lies: element (b, h, row, d) sits at
// b * Strides::b + h * Strides::h + row * Strides::row + d.
struct Strides {
  long long b, h, row;
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
// compiles the row and column checks out, here and below)
template <int D, int T, int THREADS, bool kTail>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long stride,
                                          int rows) {
  constexpr int LDT = BwdLayout<D, T>::kLdT;
  constexpr int CPR = D / 8;
  for (int e = threadIdx.x; e < T * CPR; e += THREADS) {
    const int r = e / CPR, c = (e % CPR) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDT + c) =
        !kTail || r < rows ? *reinterpret_cast<const uint4*>(src + r * stride + c)
                           : make_uint4(0u, 0u, 0u, 0u);
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
// and ds = 0, so it adds nothing to dq, dk or dv
template <int T, int THREADS, bool kTail>
__device__ __forceinline__ void probs_and_ds(const float* S, const float* dP, const float* z,
                                             const float* di, float scale, int rows, int cols,
                                             bf16* P, bf16* dS) {
  constexpr int LDS = T + 4, LDP = T + 8;
  for (int e = threadIdx.x; e < T * T; e += THREADS) {
    const int r = e / T, c = e % T;
    const bool in = !kTail || (r < rows && c < cols);
    const float p = in ? expf(S[r * LDS + c] * scale - z[r]) : 0.0f;
    const float ds = in ? p * (dP[r * LDS + c] - di[r]) * scale : 0.0f;
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

// dk and dv of one T-row K/V tile of one (b, h): stream the q tiles
template <int D, int T, int WARPS, bool kTail>
__global__ void __launch_bounds__(WARPS * 32, (BwdLayout<D, T>::kMinBlocks))
flash_bwd_dkdv_kernel(BwdArgs g) {
  constexpr int THREADS = WARPS * 32;
  using Lay = BwdLayout<D, T>;
  constexpr int LDT = Lay::kLdT;
  constexpr int RF = OutFrags<D, T, WARPS>::RF;
  constexpr int NF = OutFrags<D, T, WARPS>::NF;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + Lay::kA);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Lay::kB);
  bf16* Qs = reinterpret_cast<bf16*>(smem + Lay::kC);
  bf16* dOs = reinterpret_cast<bf16*>(smem + Lay::kD);
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

  const int fr = warp % RF, cb = (warp / RF) * NF;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[NF], dv[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::fill_fragment(dk[f], 0.0f);
    wmma::fill_fragment(dv[f], 0.0f);
  }

  for (int q0 = 0; q0 < Lq; q0 += T) {
    const int qrows = min(T, Lq - q0);
    load_tile<D, T, THREADS, kTail>(Qs, qb + q0 * g.sq.row, g.sq.row, qrows);
    load_tile<D, T, THREADS, kTail>(dOs, dob + q0 * g.sdo.row, g.sdo.row, qrows);
    if (threadIdx.x < T) {
      const bool in = !kTail || (int)threadIdx.x < qrows;
      zs[threadIdx.x] = in ? zb[q0 + threadIdx.x] : 0.0f;
      dis[threadIdx.x] = in ? dib[q0 + threadIdx.x] : 0.0f;
    }
    __syncthreads();
    tiles_abt<D, T, WARPS>(Qs, Ks, Ss, dOs, Vs, dPs);  // s and do v^T (q x kv), unscaled
    __syncthreads();
    probs_and_ds<T, THREADS, kTail>(Ss, dPs, zs, dis, g.scale, qrows, T, Ps, dSs);
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

// dq of one T-row q tile of one (b, h): stream the K/V tiles
template <int D, int T, int WARPS, bool kTail>
__global__ void __launch_bounds__(WARPS * 32, (BwdLayout<D, T>::kMinBlocks))
flash_bwd_dq_kernel(BwdArgs g) {
  constexpr int THREADS = WARPS * 32;
  using Lay = BwdLayout<D, T>;
  constexpr int LDT = Lay::kLdT;
  constexpr int RF = OutFrags<D, T, WARPS>::RF;
  constexpr int NF = OutFrags<D, T, WARPS>::NF;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + Lay::kA);
  bf16* dOs = reinterpret_cast<bf16*>(smem + Lay::kB);
  bf16* Ks = reinterpret_cast<bf16*>(smem + Lay::kC);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Lay::kD);
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
  if (threadIdx.x < T) {
    const bool in = !kTail || (int)threadIdx.x < qrows;
    zs[threadIdx.x] = in ? g.z[(size_t)blockIdx.y * Lq + q0 + threadIdx.x] : 0.0f;
    dis[threadIdx.x] = in ? g.di[(size_t)blockIdx.y * Lq + q0 + threadIdx.x] : 0.0f;
  }

  const int fr = warp % RF, cb = (warp / RF) * NF;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(dq[f], 0.0f);

  for (int k0 = 0; k0 < Lk; k0 += T) {
    const int krows = min(T, Lk - k0);
    load_tile<D, T, THREADS, kTail>(Ks, kb + k0 * g.skv.row, g.skv.row, krows);
    load_tile<D, T, THREADS, kTail>(Vs, vb + k0 * g.skv.row, g.skv.row, krows);
    __syncthreads();
    tiles_abt<D, T, WARPS>(Qs, Ks, Ss, dOs, Vs, dPs);
    __syncthreads();
    // a key column past Lk gets p = 0
    probs_and_ds<T, THREADS, kTail>(Ss, dPs, zs, dis, g.scale, qrows, krows, nullptr, dSs);
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

template <int D, int T, int WARPS, bool kTail>
int launch_bwd(const BwdArgs& g, const bf16* o, float* di, int B, cudaStream_t stream) {
  const size_t smem = BwdLayout<D, T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, T, WARPS, kTail>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, T, WARPS, kTail>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t rows = (size_t)B * g.Lq * g.H;
  flash_bwd_di_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(o, g.dout, di, g.sdo, B,
                                                                          g.Lq, g.H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<D, T, WARPS, kTail>
      <<<dim3((g.Lk + T - 1) / T, B * g.H), WARPS * 32, smem, stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D, T, WARPS, kTail>
      <<<dim3((g.Lq + T - 1) / T, B * g.H), WARPS * 32, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <int D, int T, int WARPS>
int launch_bwd(const BwdArgs& g, const bf16* o, float* di, int B, cudaStream_t stream) {
  return g.Lq % T != 0 || g.Lk % T != 0 ? launch_bwd<D, T, WARPS, true>(g, o, di, B, stream)
                                        : launch_bwd<D, T, WARPS, false>(g, o, di, B, stream);
}

int bwd_entry(const BwdArgs& g, const void* o, void* di, int B, int D, void* stream) {
  if (B <= 0 || g.H <= 0 || g.Lq <= 0 || g.Lk <= 0) return (int)cudaErrorInvalidValue;
  const bf16* op = static_cast<const bf16*>(o);
  float* dip = static_cast<float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_bwd<64, 64, 8>(g, op, dip, B, s);
    case 128: return launch_bwd<128, 64, 8>(g, op, dip, B, s);
    case 256: return launch_bwd<256, 32, 8>(g, op, dip, B, s);
    case 512: return launch_bwd<512, 32, 16>(g, op, dip, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv (B, L, 3C) bf16: q | k | v along channels, C = H * D; o and do (B, L,
// C) bf16; z (B, H, L) float32 from gvq_flash_fwd_qkv_res; di (B, H, L)
// float32 scratch; dqkv (B, L, 3C) bf16 gets dq | dk | dv.  All contiguous.
// L a multiple of 64, D 64, 128, 256 or 512.
extern "C" int gvq_flash_bwd_qkv(const void* qkv, const void* o, const void* z, const void* dout,
                                 void* di, void* dqkv, int B, int L, int H, int D, float scale,
                                 void* stream) {
  if (L % 64 != 0) return (int)cudaErrorInvalidValue;
  const bf16* in = static_cast<const bf16*>(qkv);
  bf16* out = static_cast<bf16*>(dqkv);
  const long long c = (long long)H * D, c3 = 3 * c;
  const Strides packed{L * c3, D, c3}, plain{L * c, D, c};
  const BwdArgs g{in, in + c, in + 2 * c, static_cast<const bf16*>(dout),
                  static_cast<const float*>(z), static_cast<const float*>(di),
                  out, out + c, out + 2 * c, packed, packed, plain, packed, packed, L, L, H,
                  scale};
  return bwd_entry(g, o, di, B, D, stream);
}

// The unpacked entry: q, k, v, o, do, dq, dk, dv (B, L, H*D) bf16; z (B, H,
// L) float32 from gvq_flash_fwd_res; di (B, H, L) float32 scratch.  All
// contiguous; the same shape rules.
extern "C" int gvq_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* z, const void* dout, void* di, void* dq, void* dk,
                             void* dv, int B, int L, int H, int D, float scale, void* stream) {
  if (L % 64 != 0) return (int)cudaErrorInvalidValue;
  const long long c = (long long)H * D;
  const Strides tm{L * c, D, c};
  const BwdArgs g{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                  static_cast<const float*>(z), static_cast<const float*>(di),
                  static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                  tm, tm, tm, tm, tm, L, L, H, scale};
  return bwd_entry(g, o, di, B, D, stream);
}

// The head-major entry (replaces vqvae_from_gaussian_vae_tpu/ops/flash_attention.py
// _bwd: the upstream Pallas _flash_attention_bwd_dkv and the lean dq pass
// _bwd_dq_lean): q, o, do, dq (B, H, Lq, D) and k, v, dk, dv (B, H, Lk, D)
// bf16; z (B, H, Lq) float32 from gvq_flash_fwd_hm; di (B, H, Lq) float32
// scratch.  All contiguous; any Lq, Lk >= 1; D 64, 128, 256 or 512.
extern "C" int gvq_flash_bwd_hm(const void* q, const void* k, const void* v, const void* o,
                                const void* z, const void* dout, void* di, void* dq, void* dk,
                                void* dv, int B, int H, int Lq, int Lk, int D, float scale,
                                void* stream) {
  const long long hq = (long long)Lq * D, hk = (long long)Lk * D;
  const Strides sq{H * hq, hq, D}, skv{H * hk, hk, D};
  const BwdArgs g{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                  static_cast<const float*>(z), static_cast<const float*>(di),
                  static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                  sq, skv, sq, sq, skv, Lq, Lk, H, scale};
  return bwd_entry(g, o, di, B, D, stream);
}
