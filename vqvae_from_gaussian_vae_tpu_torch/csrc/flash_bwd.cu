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
// and accumulates dk and dv, and one over (q tile, b, h) that streams K/V
// and accumulates dq.  Each recomputes s and do v^T.  di comes from a
// small pre-pass.
//
// The head-major entry gvq_flash_bwd_hm replaces the backward of
// vqvae_from_gaussian_vae_tpu/ops/flash_attention.py (_bwd: the upstream
// Pallas _flash_attention_bwd_dkv, then the lean dq pass _bwd_dq_lean) on
// (B, H, L, D) tensors, with q's length Lq apart from k's Lk.  A partial
// last tile loads zero rows, and its rows and columns past Lq or Lk get
// p = 0 and ds = 0; the rows of dk, dv past Lk and of dq past Lq are not
// written.
//
// Which body runs, by head dim: every bf16 entry takes the launch plan of
// ops/flash_attention.py flash_bwd_plan (an int64 array, BwdPlan), which
// names the body and holds the tensor maps of q, k, v and do; the entry
// holds it to its shapes before it encodes them.  D = 64 and 128 take the
// wgmma body of csrc/flash_bwd_sm90.cuh (128 keys or q rows a block, two
// warpgroups of 64 rows, the whole head dim in each); D = 256 and 512 the
// wide wgmma body of csrc/flash_bwd_sm90_wide.cuh (64 keys or q rows a
// block, the head dim's columns split over two warpgroups and, for dK/dV
// at D = 512, over two blocks).  Both are TMA rings, scores, P and dS in
// registers; each header says what it does about its costs.  The backward
// lab (csrc/flash_lab_bwd.cu) instantiates flash_bwd_sm90.cuh at its knobs.
//
// gvq_flash_bwd_hm_f32 is the head-major backward for float32 tensors (the
// JAX op runs float32 too), held to the plain version within 1e-4 of its
// largest value.  At D = 64 and 128 it runs the split-TF32 wgmma bodies of
// csrc/flash_bwd_f32_sm90.cuh (a pre-pass that writes the operands' TF32
// pairs and di, then dK/dV and dQ kernels, each product three TF32 passes
// on the tensor cores, float32-accurate whatever
// torch.backends.cuda.matmul.allow_tf32 says); at D = 256 and 512 the same
// pre-pass and two-kernel split in plain SIMT float32 (fmaf on CUDA cores,
// operands from shared memory).  Both take the launch plan of
// ops/flash_attention.py flash_f32_plan (F32Plan), which names the body.
#include "flash_bwd_f32_sm90.cuh"
#include "flash_bwd_sm90.cuh"
#include "flash_bwd_sm90_wide.cuh"
#include "flash_f32.cuh"

namespace {

// The shipped launches of flash_bwd_sm90.cuh's kernels (here, so that the
// lab's sources, which include the body, compile none of them)
template <int D, bool kQMask, bool kKeyMask>
int launch_b9(const CUtensorMap (&m)[4], const B9Args& a, dim3 kv_grid, dim3 q_grid,
              cudaStream_t stream) {
  const int err = b9_launch(flash_bwd_dkdv_sm90_kernel<D, kQMask>, kv_grid,
                            B9KvLayout<D>::kSmem, 1, m, a, stream);
  if (err != 0) return err;
  return b9_launch(flash_bwd_dq_sm90_kernel<D, kKeyMask>, q_grid, B9QLayout<D>::kSmem, 1, m, a,
                   stream);
}

template <int D>
int launch_b9_masks(const CUtensorMap (&m)[4], const B9Args& a, const BwdPlan& p,
                    cudaStream_t stream) {
  const dim3 kv_grid((unsigned)p.kv_grid_x, (unsigned)p.kv_grid_y);
  const dim3 q_grid((unsigned)p.q_grid_x, (unsigned)p.q_grid_y);
  if (p.q_mask)
    return p.key_mask ? launch_b9<D, true, true>(m, a, kv_grid, q_grid, stream)
                      : launch_b9<D, true, false>(m, a, kv_grid, q_grid, stream);
  return p.key_mask ? launch_b9<D, false, true>(m, a, kv_grid, q_grid, stream)
                    : launch_b9<D, false, false>(m, a, kv_grid, q_grid, stream);
}

// Hold the plan to this body and the entry's shapes (bwd_plan_maps), then
// launch the di pre-pass (o and do as sdo says; di into a.di), the dK/dV
// kernel and the dQ kernel.
inline int launch_flash_bwd_sm90(const BwdPlan& p, const bf16* const (&bases)[4], const B9Args& a,
                                 const bf16* o, Strides sdo, int B, int D, cudaStream_t stream) {
  const int nq = b9_q_tile(D), nk = b9_k_tile(D);
  const long long kv_smem = D == 64 ? B9KvLayout<64>::kSmem : B9KvLayout<128>::kSmem;
  const long long q_smem = D == 64 ? B9QLayout<64>::kSmem : B9QLayout<128>::kSmem;
  CUtensorMap maps[4];
  if ((D != 64 && D != 128) || !bwd_plan_maps(p, bases, a, B, D, 1, kB9Rows, nq, nk, kB9Stages,
                                               kv_smem, q_smem, 1, maps))
    return (int)cudaErrorInvalidValue;
  const int err = D == 64 ? launch_b9_di<64>(o, bases[3], a.di, sdo, B, a.Lq, a.H, stream)
                          : launch_b9_di<128>(o, bases[3], a.di, sdo, B, a.Lq, a.H, stream);
  if (err != 0) return err;
  return D == 64 ? launch_b9_masks<64>(maps, a, p, stream)
                 : launch_b9_masks<128>(maps, a, p, stream);
}


// Route a backward by its plan over the maps of bases[] (q, k, v, do),
// whose coordinates put the row at a.row_dim (1 head-major, 2
// token-major): D = 64 and 128 to the wgmma body, D = 256 and 512 to the
// wide one; o and do (as sdo says) feed the di pre-pass.
int bwd_entry(const B9Args& a, const bf16* const (&bases)[4], const void* o, Strides sdo, int B,
              int D, const long long* plan, void* stream) {
  if (B <= 0 || a.H <= 0 || a.Lq <= 0 || a.Lk <= 0 || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  BwdPlan p;
  memcpy(&p, plan, sizeof p);
  const bf16* op = static_cast<const bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 || D == 128) return launch_flash_bwd_sm90(p, bases, a, op, sdo, B, D, s);
  if (D == 256 || D == 512) return launch_flash_bwd_wide(p, bases, a, op, sdo, B, D, s);
  return (int)cudaErrorInvalidValue;
}

// The float32 head-major backward's SIMT body (D = 256 and 512): a di
// pre-pass, then dk/dv over K/V tiles
// streaming the q tiles, then dq over q tiles streaming K/V, as the bf16
// pair does, in plain SIMT float32.  T = 32 tile rows (16 at D = 512, so
// that a thread's dk and dv shares stay at 32 + 32 registers).  Shared
// memory (floats, pitch D + 1): four T-row tiles 4 * T * (D + 1), the p and
// ds tiles 2 * T * (T + 1), z and di 2 * T: at D = 512 (T = 16) 133,632
// bytes, at D = 256 (T = 32) 140,288.
struct F32BwdArgs {
  const float* q;   // (B, H, Lq, D), and o, do, dq
  const float* k;   // (B, H, Lk, D), and v, dk, dv
  const float* v;
  const float* dout;
  const float* z;   // (B, H, Lq)
  const float* di;  // (B, H, Lq)
  float* dq;
  float* dk;
  float* dv;
  int Lq, Lk;
  float scale;
};

template <int D>
struct F32BwdTile {
  static constexpr int T = D == 512 ? 16 : 32;
  static constexpr size_t kBytes =
      (4 * T * (D + 1) + 2 * T * (T + 1) + 2 * T) * sizeof(float);
};

// di[row] = sum_d o[row, d] * do[row, d], one thread a row
__global__ void flash_bwd_di_f32_kernel(const float* __restrict__ o,
                                        const float* __restrict__ dout, float* __restrict__ di,
                                        size_t rows, int D) {
  const size_t r = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float acc = 0.0f;
  for (int d = 0; d < D; ++d) acc = fmaf(o[r * D + d], dout[r * D + d], acc);
  di[r] = acc;
}

// p = exp(s scale - z) and ds = p (dp - di) scale of the thread's products
// (rows ty * N + i, columns tx + 16 j), 0 past `rows` or `cols`, into P and dS
template <int T>
__device__ __forceinline__ void f32_probs(const float (&s)[T / 16][T / 16],
                                          const float (&dp)[T / 16][T / 16], const float* zs,
                                          const float* dis, float scale, int rows, int cols,
                                          float* P, float* dS) {
  constexpr int N = T / 16, LDS = T + 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int r = ty * N + i, c = tx + 16 * j;
      const bool in = r < rows && c < cols;
      const float p = in ? expf(s[i][j] * scale - zs[r]) : 0.0f;
      if (P != nullptr) P[r * LDS + c] = p;
      dS[r * LDS + c] = in ? p * (dp[i][j] - dis[r]) * scale : 0.0f;
    }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dkdv_f32_kernel(F32BwdArgs g) {
  constexpr int T = F32BwdTile<D>::T, LD = D + 1, LDS = T + 1, N = T / 16;
  using Own = F32Own<D, T>;
  extern __shared__ __align__(16) float fsm[];
  float* Ks = fsm;
  float* Vs = Ks + T * LD;
  float* Qs = Vs + T * LD;
  float* dOs = Qs + T * LD;
  float* Ps = dOs + T * LD;
  float* dSs = Ps + T * LDS;
  float* zs = dSs + T * LDS;
  float* dis = zs + T;

  const int Lq = g.Lq, Lk = g.Lk;
  const size_t bh = blockIdx.y;
  const int k0 = blockIdx.x * T;
  const int krows = min(T, Lk - k0);
  const int cg = threadIdx.x % Own::CG, rg = threadIdx.x / Own::CG;
  load_f32_rows<D, T>(Ks, g.k + (bh * Lk + k0) * D, D, krows);
  load_f32_rows<D, T>(Vs, g.v + (bh * Lk + k0) * D, D, krows);
  float dk[Own::RO][Own::CO], dv[Own::RO][Own::CO];
#pragma unroll
  for (int i = 0; i < Own::RO; ++i)
#pragma unroll
    for (int j = 0; j < Own::CO; ++j) dk[i][j] = dv[i][j] = 0.0f;

  for (int q0 = 0; q0 < Lq; q0 += T) {
    const int qrows = min(T, Lq - q0);
    __syncthreads();  // the last tile's products are done with Qs, dOs, Ps, dSs
    load_f32_rows<D, T>(Qs, g.q + (bh * Lq + q0) * D, D, qrows);
    load_f32_rows<D, T>(dOs, g.dout + (bh * Lq + q0) * D, D, qrows);
    if (threadIdx.x < T) {
      const bool in = (int)threadIdx.x < qrows;
      zs[threadIdx.x] = in ? g.z[bh * Lq + q0 + threadIdx.x] : 0.0f;
      dis[threadIdx.x] = in ? g.di[bh * Lq + q0 + threadIdx.x] : 0.0f;
    }
    __syncthreads();
    float s[N][N], dp[N][N];
    f32_abt<D, T>(Qs, Ks, s);   // q x kv
    f32_abt<D, T>(dOs, Vs, dp);
    f32_probs<T>(s, dp, zs, dis, g.scale, qrows, krows, Ps, dSs);
    __syncthreads();
    // dv[j, c] += sum_r p[r, j] do[r, c]; dk[j, c] += sum_r ds[r, j] q[r, c]
#pragma unroll 2
    for (int r = 0; r < T; ++r) {
      float fdo[Own::CO], fq[Own::CO];
#pragma unroll
      for (int j = 0; j < Own::CO; ++j) {
        fdo[j] = dOs[r * LD + cg + j * Own::CG];
        fq[j] = Qs[r * LD + cg + j * Own::CG];
      }
#pragma unroll
      for (int i = 0; i < Own::RO; ++i) {
        const float p = Ps[r * LDS + rg * Own::RO + i];
        const float ds = dSs[r * LDS + rg * Own::RO + i];
#pragma unroll
        for (int j = 0; j < Own::CO; ++j) {
          dv[i][j] = fmaf(p, fdo[j], dv[i][j]);
          dk[i][j] = fmaf(ds, fq[j], dk[i][j]);
        }
      }
    }
  }
  store_f32_own<D, T>(g.dk + (bh * Lk + k0) * D, dk, krows);
  store_f32_own<D, T>(g.dv + (bh * Lk + k0) * D, dv, krows);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dq_f32_kernel(F32BwdArgs g) {
  constexpr int T = F32BwdTile<D>::T, LD = D + 1, LDS = T + 1, N = T / 16;
  using Own = F32Own<D, T>;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* dOs = Qs + T * LD;
  float* Ks = dOs + T * LD;
  float* Vs = Ks + T * LD;
  float* dSs = Vs + T * LD + T * LDS;  // the p tile's place stays unused
  float* zs = dSs + T * LDS;
  float* dis = zs + T;

  const int Lq = g.Lq, Lk = g.Lk;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * T;
  const int qrows = min(T, Lq - q0);
  const int cg = threadIdx.x % Own::CG, rg = threadIdx.x / Own::CG;
  load_f32_rows<D, T>(Qs, g.q + (bh * Lq + q0) * D, D, qrows);
  load_f32_rows<D, T>(dOs, g.dout + (bh * Lq + q0) * D, D, qrows);
  if (threadIdx.x < T) {
    const bool in = (int)threadIdx.x < qrows;
    zs[threadIdx.x] = in ? g.z[bh * Lq + q0 + threadIdx.x] : 0.0f;
    dis[threadIdx.x] = in ? g.di[bh * Lq + q0 + threadIdx.x] : 0.0f;
  }
  float dq[Own::RO][Own::CO];
#pragma unroll
  for (int i = 0; i < Own::RO; ++i)
#pragma unroll
    for (int j = 0; j < Own::CO; ++j) dq[i][j] = 0.0f;

  for (int k0 = 0; k0 < Lk; k0 += T) {
    const int krows = min(T, Lk - k0);
    __syncthreads();  // the last tile's products are done with Ks and dSs
    load_f32_rows<D, T>(Ks, g.k + (bh * Lk + k0) * D, D, krows);
    load_f32_rows<D, T>(Vs, g.v + (bh * Lk + k0) * D, D, krows);
    __syncthreads();
    float s[N][N], dp[N][N];
    f32_abt<D, T>(Qs, Ks, s);
    f32_abt<D, T>(dOs, Vs, dp);
    f32_probs<T>(s, dp, zs, dis, g.scale, qrows, krows, nullptr, dSs);
    __syncthreads();
    // dq[r, c] += sum_j ds[r, j] k[j, c]
#pragma unroll 2
    for (int j2 = 0; j2 < T; ++j2) {
      float fk[Own::CO];
#pragma unroll
      for (int j = 0; j < Own::CO; ++j) fk[j] = Ks[j2 * LD + cg + j * Own::CG];
#pragma unroll
      for (int i = 0; i < Own::RO; ++i) {
        const float ds = dSs[(rg * Own::RO + i) * LDS + j2];
#pragma unroll
        for (int j = 0; j < Own::CO; ++j) dq[i][j] = fmaf(ds, fk[j], dq[i][j]);
      }
    }
  }
  store_f32_own<D, T>(g.dq + (bh * Lq + q0) * D, dq, qrows);
}

template <int D>
int launch_bwd_f32(const F32BwdArgs& g, const float* o, float* di, int B, int H,
                   cudaStream_t stream) {
  constexpr int T = F32BwdTile<D>::T;
  const size_t smem = F32BwdTile<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t rows = (size_t)B * H * g.Lq;
  flash_bwd_di_f32_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(o, g.dout, di,
                                                                              rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_f32_kernel<D><<<dim3((g.Lk + T - 1) / T, B * H), kF32Threads, smem, stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_f32_kernel<D><<<dim3((g.Lq + T - 1) / T, B * H), kF32Threads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv (B, L, 3C) bf16: q | k | v along channels, C = H * D; o and do (B, L,
// C) bf16; z (B, H, L) float32 from gvq_flash_fwd_qkv_res; di (B, H, L)
// float32 scratch; dqkv (B, L, 3C) bf16 gets dq | dk | dv.  All contiguous,
// 16-byte aligned.  L a multiple of 64, D 64, 128, 256 or 512.  plan: the
// launch plan (BwdPlan, kBwdPlanLen int64).
extern "C" int gvq_flash_bwd_qkv(const void* qkv, const void* o, const void* z, const void* dout,
                                 void* di, void* dqkv, int B, int L, int H, int D, float scale,
                                 const long long* plan, void* stream) {
  if (L % 64 != 0) return (int)cudaErrorInvalidValue;
  const bf16* in = static_cast<const bf16*>(qkv);
  bf16* out = static_cast<bf16*>(dqkv);
  const long long c = (long long)H * D, c3 = 3 * c;
  const B9Args a{out, out + c, out + 2 * c, static_cast<const float*>(z),
                 static_cast<float*>(di), L * c3, D, c3, L * c3, D, c3, L, L, H, 2, scale};
  const bf16* const bases[4] = {in, in, in, static_cast<const bf16*>(dout)};
  return bwd_entry(a, bases, o, Strides{L * c, D, c}, B, D, plan, stream);
}

// The unpacked entry: q, k, v, o, do, dq, dk, dv (B, L, H*D) bf16; z (B, H,
// L) float32 from gvq_flash_fwd_res; di (B, H, L) float32 scratch.  All
// contiguous; the same shape rules and plan.
extern "C" int gvq_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* z, const void* dout, void* di, void* dq, void* dk,
                             void* dv, int B, int L, int H, int D, float scale,
                             const long long* plan, void* stream) {
  if (L % 64 != 0) return (int)cudaErrorInvalidValue;
  const long long c = (long long)H * D;
  const B9Args a{static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                 static_cast<const float*>(z), static_cast<float*>(di), L * c, D, c, L * c, D, c,
                 L, L, H, 2, scale};
  const bf16* const bases[4] = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v), static_cast<const bf16*>(dout)};
  return bwd_entry(a, bases, o, Strides{L * c, D, c}, B, D, plan, stream);
}

// The head-major entry (replaces vqvae_from_gaussian_vae_tpu/ops/flash_attention.py
// _bwd: the upstream Pallas _flash_attention_bwd_dkv and the lean dq pass
// _bwd_dq_lean): q, o, do, dq (B, H, Lq, D) and k, v, dk, dv (B, H, Lk, D)
// bf16; z (B, H, Lq) float32 from gvq_flash_fwd_hm; di (B, H, Lq) float32
// scratch.  All contiguous, 16-byte aligned; any Lq, Lk >= 1; D 64, 128, 256
// or 512; the plan as above.
extern "C" int gvq_flash_bwd_hm(const void* q, const void* k, const void* v, const void* o,
                                const void* z, const void* dout, void* di, void* dq, void* dk,
                                void* dv, int B, int H, int Lq, int Lk, int D, float scale,
                                const long long* plan, void* stream) {
  const long long hq = (long long)Lq * D, hk = (long long)Lk * D;
  const B9Args a{static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                 static_cast<const float*>(z), static_cast<float*>(di), H * hq, hq, D,
                 H * hk, hk, D, Lq, Lk, H, 1, scale};
  const bf16* const bases[4] = {static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v), static_cast<const bf16*>(dout)};
  return bwd_entry(a, bases, o, Strides{H * hq, hq, D}, B, D, plan, stream);
}

// The float32 head-major entry (the same op as gvq_flash_bwd_hm, for
// float32 tensors): q, o, do, dq (B, H, Lq, D) and k, v, dk, dv (B, H, Lk, D)
// float32; z (B, H, Lq) float32 from gvq_flash_fwd_hm_f32; di (B, H, Lq)
// float32 scratch.  All contiguous, 16-byte aligned; any Lq, Lk >= 1; D 64,
// 128, 256 or 512.  plan: the launch plan (F32Plan, kF32PlanLen int64),
// whose body must be the one of this D: split TF32 (D = 64, 128; scratch
// then holds the plan's bwd_scratch floats for the pre-pass) or SIMT
// (D = 256, 512; scratch unused).
extern "C" int gvq_flash_bwd_hm_f32(const void* q, const void* k, const void* v, const void* o,
                                    const void* z, const void* dout, void* di, void* dq,
                                    void* dk, void* dv, void* scratch, int B, int H, int Lq,
                                    int Lk, int D, float scale, const long long* plan,
                                    void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  F32Plan p;
  memcpy(&p, plan, sizeof p);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* dof = static_cast<const float*>(dout);
  float* dip = static_cast<float*>(di);
  float* sf = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 || D == 128) {
    const TfBwdArgs a{static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                      static_cast<const float*>(z), dip, Lq, Lk, scale};
    // tiles (dK/dV: warpgroups, q rows a tile, stages; dQ: warpgroups, keys
    // a tile, stages) as flash_f32_plan's
    return D == 64
               ? launch_flash_bwd_f32_sm90<64, 2, 16, 3, 1, 32, 3>(p, qf, kf, vf, of, dof, sf, a,
                                                                   B, H, s)
               : launch_flash_bwd_f32_sm90<128, 1, 8, 3, 1, 16, 2>(p, qf, kf, vf, of, dof, sf, a,
                                                                   B, H, s);
  }
  if (p.body != 0) return (int)cudaErrorInvalidValue;
  const F32BwdArgs g{qf, kf, vf, dof, static_cast<const float*>(z), dip,
                     static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                     Lq, Lk, scale};
  switch (D) {
    case 256: return launch_bwd_f32<256>(g, of, dip, B, H, s);
    case 512: return launch_bwd_f32<512>(g, of, dip, B, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
