// Flash-attention backward for the packed (B, L, 3C) QKV layout, bf16, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel of vqvae_from_gaussian_vae_tpu/ops/flash_blc.py
// reached from _bwd_call_packed (_bwd_impl -> pl.pallas_call, body
// _bwd_kernel).  Per head, with s = q k^T * scale and the forward's
// log-normaliser z (csrc/flash_fwd.cu, gvq_flash_fwd_qkv_res):
//
//   p  = exp(s - z)                      (no max or sum pass)
//   di = rowsum(do * o)                  (float32)
//   ds = p * (do v^T - di) * scale       (rounded to bf16)
//   dq = ds k,  dk = ds^T q,  dv = bf16(p)^T do   (float32 accumulation)
//
// q, k and v are read in place from the QKV projection output at channel
// offsets 0, C and 2C (token stride 3C); dq, dk and dv are written into ONE
// (B, L, 3C) tensor at the same offsets, so the projection's backward reads
// it as it is (the JAX package concatenates three (B, L, C) arrays).
//
// What bounds it on an H100: at the ViT shape (B=16, L=1024, H=12, D=64)
// the five products are 1.29e11 FLOP against ~200 MB of traffic, so it is
// tensor-core bound (0.13 ms at the bf16 dense peak).  The TPU kernel keeps
// a head group's whole K and V in VMEM and accumulates dk, dv across q
// blocks in scratch; a block here has at most 227 KB of shared memory and
// no order across blocks, so both sides are tiled into 64-row tiles and the
// work is split in two kernels with no float atomics (the gradients are
// bit-reproducible): one over (K/V tile, b, h) that streams the q tiles
// and accumulates dk and dv in tensor-core fragments, and one over
// (q tile, b, h) that streams K/V and accumulates dq.  Each recomputes s and
// do v^T, so the pair runs seven products instead of five.  di comes from a
// small pre-pass.  Products run on bf16 tensor cores through nvcuda::wmma
// with float32 accumulators; the elementwise steps read the float32 score
// tiles from shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kT = 64;          // rows of a q tile and of a K/V tile
constexpr int kThreads = 256;   // 8 warps
constexpr int kLdS = kT + 4;    // f32 pitch of the score tiles
constexpr int kLdP = kT + 8;    // bf16 pitch of the p / ds tiles

template <int D>
struct BwdLayout {
  static constexpr int kLdT = D + 8;  // bf16 pitch of the q, k, v, do tiles
  static constexpr int kLdA = D + 4;  // f32 pitch of the output staging tile
  static constexpr size_t kTile = (size_t)kT * kLdT * sizeof(bf16);
  static constexpr size_t kA = 0;                 // first input tile
  static constexpr size_t kB = kA + kTile;        // second
  static constexpr size_t kC = kB + kTile;        // third
  static constexpr size_t kD = kC + kTile;        // fourth
  static constexpr size_t kS = kD + kTile;        // s, f32
  static constexpr size_t kDP = kS + (size_t)kT * kLdS * sizeof(float);   // do v^T, f32
  static constexpr size_t kP = kDP + (size_t)kT * kLdS * sizeof(float);   // bf16(p)
  static constexpr size_t kDS = kP + (size_t)kT * kLdP * sizeof(bf16);    // bf16(ds)
  static constexpr size_t kAcc = kDS + (size_t)kT * kLdP * sizeof(bf16);  // output staging
  static constexpr size_t kRow = kAcc + (size_t)kT * kLdA * sizeof(float);  // z, di
  static constexpr size_t kBytes = kRow + 2 * kT * sizeof(float);
};

template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t stride) {
  constexpr int LDT = BwdLayout<D>::kLdT;
  constexpr int CPR = D / 8;
  for (int e = threadIdx.x; e < kT * CPR; e += kThreads) {
    const int r = e / CPR, c = (e % CPR) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDT + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * stride + c);
  }
}

// out (64 x 64, f32, pitch kLdS) = A B^T with A, B (64 x D) bf16 tiles;
// warp w computes the fragments (w >> 1, 2 (w & 1)) and (w >> 1, 2 (w & 1) + 1)
template <int D>
__device__ __forceinline__ void tile_abt(const bf16* a, const bf16* b, float* out) {
  constexpr int LDT = BwdLayout<D>::kLdT;
  const int warp = threadIdx.x >> 5;
  const int fr = warp >> 1;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int fc = (warp & 1) * 2 + t;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + fr * 16 * LDT + kk, LDT);
      wmma::load_matrix_sync(fb, b + fc * 16 * LDT + kk, LDT);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + fr * 16 * kLdS + fc * 16, acc, kLdS, wmma::mem_row_major);
  }
}

// p = exp(s * scale - z), ds = p (dp - di) scale, both rounded to bf16
__device__ __forceinline__ void probs_and_ds(const float* S, const float* dP, const float* z,
                                             const float* di, float scale, bf16* P, bf16* dS) {
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int r = e / kT, c = e % kT;
    const float p = expf(S[r * kLdS + c] * scale - z[r]);
    const float ds = p * (dP[r * kLdS + c] - di[r]) * scale;
    if (P != nullptr) P[r * kLdP + c] = __float2bfloat16(p);
    dS[r * kLdP + c] = __float2bfloat16(ds);
  }
}

// write NF accumulator fragments (rows fr, columns cb..cb+NF-1 of a 64 x D
// tile) through the f32 staging tile to dst (64 x D bf16, token stride)
template <int D, int NF>
__device__ __forceinline__ void write_out(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[NF], float* stage, int fr, int cb,
    bf16* dst, size_t stride) {
  constexpr int LDA = BwdLayout<D>::kLdA;
  constexpr int CPR = D / 8;
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(stage + fr * 16 * LDA + (cb + f) * 16, acc[f], LDA,
                            wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < kT * CPR; e += kThreads) {
    const int r = e / CPR, c = (e % CPR) * 8;
    uint4 packed;
    uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      __nv_bfloat162 v2 = __floats2bfloat162_rn(stage[r * LDA + c + i], stage[r * LDA + c + i + 1]);
      pk[i >> 1] = *reinterpret_cast<uint32_t*>(&v2);
    }
    *reinterpret_cast<uint4*>(dst + (size_t)r * stride + c) = packed;
  }
  __syncthreads();
}

// di[b, h, l] = sum_d do[b, l, h D + d] * o[b, l, h D + d], one thread a row
__global__ void flash_bwd_di_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                    float* __restrict__ di, int B, int L, int H, int D) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * L * H) return;
  const int h = (int)(idx % H);
  const size_t bl = idx / H;  // b * L + l
  const int b = (int)(bl / L), l = (int)(bl % L);
  const size_t off = bl * (size_t)H * D + (size_t)h * D;
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

// dk and dv of one 64-row K/V tile of one (b, h): stream the q tiles
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                      const float* __restrict__ z, const float* __restrict__ di,
                      bf16* __restrict__ dqkv, int L, int H, float scale) {
  using Lay = BwdLayout<D>;
  constexpr int LDT = Lay::kLdT;
  constexpr int NF = D / 32;  // accumulator fragments a warp owns, per output
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
  float* dis = zs + kT;

  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * kT;
  const size_t C = (size_t)H * D;
  const size_t s3 = 3 * C;  // token stride of qkv and dqkv
  const bf16* qb = qkv + (size_t)b * L * s3 + (size_t)h * D;
  const bf16* dob = dout + (size_t)b * L * C + (size_t)h * D;
  const float* zb = z + (size_t)blockIdx.y * L;
  const float* dib = di + (size_t)blockIdx.y * L;

  load_tile<D>(Ks, qb + C + (size_t)k0 * s3, s3);
  load_tile<D>(Vs, qb + 2 * C + (size_t)k0 * s3, s3);

  // warp w owns output rows (w >> 1) and columns (w & 1) * NF .. + NF - 1
  const int fr = warp >> 1, cb = (warp & 1) * NF;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[NF], dv[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::fill_fragment(dk[f], 0.0f);
    wmma::fill_fragment(dv[f], 0.0f);
  }

  for (int q0 = 0; q0 < L; q0 += kT) {
    load_tile<D>(Qs, qb + (size_t)q0 * s3, s3);
    load_tile<D>(dOs, dob + (size_t)q0 * C, C);
    if (threadIdx.x < kT) {
      zs[threadIdx.x] = zb[q0 + threadIdx.x];
      dis[threadIdx.x] = dib[q0 + threadIdx.x];
    }
    __syncthreads();
    tile_abt<D>(Qs, Ks, Ss);    // s (q x kv), unscaled
    tile_abt<D>(dOs, Vs, dPs);  // do v^T (q x kv)
    __syncthreads();
    probs_and_ds(Ss, dPs, zs, dis, scale, Ps, dSs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kT; kk += 16) {  // over the q rows of the tile
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pt, dst;
      wmma::load_matrix_sync(pt, Ps + kk * kLdP + fr * 16, kLdP);    // p^T (kv x q)
      wmma::load_matrix_sync(dst, dSs + kk * kLdP + fr * 16, kLdP);  // ds^T
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

  bf16* out = dqkv + (size_t)b * L * s3 + (size_t)h * D + (size_t)k0 * s3;
  write_out<D, NF>(dk, stage, fr, cb, out + C, s3);
  write_out<D, NF>(dv, stage, fr, cb, out + 2 * C, s3);
}

// dq of one 64-row q tile of one (b, h): stream the K/V tiles
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                    const float* __restrict__ z, const float* __restrict__ di,
                    bf16* __restrict__ dqkv, int L, int H, float scale) {
  using Lay = BwdLayout<D>;
  constexpr int LDT = Lay::kLdT;
  constexpr int NF = D / 32;
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
  float* dis = zs + kT;

  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kT;
  const size_t C = (size_t)H * D;
  const size_t s3 = 3 * C;
  const bf16* qb = qkv + (size_t)b * L * s3 + (size_t)h * D;

  load_tile<D>(Qs, qb + (size_t)q0 * s3, s3);
  load_tile<D>(dOs, dout + (size_t)b * L * C + (size_t)h * D + (size_t)q0 * C, C);
  if (threadIdx.x < kT) {
    zs[threadIdx.x] = z[(size_t)blockIdx.y * L + q0 + threadIdx.x];
    dis[threadIdx.x] = di[(size_t)blockIdx.y * L + q0 + threadIdx.x];
  }

  const int fr = warp >> 1, cb = (warp & 1) * NF;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(dq[f], 0.0f);

  for (int k0 = 0; k0 < L; k0 += kT) {
    load_tile<D>(Ks, qb + C + (size_t)k0 * s3, s3);
    load_tile<D>(Vs, qb + 2 * C + (size_t)k0 * s3, s3);
    __syncthreads();
    tile_abt<D>(Qs, Ks, Ss);
    tile_abt<D>(dOs, Vs, dPs);
    __syncthreads();
    probs_and_ds(Ss, dPs, zs, dis, scale, nullptr, dSs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kT; kk += 16) {  // over the kv rows of the tile
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fds;
      wmma::load_matrix_sync(fds, dSs + fr * 16 * kLdP + kk, kLdP);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fk;
        wmma::load_matrix_sync(fk, Ks + kk * LDT + (cb + f) * 16, LDT);
        wmma::mma_sync(dq[f], fds, fk, dq[f]);
      }
    }
    __syncthreads();
  }
  write_out<D, NF>(dq, stage, fr, cb, dqkv + (size_t)b * L * s3 + (size_t)h * D + (size_t)q0 * s3,
                   s3);
}

template <int D>
int launch_bwd(const bf16* qkv, const bf16* o, const float* z, const bf16* dout, float* di,
               bf16* dqkv, int B, int L, int H, float scale, cudaStream_t stream) {
  const size_t smem = BwdLayout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t rows = (size_t)B * L * H;
  flash_bwd_di_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(o, dout, di, B, L, H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(L / kT, B * H);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, smem, stream>>>(qkv, dout, z, di, dqkv, L, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(qkv, dout, z, di, dqkv, L, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv (B, L, 3C) bf16: q | k | v along channels, C = H * D; o and do (B, L,
// C) bf16; z (B, H, L) float32 from gvq_flash_fwd_qkv_res; di (B, H, L)
// float32 scratch; dqkv (B, L, 3C) bf16 gets dq | dk | dv.  All contiguous.
// L a multiple of 64, D 64 or 128.
extern "C" int gvq_flash_bwd_qkv(const void* qkv, const void* o, const void* z, const void* dout,
                                 void* di, void* dqkv, int B, int L, int H, int D, float scale,
                                 void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || L % kT != 0) return (int)cudaErrorInvalidValue;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* op = static_cast<const bf16*>(o);
  const float* zp = static_cast<const float*>(z);
  const bf16* dp = static_cast<const bf16*>(dout);
  float* dip = static_cast<float*>(di);
  bf16* out = static_cast<bf16*>(dqkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_bwd<64>(q, op, zp, dp, dip, out, B, L, H, scale, s);
    case 128: return launch_bwd<128>(q, op, zp, dp, dip, out, B, L, H, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
