// The float32 fused GroupNorm + swish + 3x3 "same" conv (+ residual) for
// Hopper (sm_90a): split TF32 on the tensor cores over the structure of
// conv_igemm_sm90.cuh's kIgSameGn (the bf16 entry's body), for
// gvq_fused_gn_conv_f32 (fused_gn_conv.cu).
//
// Replaces, in float32, the TPU kernel
// vqvae_from_gaussian_vae_tpu/ops/fused_gn_conv.py (_fused_gn_swish_conv ->
// pl.pallas_call, body _kernel): y = conv3x3(pad0(swish(x * scale + shift)),
// w) + bias (+ res), every step in float32.
//
// What bounds it on an H100: 2 * 9 * C * O FLOP a pixel, 9.66e9 FLOP at
// the float32 engine's (2, 32^2, 512 -> 512) against 13 MB; in split TF32
// (three TF32 passes at 495 TFLOP/s) 0.059 ms, on the CUDA cores (67
// TFLOP/s) 0.144 ms.
//
// The design:
// - Split TF32 (csrc/flash_f32_sm90.cuh): each operand a becomes hi =
//   cvt.rna.tf32(a) and lo = cvt.rna.tf32(a - hi); a product is three
//   wgmma .tf32 passes, lo.hi, hi.lo, hi.hi.  The kernel reads no TF32 flag.
// - The weights: .tf32 wgmma reads B only K-major, and HWIO is O-major, so
//   a pre-pass a call (gn_f32_weight_prep_kernel) writes the weights' hi
//   and lo planes as (tap, plane, O, C) into a scratch the wrapper
//   allocates; a stage of the TMA ring holds one tap's two planes of a
//   64-channel N tile and 32 input channels (a 128-byte swizzled row of
//   float32 per output channel).
// - A block owns an 8 x 16 pixel tile of one sample (kIgGnTileH x W) and
//   64 output channels: at (2, 32^2, 512 -> 512) 128 blocks on 132 SMs.
//   For each 32-channel K step the producer warp loads the tile's halo box,
//   (8 + 2) x (16 + 2) pixels, by TMA (zero fill) into one of three halo
//   buffers; the consumers rewrite it in place as hi of h = swish(x scale +
//   shift) and write lo beside it, 0 off the image and past C (the pad
//   applies after the transform), a sixth after each of the previous K
//   step's first six taps while that step's products run.  The nine taps
//   read shifted windows of both planes with ldmatrix: an 8 x 8 .b16 matrix
//   of 32-bit data hands lane l the float at (row l / 4, column l % 4), so
//   four matrices are the m64k8 TF32 A fragment, and a lane's row address
//   is its pixel shifted by the tap.
// - Two consumer warpgroups own 64 pixels each and issue wgmma m64n64k8
//   .tf32 with A from registers.  A tensor core's float32 sum truncates,
//   so each K step's 864 products (9 taps x 4 k8 steps x 3 passes) start
//   from a zeroed accumulator and are added into the running sum on the
//   CUDA cores.
// - The epilogue from the registers: + bias, + residual, float32 stores.
//   No split-K and no atomics: y repeats bit for bit.
#pragma once

#include "conv_igemm_sm90.cuh"  // the GN tile and halo geometry, ldsm_x4, swish
#include "tf32_sm90.cuh"        // the .tf32 wgmma forms, tf32_rna, TfTile

namespace gvq {
namespace {

constexpr int kGf32BK = 32;      // input channels a K step: a 128-byte row of float32
constexpr int kGf32BN = 64;      // output channels a block
constexpr int kGf32Stages = 4;   // weight stages, one tap's hi and lo planes each
using Gf32B = TfTile<kGf32BN, kGf32BK>;                  // one plane of a stage: 8 KB
constexpr int kGf32Stage = 2 * (int)Gf32B::kBytes;       // 16 KB
// a halo buffer: two planes of the bf16 body's halo buffer size (a 128-byte
// row a pixel in both), the box as the copy brings it (rewritten as hi),
// then lo
constexpr int kGf32HaloPlane = kIgHaloBytes;  // 23,552 bytes
constexpr int kGf32HaloBuf = 2 * kGf32HaloPlane;
constexpr int kGf32HaloStages = 3;
constexpr int kGf32Threads = 32 * (kIgConsumerWarps + 1);  // two consumer warpgroups, a producer
constexpr size_t kGf32Smem = (size_t)kGf32HaloStages * kGf32HaloBuf +
                             (size_t)kGf32Stages * kGf32Stage +
                             2 * (kGf32Stages + kGf32HaloStages) * 8 + 1024;
static_assert(kGf32Smem <= 232448, "one block an SM");

struct GnF32Args {
  const float* scale;  // (B, C) GroupNorm affine
  const float* shift;  // (B, C)
  const float* bias;   // (O,)
  const float* res;    // (B, H, W, O) or null
  float* out;          // (B, H, W, O)
  int H, W, C, O;
  int tiles_w, tiles, n_tiles;
};

// w (9, C, O) -> wt (9, 2, O, C): each tap's weights transposed, as TF32
// hi and lo planes, by 32 x 32 tiles through shared memory
__global__ void __launch_bounds__(256) gn_f32_weight_prep_kernel(const float* __restrict__ w,
                                                                float* __restrict__ wt, int C,
                                                                int O) {
  __shared__ float tile[32][33];
  const int t = blockIdx.z, c0 = blockIdx.y * 32, o0 = blockIdx.x * 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < 32; i += 8) {
    const int c = c0 + i, o = o0 + lane;
    tile[i][lane] = c < C && o < O ? w[((size_t)t * C + c) * O + o] : 0.0f;
  }
  __syncthreads();
  for (int i = warp; i < 32; i += 8) {
    const int o = o0 + i, c = c0 + lane;
    if (o >= O || c >= C) continue;
    const float v = tile[lane][i];
    const float hi = __uint_as_float(tf32_rna(v));
    float* d = wt + ((size_t)t * 2 * O + o) * C + c;
    d[0] = hi;
    d[(size_t)O * C] = __uint_as_float(tf32_rna(v - hi));
  }
}

__global__ void __launch_bounds__(kGf32Threads, 1)
gn_conv_split_tf32_kernel(const __grid_constant__ CUtensorMap tmap_x,
                        const __grid_constant__ CUtensorMap tmap_w, GnF32Args a) {
  extern __shared__ unsigned char gf_smem_raw[];
  const uint32_t raw = wg_smem_addr(gf_smem_raw);
  const uint32_t halo = (raw + 1023u) & ~1023u;  // the swizzle's 1024-byte atom
  unsigned char* const halo_p = gf_smem_raw + (halo - raw);
  const uint32_t stages = halo + kGf32HaloStages * kGf32HaloBuf;
  const uint32_t full_bar = stages + kGf32Stages * kGf32Stage;  // 8 bytes a stage
  const uint32_t empty_bar = full_bar + kGf32Stages * 8;
  const uint32_t halo_full = empty_bar + kGf32Stages * 8;  // 8 bytes a halo buffer
  const uint32_t halo_empty = halo_full + kGf32HaloStages * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // block -> (sample, spatial tile, N tile), the N tile fastest (the blocks
  // of one pixel tile run together and share its halo through L2)
  int rest = blockIdx.x;
  const int nt = rest % a.n_tiles;
  rest /= a.n_tiles;
  const int mt = rest % a.tiles;
  const int b = rest / a.tiles;
  const int h0 = (mt / a.tiles_w) * kIgGnTileH, w0 = (mt % a.tiles_w) * kIgGnTileW;
  const int n0 = nt * kGf32BN;
  const int kc = (a.C + kGf32BK - 1) / kGf32BK;  // K steps

  if (tid == 0) {
    for (int s = 0; s < kGf32Stages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kIgConsumerWarps);
    }
    for (int s = 0; s < kGf32HaloStages; ++s) {
      mbar_init(halo_full + 8 * s, 1);
      mbar_init(halo_empty + 8 * s, kIgConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kIgConsumerWarps) {  // the producer warp: one thread issues every copy
    if (lane != 0) return;
    // K step c: the halo box, then the nine taps' weight planes; the next
    // step's halo goes out before this step's weights
    auto load_halo = [&](int c) {
      const int hs = c % kGf32HaloStages;
      mbar_wait(halo_empty + 8 * hs, ((c / kGf32HaloStages) & 1) ^ 1);
      mbar_arrive_expect_tx(halo_full + 8 * hs, kIgHaloBox);
      tma_load_4d(halo + hs * kGf32HaloBuf, &tmap_x, halo_full + 8 * hs, c * kGf32BK, w0 - 1,
                  h0 - 1, b);
    };
    load_halo(0);
    int ks = 0;
    for (int c = 0; c < kc; ++c) {
      if (c + 1 < kc) load_halo(c + 1);
      for (int t = 0; t < 9; ++t, ++ks) {
        const int s = ks % kGf32Stages;
        mbar_wait(empty_bar + 8 * s, ((ks / kGf32Stages) & 1) ^ 1);
        const uint32_t bar = full_bar + 8 * s;
        mbar_arrive_expect_tx(bar, kGf32Stage);
#pragma unroll
        for (int pl = 0; pl < 2; ++pl)  // (c, o, plane, tap): 32 c of 64 o a box
          tma_load_4d(stages + s * kGf32Stage + pl * Gf32B::kBytes, &tmap_w, bar, c * kGf32BK, n0,
                      pl, t);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns pixels 64 wg .. + 63 of the tile, warp w
  // of it 16 w .. + 15
  const int wg = warp >> 2;
  float sum[kGf32BN / 2], part[kGf32BN / 2];
#pragma unroll
  for (int i = 0; i < kGf32BN / 2; ++i) sum[i] = 0.0f;
  // this lane's ldmatrix row (x4: matrices rows 0-7 / 8-15 x floats 0-3 /
  // 4-7 of a k8 step, in fragment order) and its 16-byte chunk of the step
  const int lrow = wg * 64 + (warp & 3) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lchunk = lane >> 4;
  const int lti = lrow / kIgGnTileW, ltj = lrow - lti * kIgGnTileW;

  // the halo buffer of K step c, rewritten in place: 16-byte chunk id
  // (pixel p = id / 8 of the box, channels 4 (id % 8) .. + 3 of the step)
  // becomes hi of h, and lo of h goes beside it; 0 off the image and past C
  auto transform = [&](int c, int i) {
    const int id = tid + i * 32 * kIgConsumerWarps;
    if (id >= kIgHaloPixels * 8) return;
    const int p = id >> 3, k = id & 7;
    const int r = p / kIgHaloW, y = h0 - 1 + r, x = w0 - 1 + p - r * kIgHaloW;
    const int ch = c * kGf32BK + 4 * k;
    float4* e = reinterpret_cast<float4*>(halo_p + (c % kGf32HaloStages) * kGf32HaloBuf + p * 128 +
                                          ((k ^ (p & 7)) << 4));
    float4 hi = make_float4(0.0f, 0.0f, 0.0f, 0.0f), lo = hi;
    if (y >= 0 && y < a.H && x >= 0 && x < a.W && ch < a.C) {  // C % 4 == 0
      const size_t off = (size_t)b * a.C + ch;
      const float4 v = *e;
      const float4 sc = __ldg(reinterpret_cast<const float4*>(a.scale + off));
      const float4 sh = __ldg(reinterpret_cast<const float4*>(a.shift + off));
      const float hv[4] = {swish(v.x * sc.x + sh.x), swish(v.y * sc.y + sh.y),
                           swish(v.z * sc.z + sh.z), swish(v.w * sc.w + sh.w)};
      float* ph = reinterpret_cast<float*>(&hi);
      float* pl = reinterpret_cast<float*>(&lo);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ph[j] = __uint_as_float(tf32_rna(hv[j]));
        pl[j] = __uint_as_float(tf32_rna(hv[j] - ph[j]));
      }
    }
    *e = hi;
    *reinterpret_cast<float4*>(reinterpret_cast<unsigned char*>(e) + kGf32HaloPlane) = lo;
  };
  // this lane's hi and lo fragments of tap t (r, s) = (t / 3, t % 3), k8
  // step kk of K step c: the tile pixel of row lrow shifted by (r, s)
  auto frag = [&](uint32_t (&fh)[4], uint32_t (&fl)[4], int c, int t, int kk) {
    const int r = t / 3;
    const int pp = (lti + r) * kIgHaloW + ltj + t - 3 * r;
    const uint32_t addr = halo + (c % kGf32HaloStages) * kGf32HaloBuf + pp * 128 +
                          (((2 * kk + lchunk) ^ (pp & 7)) << 4);
    ldsm_x4(fh, addr);
    ldsm_x4(fl, addr + kGf32HaloPlane);
  };

  mbar_wait(halo_full, 0);
  for (int i = 0; i < kIgHaloIters; ++i) transform(0, i);
  ig_consumers_sync();
  uint32_t fh[2][4], fl[2][4];
  frag(fh[0], fl[0], 0, 0, 0);
  int ks = 0;  // weight stages consumed
  for (int c = 0; c < kc; ++c) {
    for (int t = 0; t < 9; ++t, ++ks) {
      const int s = ks % kGf32Stages;
      mbar_wait(full_bar + 8 * s, (ks / kGf32Stages) & 1);
      const uint64_t bh = Gf32B::desc0(stages + s * kGf32Stage);
      const uint64_t bl = Gf32B::desc0(stages + s * kGf32Stage + Gf32B::kBytes);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wg_fence_acc(part);
        wg_fence_frag(fh);
        wg_fence_frag(fl);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        // lo.hi, hi.lo, hi.hi; the K step's first product starts from zero
        wgmma_tf32_rs<kGf32BN>(part, fl[kk & 1], Gf32B::step(bh, kk), t > 0 || kk > 0);
        wgmma_tf32_rs<kGf32BN>(part, fh[kk & 1], Gf32B::step(bl, kk), 1);
        wgmma_tf32_rs<kGf32BN>(part, fh[kk & 1], Gf32B::step(bh, kk), 1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the previous k8 step's products are done: its fragment buffers
        // are free, and after a tap's last step its weight stage
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        wg_fence_acc(part);
        wg_fence_frag(fh);
        wg_fence_frag(fl);
        if (kk == 0 && ks > 0 && lane == 0) mbar_arrive(empty_bar + 8 * ((ks - 1) % kGf32Stages));
        if (kk < 3)
          frag(fh[(kk + 1) & 1], fl[(kk + 1) & 1], c, t, kk + 1);
        else if (t < 8)
          frag(fh[0], fl[0], c, t + 1, 0);
      }
      // a sixth of the next K step's halo after each of this step's first
      // six taps, while the products run
      if (c + 1 < kc && t < kIgHaloIters) {
        if (t == 0)
          mbar_wait(halo_full + 8 * ((c + 1) % kGf32HaloStages),
                    ((c + 1) / kGf32HaloStages) & 1);
        transform(c + 1, t);
      }
    }
    // the K step's products, from zero, into the running sum on the CUDA cores
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(part);
#pragma unroll
    for (int i = 0; i < kGf32BN / 2; ++i) sum[i] += part[i];
    // every read of this step's halo buffer is done: order them before the
    // producer's next copy into it, and release it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(halo_empty + 8 * (c % kGf32HaloStages));
    if (c + 1 < kc) {
      ig_consumers_sync();  // the next step's halo is transformed
      frag(fh[0], fl[0], c + 1, 0, 0);
    }
  }

  // Epilogue from the registers: sum[4 j + e] is pixel (lane / 4) + 8 (e /
  // 2) of the warp's 16, channel n0 + 8 j + 2 (lane % 4) + e % 2
  const int q = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * half;
    const int ti = row / kIgGnTileW, tj = row - ti * kIgGnTileW;
    if (h0 + ti >= a.H || w0 + tj >= a.W) continue;
    const size_t off = (((size_t)b * a.H + h0 + ti) * a.W + w0 + tj) * a.O;
#pragma unroll
    for (int j = 0; j < kGf32BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * q;
      if (n >= a.O) continue;  // O % 4 == 0: a pair is all in or all out
      const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bias + n));
      float2 v = make_float2(sum[4 * j + 2 * half] + bb.x, sum[4 * j + 2 * half + 1] + bb.y);
      if (a.res != nullptr) {
        const float2 rv = __ldg(reinterpret_cast<const float2*>(a.res + off + n));
        v.x += rv.x;
        v.y += rv.y;
      }
      *reinterpret_cast<float2*>(a.out + off + n) = v;
    }
  }
}

// x (B, H, W, C), scale, shift (B, C), w (3, 3, C, O), bias (O,), res (B,
// H, W, O) or null, y (B, H, W, O), wt: (9, 2, O, C) scratch; float32, C
// and O multiples of 4, every pointer on 16 bytes
inline int launch_gn_conv_f32(const float* x, const float* scale, const float* shift,
                              const float* w, const float* bias, const float* res, float* y,
                              float* wt, int B, int H, int W, int C, int O, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || C % 4 != 0 || O % 4 != 0 ||
      scale == nullptr || shift == nullptr || bias == nullptr || wt == nullptr)
    return (int)cudaErrorInvalidValue;
  GnF32Args a{scale, shift, bias, res, y, H, W, C, O, 0, 0, 0};
  a.tiles_w = (W + kIgGnTileW - 1) / kIgGnTileW;
  const long long tiles = (long long)((H + kIgGnTileH - 1) / kIgGnTileH) * a.tiles_w;
  a.n_tiles = (O + kGf32BN - 1) / kGf32BN;
  const long long blocks = (long long)B * tiles * a.n_tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.tiles = (int)tiles;
  CUtensorMap tx, tw;
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xs[3] = {(cuuint64_t)C * 4, (cuuint64_t)W * C * 4, (cuuint64_t)H * W * C * 4};
  const cuuint32_t xb[4] = {kGf32BK, kIgHaloW, kIgGnTileH + 2, 1};
  const cuuint64_t wd[4] = {(cuuint64_t)C, (cuuint64_t)O, 2, 9};
  const cuuint64_t ws[3] = {(cuuint64_t)C * 4, (cuuint64_t)O * C * 4, (cuuint64_t)2 * O * C * 4};
  const cuuint32_t wbx[4] = {kGf32BK, kGf32BN, 1, 1};
  if (!encode_tiled(&tx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, xd, xs, xb) ||
      !encode_tiled(&tw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, wt, wd, ws, wbx))
    return (int)cudaErrorInvalidValue;
  gn_f32_weight_prep_kernel<<<dim3((O + 31) / 32, (C + 31) / 32, 9), 256, 0, stream>>>(w, wt, C, O);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gn_conv_split_tf32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGf32Smem);
  if (err != cudaSuccess) return (int)err;
  gn_conv_split_tf32_kernel<<<(unsigned)blocks, kGf32Threads, kGf32Smem, stream>>>(tx, tw, a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace gvq
