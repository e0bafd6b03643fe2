// The wmma bf16 flash-attention forward body, instantiated only by the
// forward labs B15 and B16 (csrc/flash_lab_fwd.cu).  The shipped entries of
// csrc/flash_fwd.cu (gvq_flash_fwd, gvq_flash_fwd_res, gvq_flash_fwd_qkv,
// gvq_flash_fwd_qkv_res, gvq_flash_fwd_hm) run the wgmma bodies of
// csrc/flash_fwd_sm90.cuh (D = 64, 128) and csrc/flash_fwd_sm90_wide.cuh
// (D = 256, 512); csrc/flash_fwd.cu's header says what they replace and
// what bounds them.  This file holds the body and its template knobs.
//
// Per (b, h) and q tile of BQ rows: an online softmax over 64-row K/V tiles,
// scores in fp32 from bf16 tensor-core products (nvcuda::wmma), p rounded to
// bf16 before the P.V product (fp32 accumulation in shared memory), the row
// sum over the fp32 p, the 1/sum normaliser applied once at the end.
//
// Template knobs (the labs' base setting: BQ 32, WARPS 8, HPB 1, kBase,
// STAGES 1, the tiling the shipped entries ran before the wgmma bodies;
// each knob is a compile-time constant):
//   BQ      q rows per block (a multiple of 16)
//   WARPS   warps per block
//   HPB     heads per block: a block runs HPB heads of one q tile in turn
//   POLICY  the softmax (kBase: per-row max then exp; the lab policies of
//           csrc/flash_lab_fwd.cu: kNoMax, kExp2, kTileMax, kMatOnly,
//           kChunk, kSbf16)
//   STAGES  K/V buffers: 1 (K and V take turns in one buffer, each loaded
//           by plain 16-byte copies) or 2 (two buffers; the next K or V tile
//           is copied by cp.async while the current tile's product runs)
// kTail: the last q tile or K/V tile may be partial; a launch of full tiles
// compiles the row and column checks out.
#pragma once

#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

// softmax policies (template values of POLICY)
constexpr int kBase = 0;     // online softmax: per-row max, then exp
constexpr int kNoMax = 1;    // p = exp(min(s, 30) - 30): no max pass, no rescale
constexpr int kExp2 = 2;     // exp2f((s - m) log2 e), log2 e folded into the scale
constexpr int kTileMax = 3;  // one max per (q tile x key tile), a scalar rescale
constexpr int kMatOnly = 4;  // p = s: no softmax (a control; ill-conditioned)
constexpr int kChunk = 5;    // kNoMax on two key halves, one per warp half
constexpr int kSbf16 = 6;    // scores rounded to bf16, then (s - m) in bf16

constexpr int kFkv = 64;       // key / value rows per tile
constexpr int kLdS = kFkv + 4; // f32 pitch of the score tile
constexpr int kLdP = kFkv + 8; // bf16 pitch of the probability tile

template <int D, int BQ = 32, int POLICY = kBase, int STAGES = 1>
struct FlashLayout {
  static constexpr int kLdQ = D + 8;  // bf16 pitch of the Q and K/V tiles
  static constexpr int kLdO = D + 4;  // f32 pitch of the accumulator
  static constexpr size_t kQ = 0;
  static constexpr size_t kKV = kQ + (size_t)BQ * kLdQ * sizeof(bf16);
  static constexpr size_t kO = kKV + (size_t)STAGES * kFkv * kLdQ * sizeof(bf16);
  static constexpr size_t kS = kO + (size_t)BQ * kLdO * sizeof(float);
  static constexpr size_t kSb = kS + (size_t)BQ * kLdS * sizeof(float);  // bf16 scores (kSbf16)
  static constexpr size_t kP = kSb + (POLICY == kSbf16 ? (size_t)BQ * kLdP * sizeof(bf16) : 0);
  static constexpr size_t kStats = kP + (size_t)BQ * kLdP * sizeof(bf16);
  // row max, row sum, rescale; then the two half sums (kChunk) or the
  // block max and the warps' maxima (kTileMax)
  static constexpr int kExtra = POLICY == kChunk ? 2 * BQ : (POLICY == kTileMax ? 64 : 0);
  static constexpr size_t kBytes = kStats + (3 * BQ + kExtra) * sizeof(float);
  // blocks an SM holds by shared memory (232,448 bytes), at most 5:
  // __launch_bounds__ then keeps a thread within the registers that many
  // blocks leave it.  At D = 64 with 32 rows and 8 warps that is five
  // blocks at 48 registers, what this body compiled to before its knobs
  // existed; left to itself ptxas took 64, one block less an SM, and the
  // packed forward ran 4% slower
  static constexpr int kFit = (int)(232448 / kBytes);
  static constexpr int kMinBlocks = kFit < 1 ? 1 : (kFit > 5 ? 5 : kFit);
};

struct FwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* z;         // (B, H, Lq) float32, or null for the inference form
  Strides sq, skv, so;
  int Lq, Lk, H;
  float scale;
};

// ROWS rows of D bf16 from src (row stride `stride`) into dst (pitch LD); a
// row at or past `valid` is zeros.  kAsync: by cp.async (the caller commits
// and waits)
template <int D, int LD, int ROWS, int THREADS, bool kTail, bool kAsync>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long stride,
                                          int valid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < ROWS * CPR; e += THREADS) {
    const int r = e / CPR, c = (e % CPR) * 8;
    uint4* d = reinterpret_cast<uint4*>(dst + r * LD + c);
    if (!kTail || r < valid) {
      if constexpr (kAsync)
        cp_async16(d, src + r * stride + c);
      else
        *d = *reinterpret_cast<const uint4*>(src + r * stride + c);
    } else {
      *d = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// named barrier over `count` threads (the warps of one half of the block)
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int D, bool kTail, int BQ = 32, int WARPS = 8, int HPB = 1, int POLICY = kBase,
          int STAGES = 1>
__global__ void __launch_bounds__(WARPS * 32, (FlashLayout<D, BQ, POLICY, STAGES>::kMinBlocks))
flash_fwd_kernel(FwdArgs g) {
  using namespace nvcuda;
  using Lay = FlashLayout<D, BQ, POLICY, STAGES>;
  constexpr int THREADS = WARPS * 32;
  constexpr int LDQ = Lay::kLdQ;
  constexpr int LDO = Lay::kLdO;
  constexpr int CPR = D / 8;               // 16-byte chunks per row
  constexpr int RQF = BQ / 16;             // row fragments of the q tile
  constexpr int SF = RQF * (kFkv / 16);    // score fragments
  // the accumulator fragments a warp owns: NR row fragments of NC columns
  constexpr int NR = RQF >= WARPS ? RQF / WARPS : 1;
  constexpr int NC = RQF >= WARPS ? D / 16 : RQF * (D / 16) / WARPS;
  // the row pass: TPR threads a row, COLS scores each, RPT rows a thread
  constexpr int TPR = THREADS >= BQ ? THREADS / BQ : 1;
  constexpr int RPT = THREADS >= BQ ? 1 : BQ / THREADS;
  constexpr int COLS = kFkv / TPR;
  constexpr bool kRescale =
      POLICY == kBase || POLICY == kExp2 || POLICY == kTileMax || POLICY == kSbf16;
  constexpr bool kRowMax = POLICY == kBase || POLICY == kExp2 || POLICY == kSbf16;
  constexpr bool kAsync = STAGES == 2;
  static_assert(BQ % 16 == 0 && SF % WARPS == 0, "the score fragments must split evenly");
  static_assert(NR * NC * WARPS == RQF * (D / 16), "the output fragments must split evenly");
  static_assert(TPR <= 32 && COLS >= 1 && RPT * THREADS / TPR == BQ, "the row pass");
  static_assert(STAGES == 1 || STAGES == 2, "one or two K/V buffers");
  static_assert(POLICY != kTileMax || RPT == 1, "kTileMax: one row a thread at most");
  static_assert(POLICY != kChunk || (BQ == 32 && WARPS == 8 && STAGES == 1),
                "kChunk is written for 32 rows and 8 warps");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + Lay::kQ);
  bf16* KV0 = reinterpret_cast<bf16*>(smem + Lay::kKV);
  bf16* KV1 = KV0 + (STAGES == 2 ? kFkv * LDQ : 0);
  float* Os = reinterpret_cast<float*>(smem + Lay::kO);
  float* Ss = reinterpret_cast<float*>(smem + Lay::kS);
  bf16* Sb = reinterpret_cast<bf16*>(smem + Lay::kSb);
  bf16* Ps = reinterpret_cast<bf16*>(smem + Lay::kP);
  float* row_m = reinterpret_cast<float*>(smem + Lay::kStats);
  float* row_l = row_m + BQ;
  float* row_a = row_l + BQ;
  float* extra = row_a + BQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int Lq = g.Lq, Lk = g.Lk;
  const int q0 = blockIdx.x * BQ;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // kExp2 works in base 2: s * log2(e) against a base-2 max
  const float scale = POLICY == kExp2 ? g.scale * 1.4426950408889634f : g.scale;

  for (int hh = 0; hh < HPB; ++hh) {
    const int bh = blockIdx.y * HPB + hh;
    const int b = bh / g.H;
    const int h = bh % g.H;
    const bf16* qb = g.q + b * g.sq.b + h * g.sq.h;
    const bf16* kb = g.k + b * g.skv.b + h * g.skv.h;
    const bf16* vb = g.v + b * g.skv.b + h * g.skv.h;
    bf16* ob = g.o + b * g.so.b + h * g.so.h;
    if (hh > 0) __syncthreads();  // the last head's output pass read Os and the stats

    // a q row past Lq loads zeros and is never stored
    for (int e = tid; e < BQ * CPR; e += THREADS) {
      const int r = e / CPR, c = (e % CPR) * 8;
      *reinterpret_cast<uint4*>(Qs + r * LDQ + c) =
          !kTail || q0 + r < Lq ? *reinterpret_cast<const uint4*>(qb + (q0 + r) * g.sq.row + c)
                                : zero;
    }
    for (int e = tid; e < BQ * D; e += THREADS) Os[(e / D) * LDO + e % D] = 0.0f;
    if constexpr (BQ <= THREADS) {
      if (tid < BQ) {
        row_m[tid] = -INFINITY;
        row_l[tid] = 0.0f;
      }
    } else {
      for (int r = tid; r < BQ; r += THREADS) {
        row_m[r] = -INFINITY;
        row_l[r] = 0.0f;
      }
    }
    if constexpr (POLICY == kTileMax) {
      if (tid == 0) extra[0] = -INFINITY;  // the block's running max
    }
    __syncthreads();
    if constexpr (kAsync) {
      load_rows<D, LDQ, kFkv, THREADS, kTail, true>(KV0, kb, g.skv.row, Lk);
      cp_async_commit();
    }

    for (int k0 = 0; k0 < Lk; k0 += kFkv) {
      bf16* Ks = KV0;
      bf16* Vs = kAsync ? KV1 : KV0;
      if constexpr (kAsync) {
        // K is in; V goes to the other buffer while S = Q K^T runs
        cp_async_wait_all();
        __syncthreads();
        load_rows<D, LDQ, kFkv, THREADS, kTail, true>(Vs, vb + k0 * g.skv.row, g.skv.row,
                                                      Lk - k0);
        cp_async_commit();
      } else {
        // a key row past Lk loads zeros (its score is masked below)
        for (int e = tid; e < kFkv * CPR; e += THREADS) {
          const int r = e / CPR, c = (e % CPR) * 8;
          *reinterpret_cast<uint4*>(Ks + r * LDQ + c) =
              !kTail || k0 + r < Lk
                  ? *reinterpret_cast<const uint4*>(kb + (k0 + r) * g.skv.row + c)
                  : zero;
        }
        __syncthreads();
      }

      if constexpr (POLICY == kChunk) {
        // each half of the warps takes one 32-key half of the tile: its
        // score product, then its exp, under a barrier of its own, so one
        // half's exp runs beside the other half's tensor-core work
        constexpr int HALF = THREADS / 2;
        const int grp = warp / (WARPS / 2);
        const int gw = warp % (WARPS / 2);
#pragma unroll
        for (int i = 0; i < RQF * 2 / (WARPS / 2); ++i) {
          const int f = gw + i * (WARPS / 2);
          const int fr = f >> 1, fc = grp * 2 + (f & 1);
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
          wmma::fill_fragment(sacc, 0.0f);
#pragma unroll 4
          for (int kk = 0; kk < D; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
            wmma::load_matrix_sync(fa, Qs + fr * 16 * LDQ + kk, LDQ);
            wmma::load_matrix_sync(fb, Ks + fc * 16 * LDQ + kk, LDQ);
            wmma::mma_sync(sacc, fa, fb, sacc);
          }
          wmma::store_matrix_sync(Ss + fr * 16 * kLdS + fc * 16, sacc, kLdS,
                                  wmma::mem_row_major);
        }
        bar_sync(1 + grp, HALF);
        {
          constexpr int TPRC = HALF / BQ;       // threads a row in one half
          constexpr int COLSC = kFkv / 2 / TPRC;
          const int lt = tid - grp * HALF;
          const int r = lt / TPRC, part = lt % TPRC;
          float sum = 0.0f;
#pragma unroll
          for (int i = 0; i < COLSC; ++i) {
            const int col = grp * (kFkv / 2) + part * COLSC + i;
            const float s = !kTail || k0 + col < Lk ? Ss[r * kLdS + col] * scale : -INFINITY;
            const float p = expf(fminf(s, 30.0f) - 30.0f);
            sum += p;
            Ps[r * kLdP + col] = __float2bfloat16(p);
          }
#pragma unroll
          for (int o = 1; o < TPRC; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
          if (part == 0) extra[grp * BQ + r] = sum;
        }
        __syncthreads();
        for (int e = tid; e < kFkv * CPR; e += THREADS) {
          const int r = e / CPR, c = (e % CPR) * 8;
          *reinterpret_cast<uint4*>(Vs + r * LDQ + c) =
              !kTail || k0 + r < Lk
                  ? *reinterpret_cast<const uint4*>(vb + (k0 + r) * g.skv.row + c)
                  : zero;
        }
        if (tid < BQ) row_l[tid] += extra[tid] + extra[BQ + tid];
        __syncthreads();
      } else {
        // S = Q K^T: warp w owns score fragments w, w + WARPS, ... (fragment
        // f is the 16 x 16 block (f / 4, f % 4))
#pragma unroll
        for (int i = 0; i < SF / WARPS; ++i) {
          const int f = warp + i * WARPS;
          const int fr = f >> 2, fc = f & 3;
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
          wmma::fill_fragment(sacc, 0.0f);
#pragma unroll 4
          for (int kk = 0; kk < D; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
            wmma::load_matrix_sync(fa, Qs + fr * 16 * LDQ + kk, LDQ);
            wmma::load_matrix_sync(fb, Ks + fc * 16 * LDQ + kk, LDQ);
            wmma::mma_sync(sacc, fa, fb, sacc);
          }
          wmma::store_matrix_sync(Ss + fr * 16 * kLdS + fc * 16, sacc, kLdS,
                                  wmma::mem_row_major);
          if constexpr (POLICY == kSbf16) {
            // the warp rounds its own scaled fragment to the bf16 score tile
            __syncwarp();
            const int lane = tid & 31;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int idx = lane * 8 + j, rr = fr * 16 + idx / 16, cc = fc * 16 + idx % 16;
              Sb[rr * kLdP + cc] = __float2bfloat16(Ss[rr * kLdS + cc] * scale);
            }
          }
        }
        __syncthreads();

        if constexpr (!kAsync) {
          // V takes the K buffer (zero rows past Lk: p is 0 there, and 0 * v
          // must not meet stale data); the softmax update runs on S meanwhile
          for (int e = tid; e < kFkv * CPR; e += THREADS) {
            const int r = e / CPR, c = (e % CPR) * 8;
            *reinterpret_cast<uint4*>(Vs + r * LDQ + c) =
                !kTail || k0 + r < Lk
                    ? *reinterpret_cast<const uint4*>(vb + (k0 + r) * g.skv.row + c)
                    : zero;
          }
        }
        float blk_old = 0.0f;
        if constexpr (POLICY == kTileMax) blk_old = extra[0];
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr) {
          // TPR threads a row, COLS scores each; a key column past Lk scores
          // -inf before the row max, so it adds exactly 0 to the row sum
          // (every tile holds at least one column below Lk, so the max stays
          // finite)
          const int r = tid / TPR + rr * (THREADS / TPR), part = tid % TPR;
          float sv[COLS];
          float mx = -INFINITY;
#pragma unroll
          for (int i = 0; i < COLS; ++i) {
            const int col = part * COLS + i;
            const bool in = !kTail || k0 + col < Lk;
            if constexpr (POLICY == kSbf16)
              sv[i] = in ? __bfloat162float(Sb[r * kLdP + col]) : -INFINITY;
            else if constexpr (POLICY == kMatOnly)
              sv[i] = in ? Ss[r * kLdS + col] * scale : 0.0f;
            else
              sv[i] = in ? Ss[r * kLdS + col] * scale : -INFINITY;
            if constexpr (kRowMax || POLICY == kTileMax) mx = fmaxf(mx, sv[i]);
          }
          float m_old = 0.0f, m_new = 0.0f;
          if constexpr (kRowMax) {
#pragma unroll
            for (int o = 1; o < TPR; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            m_old = row_m[r];
            m_new = fmaxf(m_old, mx);
          } else if constexpr (POLICY == kTileMax) {
            // one max over the whole (q tile x key tile)
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            if ((tid & 31) == 0) extra[1 + warp] = mx;
            __syncthreads();
            mx = extra[1];
#pragma unroll
            for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, extra[1 + w]);
            m_old = blk_old;
            m_new = fmaxf(m_old, mx);
          }
          float sum = 0.0f;
#pragma unroll
          for (int i = 0; i < COLS; ++i) {
            float p;
            if constexpr (POLICY == kExp2)
              p = exp2f(sv[i] - m_new);
            else if constexpr (POLICY == kSbf16)
              p = expf(__bfloat162float(__float2bfloat16(sv[i] - m_new)));
            else if constexpr (POLICY == kNoMax)
              p = expf(fminf(sv[i], 30.0f) - 30.0f);
            else if constexpr (POLICY == kMatOnly)
              p = sv[i];
            else
              p = expf(sv[i] - m_new);
            sum += p;
            Ps[r * kLdP + part * COLS + i] = __float2bfloat16(p);
          }
#pragma unroll
          for (int o = 1; o < TPR; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
          if (part == 0) {
            if constexpr (kRescale) {
              // 0 on the first tile
              const float alpha = POLICY == kExp2 ? exp2f(m_old - m_new) : expf(m_old - m_new);
              row_a[r] = alpha;
              row_l[r] = row_l[r] * alpha + sum;
              row_m[r] = m_new;
            } else {
              row_l[r] += sum;
            }
          }
          if constexpr (POLICY == kTileMax) {
            if (tid == 0) extra[0] = m_new;
          }
        }
        if constexpr (kAsync) cp_async_wait_all();  // V is in
        __syncthreads();
        if constexpr (kAsync) {
          // S is consumed: the next K goes to its buffer during P V
          if (k0 + kFkv < Lk) {
            load_rows<D, LDQ, kFkv, THREADS, kTail, true>(Ks, kb + (k0 + kFkv) * g.skv.row,
                                                          g.skv.row, Lk - k0 - kFkv);
            cp_async_commit();
          }
        }
      }

      if constexpr (kRescale) {
        if (k0 > 0) {
          for (int e = tid; e < BQ * D; e += THREADS) {
            const int r = e / D;
            Os[r * LDO + e % D] *= row_a[r];
          }
          __syncthreads();
        }
      }

      // O += P V: warp w owns NR row fragments and NC column fragments
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int fr = RQF >= WARPS ? warp + i * WARPS : warp % RQF;
        const int cb = RQF >= WARPS ? 0 : (warp / RQF) * NC;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wmma::load_matrix_sync(oacc[c], Os + fr * 16 * LDO + (cb + c) * 16, LDO,
                                 wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kFkv; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
          wmma::load_matrix_sync(pa, Ps + fr * 16 * kLdP + kk, kLdP);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
            wmma::load_matrix_sync(vf, Vs + kk * LDQ + (cb + c) * 16, LDQ);
            wmma::mma_sync(oacc[c], pa, vf, oacc[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wmma::store_matrix_sync(Os + fr * 16 * LDO + (cb + c) * 16, oacc[c], LDO,
                                  wmma::mem_row_major);
      }
      __syncthreads();
    }

    for (int e = tid; e < BQ * CPR; e += THREADS) {
      const int r = e / CPR, c = (e % CPR) * 8;
      if (kTail && q0 + r >= Lq) continue;
      const float inv = 1.0f / row_l[r];
      uint4 packed;
      uint32_t* pk = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        __nv_bfloat162 r2 = __floats2bfloat162_rn(Os[r * LDO + c + i] * inv,
                                                 Os[r * LDO + c + i + 1] * inv);
        pk[i >> 1] = *reinterpret_cast<uint32_t*>(&r2);
      }
      *reinterpret_cast<uint4*>(ob + (q0 + r) * g.so.row + c) = packed;
    }
    if (g.z != nullptr) {
      for (int r = tid; r < BQ; r += THREADS)
        if (!kTail || q0 + r < Lq) g.z[(size_t)bh * Lq + q0 + r] = row_m[r] + logf(row_l[r]);
    }
  }
}

// Launch one instantiation over a (q tiles, B * H / HPB) grid.
template <int D, bool kTail, int BQ = 32, int WARPS = 8, int HPB = 1, int POLICY = kBase,
          int STAGES = 1>
int launch_flash_fwd(const FwdArgs& g, int B, cudaStream_t stream) {
  if (g.H % HPB != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = FlashLayout<D, BQ, POLICY, STAGES>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, kTail, BQ, WARPS, HPB, POLICY, STAGES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.Lq + BQ - 1) / BQ, B * g.H / HPB);
  flash_fwd_kernel<D, kTail, BQ, WARPS, HPB, POLICY, STAGES><<<grid, WARPS * 32, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace
