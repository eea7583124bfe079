// fp32 flash attention on Hopper's tensor cores (sm_90a): every product runs
// as three TF32 products with fp32 accumulation, which keeps the result
// within a few fp32 ulps of an fp32 product (flash_attention_f32.cu has the
// entry points and the CUDA-core form for what these forms do not take).
//
// The arithmetic. Each fp32 operand x splits into big = tf32(x) (rounded to
// the nearest as cvt.rna would, in integer operations: its low 13 mantissa
// bits are zero, so the tensor cores read it exactly) and small = x - big
// (exact in fp32, |small| <= 2^-11 |x|). A product a.b runs as small_a.big_b + big_a.small_b +
// big_a.big_b, small terms first, all into one fp32 accumulator; the dropped
// small.small term and the tf32 reading of small are each about 2^-22 of
// |a.b|, the order of fp32's own rounding (CUTLASS's OpMultiplyAddFastF32,
// which PyTorch's memory-efficient attention runs in fp32, does the same).
// One TF32 pass alone would keep about three digits, short of the 1e-4 bar.
// The exps run on ex2.approx with log2(e) folded into the scale.
//
// The function is that of the CUDA-core form, and of the TPU kernels for
// fp32 inputs (mdu_tpu/ops/pallas/flash_attention.py):
//   Fixed (flash_attention_t_fm): p = exp(min(s * scale, smax) - smax), the
//     min only with clamp; with bf16_exp p = bf16(exp(bf16(...))). out =
//     sum_j p_j v_j / max(sum_j p_j, 1e-30) over the real kv columns.
//   Online (flash_attention, and flash_attention_t in fp32): a running row
//     max, an fp32 denominator of the unrounded p, floored at 1e-30.
//
// ---------------------------------------------------------------- sm90 form
// For contiguous fp32 [bh, L, D] with D % 4 == 0, D <= 160 and 16-byte
// aligned q, k, v. D is padded to DP, a multiple of 8 (one tf32 k-step is 8
// columns, 32 bytes), by the TMA's zero fill.
//
// Layout of a block:
// - warpgroup 0. Thread 0 issues every TMA load: K tiles of BK kv rows into
//   a ring of STAGES stages, as 8-column slices of 32 bytes, 32-byte
//   swizzled (one slice is one k-step of Q.K^T), and Q's rows once. Warps 1-3 (96 threads) prepare each stage for the consumers: they
//   round K in place to its big part and write its small part beside it,
//   and they read V's tile from global memory and write it transposed, big
//   and small.
// - NCONS consumer warpgroups of 64 query rows. Q's small part sits in
//   registers as the A fragments of its pass of Q.K^T (read from global
//   memory once), its big part in shared memory, rounded in place. S =
//   Qs.Kb + Qb.Ks + Qb.Kb is one wgmma m64nBKk8 per 8 columns of d and pass;
//   O += Ps.Vb + Pb.Vs + Pb.Vb takes P from registers.
//
// Two mismatches of tf32 with the bf16 design, and what this does:
// - tf32 wgmma reads B K-major only (no transposed layouts), so P.V needs V
//   with kv contiguous. The helper warps write V^T, in core matrices of 8 d
//   rows x 4 kv (16 bytes) without swizzle (LBO = the next 4 kv, SBO = the
//   next 8 d).
// - In a tf32 A fragment a thread holds columns t and t + 4 of each 8; the S
//   accumulator gives it columns 2t and 2t + 1. Rather than shuffle P, V^T
//   stores each group of 8 kv rows permuted the same way: position k' holds
//   kv 2 (k' % 4) + k' / 4, so the accumulator's registers {s0, s2, s1, s3}
//   of each 8 columns are the A fragment as they stand, and P.V sums the
//   same products.
//
// O's accumulation. The tensor cores add into an fp32 accumulator with
// truncation, so products chained into O's registers over every kv tile
// drift with |O|: with scores of std 3 (a sharp softmax, a large |O|) the
// chain missed the 1e-4 bar (1.0e-4 at [10, 8, 6144, 40]; the wide form
// 1.6e-4 to 1.8e-4 at [2, 1, 9600, 512]; the CUDA-core form 1e-5 to 2e-5;
// H100 80GB HBM3, 700 W). So each kv tile's P.V runs into a fresh
// accumulator, which the CUDA cores add to O in fp32 after O's rescale (as
// the fp32 conv adds each channel chunk, conv3x3_f32_sm90.cuh): a chain of
// at most 3 BK / 8 products.
//
// Sizes. Consumers hold S (BK / 2 registers), P's small part (BK / 2), O
// (DP / 2), the tile's P.V accumulator (DP / 2; above DP = 80 it runs in
// chunks of 40 columns, 20) and Q's small part (DP / 2); Q's big part sits
// in shared memory. The fresh accumulator took the registers that Q's big
// part held in PR 6's design (Q in registers at DP <= 80): at config 2's
// D = 40 the repair costs 6 % over the chained accumulation (4.80 against
// 4.54 ms), where BK = 32 with Q in registers cost 13 % (5.15); at D = 80
// 6 % (0.888 against 0.837), where BK = 32 cost 9 % (0.915); H100 80GB
// HBM3, 700 W.
// - DP <= 40: three consumers (152 registers each; the producer warpgroup
//   gives its own up, to 56), BK = 64, four stages of Kb, Ks and V^T big and
//   small (40 KB at DP = 40) beside Q's 30 KB.
// - DP <= 80: two consumers (232 registers; the producer keeps 40), BK = 64,
//   two to four stages.
// - DP > 80: one consumer, BK = 32, Q's big part up to 40 KB.
// (Three consumers at DP = 48 spill. At config 2's D = 40 three consumers
// took 4.6 ms against 5.7 for two, on an H100 80GB HBM3 at 700 W.)
//
// What bounds it, at config 2's shapes (H100 SXM, 495 TFLOP/s dense TF32):
// [10, 8, 6144, 40]: 3 passes x 4 L^2 D flops x 80 heads = 3.62e13 flops =
// 2.93 ms; the exps, L^2 x 80 = 3.0e9 ex2 at 16 a clock per SM = 0.72 ms;
// the bytes (31 MB) 0.01 ms. [10, 8, 1536, 80]: 0.366 ms of products, 0.045
// ms of exps. So the tensor cores bound both, by four and eight times the
// exps; the consumers overlap one's softmax with the other's products
// simply by running side by side, and the split of P (two integer
// operations and a subtract per score) and the helpers' passes run beside
// the products too.
// [10, 8, 6144, 40] is 32 x 80 = 2560 blocks of 192 rows, 19.4 waves.
//
// ---------------------------------------------------------------- wide form
// For 160 < D <= 512, the same alignment (the VAE's single head at D = 512,
// [2, 1, 9600, 512]: 4.5e12 flops x 3 = 2.29 ms at the TF32 rate):
// mma.sync m16n8k8 in tf32, three passes, the split made as the fragments
// are loaded. Why not wgmma: O for 64 rows at D = 512 is 256 fp32 registers
// a thread, so D splits across warpgroups; Q.K^T then splits along D too,
// and Q in big and small (256 KB for 64 rows) does not fit shared memory,
// so it would stream from L2 with every kv tile, beside K and V.
// A block takes 32 query rows and 8 warps. Warp w owns the D slice w of
// Q.K^T's sum and of O for all 32 rows (two m16 tiles, so that each K and V
// fragment serves both: 64 registers of O at D = 512). The 8 partial score
// tiles go through shared memory; 256 threads sum them, 4 scores each, and
// run the softmax there (a row's 32 columns in 8 lanes), writing P and each
// row's rescale factor back for the P.V products. Q, a 32-row K tile, a
// 32-row V tile and the partial tiles take 227 KB at DP = 512, one stage
// (V's copy overlaps Q.K^T); P lives where K was. The permutation of each 8
// columns of the fragments (here of d for Q.K^T and of kv for P.V) lets Q,
// K and P fragments load as 8-byte pairs. 600 blocks at one an SM are 4.5
// waves. O's accumulation goes through a fresh accumulator per kv tile, as
// in the sm90 form: 64 more registers at DP = 512.
#pragma once

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace mdu {
namespace f32 {

using namespace mdu::sm90;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG = -1e30f;

// ------------------------------------------------------------ helpers

// the small part of x, as the bits of an fp32
__device__ __forceinline__ uint32_t small_of(float x, uint32_t big) {
  return __float_as_uint(x - __uint_as_float(big));
}

// 1 / the denominator of a row whose partial sums are in the 4 lanes of a
// quad (the accumulator layout)
__device__ __forceinline__ float inv_of_quad(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return 1.f / fmaxf(x, 1e-30f);
}

// ... and in 8 aligned lanes (the wide form's row layout)
__device__ __forceinline__ float inv_of_row8(float x) {
  return inv_of_quad(x + __shfl_xor_sync(0xffffffffu, x, 4));
}

// ----------------------------------------------------------------- policies
//
// A policy turns the scores of a thread, s[i] = row g + 8 ((i >> 1) & 1),
// column 8 (i / 4) + 2t + (i & 1) of a kv tile (the accumulator layout),
// into p in place (``exps``; the wide form's row layout: ``row4``). Columns
// at or past ``kvalid`` do not count. ``corr`` is the factor O's rows take
// before the tile's P.V (RESCALES). ``finish`` gives each row's
// 1 / denominator.

struct Fixed {
  static constexpr bool RESCALES = false;
  float scale, smax, sc, sh;
  int clamp, bf16_exp;
  float l[2];

  __device__ __forceinline__ Fixed(float scale_, float smax_, int clamp_, int bf16_exp_)
      : scale(scale_), smax(smax_), sc(scale_ * LOG2E), sh(smax_ * LOG2E), clamp(clamp_),
        bf16_exp(bf16_exp_) {
    l[0] = l[1] = 0.f;
  }

  // p of one score, before the kv mask: with bf16_exp the shifted score
  // rounded to bf16 and its exp rounded to bf16, as the TPU kernel and the
  // plain version compute them; else in the log2 domain
  __device__ __forceinline__ float p_bf16(float x) const {
    const float xs = x * scale;
    return round_bf16(expf(round_bf16((clamp ? fminf(xs, smax) : xs) - smax)));
  }
  __device__ __forceinline__ float p_clamp(float x) const { return ex2(fminf(x * sc, sh) - sh); }
  __device__ __forceinline__ float p_plain(float x) const { return ex2(fmaf(x, sc, -sh)); }
  __device__ __forceinline__ float p_of(float x) const {
    return bf16_exp ? p_bf16(x) : clamp ? p_clamp(x) : p_plain(x);
  }

  // the wide form's layout: columns c0..c0 + 3 of one row, whose other
  // columns are in the 8 lanes of an aligned group
  __device__ __forceinline__ void row4(float (&s)[4], int c0, int kvalid, float&) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = c0 + i < kvalid ? p_of(s[i]) : 0.f;
      l[0] += s[i];
    }
  }

  __device__ __forceinline__ float finish_row4() const { return inv_of_row8(l[0]); }

  template <int N>
  __device__ __forceinline__ void exps(float (&s)[N], int kvalid, int t, float (&)[2]) {
    // the choice of formula taken once for the tile, not per score
    if (bf16_exp) {
#pragma unroll
      for (int i = 0; i < N; ++i) s[i] = p_bf16(s[i]);
    } else if (clamp) {
#pragma unroll
      for (int i = 0; i < N; ++i) s[i] = p_clamp(s[i]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) s[i] = p_plain(s[i]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (8 * (i / 4) + 2 * t + (i & 1) >= kvalid) s[i] = 0.f;
      l[(i >> 1) & 1] += s[i];
    }
  }

  __device__ __forceinline__ void finish(float (&inv)[2]) const {
    inv[0] = inv_of_quad(l[0]);
    inv[1] = inv_of_quad(l[1]);
  }
};

struct Online {
  static constexpr bool RESCALES = true;
  // (the wide form's row layout, as in Fixed)
  __device__ __forceinline__ void row4(float (&s)[4], int c0, int kvalid, float& corr) {
    float mx = NEG;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = c0 + i < kvalid ? s[i] * sc : NEG;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float mn = fmaxf(m[0], mx);
    corr = ex2(m[0] - mn);
    m[0] = mn;
    l[0] *= corr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = s[i] == NEG ? 0.f : ex2(s[i] - mn);
      l[0] += s[i];
    }
  }

  __device__ __forceinline__ float finish_row4() const { return inv_of_row8(l[0]); }

  float sc;
  float m[2];     // running max of rows g, g + 8 (log2 domain)
  float l[2];     // this lane's share of their denominators

  __device__ __forceinline__ Online(float scale, float, int, int) : sc(scale * LOG2E) {
    m[0] = m[1] = NEG;
    l[0] = l[1] = 0.f;
  }

  template <int N>
  __device__ __forceinline__ void exps(float (&s)[N], int kvalid, int t, float (&corr)[2]) {
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s[i] = 8 * (i / 4) + 2 * t + (i & 1) < kvalid ? s[i] * sc : NEG;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four lanes of a quad hold disjoint columns of the same rows
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      corr[r] = ex2(m[r] - mn);
      m[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = s[i] == NEG ? 0.f : ex2(s[i] - m[r]);
      l[r] += s[i];
    }
  }

  __device__ __forceinline__ void finish(float (&inv)[2]) const {
    inv[0] = inv_of_quad(l[0]);
    inv[1] = inv_of_quad(l[1]);
  }
};

// ------------------------------------------------------------ the sm90 form

template <int DP>
struct Cfg {
  static constexpr int NCONS = DP <= 40 ? 3 : DP <= 80 ? 2 : 1;
  static constexpr int BQ = 64 * NCONS;
  static constexpr int BK = DP <= 80 ? 64 : 32;
  // width of a chunk of P.V's fresh accumulator
  static constexpr int PV_N = DP <= 80 ? DP : 40;
  static constexpr int NTHREADS = 128 * (NCONS + 1);
  static constexpr int NS = DP / 8;                   // k-steps (slices) of Q.K^T
  static constexpr int Q_SLICE = BQ * 32;
  static constexpr int K_SLICE = BK * 32;
  static constexpr int Q_BYTES = NS * Q_SLICE;        // Q's big part
  static constexpr int K_BYTES = NS * K_SLICE;        // K big, or K small, of a stage
  static constexpr int VT_BYTES = BK * DP * 4;        // V^T big, or V^T small
  static constexpr int STAGE = 2 * K_BYTES + 2 * VT_BYTES;
  static constexpr int FIT = (227 * 1024 - 1024 - 256 - Q_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static_assert(STAGES >= 2, "two stages must fit");
  static constexpr int BAR = Q_BYTES + STAGES * STAGE;
  static constexpr int BYTES = BAR + 8 * (1 + 3 * STAGES) + 1024;
};

// O += P V over one kv tile, columns [C0, DP): for each chunk of at most
// PV_N columns, the three products of every k-step of 8 kv into ``pv``
// (the first overwrites it), then pv added to O's columns on the CUDA
// cores. P is s (big part, as bits) and ps (small part) in the S
// accumulator's layout; V^T's k-step j is at 2 j DP 16 bytes (core matrices
// of 8 d x 4 kv, LBO = DP * 16 bytes, SBO = 128; 8 columns of d are 128
// bytes).
template <int DP, int BK, int C0 = 0>
__device__ __forceinline__ void pv_tile(float (&acc)[DP / 2], float (&pv)[Cfg<DP>::PV_N / 2],
                                        float (&s)[BK / 2], uint32_t (&ps)[BK / 2],
                                        uint32_t vtb, uint32_t vts) {
  constexpr int N = DP - C0 < Cfg<DP>::PV_N ? DP - C0 : Cfg<DP>::PV_N;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) fence_reg(pv[i]);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const uint32_t as[4] = {ps[4 * j], ps[4 * j + 2], ps[4 * j + 1], ps[4 * j + 3]};
    const uint32_t ab[4] = {__float_as_uint(s[4 * j]), __float_as_uint(s[4 * j + 2]),
                            __float_as_uint(s[4 * j + 1]), __float_as_uint(s[4 * j + 3])};
    const uint32_t off = 2 * j * DP * 16 + C0 * 16;
    Tf32<N>::rs(pv, as, desc_plain(vtb + off, DP * 16, 128), j > 0);
    Tf32<N>::rs(pv, ab, desc_plain(vts + off, DP * 16, 128), 1);
    Tf32<N>::rs(pv, ab, desc_plain(vtb + off, DP * 16, 128), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    fence_reg(pv[i]);
    acc[C0 / 2 + i] += pv[i];
  }
  if constexpr (C0 + N < DP) pv_tile<DP, BK, C0 + N>(acc, pv, s, ps, vtb, vts);
}

template <int DP, class Policy>
__global__ void __launch_bounds__(Cfg<DP>::NTHREADS, 1)
flash_f32_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk, const float* __restrict__ q,
                      const float* __restrict__ v, float* __restrict__ o, int Lq, int Lk,
                      int D, float scale, float smax, int clamp, int bf16_exp) {
  using C = Cfg<DP>;
  constexpr int NS = C::NS;
  constexpr int BK = C::BK;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;
  unsigned char* const base = smem_raw + (sq - raw);   // generic pointer of sq
  const uint32_t bars = sq + C::BAR;
  auto kfull = [&](int st) { return bars + 8u + 8u * st; };
  auto full = [&](int st) { return bars + 8u + 8u * (STAGES + st); };
  auto empty = [&](int st) { return bars + 8u + 8u * (2 * STAGES + st); };
  auto stage = [&](int st) { return (uint32_t)(C::Q_BYTES + st * C::STAGE); };  // offset
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * C::BQ;
  const int ntiles = (Lk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(kfull(st), 1);
      mbar_init(full(st), 96);              // every helper thread
      mbar_init(empty(st), 4 * C::NCONS);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------ producer warpgroup
    if constexpr (C::NCONS == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if constexpr (C::NCONS == 3) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bars, C::Q_BYTES);
      for (int c = 0; c < NS; ++c) tma_load_3d(sq + c * C::Q_SLICE, &mq, bars, 8 * c, q0, bh);
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(st), ((it / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(kfull(st), C::K_BYTES);
        for (int c = 0; c < NS; ++c)
          tma_load_3d(sq + stage(st) + c * C::K_SLICE, &mk, kfull(st), 8 * c, it * BK, bh);
      }
    } else if (threadIdx.x >= 32) {
      // helpers: V^T (big, small) from global memory, then K split in place
      const int h = threadIdx.x - 32;
      const float* vb = v + (size_t)bh * Lk * D;
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(st), ((it / STAGES) - 1) & 1);
        unsigned char* sb = base + stage(st);
        unsigned char* vtb = sb + 2 * C::K_BYTES;
        unsigned char* vts = vtb + C::VT_BYTES;
        // task: d columns 4nq..4nq+3 and the 4 kv of core-matrix column kq
        // (k-step kq / 2; kv 8 (kq / 2) + 2m + kq % 2 for m = 0..3)
        for (int task = h; task < (DP / 4) * (BK / 4); task += 96) {
          const int nq = task % (DP / 4);
          const int kq = task / (DP / 4);
          float4 r[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int kv = it * BK + 8 * (kq >> 1) + 2 * m + (kq & 1);
            r[m] = kv < Lk && 4 * nq < D
                       ? __ldg(reinterpret_cast<const float4*>(vb + (size_t)kv * D + 4 * nq))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x[4] = {(&r[0].x)[e], (&r[1].x)[e], (&r[2].x)[e], (&r[3].x)[e]};
            uint4 big, sml;
            big.x = to_tf32(x[0]); sml.x = small_of(x[0], big.x);
            big.y = to_tf32(x[1]); sml.y = small_of(x[1], big.y);
            big.z = to_tf32(x[2]); sml.z = small_of(x[2], big.z);
            big.w = to_tf32(x[3]); sml.w = small_of(x[3], big.w);
            const int off = kq * DP * 16 + (4 * nq + e) * 16;
            *reinterpret_cast<uint4*>(vtb + off) = big;
            *reinterpret_cast<uint4*>(vts + off) = sml;
          }
        }
        mbar_wait(kfull(st), (it / STAGES) & 1);
        uint4* kb = reinterpret_cast<uint4*>(sb);
        uint4* ks = reinterpret_cast<uint4*>(sb + C::K_BYTES);
        for (int i = h; i < C::K_BYTES / 16; i += 96) {
          const uint4 x = kb[i];
          uint4 big, sml;
          big.x = to_tf32(__uint_as_float(x.x)); sml.x = small_of(__uint_as_float(x.x), big.x);
          big.y = to_tf32(__uint_as_float(x.y)); sml.y = small_of(__uint_as_float(x.y), big.y);
          big.z = to_tf32(__uint_as_float(x.z)); sml.z = small_of(__uint_as_float(x.z), big.z);
          big.w = to_tf32(__uint_as_float(x.w)); sml.w = small_of(__uint_as_float(x.w), big.w);
          kb[i] = big;
          ks[i] = sml;
        }
        fence_proxy_async();                // seen by wgmma
        mbar_arrive(full(st));
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (C::NCONS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    if constexpr (C::NCONS == 3) asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int r0 = q0 + cw * 64 + warp * 16 + g;
    const int r1 = r0 + 8;

    // Q's small part: the A fragments of every k-step, from global memory
    uint32_t qs[NS][4];
    {
      const float* qg = q + (size_t)bh * Lq * D;
      auto ld = [&](int r, int c) { return r < Lq && c < D ? __ldg(qg + (size_t)r * D + c) : 0.f; };
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        const float x[4] = {ld(r0, 8 * c + t), ld(r1, 8 * c + t), ld(r0, 8 * c + t + 4),
                            ld(r1, 8 * c + t + 4)};
#pragma unroll
        for (int i = 0; i < 4; ++i) qs[c][i] = small_of(x[i], to_tf32(x[i]));
      }
    }
    // Q's big part: this consumer's rows of every slice, rounded in place
    const uint32_t qw = sq + cw * 64 * 32;
    mbar_wait(bars, 0);
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      uint4* p = reinterpret_cast<uint4*>(base + c * C::Q_SLICE + cw * 64 * 32) + tid;
      const uint4 x = *p;
      *p = make_uint4(to_tf32(__uint_as_float(x.x)), to_tf32(__uint_as_float(x.y)),
                      to_tf32(__uint_as_float(x.z)), to_tf32(__uint_as_float(x.w)));
    }
    fence_proxy_async();
    named_sync(1 + cw, 128);

    Policy pol(scale, smax, clamp, bf16_exp);
    float s[BK / 2];
    uint32_t ps[BK / 2];
    float acc[DP / 2];
    float pv[C::PV_N / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float corr[2] = {1.f, 1.f};

    for (int it = 0; it < ntiles; ++it) {
      const int st = it % STAGES;
      const uint32_t kb = sq + stage(st);
      const uint32_t ks = kb + C::K_BYTES;
      const uint32_t vtb = ks + C::K_BYTES;
      const uint32_t vts = vtb + C::VT_BYTES;
      mbar_wait(full(st), (it / STAGES) & 1);

      // S = Qs Kb + Qb Ks + Qb Kb
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) fence_reg(s[i]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NS; ++c)
        Tf32<BK>::rs(s, qs[c], desc_b32(kb + c * C::K_SLICE, 16, 256), c > 0);
#pragma unroll
      for (int c = 0; c < NS; ++c)
        Tf32<BK>::ss(s, desc_b32(qw + c * C::Q_SLICE, 16, 256),
                     desc_b32(ks + c * C::K_SLICE, 16, 256), 1);
#pragma unroll
      for (int c = 0; c < NS; ++c)
        Tf32<BK>::ss(s, desc_b32(qw + c * C::Q_SLICE, 16, 256),
                     desc_b32(kb + c * C::K_SLICE, 16, 256), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) fence_reg(s[i]);

      pol.exps(s, Lk - it * BK, t, corr);
      if constexpr (Policy::RESCALES) {
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      }
      // P's big part replaces p in s (as bits); its small part goes to ps
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const uint32_t big = to_tf32(s[i]);
        ps[i] = small_of(s[i], big);
        s[i] = __uint_as_float(big);
      }

      // O += Ps Vb + Pb Vs + Pb Vb, through the tile's fresh accumulator
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        fence_reg(s[i]);
        fence_reg(ps[i]);
      }
      pv_tile<DP, BK>(acc, pv, s, ps, vtb, vts);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        fence_reg(s[i]);
        fence_reg(ps[i]);
      }
      if (lane == 0) mbar_arrive(empty(st));  // this warp is done with stage st
    }

    float inv[2];
    pol.finish(inv);
    float* ob = o + (size_t)bh * Lq * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;          // D % 4 == 0: col < D covers col + 1
      if (col < D) {
        if (r0 < Lq)
          *reinterpret_cast<float2*>(ob + (size_t)r0 * D + col) =
              make_float2(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
        if (r1 < Lq)
          *reinterpret_cast<float2*>(ob + (size_t)r1 * D + col) =
              make_float2(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
      }
    }
  }
}

// A contiguous [bh, L, D] fp32 tensor as a 3-d tensor map whose box is one
// 8-column slice of ``rows`` rows, 32-byte swizzled; the TMA fills columns
// past D and rows past L with zeros.
inline bool tensor_map_f32(CUtensorMap* map, const void* ptr, int bh, int L, int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)L * D * 4};
  const cuuint32_t box[3] = {8, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, class Policy>
cudaError_t launch_sm90_dp(const void* q, const void* k, const void* v, void* o, int bh, int Lq,
                           int Lk, int D, float scale, float smax, int clamp, int bf16_exp,
                           cudaStream_t stream) {
  using C = Cfg<DP>;
  CUtensorMap mq, mk;
  if (!tensor_map_f32(&mq, q, bh, Lq, D, C::BQ) || !tensor_map_f32(&mk, k, bh, Lk, D, C::BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_f32_sm90_kernel<DP, Policy>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + C::BQ - 1) / C::BQ, bh);
  flash_f32_sm90_kernel<DP, Policy><<<grid, C::NTHREADS, C::BYTES, stream>>>(
      mq, mk, static_cast<const float*>(q), static_cast<const float*>(v),
      static_cast<float*>(o), Lq, Lk, D, scale, smax, clamp, bf16_exp);
  return cudaGetLastError();
}

// q, k, v, o: contiguous fp32 [bh, L, D], D % 4 == 0, D <= 160, 16-byte
// aligned; D is padded to the next width of {8, 16, 24, 32, 40, 48, 64, 80,
// 96, 128, 160}.
template <class Policy>
cudaError_t launch_sm90(const void* q, const void* k, const void* v, void* o, int bh, int Lq,
                        int Lk, int D, float scale, float smax, int clamp, int bf16_exp,
                        cudaStream_t s) {
  if (D % 4 != 0 || D < 4 || D > 160) return cudaErrorInvalidValue;
#define MDU_F32_SM90(DP)                                                                     \
  if (D <= DP)                                                                               \
    return launch_sm90_dp<DP, Policy>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, bf16_exp, s);
  MDU_F32_SM90(8) MDU_F32_SM90(16) MDU_F32_SM90(24) MDU_F32_SM90(32) MDU_F32_SM90(40)
  MDU_F32_SM90(48) MDU_F32_SM90(64) MDU_F32_SM90(80) MDU_F32_SM90(96) MDU_F32_SM90(128)
  MDU_F32_SM90(160)
#undef MDU_F32_SM90
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------ the wide form

namespace wide {

constexpr int BQ = 32;
constexpr int BK = 32;
constexpr int NWARPS = 8;

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (four elements) and a B fragment (two) split into their big
// and small parts
struct Split4 {
  uint32_t big[4], small[4];
  Split4() = default;
  __device__ __forceinline__ Split4(float x0, float x1, float x2, float x3) {
    const float x[4] = {x0, x1, x2, x3};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      big[i] = to_tf32(x[i]);
      small[i] = small_of(x[i], big[i]);
    }
  }
};
struct Split2 {
  uint32_t big[2], small[2];
  Split2() = default;
  __device__ __forceinline__ Split2(float x0, float x1) {
    big[0] = to_tf32(x0);
    small[0] = small_of(x0, big[0]);
    big[1] = to_tf32(x1);
    small[1] = small_of(x1, big[1]);
  }
};

// c[m][n0 + n] += a[m] b[n] in three passes (small.big, big.small,
// big.big), each pass over the M x N independent accumulators in turn
template <int M, int N, int NC>
__device__ __forceinline__ void mma3(float (&c)[M][NC][4], int n0, const Split4 (&a)[M],
                                     const Split2 (&b)[N]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(c[m][n0 + n], a[m].small, b[n].big[0], b[n].big[1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(c[m][n0 + n], a[m].big, b[n].small[0], b[n].small[1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma_tf32(c[m][n0 + n], a[m].big, b[n].big[0], b[n].big[1]);
}

template <int DP>
struct WCfg {
  static constexpr int LDQ = DP + 8;   // 8-byte fragment loads: 8 rows, 8 banks apart
  static constexpr int LDK = DP + 8;
  static constexpr int LDV = DP + 4;   // 4-byte loads of rows 2t, 2t + 1: 4 banks apart
  static constexpr int DQ = DP / NWARPS;   // the D slice of one warp
  static constexpr int TILE = BQ * BK;     // one 32 x 32 score tile (floats)
  static constexpr int BYTES = (BQ * LDQ + BK * LDK + BK * LDV + NWARPS * TILE) * 4;
};

// Element (r, c) of a 32 x 32 score tile in shared memory. The pairs and
// quads of a row that the products and the softmax move stay together, and
// the xor spreads the rows g = 0..3 that a half warp writes over all banks.
__device__ __forceinline__ int sidx(int r, int c) { return r * BK + (c ^ ((r & 3) << 3)); }

// Rows [row0, row0 + ROWS) of a row-major [L, D] fp32 matrix into a shared
// tile of ROWS x DP (row stride ld) with 16-byte cp.async copies; rows past L
// and columns past D are zero-filled. Commits no group.
template <int ROWS, int DP>
__device__ __forceinline__ void load_async(float* sm, int ld, const float* g, int row0, int L,
                                           int D) {
  constexpr int CH = DP / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += NWARPS * 32) {
    const int r = i / CH;
    const int c = (i % CH) * 4;
    const bool in = row0 + r < L && c < D;
    cp_async_16(sm + r * ld + c, in ? g + (size_t)(row0 + r) * D + c : g, in ? 16 : 0);
  }
}

template <int DP, class Policy>
__global__ void __launch_bounds__(NWARPS * 32, 1)
flash_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int Lq, int Lk, int D,
                      float scale, float smax, int clamp, int bf16_exp) {
  using C = WCfg<DP>;
  constexpr int DQ = C::DQ;
  constexpr int NJ = DQ / 8;            // k-steps of Q.K^T and 8-column tiles of O, a warp
  constexpr int NT = BK / 8;            // 8-column tiles of a score tile
  static_assert(BQ == 32 && BK == 32 && NWARPS * 32 == BQ * BK / 4,
                "the softmax takes 4 scores a thread; sidx a 32-column tile");
  constexpr int JG = NJ % 4 == 0 ? 4 : 2;  // O tiles per group of products
  extern __shared__ float4 wide_smem[];
  float* Qs = reinterpret_cast<float*>(wide_smem);
  float* Ks = Qs + BQ * C::LDQ;
  float* Vs = Ks + BK * C::LDK;
  float* Sp = Vs + BK * C::LDV;         // [NWARPS] partial score tiles
  float* Ps = Ks;                       // P of the tile, once Q.K^T is done with K
  float* rows_s = Ks + C::TILE;         // a factor per row: corr, then 1 / den

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int d0 = warp * DQ;
  const int rr = threadIdx.x / 8;       // softmax: row rr, columns cc .. cc + 3
  const int cc = (threadIdx.x % 8) * 4;
  const float* kb = k + (size_t)bh * Lk * D;
  const float* vb = v + (size_t)bh * Lk * D;

  load_async<BQ, DP>(Qs, C::LDQ, q + (size_t)bh * Lq * D, q0, Lq, D);
  cp_async_commit();

  Policy pol(scale, smax, clamp, bf16_exp);
  float acc[2][NJ][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
  // Within each 8 columns of d (Q.K^T) and of kv (P.V), fragment position k
  // holds column 2 (k % 4) + k / 4, so a thread's a and b elements are the
  // pairs (2t, 2t + 1), and the score accumulator's {s0, s2, s1, s3} is an
  // A fragment as it stands.
  const float* qw = Qs + g * C::LDQ + d0 + 2 * t;
  const float* kw = Ks + g * C::LDK + d0 + 2 * t;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();                    // the previous tile is no longer read
    load_async<BK, DP>(Ks, C::LDK, kb, k0, Lk, D);
    cp_async_commit();
    load_async<BK, DP>(Vs, C::LDV, vb, k0, Lk, D);
    cp_async_commit();
    cp_async_wait<1>();                 // Q and K have landed; V is in flight
    __syncthreads();

    // partial scores of all 32 rows over this warp's slice of d
    float sp[2][NT][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) sp[m][n][0] = sp[m][n][1] = sp[m][n][2] = sp[m][n][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < NJ; ++kk) {
      Split4 a[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float2 x0 = *reinterpret_cast<const float2*>(qw + 16 * m * C::LDQ + 8 * kk);
        const float2 x1 = *reinterpret_cast<const float2*>(qw + (16 * m + 8) * C::LDQ + 8 * kk);
        a[m] = Split4(x0.x, x1.x, x0.y, x1.y);
      }
      Split2 b[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(kw + 8 * n * C::LDK + 8 * kk);
        b[n] = Split2(y.x, y.y);
      }
      mma3(sp, 0, a, b);
    }
    float* mine = Sp + warp * C::TILE;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        *reinterpret_cast<float2*>(mine + sidx(16 * m + g, 8 * n + 2 * t)) =
            make_float2(sp[m][n][0], sp[m][n][1]);
        *reinterpret_cast<float2*>(mine + sidx(16 * m + g + 8, 8 * n + 2 * t)) =
            make_float2(sp[m][n][2], sp[m][n][3]);
      }
    cp_async_wait<0>();                 // V, visible to all after the barrier
    __syncthreads();

    // the full scores of row rr, columns cc.., summed over the warps in a
    // fixed order; the softmax; P and the row's factor into shared memory
    {
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const float4 p4 = *reinterpret_cast<const float4*>(Sp + w * C::TILE + sidx(rr, cc));
        s4[0] += p4.x; s4[1] += p4.y; s4[2] += p4.z; s4[3] += p4.w;
      }
      float corr = 1.f;
      pol.row4(s4, cc, Lk - k0, corr);
      *reinterpret_cast<float4*>(Ps + sidx(rr, cc)) = make_float4(s4[0], s4[1], s4[2], s4[3]);
      if (cc == 0) rows_s[rr] = corr;
    }
    __syncthreads();

    if constexpr (Policy::RESCALES) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float c0 = rows_s[16 * m + g], c1 = rows_s[16 * m + g + 8];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[m][j][0] *= c0; acc[m][j][1] *= c0;
          acc[m][j][2] *= c1; acc[m][j][3] *= c1;
        }
      }
    }
    // O += P V over this warp's slice of d, 8 kv at a time, through a
    // fresh accumulator (O's accumulation, above)
    float pv[2][NJ][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NJ; ++j) pv[m][j][0] = pv[m][j][1] = pv[m][j][2] = pv[m][j][3] = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      Split4 a[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float2 x0 = *reinterpret_cast<const float2*>(Ps + sidx(16 * m + g, 8 * n + 2 * t));
        const float2 x1 =
            *reinterpret_cast<const float2*>(Ps + sidx(16 * m + g + 8, 8 * n + 2 * t));
        a[m] = Split4(x0.x, x1.x, x0.y, x1.y);
      }
      const float* v0 = Vs + (8 * n + 2 * t) * C::LDV + d0 + g;
#pragma unroll
      for (int j0 = 0; j0 < NJ; j0 += JG) {
        Split2 b[JG];
#pragma unroll
        for (int j = 0; j < JG; ++j) b[j] = Split2(v0[8 * (j0 + j)], v0[C::LDV + 8 * (j0 + j)]);
        mma3(pv, j0, a, b);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] += pv[m][j][i];
  }

  __syncthreads();                      // P and the factors are no longer read
  const float inv = pol.finish_row4();
  if (cc == 0) rows_s[rr] = inv;
  __syncthreads();
  float* ob = o + (size_t)bh * Lq * D;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int r0 = 16 * m + g;
    const float i0 = rows_s[r0], i1 = rows_s[r0 + 8];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = d0 + 8 * j + 2 * t;      // D % 4 == 0: col < D covers col + 1
      if (col < D) {
        if (q0 + r0 < Lq)
          *reinterpret_cast<float2*>(ob + (size_t)(q0 + r0) * D + col) =
              make_float2(acc[m][j][0] * i0, acc[m][j][1] * i0);
        if (q0 + r0 + 8 < Lq)
          *reinterpret_cast<float2*>(ob + (size_t)(q0 + r0 + 8) * D + col) =
              make_float2(acc[m][j][2] * i1, acc[m][j][3] * i1);
      }
    }
  }
}

template <int DP, class Policy>
cudaError_t launch_dp(const void* q, const void* k, const void* v, void* o, int bh, int Lq,
                      int Lk, int D, float scale, float smax, int clamp, int bf16_exp,
                      cudaStream_t stream) {
  const int smem = WCfg<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_f32_wide_kernel<DP, Policy>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, bh);
  flash_f32_wide_kernel<DP, Policy><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Lq, Lk, D, scale, smax, clamp, bf16_exp);
  return cudaGetLastError();
}

}  // namespace wide

// q, k, v, o: contiguous fp32 [bh, L, D], D % 4 == 0, 160 < D <= 512,
// 16-byte aligned; D is padded to 256, 384 or 512.
template <class Policy>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, int bh, int Lq,
                        int Lk, int D, float scale, float smax, int clamp, int bf16_exp,
                        cudaStream_t s) {
  if (D % 4 != 0 || D <= 160 || D > 512) return cudaErrorInvalidValue;
  if (D <= 256)
    return wide::launch_dp<256, Policy>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, bf16_exp, s);
  if (D <= 384)
    return wide::launch_dp<384, Policy>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, bf16_exp, s);
  return wide::launch_dp<512, Policy>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, bf16_exp, s);
}

}  // namespace f32
}  // namespace mdu
