// The attention backward on Hopper's tensor cores (sm_90a): the forms
// bf16_sm90 (wgmma in bf16) and f32_sm90 (wgmma in TF32, three passes) of the
// gradient that flash_attention_bwd.cu computes on the CUDA cores. Built as two
// libraries, flash_attention_bwd_bf16.cu and flash_attention_bwd_f32.cu.
//
// Replaces no TPU kernel: the Pallas kernels of
// mdu_tpu/ops/pallas/flash_attention.py have no backward (``pallas_call`` has
// no transpose rule). It exists so that a train step on the card keeps the
// gradient of every long self-attention (ops/kernels/flash.py wraps #1-#3 in
// an autograd function whose backward this is). The function is that of the
// CUDA-core form: the gradient of exact softmax attention on contiguous
// [bh, L, D], ``scale`` as given, fp32 accumulation, the gradients in the
// inputs' dtype. With P = exp(S scale - lse), delta = rowsum(dO o O):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - delta),
//   dQ = scale dS K,  dK = scale dS^T Q.
//
// Two launches a call, no float atomics (both gradients come out the same in
// every run), never the [Lq, Lk] matrix in device memory:
//   dq    one block per (bh, BA query rows): sweeps the kv tiles twice. The
//         first sweep is the log-sum-exp pre-pass on the tensor cores (S =
//         Q K^T, online max and sum); it writes each row's lse (log2 domain)
//         and delta (from O and dO) to a scratch of bh x Lq_pad rows (Lq
//         padded to 64). The second recomputes S and dP = dO V^T and runs
//         dQ += dS K.
//   dkdv  one block per (bh, BA kv rows): sweeps the query tiles once,
//         computing S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T sit in
//         registers as the A operand of dV += P^T dO and dK += dS^T Q; each
//         tile's lse and delta come in beside it by a bulk copy.
// The fixed operands of a block (dq: Q and dO; dkdv: K and V) are loaded once
// by the TMA; the streamed ones (dq: K and V; dkdv: Q and dO) come into a ring
// of STAGES shared-memory stages, as 32-byte swizzled column slices of BT rows
// (16 bf16 or 8 fp32 columns: one k-step of the first products), with
// "full" and "empty" mbarriers. Ragged Lq and Lk: the TMA zero-fills rows
// past L and columns past D; P is 0 at streamed columns past L.
//
// What bounds it on an H100: the work. check_attention_bwd counts 12 B H Lq Lk
// D operations (the five [L, L, D] products of dQ, dK, dV and dP with the
// recomputed Q K^T: 2.5x the forward's products and one more); these kernels
// run 16 (S three times, dP twice, dV, dK, dQ), at 989 TFLOP/s in bf16 and at
// 495 / 3 in fp32 (each product three TF32 passes). The bytes (q, k, v, O, dO
// read, dQ, dK, dV written) are a few microseconds at 3.35 TB/s. Beside the
// products run the exps (3 Lq Lk per head: the pre-pass, dq, dkdv) on the
// MUFU pipe, 16 a clock per SM, and in fp32 the split of every operand into
// big and small parts.
//
// ---------------------------------------------------------------- bf16_sm90
// bf16 q, k, v, O, dO with D % 8 == 0, 16 <= D <= 160 and 16-byte aligned
// q, k, v, dO. D is padded to DP, the next multiple of 16, by the TMA's zero
// fill (D = 40: 48, the 8 zero columns are 1/6 of every product).
// A block: a producer warpgroup (one thread issues every TMA load; setmaxnreg
// 24) and two consumer warpgroups (240 registers) of 64 fixed rows each, BA =
// 128. Streamed tiles of BT = 64 rows (dkdv above DP = 80: 32, so that dK and
// dV, 2 x DP / 2 floats a thread, fit beside the tiles' products), two to four
// stages. The first products are wgmma m64nBTk16 with both operands from
// shared memory, K-major. P and dS go from the accumulator into the register
// A fragments of the second products, whose B operand (dq: K; dkdv: dO and
// Q) is the same stage's slices read MN-major (transposed descriptor), as the
// forward's P.V reads V. dQ, dK and dV accumulate in the tensor cores'
// registers over every tile.
// P and dS each go in as two bf16 passes, big = bf16(x) and small = bf16(x -
// big), not rounded once to bf16 as flash backwards usually do: rounded once,
// the gradients' largest error came out 0.9-3.0x the bf16 plain version's own
// (which rounds p but keeps dS and every product in fp32), past the bar of 2x
// + 1e-3 of the largest entry at [2, 8, 4096, 40] (dV 9.47e-3 against 7.40e-3;
// the kernel matched an fp32 emulation of that arithmetic to the output's
// rounding, so the rounding, not a fault, was the cause). With the split the
// ratio was 0.7-1.4x, for 20 % more time (0.685 -> 0.824 ms there, H100 80GB
// HBM3, 700 W).
//
// ----------------------------------------------------------------- f32_sm90
// fp32 inputs with D % 4 == 0, D <= 160 and 16-byte aligned q, k, v, dO. D is
// padded to DP, a multiple of 8 (one tf32 k-step), by the TMA's zero fill.
// Every product runs as three TF32 passes (small.big + big.small + big.big,
// small terms first) with the split of flash_attention_f32_sm90.cuh: big =
// tf32(x) in integer operations, small = x - big, exact in fp32.
// - tf32 wgmma reads B K-major only. The first products' B (the streamed
//   tiles, K-major in d) come by the TMA, and three helper warps of the
//   producer warpgroup round each slice in place to its big part and write
//   its small part beside it. The second products' B (dq: K; dkdv: Q and dO)
//   has the streamed rows as its K dimension, so the helpers also write each
//   of them transposed, big and small, from global memory (L2), in core
//   matrices of 8 d x 4 rows (LBO = DP * 16 bytes, SBO = 128), each group of 8
//   rows permuted (position k' holds row 2 (k' % 4) + k' / 4) so that the
//   accumulator's registers {x0, x2, x1, x3} of each 8 columns are a tf32 A
//   fragment as they stand (the forward's V^T).
// - The fixed operands: their big parts in shared memory (rounded in place by
//   their consumer), their small parts as register A fragments where the
//   registers allow it (the forward's Q), else in shared memory beside the
//   big parts (both operands of every pass from shared memory).
// - How fp32 holds 1e-4 of each gradient's largest entry: the tensor cores
//   add into fp32 with truncation, and dK, dV sum over every query tile (64
//   tiles at 4096 rows), dQ over every kv tile; the forward found such a
//   chain drifts past 1e-4 on a sharp softmax. So each tile's second product
//   runs into a fresh accumulator (a chain of at most 3 BT / 8 products, in
//   chunks of at most 40 columns), which the CUDA cores add to dQ, dK or dV in
//   fp32. The first products are chains of 3 DP / 8 over d, as in the forward.
// Consumers, tiles and stages by DP (registers a consumer thread: the first
// products' S and dP and P's or dS's small part, 3 BT / 2; dQ, or dK and dV,
// DP / 2 each; the fresh accumulator, at most 20; the fixed operands' small
// parts in registers, DP / 2 each):
// - DP <= 40: two consumers (232 registers; the producer warpgroup keeps 40),
//   BA = 128, BT = 64, both small parts in registers; dq three stages (60 KB
//   each: K and V big and small, K^T big and small), dkdv two (80 KB: Q and dO
//   big and small, Q^T and dO^T big and small).
// - DP = 48, 64: two consumers, BT = 32, both small parts in registers, two
//   or three stages (at D = 64 one consumer of BT = 32 took 8.7 ms at [2, 10,
//   4096, 64], two 5.6; H100 80GB HBM3, 700 W).
// - DP = 80: one consumer (BA = 64: up to 255 registers), BT = 32; dq keeps
//   both small parts in registers (188 registers), three stages; dkdv keeps
//   K's in registers and V's in shared memory (dK and dV take 80), two stages.
// - DP > 80: one consumer, both small parts in shared memory (up to 160 KB
//   at DP = 160), dq BT = 16 and dkdv BT = 8 with one to four stages: the
//   widest heads fit, at a low rate (the narrow first products read A from
//   shared memory for every 8 columns of the tile).
#pragma once

#include "flash_attention_f32_sm90.cuh"
#include "flash_attention_sm90.cuh"
#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace mdu {
namespace bwd {

using namespace mdu::sm90;

// s as the bf16 A fragments of two passes: s packed to bf16 into ``big``,
// and what the rounding left (s - big, which s keeps) packed into ``small``
template <int N>
__device__ __forceinline__ void pack_split(float (&s)[N], uint32_t (&big)[N / 2],
                                           uint32_t (&small)[N / 2]) {
  pack(s, big);
#pragma unroll
  for (int m = 0; m < N / 2; ++m) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&big[m]));
    s[2 * m] -= f.x;
    s[2 * m + 1] -= f.y;
  }
  pack(s, small);
}

// ------------------------------------------------------------ PTX helpers

// X (+)= A B^T in bf16, m64n64k16 and m64n32k16: A and B from shared memory,
// both K-major.
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[16], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(x[i]);
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(x[i]);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// ------------------------------------------------------ the tiles' arithmetic
//
// A thread's share of an m64nN accumulator: x[i] is row g + 8 ((i >> 1) & 1),
// column 8 (i / 4) + 2t + (i & 1) of its warp's 16 rows (g = lane / 4, t =
// lane % 4). The rows are the block's fixed rows, the columns a streamed tile's.

__device__ __forceinline__ int col_of(int i, int t) { return 8 * (i / 4) + 2 * t + (i & 1); }

// delta = rowsum(dO o O) of rows r0 and r1 (< L), its terms split over the
// four lanes of a quad
template <typename T>
__device__ __forceinline__ void row_delta(float (&dl)[2], const T* o, const T* dout, int r0,
                                          int r1, int L, int D, int t) {
  const int rows[2] = {r0, r1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
    if (rows[h] < L)
      for (int d = t; d < D; d += 4)
        s = fmaf(to_float(o[(size_t)rows[h] * D + d]), to_float(dout[(size_t)rows[h] * D + d]), s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    dl[h] = s;
  }
}

// The pre-pass over one tile of scores: the running max m and sum l (log2
// domain, sc = scale log2(e)) of rows g and g + 8, columns at or past
// ``valid`` left out. The four lanes of a quad hold the same m.
template <int N>
__device__ __forceinline__ void online(const float (&s)[N], float sc, int valid, int t,
                                       float (&m)[2], float (&l)[2]) {
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (col_of(i, t) < valid) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i] * sc);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    l[r] *= ex2(m[r] - mn);
    m[r] = mn;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (col_of(i, t) < valid) l[(i >> 1) & 1] += ex2(fmaf(s[i], sc, -m[(i >> 1) & 1]));
}

// Each row's lse (log2 domain) from the pre-pass, and with delta into the
// scratch (rows below Lq_pad: the padded rows' values are finite, and the
// dkdv kernel masks their columns)
__device__ __forceinline__ void finish_lse(float (&lse_r)[2], const float (&m)[2], float (&l)[2],
                                           const float (&dl)[2], float* lse, float* delta,
                                           size_t row0, int r0, int r1, int Lq_pad, int t) {
  const int rows[2] = {r0, r1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    lse_r[h] = m[h] + log2f(l[h]);
    if (t == 0 && rows[h] < Lq_pad) {
      lse[row0 + rows[h]] = lse_r[h];
      delta[row0 + rows[h]] = dl[h];
    }
  }
}

// P and dS of one tile in place (s -> P, dp -> dS): P = 2^(s sc - lse), dS =
// P (dP - delta), both 0 at columns at or past ``valid``. The statistics are
// those of rows g, g + 8 (dq: lse_r, delta_r) or, with COLS, of each column,
// from the tile's vectors in shared memory (dkdv).
template <bool COLS, int N>
__device__ __forceinline__ void p_ds(float (&s)[N], float (&dp)[N], float sc, int valid, int t,
                                     const float (&lse_r)[2], const float (&delta_r)[2],
                                     const float* lse_c, const float* delta_c) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = col_of(i, t);
    const float lse = COLS ? lse_c[c] : lse_r[(i >> 1) & 1];
    const float de = COLS ? delta_c[c] : delta_r[(i >> 1) & 1];
    const float p = c < valid ? ex2(fmaf(s[i], sc, -lse)) : 0.f;
    s[i] = p;
    dp[i] = p * (dp[i] - de);
  }
}

// ------------------------------------------------------------------- bf16

// The bf16 block at padded width DP (a multiple of 16). Shared memory: the
// fixed operands' slices (A0, A1), STAGES stages (B0's slices, B1's slices,
// dkdv: the tile's lse and delta), then the mbarriers (fixed, full[STAGES],
// empty[STAGES]); 1 KB of slack to align the base to 1 KB.
template <int DP, bool DKDV>
struct CfgB {
  static constexpr int NCONS = 2;
  static constexpr int BA = 64 * NCONS;
  static constexpr int BT = DKDV && DP > 80 ? 32 : 64;
  static constexpr int NTHREADS = 128 * (NCONS + 1);
  static constexpr int NS = DP / 16;
  static constexpr int A_SLICE = BA * 32;
  static constexpr int B_SLICE = BT * 32;
  static constexpr int A_BYTES = NS * A_SLICE;
  static constexpr int B_BYTES = NS * B_SLICE;
  static constexpr int STATS = DKDV ? 8 * BT : 0;
  static constexpr int STAGE = (2 * B_BYTES + STATS + 1023) / 1024 * 1024;
  static constexpr int FIT = (227 * 1024 - 1024 - 256 - 2 * A_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static_assert(STAGES >= 2, "two stages must fit");
  static constexpr int BAR = 2 * A_BYTES + STAGES * STAGE;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// acc += W B over one tile: W (64 x BT) the packed bf16 A fragments, B (BT x
// DP) the stage's 16-column slices of BT rows at ``b``, read MN-major
template <int DP, int BT>
__device__ __forceinline__ void prod_bf16(float (&acc)[DP / 2], const uint32_t (&w)[BT / 4],
                                          uint32_t b) {
  constexpr int SL = BT * 32;
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    const uint32_t a[4] = {w[4 * kk], w[4 * kk + 1], w[4 * kk + 2], w[4 * kk + 3]};
    const uint32_t bk = b + kk * 16 * 32;   // rows 16 kk.. of every slice
    if constexpr (DP == 48) {
      wgmma_rs_n48(acc, a, desc_b32(bk, SL, 256));
    } else if constexpr (DP == 64) {
      wgmma_rs_n64(acc, a, desc_b32(bk, SL, 256));
    } else if constexpr (DP == 80) {
      wgmma_rs_n80(acc, a, desc_b32(bk, SL, 256));
    } else {
#pragma unroll
      for (int c = 0; c < DP / 16; ++c)
        wgmma_rs_n16(acc + 8 * c, a, desc_b32(bk + c * SL, SL, 256));
    }
  }
}

template <int DP, bool DKDV>
__global__ void __launch_bounds__(CfgB<DP, DKDV>::NTHREADS, 1)
bwd_bf16_kernel(const __grid_constant__ CUtensorMap ma0, const __grid_constant__ CUtensorMap ma1,
                const __grid_constant__ CUtensorMap mb0, const __grid_constant__ CUtensorMap mb1,
                const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                float* __restrict__ lse, float* __restrict__ delta,
                __nv_bfloat16* __restrict__ out0, __nv_bfloat16* __restrict__ out1, int Lq,
                int Lk, int D, int Lq_pad, float scale) {
  using C = CfgB<DP, DKDV>;
  constexpr int NS = C::NS;
  constexpr int BT = C::BT;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sb = (raw + 1023u) & ~1023u;
  const unsigned char* const base = smem_raw + (sb - raw);
  const uint32_t bars = sb + C::BAR;
  auto full = [&](int st) { return bars + 8u + 8u * st; };
  auto empty = [&](int st) { return bars + 8u + 8u * (STAGES + st); };
  auto stage = [&](int st) { return (uint32_t)(2 * C::A_BYTES + st * C::STAGE); };  // offset
  const int bh = blockIdx.y;
  const int a0 = blockIdx.x * C::BA;
  const int LA = DKDV ? Lk : Lq;
  const int LB = DKDV ? Lq : Lk;
  const int ntiles = (LB + BT - 1) / BT;
  const int nit = DKDV ? ntiles : 2 * ntiles;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * C::NCONS);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bars, 2 * C::A_BYTES);
      for (int c = 0; c < NS; ++c) {
        tma_load_3d(sb + c * C::A_SLICE, &ma0, bars, 16 * c, a0, bh);
        tma_load_3d(sb + C::A_BYTES + c * C::A_SLICE, &ma1, bars, 16 * c, a0, bh);
      }
      for (int it = 0; it < nit; ++it) {
        const int st = it % STAGES;
        const int tile = it % ntiles;
        const bool second = DKDV || it >= ntiles;   // the dq pre-pass needs K alone
        if (it >= STAGES) mbar_wait(empty(st), ((it / STAGES) - 1) & 1);
        const uint32_t s0 = sb + stage(st);
        mbar_arrive_expect_tx(full(st), (second ? 2 : 1) * C::B_BYTES + C::STATS);
        for (int c = 0; c < NS; ++c) {
          tma_load_3d(s0 + c * C::B_SLICE, &mb0, full(st), 16 * c, tile * BT, bh);
          if (second)
            tma_load_3d(s0 + C::B_BYTES + c * C::B_SLICE, &mb1, full(st), 16 * c, tile * BT, bh);
        }
        if constexpr (DKDV) {
          const size_t g = (size_t)bh * Lq_pad + (size_t)tile * BT;
          bulk_load(s0 + 2 * C::B_BYTES, lse + g, 4 * BT, full(st));
          bulk_load(s0 + 2 * C::B_BYTES + 4 * BT, delta + g, 4 * BT, full(st));
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int r0 = a0 + cw * 64 + warp * 16 + g;   // the thread's fixed rows r0, r1
    const int r1 = r0 + 8;
    const uint32_t aw = sb + cw * 64 * 32;          // this consumer's rows of a slice
    const float sc = scale * LOG2E;
    float dl[2] = {0.f, 0.f};
    if constexpr (!DKDV)
      row_delta(dl, o + (size_t)bh * Lq * D, dout + (size_t)bh * Lq * D, r0, r1, Lq, D, t);
    float x[BT / 2], y[BT / 2];                     // S (S^T), dP (dP^T); then P, dS
    uint32_t pp[BT / 4], ps[DKDV ? BT / 4 : 1];     // P packed to bf16: big, small
    uint32_t pd[BT / 4], ds[BT / 4];                // dS packed to bf16: big, small
    float acc0[DP / 2];                             // dQ or dK
    float acc1[DKDV ? DP / 2 : 1];                  // dV
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (DKDV ? DP / 2 : 1); ++i) acc1[i] = 0.f;
    float lse_r[2] = {0.f, 0.f};
    mbar_wait(bars, 0);

    int it = 0;
    if constexpr (!DKDV) {
      // the pre-pass: each row's lse over every kv tile
      float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
      for (; it < ntiles; ++it) {
        const int st = it % STAGES;
        const uint32_t s0 = sb + stage(st);
        mbar_wait(full(st), (it / STAGES) & 1);
        fence_regs(x);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NS; ++c)
          wgmma_ss_bf16(x, desc_b32(aw + c * C::A_SLICE, 16, 256),
                        desc_b32(s0 + c * C::B_SLICE, 16, 256), c > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(x);
        if (lane == 0) mbar_arrive(empty(st));
        online(x, sc, LB - it * BT, t, m, l);
      }
      finish_lse(lse_r, m, l, dl, lse, delta, (size_t)bh * Lq_pad, r0, r1, Lq_pad, t);
    }
    for (; it < nit; ++it) {
      const int st = it % STAGES;
      const int tile = it % ntiles;
      const uint32_t s0 = sb + stage(st);
      mbar_wait(full(st), (it / STAGES) & 1);
      fence_regs(x);
      fence_regs(y);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NS; ++c)
        wgmma_ss_bf16(x, desc_b32(aw + c * C::A_SLICE, 16, 256),
                      desc_b32(s0 + c * C::B_SLICE, 16, 256), c > 0);
#pragma unroll
      for (int c = 0; c < NS; ++c)
        wgmma_ss_bf16(y, desc_b32(aw + C::A_BYTES + c * C::A_SLICE, 16, 256),
                      desc_b32(s0 + C::B_BYTES + c * C::B_SLICE, 16, 256), c > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      fence_regs(y);
      const float* stats = reinterpret_cast<const float*>(base + stage(st) + 2 * C::B_BYTES);
      p_ds<DKDV>(x, y, sc, LB - tile * BT, t, lse_r, dl, stats, stats + BT);
      pack_split(y, pd, ds);
      fence_regs(acc0);
      fence_regs(pd);
      fence_regs(ds);
      if constexpr (DKDV) {
        pack_split(x, pp, ps);
        fence_regs(acc1);
        fence_regs(pp);
        fence_regs(ps);
      }
      wgmma_fence();
      if constexpr (DKDV) {                         // dV += P^T dO, small part first
        prod_bf16<DP, BT>(acc1, ps, s0 + C::B_BYTES);
        prod_bf16<DP, BT>(acc1, pp, s0 + C::B_BYTES);
      }
      prod_bf16<DP, BT>(acc0, ds, s0);             // dK += dS^T Q, or dQ += dS K
      prod_bf16<DP, BT>(acc0, pd, s0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc0);
      fence_regs(pd);
      fence_regs(ds);
      if constexpr (DKDV) {
        fence_regs(acc1);
        fence_regs(pp);
        fence_regs(ps);
      }
      if (lane == 0) mbar_arrive(empty(st));        // this warp is done with stage st
    }

    const size_t off = (size_t)bh * LA * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;                // D % 8 == 0: col < D covers col + 1
      if (col < D) {
        if (r0 < LA)
          *reinterpret_cast<__nv_bfloat162*>(out0 + off + (size_t)r0 * D + col) =
              __floats2bfloat162_rn(acc0[4 * j] * scale, acc0[4 * j + 1] * scale);
        if (r1 < LA)
          *reinterpret_cast<__nv_bfloat162*>(out0 + off + (size_t)r1 * D + col) =
              __floats2bfloat162_rn(acc0[4 * j + 2] * scale, acc0[4 * j + 3] * scale);
        if constexpr (DKDV) {
          if (r0 < LA)
            *reinterpret_cast<__nv_bfloat162*>(out1 + off + (size_t)r0 * D + col) =
                __floats2bfloat162_rn(acc1[4 * j], acc1[4 * j + 1]);
          if (r1 < LA)
            *reinterpret_cast<__nv_bfloat162*>(out1 + off + (size_t)r1 * D + col) =
                __floats2bfloat162_rn(acc1[4 * j + 2], acc1[4 * j + 3]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------- fp32

// The fp32 block at padded width DP (a multiple of 8). Shared memory: the
// fixed operands' big parts (A0, A1) and, where not in registers, their small
// parts; STAGES stages (B0 big, B0 small, B1 big, B1 small, B0^T big, B0^T
// small, dkdv: B1^T big and small and the tile's lse and delta); then the
// mbarriers (fixed, kfull[STAGES]: the TMA's bytes, full[STAGES]: the
// helpers, empty[STAGES]: the consumers).
template <int DP, bool DKDV>
struct CfgF {
  static constexpr int NCONS = DP <= 64 ? 2 : 1;
  static constexpr int BA = 64 * NCONS;
  static constexpr int BT = DP <= 40 ? 64 : DP <= 80 ? 32 : DKDV ? 8 : 16;
  static constexpr bool A0_REGS = DP <= 80;                 // Q's (dq) or K's small part
  static constexpr bool A1_REGS = DP <= 64 || (!DKDV && DP <= 80);   // dO's (dq) or V's
  static constexpr int CH = DP < 40 ? DP : 40;              // a chunk of the fresh accumulator
  static constexpr int NTHREADS = 128 * (NCONS + 1);
  static constexpr int NS = DP / 8;
  static constexpr int A_SLICE = BA * 32;
  static constexpr int B_SLICE = BT * 32;
  static constexpr int A_BYTES = NS * A_SLICE;
  static constexpr int B_BYTES = NS * B_SLICE;
  static constexpr int T_BYTES = BT * DP * 4;
  static constexpr int NT = DKDV ? 2 : 1;                   // transposed operands
  static constexpr int A0S = 2 * A_BYTES;                   // the small parts' offsets
  static constexpr int A1S = A0S + (A0_REGS ? 0 : A_BYTES);
  static constexpr int FIXED = A1S + (A1_REGS ? 0 : A_BYTES);
  static constexpr int STATS = DKDV ? 8 * BT : 0;
  static constexpr int T0 = 4 * B_BYTES;                    // offsets in a stage
  static constexpr int STATS_AT = T0 + 2 * NT * T_BYTES;
  static constexpr int STAGE = (STATS_AT + STATS + 1023) / 1024 * 1024;
  static constexpr int FIT = (227 * 1024 - 1024 - 256 - FIXED) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static_assert(STAGES >= 1, "a stage must fit");
  static constexpr int BAR = FIXED + STAGES * STAGE;
  static constexpr int BYTES = BAR + 8 * (1 + 3 * STAGES) + 1024;
};

// One 16-byte group of fp32 values in shared memory rounded in place to its
// big part; with SMALL, its small part written at ``sml``.
template <bool SMALL>
__device__ __forceinline__ void split16(unsigned char* big, unsigned char* sml) {
  uint4* b = reinterpret_cast<uint4*>(big);
  const uint4 x = *b;
  uint4 hi, lo;
  hi.x = to_tf32(__uint_as_float(x.x)); lo.x = f32::small_of(__uint_as_float(x.x), hi.x);
  hi.y = to_tf32(__uint_as_float(x.y)); lo.y = f32::small_of(__uint_as_float(x.y), hi.y);
  hi.z = to_tf32(__uint_as_float(x.z)); lo.z = f32::small_of(__uint_as_float(x.z), hi.z);
  hi.w = to_tf32(__uint_as_float(x.w)); lo.w = f32::small_of(__uint_as_float(x.w), hi.w);
  *b = hi;
  if constexpr (SMALL) *reinterpret_cast<uint4*>(sml) = lo;
}

// Rows [row0, row0 + BT) of a row-major [L, D] fp32 matrix written
// transposed, big part at ``dst`` and small part BT * DP * 4 bytes on: core
// matrices of 8 d x 4 rows (16 bytes); core-matrix column kq at kq DP 16
// bytes holds rows 8 (kq / 2) + 2 m + kq % 2, m = 0..3; zero past L and D.
// A task is 4 columns of d by one core-matrix column; the 96 helper threads
// (h) take them in turn.
template <int DP, int BT>
__device__ __forceinline__ void transpose(unsigned char* dst, const float* src, int row0, int L,
                                          int D, int h) {
  unsigned char* sml = dst + BT * DP * 4;
  for (int task = h; task < (DP / 4) * (BT / 4); task += 96) {
    const int nq = task % (DP / 4);
    const int kq = task / (DP / 4);
    float4 r[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int row = row0 + 8 * (kq >> 1) + 2 * m + (kq & 1);
      r[m] = row < L && 4 * nq < D
                 ? __ldg(reinterpret_cast<const float4*>(src + (size_t)row * D + 4 * nq))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float xv[4] = {(&r[0].x)[e], (&r[1].x)[e], (&r[2].x)[e], (&r[3].x)[e]};
      uint4 big, lo;
      big.x = to_tf32(xv[0]); lo.x = f32::small_of(xv[0], big.x);
      big.y = to_tf32(xv[1]); lo.y = f32::small_of(xv[1], big.y);
      big.z = to_tf32(xv[2]); lo.z = f32::small_of(xv[2], big.z);
      big.w = to_tf32(xv[3]); lo.w = f32::small_of(xv[3], big.w);
      const int off = kq * DP * 16 + (4 * nq + e) * 16;
      *reinterpret_cast<uint4*>(dst + off) = big;
      *reinterpret_cast<uint4*>(sml + off) = lo;
    }
  }
}

// The small parts of rows r0, r1 of a fixed operand as the tf32 A fragments
// of every k-step: a0 = (r0, 8c + t), a1 = (r1, 8c + t), a2 = (r0, 8c + t +
// 4), a3 = (r1, 8c + t + 4)
template <int NS>
__device__ __forceinline__ void frag_small(uint32_t (&a)[NS][4], const float* gm, int r0, int r1,
                                           int L, int D, int t) {
  auto ld = [&](int r, int c) { return r < L && c < D ? __ldg(gm + (size_t)r * D + c) : 0.f; };
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    const float xv[4] = {ld(r0, 8 * c + t), ld(r1, 8 * c + t), ld(r0, 8 * c + t + 4),
                         ld(r1, 8 * c + t + 4)};
#pragma unroll
    for (int i = 0; i < 4; ++i) a[c][i] = f32::small_of(xv[i], to_tf32(xv[i]));
  }
}

// X (+)= A B^T over the NS k-steps of 8 in three TF32 passes (A small . B big,
// A big . B small, A big . B big; the first overwrites X): A's small part as
// register fragments (REGS) or from shared memory (as), its big part (ab) and
// B's parts (bb, bs) from shared memory, 32-byte swizzled K-major slices
template <int BT, int NS, bool REGS, int NA>
__device__ __forceinline__ void first_f32(float (&x)[BT / 2], uint32_t (&areg)[NA][4],
                                          uint32_t ab, uint32_t as, uint32_t a_slice,
                                          uint32_t bb, uint32_t bs, uint32_t b_slice) {
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    if constexpr (REGS)
      Tf32<BT>::rs(x, areg[c], desc_b32(bb + c * b_slice, 16, 256), c > 0);
    else
      Tf32<BT>::ss(x, desc_b32(as + c * a_slice, 16, 256), desc_b32(bb + c * b_slice, 16, 256),
                   c > 0);
  }
#pragma unroll
  for (int c = 0; c < NS; ++c)
    Tf32<BT>::ss(x, desc_b32(ab + c * a_slice, 16, 256), desc_b32(bs + c * b_slice, 16, 256), 1);
#pragma unroll
  for (int c = 0; c < NS; ++c)
    Tf32<BT>::ss(x, desc_b32(ab + c * a_slice, 16, 256), desc_b32(bb + c * b_slice, 16, 256), 1);
}

// x split in place: its big part (as fp32 bits) stays, its small part goes to xs
template <int N>
__device__ __forceinline__ void split_regs(float (&x)[N], uint32_t (&xs)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t big = to_tf32(x[i]);
    xs[i] = f32::small_of(x[i], big);
    x[i] = __uint_as_float(big);
  }
}

// acc += W B over one tile: W (64 x BT) in registers in the accumulator's
// layout (big part in w as bits, small part in ws), B (BT x DP) the stage's
// transposed copy (big tb, small ts; k-step j at 2 j DP 16 bytes). Columns
// [C0, DP) in chunks of at most CH, each chunk's three passes of every k-step
// into the fresh accumulator ``fresh`` (the first overwrites it), which the
// CUDA cores then add to acc.
template <int DP, int BT, int CH, int C0 = 0>
__device__ __forceinline__ void prod_f32(float (&acc)[DP / 2], float (&fresh)[CH / 2],
                                         float (&w)[BT / 2], uint32_t (&ws)[BT / 2], uint32_t tb,
                                         uint32_t ts) {
  constexpr int N = DP - C0 < CH ? DP - C0 : CH;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) fence_reg(fresh[i]);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
    const uint32_t as[4] = {ws[4 * j], ws[4 * j + 2], ws[4 * j + 1], ws[4 * j + 3]};
    const uint32_t ab[4] = {__float_as_uint(w[4 * j]), __float_as_uint(w[4 * j + 2]),
                            __float_as_uint(w[4 * j + 1]), __float_as_uint(w[4 * j + 3])};
    const uint32_t off = 2 * j * DP * 16 + C0 * 16;
    Tf32<N>::rs(fresh, as, desc_plain(tb + off, DP * 16, 128), j > 0);
    Tf32<N>::rs(fresh, ab, desc_plain(ts + off, DP * 16, 128), 1);
    Tf32<N>::rs(fresh, ab, desc_plain(tb + off, DP * 16, 128), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    fence_reg(fresh[i]);
    acc[C0 / 2 + i] += fresh[i];
  }
  if constexpr (C0 + N < DP) prod_f32<DP, BT, CH, C0 + N>(acc, fresh, w, ws, tb, ts);
}

template <int DP, bool DKDV>
__global__ void __launch_bounds__(CfgF<DP, DKDV>::NTHREADS, 1)
bwd_f32_kernel(const __grid_constant__ CUtensorMap ma0, const __grid_constant__ CUtensorMap ma1,
               const __grid_constant__ CUtensorMap mb0, const __grid_constant__ CUtensorMap mb1,
               const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ o,
               const float* __restrict__ dout, float* __restrict__ lse,
               float* __restrict__ delta, float* __restrict__ out0, float* __restrict__ out1,
               int Lq, int Lk, int D, int Lq_pad, float scale) {
  using C = CfgF<DP, DKDV>;
  constexpr int NS = C::NS;
  constexpr int BT = C::BT;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sb = (raw + 1023u) & ~1023u;
  unsigned char* const base = smem_raw + (sb - raw);   // generic pointer of sb
  const uint32_t bars = sb + C::BAR;
  auto kfull = [&](int st) { return bars + 8u + 8u * st; };
  auto full = [&](int st) { return bars + 8u + 8u * (STAGES + st); };
  auto empty = [&](int st) { return bars + 8u + 8u * (2 * STAGES + st); };
  auto stage = [&](int st) { return (uint32_t)(C::FIXED + st * C::STAGE); };   // offset
  const int bh = blockIdx.y;
  const int a0 = blockIdx.x * C::BA;
  const int LA = DKDV ? Lk : Lq;
  const int LB = DKDV ? Lq : Lk;
  const int ntiles = (LB + BT - 1) / BT;
  const int nit = DKDV ? ntiles : 2 * ntiles;
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
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bars, 2 * C::A_BYTES);
      for (int c = 0; c < NS; ++c) {
        tma_load_3d(sb + c * C::A_SLICE, &ma0, bars, 8 * c, a0, bh);
        tma_load_3d(sb + C::A_BYTES + c * C::A_SLICE, &ma1, bars, 8 * c, a0, bh);
      }
      for (int it = 0; it < nit; ++it) {
        const int st = it % STAGES;
        const int tile = it % ntiles;
        const bool second = DKDV || it >= ntiles;   // the dq pre-pass needs K alone
        if (it >= STAGES) mbar_wait(empty(st), ((it / STAGES) - 1) & 1);
        const uint32_t s0 = sb + stage(st);
        mbar_arrive_expect_tx(kfull(st), (second ? 2 : 1) * C::B_BYTES + C::STATS);
        for (int c = 0; c < NS; ++c) {
          tma_load_3d(s0 + c * C::B_SLICE, &mb0, kfull(st), 8 * c, tile * BT, bh);
          if (second)
            tma_load_3d(s0 + 2 * C::B_BYTES + c * C::B_SLICE, &mb1, kfull(st), 8 * c, tile * BT,
                        bh);
        }
        if constexpr (DKDV) {
          const size_t g = (size_t)bh * Lq_pad + (size_t)tile * BT;
          bulk_load(s0 + C::STATS_AT, lse + g, 4 * BT, kfull(st));
          bulk_load(s0 + C::STATS_AT + 4 * BT, delta + g, 4 * BT, kfull(st));
        }
      }
    } else if (threadIdx.x >= 32) {
      // helpers: the transposed copies from global memory, then the slices
      // split in place
      const int h = threadIdx.x - 32;
      const float* gb0 = (DKDV ? q : k) + (size_t)bh * LB * D;
      const float* gb1 = (DKDV ? dout : v) + (size_t)bh * LB * D;
      for (int it = 0; it < nit; ++it) {
        const int st = it % STAGES;
        const int tile = it % ntiles;
        const bool second = DKDV || it >= ntiles;
        if (it >= STAGES) mbar_wait(empty(st), ((it / STAGES) - 1) & 1);
        unsigned char* s0 = base + stage(st);
        if (second) {
          transpose<DP, BT>(s0 + C::T0, gb0, tile * BT, LB, D, h);
          if constexpr (DKDV)
            transpose<DP, BT>(s0 + C::T0 + 2 * C::T_BYTES, gb1, tile * BT, LB, D, h);
        }
        mbar_wait(kfull(st), (it / STAGES) & 1);
        for (int i = h; i < C::B_BYTES / 16; i += 96)
          split16<true>(s0 + 16 * i, s0 + C::B_BYTES + 16 * i);
        if (second)
          for (int i = h; i < C::B_BYTES / 16; i += 96)
            split16<true>(s0 + 2 * C::B_BYTES + 16 * i, s0 + 3 * C::B_BYTES + 16 * i);
        fence_proxy_async();                // seen by wgmma
        mbar_arrive(full(st));
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (C::NCONS == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int r0 = a0 + cw * 64 + warp * 16 + g;   // the thread's fixed rows r0, r1
    const int r1 = r0 + 8;
    const float* ga0 = (DKDV ? k : q) + (size_t)bh * LA * D;
    const float* ga1 = (DKDV ? v : dout) + (size_t)bh * LA * D;

    // the fixed operands' small parts as register fragments, where they fit
    uint32_t a0s[C::A0_REGS ? NS : 1][4];
    uint32_t a1s[C::A1_REGS ? NS : 1][4];
    if constexpr (C::A0_REGS) frag_small<NS>(a0s, ga0, r0, r1, LA, D, t);
    if constexpr (C::A1_REGS) frag_small<NS>(a1s, ga1, r0, r1, LA, D, t);
    float dl[2] = {0.f, 0.f};
    if constexpr (!DKDV)
      row_delta(dl, o + (size_t)bh * Lq * D, dout + (size_t)bh * Lq * D, r0, r1, Lq, D, t);
    // their big parts (this consumer's rows of every slice) rounded in place,
    // the small parts written beside them where they are not in registers
    mbar_wait(bars, 0);
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      const int off = c * C::A_SLICE + cw * 64 * 32 + tid * 16;
      split16<!C::A0_REGS>(base + off, base + C::A0S + off);
      split16<!C::A1_REGS>(base + C::A_BYTES + off, base + C::A1S + off);
    }
    fence_proxy_async();
    named_sync(1 + cw, 128);

    const uint32_t aw = sb + cw * 64 * 32;          // this consumer's rows of a slice
    const float sc = scale * LOG2E;
    float x[BT / 2], y[BT / 2];                     // S (S^T), dP (dP^T); then P, dS
    uint32_t xs[BT / 2];                            // the small part of P or dS
    float acc0[DP / 2];                             // dQ or dK
    float acc1[DKDV ? DP / 2 : 1];                  // dV
    float fresh[C::CH / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc0[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (DKDV ? DP / 2 : 1); ++i) acc1[i] = 0.f;
    float lse_r[2] = {0.f, 0.f};

    int it = 0;
    if constexpr (!DKDV) {
      // the pre-pass: each row's lse over every kv tile
      float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
      for (; it < ntiles; ++it) {
        const int st = it % STAGES;
        const uint32_t s0 = sb + stage(st);
        mbar_wait(full(st), (it / STAGES) & 1);
        fence_regs(x);
        wgmma_fence();
        first_f32<BT, NS, C::A0_REGS>(x, a0s, aw, sb + C::A0S + cw * 64 * 32, C::A_SLICE, s0,
                                      s0 + C::B_BYTES, C::B_SLICE);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(x);
        if (lane == 0) mbar_arrive(empty(st));
        online(x, sc, LB - it * BT, t, m, l);
      }
      finish_lse(lse_r, m, l, dl, lse, delta, (size_t)bh * Lq_pad, r0, r1, Lq_pad, t);
    }
    for (; it < nit; ++it) {
      const int st = it % STAGES;
      const int tile = it % ntiles;
      const uint32_t s0 = sb + stage(st);
      if constexpr (DKDV) mbar_wait(kfull(st), (it / STAGES) & 1);   // the tile's lse, delta
      mbar_wait(full(st), (it / STAGES) & 1);
      fence_regs(x);
      fence_regs(y);
      wgmma_fence();
      first_f32<BT, NS, C::A0_REGS>(x, a0s, aw, sb + C::A0S + cw * 64 * 32, C::A_SLICE, s0,
                                    s0 + C::B_BYTES, C::B_SLICE);
      first_f32<BT, NS, C::A1_REGS>(y, a1s, aw + C::A_BYTES, sb + C::A1S + cw * 64 * 32,
                                    C::A_SLICE, s0 + 2 * C::B_BYTES, s0 + 3 * C::B_BYTES,
                                    C::B_SLICE);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
      fence_regs(y);
      const float* stats = reinterpret_cast<const float*>(base + stage(st) + C::STATS_AT);
      p_ds<DKDV>(x, y, sc, LB - tile * BT, t, lse_r, dl, stats, stats + BT);
      const uint32_t t0 = s0 + C::T0;
      if constexpr (DKDV) {
        // dV += P^T dO
        split_regs(x, xs);
        fence_regs(x);
        fence_regs(xs);
        prod_f32<DP, BT, C::CH>(acc1, fresh, x, xs, t0 + 2 * C::T_BYTES, t0 + 3 * C::T_BYTES);
        fence_regs(x);
        fence_regs(xs);
      }
      // dK += dS^T Q, or dQ += dS K
      split_regs(y, xs);
      fence_regs(y);
      fence_regs(xs);
      prod_f32<DP, BT, C::CH>(acc0, fresh, y, xs, t0, t0 + C::T_BYTES);
      fence_regs(y);
      fence_regs(xs);
      if (lane == 0) mbar_arrive(empty(st));        // this warp is done with stage st
    }

    float* o0 = out0 + (size_t)bh * LA * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;                // D % 4 == 0: col < D covers col + 1
      if (col < D) {
        if (r0 < LA)
          *reinterpret_cast<float2*>(o0 + (size_t)r0 * D + col) =
              make_float2(acc0[4 * j] * scale, acc0[4 * j + 1] * scale);
        if (r1 < LA)
          *reinterpret_cast<float2*>(o0 + (size_t)r1 * D + col) =
              make_float2(acc0[4 * j + 2] * scale, acc0[4 * j + 3] * scale);
        if constexpr (DKDV) {
          float* o1 = out1 + (size_t)bh * LA * D;
          if (r0 < LA)
            *reinterpret_cast<float2*>(o1 + (size_t)r0 * D + col) =
                make_float2(acc1[4 * j], acc1[4 * j + 1]);
          if (r1 < LA)
            *reinterpret_cast<float2*>(o1 + (size_t)r1 * D + col) =
                make_float2(acc1[4 * j + 2], acc1[4 * j + 3]);
        }
      }
    }
  }
}

// --------------------------------------------------------------------- host

// Lq padded to whole 64-row tiles: the rows of the lse and delta scratch
inline int lq_pad(int Lq) { return (Lq + 63) / 64 * 64; }

template <int DP>
cudaError_t launch_bf16_dp(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, void* dq, void* dk, void* dv, float* lse,
                           float* delta, int bh, int Lq, int Lk, int D, float scale,
                           cudaStream_t stream) {
  using CQ = CfgB<DP, false>;
  using CK = CfgB<DP, true>;
  CUtensorMap mq, mdo, mk, mv, mk_a, mv_a, mq_b, mdo_b;
  if (!slice_map_bf16(&mq, q, bh, Lq, D, CQ::BA) || !slice_map_bf16(&mdo, dout, bh, Lq, D, CQ::BA) ||
      !slice_map_bf16(&mk, k, bh, Lk, D, CQ::BT) || !slice_map_bf16(&mv, v, bh, Lk, D, CQ::BT) ||
      !slice_map_bf16(&mk_a, k, bh, Lk, D, CK::BA) || !slice_map_bf16(&mv_a, v, bh, Lk, D, CK::BA) ||
      !slice_map_bf16(&mq_b, q, bh, Lq, D, CK::BT) ||
      !slice_map_bf16(&mdo_b, dout, bh, Lq, D, CK::BT))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_bf16_kernel<DP, false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, CQ::BYTES)) !=
      cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(bwd_bf16_kernel<DP, true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, CK::BYTES)) !=
      cudaSuccess)
    return err;
  using bf = __nv_bfloat16;
  const int pad = lq_pad(Lq);
  bwd_bf16_kernel<DP, false><<<dim3((Lq + CQ::BA - 1) / CQ::BA, bh), CQ::NTHREADS, CQ::BYTES,
                               stream>>>(
      mq, mdo, mk, mv, static_cast<const bf*>(o), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dq), nullptr, Lq, Lk, D, pad, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_bf16_kernel<DP, true><<<dim3((Lk + CK::BA - 1) / CK::BA, bh), CK::NTHREADS, CK::BYTES,
                              stream>>>(
      mk_a, mv_a, mq_b, mdo_b, static_cast<const bf*>(o), static_cast<const bf*>(dout), lse,
      delta, static_cast<bf*>(dk), static_cast<bf*>(dv), Lq, Lk, D, pad, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32_dp(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, void* dq, void* dk, void* dv, float* lse,
                          float* delta, int bh, int Lq, int Lk, int D, float scale,
                          cudaStream_t stream) {
  using CQ = CfgF<DP, false>;
  using CK = CfgF<DP, true>;
  CUtensorMap mq, mdo, mk, mv, mk_a, mv_a, mq_b, mdo_b;
  if (!f32::tensor_map_f32(&mq, q, bh, Lq, D, CQ::BA) ||
      !f32::tensor_map_f32(&mdo, dout, bh, Lq, D, CQ::BA) ||
      !f32::tensor_map_f32(&mk, k, bh, Lk, D, CQ::BT) ||
      !f32::tensor_map_f32(&mv, v, bh, Lk, D, CQ::BT) ||
      !f32::tensor_map_f32(&mk_a, k, bh, Lk, D, CK::BA) ||
      !f32::tensor_map_f32(&mv_a, v, bh, Lk, D, CK::BA) ||
      !f32::tensor_map_f32(&mq_b, q, bh, Lq, D, CK::BT) ||
      !f32::tensor_map_f32(&mdo_b, dout, bh, Lq, D, CK::BT))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_f32_kernel<DP, false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, CQ::BYTES)) !=
      cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(bwd_f32_kernel<DP, true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, CK::BYTES)) !=
      cudaSuccess)
    return err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* gf = static_cast<const float*>(dout);
  const int pad = lq_pad(Lq);
  bwd_f32_kernel<DP, false><<<dim3((Lq + CQ::BA - 1) / CQ::BA, bh), CQ::NTHREADS, CQ::BYTES,
                              stream>>>(mq, mdo, mk, mv, qf, kf, vf, of, gf, lse, delta,
                                        static_cast<float*>(dq), nullptr, Lq, Lk, D, pad, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_f32_kernel<DP, true><<<dim3((Lk + CK::BA - 1) / CK::BA, bh), CK::NTHREADS, CK::BYTES,
                             stream>>>(mk_a, mv_a, mq_b, mdo_b, qf, kf, vf, of, gf, lse, delta,
                                       static_cast<float*>(dk), static_cast<float*>(dv), Lq, Lk,
                                       D, pad, scale);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace bwd
}  // namespace mdu
