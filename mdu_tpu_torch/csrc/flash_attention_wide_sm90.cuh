// Warpgroup flash attention for heads wider than 160 on Hopper (sm_90a):
// wgmma products, TMA loads, a producer warp and two consumer warpgroups
// that split D. bf16 in, fp32 accumulate. Included by flash_attention.cu,
// which keeps the split-D mma.sync kernel for the inputs this form does not
// take.
//
// One template, two softmax policies, one for each kernel it serves:
//   Online (mdu_flash_attention_wide, TPU kernel flash_attention): a running
//     row max, an fp32 denominator of the unrounded p floored at 1e-30, p
//     rounded to bf16 for P.V.
//   FixedShift (mdu_flash_attention_fm_wide, TPU kernel flash_attention_t_fm
//     at D > 160): p = bf16(exp(min(s * scale, smax) - smax)), the min only
//     with clamp; with BF16_EXP the shifted score is rounded to bf16 before
//     the exp; the denominator sums the rounded p over the real kv columns,
//     floored at 1e-30. The arithmetic is the mma.sync kernel's
//     (flash_attention.cu, FIXED).
//
// Inputs: contiguous bf16 [bh, L, D] with D % 8 == 0 (a 16-byte TMA row
// stride), 160 < D <= 512, and 16-byte aligned bases. D is padded to DP, the
// next multiple of 128, by the TMA's zero fill of columns past D.
//
// Layout of a block: 64 query rows.
// - Warpgroup 0, the producer: one thread issues every TMA load, Q's rows
//   once, then K and V tiles of BK = 32 kv rows into a ring of STAGES stages.
//   K and V have their own "full" and "empty" mbarriers, so that K's slot is
//   refilled as soon as Q.K^T has read it, a tile before V's. It gives its
//   registers up (setmaxnreg 24).
// - Two consumer warpgroups (240 registers each) own the same 64 query rows
//   and one half of D each: O for 64 rows x 512 fp32 is 256 registers a
//   thread, more than one warpgroup holds, so consumer cw keeps O's columns
//   cw * DP / 2 .. (128 registers at DP = 512).
//   - Q.K^T splits along D the same way: each consumer runs one
//     wgmma.m64n32k16 per 16 columns of its half, Q and K from shared
//     memory, and the two partial score tiles are summed through shared
//     memory (8 KB each, double-buffered by tile parity, one named barrier
//     of both consumers per tile). Both consumers then hold the same scores
//     (a + b == b + a in fp32) and run the same softmax, so each has P for
//     all 32 kv columns without a second exchange. Computing all of S in
//     each consumer instead would be 1.5x the products and twice the reads
//     of Q and K from shared memory, the scarcer resource here.
//   - O += P.V takes P from registers (the S accumulator's layout, packed to
//     bf16x2, is the A fragment) and V's half, read MN-major (transposed), as
//     one wgmma of width DP / 2 per 16 kv rows.
//   - Each iteration issues Q.K^T of tile j + 1 and P.V of tile j back to
//     back; the exchange and the softmax of tile j + 1 run while P.V is in
//     flight; only the bf16 packing of P waits for it.
// Every operand in shared memory is a stack of 16-column slices, [rows][16]
// bf16 with the 32-byte swizzle (flash_attention_sm90.cuh has the same
// layout): one slice is one k-step of Q.K^T, and V's slices side by side are
// the N dimension of P.V (LBO = one slice). The D / 16 whole slices of a
// tile arrive as one TMA box of a 4-d view of the tensor (column, row,
// slice, head; the slice stride is 32 bytes), which writes this stack as it
// stands; a partial last slice and the slices past D come by a 3-d map that
// zero-fills columns past D. One box of 32 slices, not 32 boxes of 1 KB: one
// thread issues them.
//
// Shared memory at DP = 512: Q 64 KB, two stages of K and V (64 KB each),
// the exchange 32 KB, barriers: 225 KB of 227 KB. A stage of BK = 64 would
// leave room for one stage only.
//
// What bounds it on an H100, at config 2's [2, 1, 9600, 512] (the VAE's
// mid-block attention): 4 * L^2 * D * bh = 3.77e11 flops = 0.382 ms at 989
// TFLOP/s; the exps, L^2 * bh = 1.8e8 ex2 (run twice, once per consumer) at
// 16 a clock per SM, 0.09 ms; device memory 39 MB, 0.012 ms. With 64 query
// rows a block, each K and V row read from L2 serves 64 rows' products: the
// blocks read 300 x 19.7 MB = 5.9 GB from L2. A tile's products take about
// 1000 clocks of tensor time; its shared-memory traffic (Q and K read by
// Q.K^T 96 KB, V 32 KB, the exchange 32 KB, the TMA's writes 64 KB) about
// 1750 at 128 bytes a clock. It runs at 1.65 ms, and at 1.15 ms with K and V
// loaded for the first stages only (a diagnostic version), so the loads
// cost a third. What measured slower (PERF.md has the numbers): a pair of
// blocks in a cluster that multicasts K and V (each block then waits for the
// slower one), every consumer computing all of S, Q held in registers. The
// grid is 150 x 2 = 300 blocks on 132 SMs, 2.27 waves: the design leaves the
// last wave 27 % full (a kv split with a combine would need a second pass
// and scratch). What that costs, with kv fixed at 9600 and the query rows
// varied (scripts/kernel_variants.py, H100 80GB HBM3 at 700 W): 1.235 ms at
// 8448 rows (264 blocks, two full waves), 1.608 at 9600, 1.846 at 12672
// (three full waves). The last wave's 36 blocks take 0.37 ms, where 300
// blocks at the full waves' rate would take 1.40 ms in all: about 0.2 ms a
// call.
#pragma once

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace mdu {
namespace wide {

using namespace mdu::sm90;

constexpr int BQ = 64;           // query rows of a block
constexpr int BK = 32;           // kv rows of a tile
constexpr int SLICE = 16;        // columns of one shared-memory slice (32 bytes)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG = -1e30f;

// ------------------------------------------------------- wgmma instructions

// S (+)= A B^T, m64n32k16: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D += A B, m64n128k16: A (P) from registers, B (V) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A B, m64n192k16: A (P) from registers, B (V) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n192(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A B, m64n256k16: A (P) from registers, B (V) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------ helpers

// the column of score s[i] in its tile, for lane t of a quad
__device__ __forceinline__ int col_of(int i, int t) { return 8 * (i / 4) + 2 * t + (i & 1); }

// ----------------------------------------------------------------- policies
//
// A policy turns the scores of one 64 x 32 tile into p in place (``exps``),
// keeps each row's denominator, and gives 1 / denominator at the end
// (``finish``). ``corr`` is the factor the accumulator's rows take before
// the next P.V (RESCALES only). Columns at or past ``kvalid`` of a ragged
// tile do not count.

template <bool BF16_EXP>
struct FixedShift {
  static constexpr bool RESCALES = false;
  float scale, smax, sc, sh;
  int clamp;
  float l[2];     // this lane's share of the denominators of rows g, g + 8

  __device__ __forceinline__ FixedShift(float scale_, float smax_, int clamp_)
      : scale(scale_), smax(smax_), sc(scale_ * LOG2E), sh(smax_ * LOG2E), clamp(clamp_) {
    l[0] = l[1] = 0.f;
  }

  // the exponent, in the log2 domain, of one score
  __device__ __forceinline__ float shifted(float x) const {
    if constexpr (BF16_EXP) {
      // the shift in the natural domain, rounded to bf16, then the exp
      const float e = clamp ? fminf(x * scale, smax) - smax : fmaf(x, scale, -smax);
      return round_bf16(e) * LOG2E;
    } else {
      return clamp ? fminf(x * sc, sh) - sh : fmaf(x, sc, -sh);
    }
  }

  // p rounded to bf16 here, so that the denominator sums what P.V reads
  __device__ __forceinline__ void exps(float (&s)[16], int kvalid, int t, bool ragged,
                                       float (&)[2]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float p = round_bf16(ex2(shifted(s[i])));
      s[i] = ragged && col_of(i, t) >= kvalid ? 0.f : p;
      l[(i >> 1) & 1] += s[i];
    }
  }

  __device__ __forceinline__ void finish(float (&inv)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = l[r];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      inv[r] = 1.f / fmaxf(x, 1e-30f);
    }
  }
};

struct Online {
  static constexpr bool RESCALES = true;
  float sc;
  float m[2];     // running max of rows g, g + 8 (log2 domain)
  float l[2];     // this lane's share of their fp32 denominators

  __device__ __forceinline__ Online(float scale, float, int) : sc(scale * LOG2E) {
    m[0] = m[1] = NEG;
    l[0] = l[1] = 0.f;
  }

  // a masked score is -1e30 in the max and 0 after the exp
  __device__ __forceinline__ void exps(float (&s)[16], int kvalid, int t, bool ragged,
                                       float (&corr)[2]) {
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      s[i] = ragged && col_of(i, t) >= kvalid ? NEG : s[i] * sc;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float mn[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four lanes of a quad hold disjoint columns of the same rows
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mn[r] = fmaxf(m[r], mx[r]);
      corr[r] = ex2(m[r] - mn[r]);
      m[r] = mn[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      s[i] = ex2(s[i] - mn[(i >> 1) & 1]);
      l[(i >> 1) & 1] += s[i];
    }
  }

  __device__ __forceinline__ void finish(float (&inv)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = l[r];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      inv[r] = 1.f / fmaxf(x, 1e-30f);
    }
  }
};

// ------------------------------------------------------------------- kernel

// Shared memory at padded width DP: Q's slices, then STAGES stages of K's
// slices and V's slices, the exchange of partial scores ([parity][consumer]
// [4][128 threads][4] fp32), then the mbarriers (Q, kfull, vfull, kempty,
// vempty of each stage); 1 KB of slack to align the base to 1 KB.
template <int DP>
struct Smem {
  static constexpr int NS = DP / SLICE;
  static constexpr int HALF = NS / 2;                     // slices of one consumer
  static constexpr int Q_SLICE = BQ * SLICE * 2;
  static constexpr int KV_SLICE = BK * SLICE * 2;
  static constexpr int Q_BYTES = NS * Q_SLICE;
  static constexpr int KV_BYTES = NS * KV_SLICE;          // K or V of one stage
  static constexpr int X_BYTES = BQ * BK * 4;             // one consumer's partial scores
  static constexpr int XCH = 2 * 2 * X_BYTES;
  static constexpr int FIT = (232448 - 1024 - 8 * 17 - Q_BYTES - XCH) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static_assert(STAGES >= 2, "two stages must fit");
  static constexpr int OFF_X = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int BAR = OFF_X + XCH;
  static constexpr int BYTES = BAR + 8 * (1 + 4 * STAGES) + 1024;
};

template <int DP, class Policy>
__global__ void __launch_bounds__(384, 1)
flash_wide_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mq4,
                       const __grid_constant__ CUtensorMap mk4,
                       const __grid_constant__ CUtensorMap mv4, __nv_bfloat16* __restrict__ o,
                       int Lq, int Lk, int D, float scale, float smax, int clamp) {
  using L = Smem<DP>;
  constexpr int HALF = L::HALF;
  constexpr int STAGES = L::STAGES;
  constexpr int NA = DP / 4;              // accumulator registers of O's half
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;
  float* xs = reinterpret_cast<float*>(smem_raw + (sq - raw) + L::OFF_X);
  const uint32_t bars = sq + L::BAR;
  auto kfull = [&](int st) { return bars + 8u + 8u * st; };
  auto vfull = [&](int st) { return bars + 8u + 8u * (STAGES + st); };
  auto kempty = [&](int st) { return bars + 8u + 8u * (2 * STAGES + st); };
  auto vempty = [&](int st) { return bars + 8u + 8u * (3 * STAGES + st); };
  auto kstage = [&](int st) { return sq + L::Q_BYTES + (uint32_t)(st * 2 * L::KV_BYTES); };
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (Lk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(kfull(st), 1);
      mbar_init(vfull(st), 1);
      mbar_init(kempty(st), 8);             // one arrival per consumer warp
      mbar_init(vempty(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      // the slices of rows row.. of one operand: D / 16 whole ones in one
      // box, the rest one box each (zero past D)
      const int nfull = D / SLICE;
      auto load = [&](uint32_t dst, const CUtensorMap* m4, const CUtensorMap* m3, uint32_t bar,
                      int row, int slice_bytes) {
        tma_load_4d(dst, m4, bar, 0, row, 0, bh);
        for (int c = nfull; c < L::NS; ++c)
          tma_load_3d(dst + c * slice_bytes, m3, bar, c * SLICE, row, bh);
      };
      mbar_arrive_expect_tx(bars, L::Q_BYTES);
      load(sq, &mq4, &mq, bars, q0, L::Q_SLICE);
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % STAGES;
        const uint32_t ks = kstage(st);
        if (it >= STAGES) mbar_wait(kempty(st), ((it / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(kfull(st), L::KV_BYTES);
        load(ks, &mk4, &mk, kfull(st), it * BK, L::KV_SLICE);
        if (it >= STAGES) mbar_wait(vempty(st), ((it / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(vfull(st), L::KV_BYTES);
        load(ks + L::KV_BYTES, &mv4, &mv, vfull(st), it * BK, L::KV_SLICE);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;                  // this consumer's half of D
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int kvalid = Lk - (ntiles - 1) * BK;      // real kv rows of the last tile
    const bool ragged = kvalid < BK;

    Policy pol(scale, smax, clamp);
    float s[16];
    uint32_t p[8];
    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.f;
    float corr[2] = {1.f, 1.f};

    // S of tile ``it`` over this consumer's half of D
    auto issue_qk = [&](int st) {
#pragma unroll
      for (int i = 0; i < 16; ++i) fence_reg(s[i]);
      wgmma_fence();
      const uint32_t ks = kstage(st);
#pragma unroll
      for (int c = 0; c < HALF; ++c) {
        const int cc = cw * HALF + c;
        wgmma_ss_n32(s, desc_b32(sq + cc * L::Q_SLICE, 16, 256),
                     desc_b32(ks + cc * L::KV_SLICE, 16, 256), c > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int i = 0; i < NA; ++i) fence_reg(acc[i]);
#pragma unroll
      for (int i = 0; i < 8; ++i) fence_reg(p[i]);
      wgmma_fence();
      const uint32_t vs = kstage(st) + L::KV_BYTES + cw * HALF * L::KV_SLICE;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        const uint64_t db = desc_b32(vs + kk * 16 * SLICE * 2, L::KV_SLICE, 256);
        if constexpr (DP == 256)
          wgmma_rs_n128(acc, a, db);
        else if constexpr (DP == 384)
          wgmma_rs_n192(acc, a, db);
        else
          wgmma_rs_n256(acc, a, db);
      }
      wgmma_commit();
    };
    // the full scores: this consumer's partial tile plus the other's, through
    // shared memory; thread tid of either consumer holds the same scores
    auto exchange = [&](int parity) {
#pragma unroll
      for (int i = 0; i < 16; ++i) fence_reg(s[i]);
      float4* mine = reinterpret_cast<float4*>(xs + (2 * parity + cw) * BQ * BK);
      const float4* theirs = reinterpret_cast<const float4*>(xs + (2 * parity + 1 - cw) * BQ * BK);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        mine[q * 128 + tid] = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3]);
      named_sync(1);                        // both consumers, 256 threads
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = theirs[q * 128 + tid];
        s[4 * q] += v.x;
        s[4 * q + 1] += v.y;
        s[4 * q + 2] += v.z;
        s[4 * q + 3] += v.w;
      }
    };
    auto rescale = [&]() {
      if constexpr (Policy::RESCALES) {
#pragma unroll
        for (int j = 0; j < NA / 4; ++j) {
          acc[4 * j] *= corr[0];
          acc[4 * j + 1] *= corr[0];
          acc[4 * j + 2] *= corr[1];
          acc[4 * j + 3] *= corr[1];
        }
      }
    };

    mbar_wait(bars, 0);
    mbar_wait(kfull(0), 0);
    issue_qk(0);
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(kempty(0));
    exchange(0);
    pol.exps(s, kvalid, t, ragged && ntiles == 1, corr);
    pack(s, p);

    // Every tile but the last: the products of two tiles in flight at once.
    // The last tile is peeled off, so that the loop body is straight-line
    // code for the compiler's tracking of the asynchronous products.
    for (int it = 0; it + 1 < ntiles; ++it) {
      const int st = it % STAGES;
      const int sn = (it + 1) % STAGES;
      mbar_wait(kfull(sn), ((it + 1) / STAGES) & 1);
      issue_qk(sn);                         // S of tile it + 1 ...
      rescale();
      mbar_wait(vfull(st), (it / STAGES) & 1);
      issue_pv(st);                         // ... then O += P V of tile it
      wgmma_wait<1>();                      // S of tile it + 1 has landed
      if (lane == 0) mbar_arrive(kempty(sn));
      // its exchange and exps run while P.V of tile it is in flight
      exchange((it + 1) & 1);
      pol.exps(s, kvalid, t, ragged && it + 2 == ntiles, corr);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NA; ++i) fence_reg(acc[i]);
#pragma unroll
      for (int i = 0; i < 8; ++i) fence_reg(p[i]);
      if (lane == 0) mbar_arrive(vempty(st));
      pack(s, p);
    }
    const int sl = (ntiles - 1) % STAGES;
    rescale();
    mbar_wait(vfull(sl), ((ntiles - 1) / STAGES) & 1);
    issue_pv(sl);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NA; ++i) fence_reg(acc[i]);

    float inv[2];
    pol.finish(inv);
    const int r0 = q0 + warp * 16 + g;
    const int r1 = r0 + 8;
    __nv_bfloat16* ob = o + (size_t)bh * Lq * D;
#pragma unroll
    for (int j = 0; j < NA / 4; ++j) {
      const int col = cw * (DP / 2) + 8 * j + 2 * t;   // D % 8 == 0: col < D covers col + 1
      if (col < D) {
        if (r0 < Lq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * D + col) =
              __floats2bfloat162_rn(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
        if (r1 < Lq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * D + col) =
              __floats2bfloat162_rn(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
      }
    }
  }
}

// --------------------------------------------------------------------- host

// A contiguous [bh, L, D] bf16 tensor's D / 16 whole 16-column slices as a
// 4-d map {column, row, slice, head} (slice stride 32 bytes) whose box is
// every slice of ``rows`` rows: shared memory receives [slice][row][16],
// 32-byte swizzled, as slice_map_bf16 (sm90.cuh) would one box at a time.
inline bool slices_map(CUtensorMap* map, const void* ptr, int bh, int L, int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)SLICE, (cuuint64_t)L, (cuuint64_t)(D / SLICE),
                              (cuuint64_t)bh};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)SLICE * 2,
                                 (cuuint64_t)L * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)SLICE, (cuuint32_t)rows, (cuuint32_t)(D / SLICE), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, class Policy>
cudaError_t launch_dp(const void* q, const void* k, const void* v, void* o, int bh, int Lq,
                      int Lk, int D, float scale, float smax, int clamp, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mq4, mk4, mv4;
  if (!slice_map_bf16(&mq, q, bh, Lq, D, BQ) || !slice_map_bf16(&mk, k, bh, Lk, D, BK) ||
      !slice_map_bf16(&mv, v, bh, Lk, D, BK) || !slices_map(&mq4, q, bh, Lq, D, BQ) ||
      !slices_map(&mk4, k, bh, Lk, D, BK) || !slices_map(&mv4, v, bh, Lk, D, BK))
    return cudaErrorInvalidValue;
  const int smem = Smem<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_wide_sm90_kernel<DP, Policy>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, bh);
  flash_wide_sm90_kernel<DP, Policy><<<grid, 384, smem, stream>>>(
      mq, mk, mv, mq4, mk4, mv4, static_cast<__nv_bfloat16*>(o), Lq, Lk, D, scale, smax, clamp);
  return cudaGetLastError();
}

// q, k, v, o: contiguous bf16 [bh, L, D], D % 8 == 0, 160 < D <= 512,
// 16-byte aligned bases; D is padded to the next multiple of 128.
template <class Policy>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int Lq,
                   int Lk, int D, float scale, float smax, int clamp, cudaStream_t stream) {
  if (D % 8 != 0 || D <= 160 || D > 512) return cudaErrorInvalidValue;
  if (D <= 256)
    return launch_dp<256, Policy>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, stream);
  if (D <= 384)
    return launch_dp<384, Policy>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, stream);
  return launch_dp<512, Policy>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, stream);
}

}  // namespace wide
}  // namespace mdu
