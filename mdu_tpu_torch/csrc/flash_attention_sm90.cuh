// Warpgroup flash attention for Hopper (sm_90a): wgmma products, TMA loads,
// a producer warp and two or three consumer warpgroups. bf16 in, fp32
// accumulate.
//
// One template, two softmax policies, instantiated by the sources of the
// kernels it serves:
//   FixedShift (flash_attention_fm.cu, TPU kernel flash_attention_t_fm):
//     p = bf16(exp(min(s * scale, smax) - smax)), den = sum of the rounded p
//     over the real kv columns, floored at 1e-30; with BF16_EXP the shifted
//     score is rounded to bf16 before the exp.
//   Online (flash_attention_t.cu, TPU kernel flash_attention_t): running
//     row max, fp32 denominator of the unrounded p, accumulator rescale.
//
// Inputs: contiguous bf16 [bh, L, D] with D % 8 == 0, 16 <= D <= 160 and
// 16-byte aligned bases (a tensor map needs 16-byte strides). D is padded to
// DP, the next multiple of 16, by the TMA's zero fill of columns past D.
//
// Layout of a block (one block an SM):
// - warpgroup 0, the producer: one thread issues every TMA load. Q's rows
//   once; then K and V tiles of BK = 128 kv rows into a ring of STAGES
//   stages, each with a "full" mbarrier (the TMA's bytes) and an "empty"
//   one (one arrival from each consumer warp). It gives its registers up
//   (setmaxnreg 24) to the consumers.
// - NCONS consumer warpgroups of 64 query rows each: three (160 registers)
//   at a padded width up to 64, two (240 registers) above. Every operand in
//   shared memory is a stack of 16-column slices, [rows][16] bf16 with the
//   32-byte swizzle, one TMA box each, so that one slice is one K-step of
//   Q.K^T (K-major A and B) and V is read MN-major (transposed) by P.V.
//   S = Q.K^T is one wgmma.m64n128k16 per slice, with Q and K from shared
//   memory; O += P.V takes P from registers: the S accumulator's layout,
//   packed to bf16x2, is the register A fragment of the next wgmma.
//
// What bounds it on an H100, at config 2's [10, 8, 6144, 40]: the tensor
// cores, 4 * L^2 * D flops = 0.489 ms at 989 TFLOP/s (0.587 ms with D padded
// to 48), and the exp of every score, L^2 * B * H = 3.0e9 MUFU ex2 at 16 a
// clock per SM over 132 SMs = about 0.72 ms at 1.98 GHz: above the tensor
// bound, so the design has to keep the exps running while the products do,
// and has to spend as little else as it can on the CUDA cores beside them.
// How it overlaps them:
// - inside a consumer, each iteration issues Q.K^T of tile j + 1 and P.V of
//   tile j back to back, then runs the exps of tile j + 1 while both products
//   are in flight; only the bf16 packing of P waits for P.V to finish;
// - the consumers take turns to issue their products (ping-pong, named
//   barriers 1 .. NCONS), so that one warpgroup's exps run while another's
//   products occupy the tensor cores; the online softmax with two consumers
//   runs without the turns, which measured faster there;
// - three consumers where their registers suffice (DP <= 64): more warps to
//   keep the MUFU pipe busy (1.8 -> 1.3 ms at [10, 8, 6144, 40]);
// - P.V is one wgmma of width DP where one is written (DP = 48, 64, 80),
//   else one m64n16 per 16-column slice of V;
// - the fixed shift's denominator is a product on the tensor cores (P times
//   a shared 128 x 16 tile of ones, the TPU kernel's ones row of V) instead
//   of an unpack and an add per score, and bf16_exp rounds with integer
//   operations, off the exp's pipe.
// PERF.md has what each of these choices measured against the others.
// The kv mask acts on the ragged last tile only (p = 0 for the fixed shift, a
// score of -1e30 for the online softmax); TMA zero-fills rows past Lq and Lk.
#pragma once

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace mdu {
namespace sm90 {

constexpr int BK = 128;          // kv rows of a tile
constexpr int SLICE = 16;        // columns of one shared-memory slice (32 bytes)
// Three consumer warpgroups (192 query rows a block, 160 registers each) up
// to this padded width, two (128 rows, 240 registers) above it: three spill
// at DP = 80.
constexpr int THREE_CONSUMERS_MAX_DP = 64;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG = -1e30f;

// ------------------------------------------------------- wgmma instructions

// S (+)= A B^T, m64n128k16: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D += A B, m64n16k16: A (P) from registers, B (V) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A B, m64n48k16: A (P) from registers, B (V) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n48(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A B, m64n64k16: A (P) from registers, B (V) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A B, m64n80k16: A (P) from registers, B (V) from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ----------------------------------------------------------------- policies
//
// A policy turns the scores of one 64 x 128 tile (the m64n128 accumulator:
// s[4j + i] is row g + 8 (i / 2), column 8j + 2t + i % 2, with g = lane / 4,
// t = lane % 4 in each warp's 16 rows) into p in place (``exps``) and gives
// each row's 1 / denominator at the end (``finish``); the kernel packs p to
// bf16 for P.V. ``corr`` is the factor the accumulator's rows take before the
// next P.V (RESCALES only). Columns at or past ``kvalid`` of a ragged tile do
// not count. With TENSOR_DEN the kernel accumulates P times ones (``dacc``:
// column 0 is the row sum of rows g, g + 8 in every lane), the sum of the
// rounded p.

template <bool BF16_EXP>
struct FixedShift {
  static constexpr bool RESCALES = false;
  static constexpr bool TENSOR_DEN = true;
  float scale, smax, sc, sh;
  int clamp;

  __device__ __forceinline__ FixedShift(float scale_, float smax_, int clamp_)
      : scale(scale_), smax(smax_), sc(scale_ * LOG2E), sh(smax_ * LOG2E), clamp(clamp_) {}

  // the exponent, in the log2 domain, of one score
  template <bool CLAMP>
  __device__ __forceinline__ float shifted(float x) const {
    if constexpr (BF16_EXP) {
      // the shift in the natural domain, rounded to bf16, then the exp
      const float e = CLAMP ? fminf(x * scale, smax) - smax : fmaf(x, scale, -smax);
      return round_bf16(e) * LOG2E;
    } else {
      return CLAMP ? fminf(x * sc, sh) - sh : fmaf(x, sc, -sh);
    }
  }

  __device__ __forceinline__ void exps(float (&s)[64], int kvalid, int t, bool ragged,
                                       float (&corr)[2]) {
    if (clamp) {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = ex2(shifted<true>(s[i]));
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = ex2(shifted<false>(s[i]));
    }
    if (ragged) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (8 * (i / 4) + 2 * t + (i & 1) >= kvalid) s[i] = 0.f;
    }
  }

  __device__ __forceinline__ void finish(float (&inv)[2], const float (&dacc)[8]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(dacc[2 * r], 1e-30f);
  }
};

struct Online {
  static constexpr bool RESCALES = true;
  static constexpr bool TENSOR_DEN = false;
  float sc;
  float m[2];     // running max of rows g, g + 8 (log2 domain)
  float l[2];     // this lane's share of their fp32 denominators

  __device__ __forceinline__ Online(float scale, float, int) : sc(scale * LOG2E) {
    m[0] = m[1] = NEG;
    l[0] = l[1] = 0.f;
  }

  __device__ __forceinline__ void exps(float (&s)[64], int kvalid, int t, bool ragged,
                                       float (&corr)[2]) {
    if (sc >= 0.f)
      exps_signed<true>(s, kvalid, t, ragged, corr);
    else
      exps_signed<false>(s, kvalid, t, ragged, corr);
  }

  // The row max of s * sc is |sc| * max(s) (POS: sc >= 0) or |sc| * max(-s),
  // taken on the raw scores, so that each p is one fma and one exp2. A masked
  // score is -1e30 (+1e30 for a negative scale) in the max and 0 after the
  // exp.
  template <bool POS>
  __device__ __forceinline__ void exps_signed(float (&s)[64], int kvalid, int t, bool ragged,
                                              float (&corr)[2]) {
    if (ragged) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (8 * (i / 4) + 2 * t + (i & 1) >= kvalid) s[i] = POS ? NEG : -NEG;
    }
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < 64; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], POS ? s[i] : -s[i]);
    float mn[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four lanes of a quad hold disjoint columns of the same rows
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mn[r] = fmaxf(m[r], fabsf(sc) * mx[r]);
      corr[r] = ex2(m[r] - mn[r]);
      m[r] = mn[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = ex2(fmaf(s[i], sc, -mn[(i >> 1) & 1]));
    if (ragged) {                           // exactly 0, whatever the scale
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (8 * (i / 4) + 2 * t + (i & 1) >= kvalid) s[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) l[(i >> 1) & 1] += s[i];
  }

  __device__ __forceinline__ void finish(float (&inv)[2], const float (&)[8]) {
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

// The block at padded width DP: NCONS consumer warpgroups of 64 query rows
// and a producer warpgroup. Shared memory: Q's slices, then STAGES stages of
// K's slices and V's slices, a 128 x 16 slice of ones (TENSOR_DEN), then the
// mbarriers (Q, full[STAGES], empty[STAGES]); 1 KB of slack to align the
// base to 1 KB.
template <int DP>
struct Smem {
  static constexpr int NCONS = DP <= THREE_CONSUMERS_MAX_DP ? 3 : 2;
  static constexpr int BQ = 64 * NCONS;
  static constexpr int NTHREADS = 128 * (NCONS + 1);
  static constexpr int NS = DP / SLICE;
  static constexpr int Q_SLICE = BQ * SLICE * 2;
  static constexpr int KV_SLICE = BK * SLICE * 2;
  static constexpr int Q_BYTES = NS * Q_SLICE;
  static constexpr int KV_BYTES = NS * KV_SLICE;          // K or V of one stage
  static constexpr int FIT = (227 * 1024 - 1024 - 256 - KV_SLICE - Q_BYTES) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static_assert(STAGES >= 2, "two stages must fit");
  static constexpr int ONES = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int BAR = ONES + KV_SLICE;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DP, class Policy>
__global__ void __launch_bounds__(Smem<DP>::NTHREADS, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv, __nv_bfloat16* __restrict__ o,
                  int Lq, int Lk, int D, float scale, float smax, int clamp) {
  using L = Smem<DP>;
  constexpr int NS = L::NS;
  constexpr int STAGES = L::STAGES;
  constexpr int NCONS = L::NCONS;
  constexpr int BQ = L::BQ;
  // the consumers take turns to issue their products, except the online
  // softmax with two consumers: its row max and rescale sit between its
  // products, and it measured faster without the turns (PERF.md)
  constexpr bool PINGPONG = !(Policy::RESCALES && NCONS == 2);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = sq + L::BAR;
  auto full = [&](int st) { return bars + 8u + 8u * st; };
  auto empty = [&](int st) { return bars + 8u + 8u * (STAGES + st); };
  auto kstage = [&](int st) { return sq + L::Q_BYTES + (uint32_t)(st * 2 * L::KV_BYTES); };
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (Lk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * NCONS);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (Policy::TENSOR_DEN) {
    for (int i = threadIdx.x; i < L::KV_SLICE / 16; i += blockDim.x)   // bf16 1.0
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n"
                   :: "r"(sq + L::ONES + 16 * i), "r"(0x3F803F80u) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // seen by wgmma
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bars, L::Q_BYTES);
      for (int c = 0; c < NS; ++c)
        tma_load_3d(sq + c * L::Q_SLICE, &mq, bars, c * SLICE, q0, bh);
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(st), ((it / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(full(st), 2 * L::KV_BYTES);
        const uint32_t ks = kstage(st);
        for (int c = 0; c < NS; ++c) {
          tma_load_3d(ks + c * L::KV_SLICE, &mk, full(st), c * SLICE, it * BK, bh);
          tma_load_3d(ks + L::KV_BYTES + c * L::KV_SLICE, &mv, full(st), c * SLICE, it * BK, bh);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (NCONS == 3)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;                  // consumer 0 .. NCONS - 1
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const uint32_t qw = sq + cw * 64 * SLICE * 2;   // this consumer's 64 rows of a Q slice
    const int kvalid = Lk - (ntiles - 1) * BK;      // real kv rows of the last tile
    const bool ragged = kvalid < BK;

    Policy pol(scale, smax, clamp);
    float s[64];
    uint32_t p[32];
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float corr[2] = {1.f, 1.f};
    float dacc[8];                          // P times ones (TENSOR_DEN)
#pragma unroll
    for (int i = 0; i < 8; ++i) dacc[i] = 0.f;

    auto issue_qk = [&](int st) {
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_reg(s[i]);
      wgmma_fence();
      const uint32_t ks = kstage(st);
#pragma unroll
      for (int c = 0; c < NS; ++c)
        wgmma_ss_n128(s, desc_b32(qw + c * L::Q_SLICE, 16, 256),
                      desc_b32(ks + c * L::KV_SLICE, 16, 256), c > 0);
      wgmma_commit();
    };
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) fence_reg(acc[i]);
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_reg(p[i]);
#pragma unroll
      for (int i = 0; i < 8; ++i) fence_reg(dacc[i]);
      wgmma_fence();
      const uint32_t vs = kstage(st) + L::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        const uint32_t vk = vs + kk * 16 * SLICE * 2;   // kv rows 16kk.. of every slice
        if constexpr (DP == 48) {
          wgmma_rs_n48(acc, a, desc_b32(vk, L::KV_SLICE, 256));
        } else if constexpr (DP == 64) {
          wgmma_rs_n64(acc, a, desc_b32(vk, L::KV_SLICE, 256));
        } else if constexpr (DP == 80) {
          wgmma_rs_n80(acc, a, desc_b32(vk, L::KV_SLICE, 256));
        } else {
#pragma unroll
          for (int c = 0; c < NS; ++c)
            wgmma_rs_n16(acc + 8 * c, a, desc_b32(vk + c * L::KV_SLICE, L::KV_SLICE, 256));
        }
        if constexpr (Policy::TENSOR_DEN)
          wgmma_rs_n16(dacc, a, desc_b32(sq + L::ONES + kk * 16 * SLICE * 2, L::KV_SLICE, 256));
      }
      wgmma_commit();
    };

    // ping-pong: consumer c issues its products after consumer c - 1 (and
    // consumer 0 after the last), through named barrier 1 + c
    const int next_bar = 1 + (cw + 1) % NCONS;
    if (PINGPONG && cw == NCONS - 1) named_arrive(1);   // consumer 0 goes first
    mbar_wait(bars, 0);
    mbar_wait(full(0), 0);
    issue_qk(0);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_reg(s[i]);
    pol.exps(s, kvalid, t, ragged && ntiles == 1, corr);
    pack(s, p);

    auto rescale = [&]() {
      if constexpr (Policy::RESCALES) {
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          acc[4 * j] *= corr[0];
          acc[4 * j + 1] *= corr[0];
          acc[4 * j + 2] *= corr[1];
          acc[4 * j + 3] *= corr[1];
        }
      }
    };
    // Every tile but the last: the products of two tiles in flight at once.
    // The last tile is peeled off, so that the loop body is straight-line
    // code for the compiler's tracking of the asynchronous products.
    for (int it = 0; it + 1 < ntiles; ++it) {
      const int st = it % STAGES;
      const int sn = (it + 1) % STAGES;
      if (PINGPONG) named_sync(1 + cw);
      mbar_wait(full(sn), ((it + 1) / STAGES) & 1);
      issue_qk(sn);                         // S of tile it + 1 ...
      rescale();
      issue_pv(st);                         // ... then O += P V of tile it
      if (PINGPONG) named_arrive(next_bar);
      wgmma_wait<1>();                      // S of tile it + 1 has landed
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_reg(s[i]);
      // its exps run while P.V of tile it is in flight
      pol.exps(s, kvalid, t, ragged && it + 2 == ntiles, corr);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) fence_reg(acc[i]);
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_reg(p[i]);
#pragma unroll
      for (int i = 0; i < 8; ++i) fence_reg(dacc[i]);
      if (lane == 0) mbar_arrive(empty(st));  // this warp is done with stage st
      pack(s, p);
    }
    // the last tile: P.V only (the last consumer gave consumer 0 its first
    // turn, so it owes no arrival after its last one)
    if (PINGPONG) named_sync(1 + cw);
    rescale();
    issue_pv((ntiles - 1) % STAGES);
    if (PINGPONG && cw != NCONS - 1) named_arrive(next_bar);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) fence_reg(acc[i]);
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(p[i]);
#pragma unroll
    for (int i = 0; i < 8; ++i) fence_reg(dacc[i]);

    float inv[2];
    pol.finish(inv, dacc);
    const int r0 = q0 + cw * 64 + warp * 16 + g;
    const int r1 = r0 + 8;
    __nv_bfloat16* ob = o + (size_t)bh * Lq * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;        // D % 8 == 0: col < D covers col + 1
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

template <int DP, class Policy>
cudaError_t launch_dp(const void* q, const void* k, const void* v, void* o, int bh, int Lq,
                      int Lk, int D, float scale, float smax, int clamp, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  constexpr int BQ = Smem<DP>::BQ;
  if (!slice_map_bf16(&mq, q, bh, Lq, D, BQ) || !slice_map_bf16(&mk, k, bh, Lk, D, BK) ||
      !slice_map_bf16(&mv, v, bh, Lk, D, BK))
    return cudaErrorInvalidValue;
  const int smem = Smem<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_sm90_kernel<DP, Policy>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, bh);
  flash_sm90_kernel<DP, Policy><<<grid, Smem<DP>::NTHREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Lq, Lk, D, scale, smax, clamp);
  return cudaGetLastError();
}

// q, k, v, o: contiguous bf16 [bh, L, D], D % 8 == 0, 16 <= D <= 160,
// 16-byte aligned bases; D is padded to the next multiple of 16.
template <class Policy>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int Lq,
                   int Lk, int D, float scale, float smax, int clamp, cudaStream_t stream) {
  if (D % 8 != 0 || D < 16 || D > 160) return cudaErrorInvalidValue;
  switch ((D + 15) / 16) {
    case 1: return launch_dp<16, Policy>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, stream);
    case 2: return launch_dp<32, Policy>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, stream);
    case 3: return launch_dp<48, Policy>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, stream);
    case 4: return launch_dp<64, Policy>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, stream);
    case 5: return launch_dp<80, Policy>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, stream);
    case 6: return launch_dp<96, Policy>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, stream);
    case 7: return launch_dp<112, Policy>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, stream);
    case 8: return launch_dp<128, Policy>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, stream);
    case 9: return launch_dp<144, Policy>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, stream);
    default: return launch_dp<160, Policy>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, stream);
  }
}

}  // namespace sm90
}  // namespace mdu
