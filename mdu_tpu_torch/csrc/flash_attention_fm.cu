// Fixed-shift flash attention for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces the TPU kernel mdu_tpu/ops/pallas/flash_attention.py::
// flash_attention_t_fm (body _flash_kernel_t_fm). It computes the same
// function, not the same block structure:
//   p   = bf16(exp(min(s * scale, smax) - smax))     (min only with clamp)
//   out = (sum_j p_j v_j) / max(sum_j p_j, 1e-30)     over real kv columns j
// The denominator sums the bf16-rounded p, as the TPU kernel's ones row of V
// did on its matrix unit; here it is a row sum kept in registers. The TPU's
// [D, L] transpose, ones row and lane padding have no counterpart.
// With the template flag BF16_EXP (the TPU kernel's ``bf16_exp``, selected by
// MDU_FLASH=fm16) the shifted score is rounded to bf16 before the exp:
//   p   = bf16(exp(bf16(min(s * scale, smax) - smax))).
//
// Two forms, chosen by the wrapper (ops/kernels/flash.py) on shape and
// alignment alone:
// - mdu_flash_attention_fm_sm90: the warpgroup kernel of
//   flash_attention_sm90.cuh (wgmma, TMA, a producer warp and two or three
//   consumer warpgroups) with the FixedShift policy, for D % 8 == 0,
//   16 <= D <= 160 and 16-byte aligned inputs: all of config 2 (D = 40, 80).
//   What bounds it, and how it overlaps the exps with the products, is in
//   that header: at [10, 8, 6144, 40] the tensor cores (0.489 ms) and the
//   MUFU exp floor (about 0.72 ms at 1.98 GHz).
// - mdu_flash_attention_fm: the mma.sync kernel below, for any D <= 160
//   (D = 13, unaligned inputs).
// bf16 heads wider than 160 (the VAE's 512) go to flash_attention.cu's
// split-D kernel with the same fixed-shift policy.
//
// The mma.sync form: the fixed shift removes the running max and the per-tile
// rescale of the accumulator, so each kv tile costs two tensor-core products
// and one fused multiply-add + exp2 per score; the kv mask runs only on the
// ragged last tile. K and V tiles are double-buffered with cp.async, and
// fragments come from shared memory through ldmatrix. One block of 4 warps
// per (batch*head, 64-query tile); each warp owns 16 query rows and loops over
// 64-row kv tiles held in shared memory. Each warp issues 24 mma.sync, 12
// ldmatrix.x4 and 32 exp2 a lane per kv tile, and no product overlaps the
// exps of the same warp: that instruction count, not L2, bounds it (128-query
// blocks of 8 warps halve the L2 reads of K and V but measured no faster).
// D is padded to DP (a multiple of 16) with zero-filled loads.
#include "flash_attention_sm90.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr float LOG2E = 1.4426950408889634f;

template <int DP, bool BF16_EXP>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fm_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int Lq, int Lk, int D,
                float scale, float smax, int clamp, int vec) {
  constexpr int LDS = DP + 8;          // +16 bytes: conflict-free ldmatrix rows
  constexpr int KB = DP / 16;          // k-steps of Q.K^T
  constexpr int NT = DP / 8;           // n-tiles of P.V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LDS;   // [2 stages][BK][LDS]
  __nv_bfloat16* Vs = Ks + 2 * BK * LDS;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int lm = lane / 8;             // ldmatrix: the matrix this lane addresses
  const int lr = lane % 8;             // ... and its row
  const __nv_bfloat16* qb = q + (size_t)bh * Lq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * Lk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Lk * D;
  const int ntiles = (Lk + BK - 1) / BK;

  auto load_kv = [&](int tile, int stage) {
    __nv_bfloat16* ks = Ks + stage * BK * LDS;
    __nv_bfloat16* vs = Vs + stage * BK * LDS;
    if (vec) {
      mdu::load_tile_async<BK, DP, LDS>(ks, kb, tile * BK, Lk, D);
      mdu::load_tile_async<BK, DP, LDS>(vs, vb, tile * BK, Lk, D);
    } else {
      mdu::load_tile<BK, DP, LDS>(ks, kb, tile * BK, Lk, D, false);
      mdu::load_tile<BK, DP, LDS>(vs, vb, tile * BK, Lk, D, false);
    }
    mdu::cp_async_commit();
  };

  load_kv(0, 0);
  mdu::load_tile<BQ, DP, LDS>(Qs, qb, q0, Lq, D, vec);
  __syncthreads();

  // this warp's 16 query rows as A fragments, kept for the whole kv loop
  uint32_t qa[KB][4];
  const __nv_bfloat16* qw = Qs + warp * 16 * LDS;
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
    qa[kk][0] = mdu::ld_u32(qw + g * LDS + kk * 16 + 2 * t);
    qa[kk][1] = mdu::ld_u32(qw + (g + 8) * LDS + kk * 16 + 2 * t);
    qa[kk][2] = mdu::ld_u32(qw + g * LDS + kk * 16 + 2 * t + 8);
    qa[kk][3] = mdu::ld_u32(qw + (g + 8) * LDS + kk * 16 + 2 * t + 8);
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float den0 = 0.f, den1 = 0.f;        // rows g and g+8 (this lane's columns)
  const float sc = scale * LOG2E;      // exp(x) = exp2(x * log2 e)
  const float sh = smax * LOG2E;

  for (int it = 0; it < ntiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < ntiles) {
      load_kv(it + 1, stage ^ 1);
      mdu::cp_async_wait<1>();
    } else {
      mdu::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = Ks + stage * BK * LDS;
    const __nv_bfloat16* vs = Vs + stage * BK * LDS;
    const int k0 = it * BK;

    // S = Q K^T for 16 rows x 64 kv columns; B fragments of two n-tiles at
    // a time: matrices (n, d lo), (n, d hi), (n+1, d lo), (n+1, d hi)
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; n += 2) {
      const __nv_bfloat16* kr = ks + ((n + lm / 2) * 8 + lr) * LDS + (lm % 2) * 8;
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        uint32_t b[4];
        mdu::ldmatrix_x4(b, kr + kk * 16);
        mdu::mma_16816(s[n], qa[kk], b[0], b[1]);
        mdu::mma_16816(s[n + 1], qa[kk], b[2], b[3]);
      }
    }

    // fixed-shift exp, rounded to bf16; kv columns past Lk contribute 0
    uint32_t pa[BK / 8][2];
    const bool ragged = k0 + BK > Lk;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x;
        if constexpr (BF16_EXP) {
          // the shift in the natural domain, rounded to bf16, then the exp
          const float e = clamp ? fminf(s[n][j] * scale, smax) - smax
                                : fmaf(s[n][j], scale, -smax);
          x = __bfloat162float(__float2bfloat16_rn(e)) * LOG2E;
        } else {
          x = clamp ? fminf(s[n][j] * sc, sh) - sh : fmaf(s[n][j], sc, -sh);
        }
        p[j] = mdu::ex2(x);
      }
      if (ragged) {
        const int col = k0 + n * 8 + 2 * t;
        if (col >= Lk) p[0] = p[2] = 0.f;
        if (col + 1 >= Lk) p[1] = p[3] = 0.f;
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(p[0], p[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p[2], p[3]);
      const float2 flo = __bfloat1622float2(lo);
      const float2 fhi = __bfloat1622float2(hi);
      den0 += flo.x + flo.y;
      den1 += fhi.x + fhi.y;
      pa[n][0] = *reinterpret_cast<const uint32_t*>(&lo);
      pa[n][1] = *reinterpret_cast<const uint32_t*>(&hi);
    }

    // acc += P V: the S accumulator layout is the A fragment layout of P; V
    // fragments by ldmatrix.trans: matrices (kv lo, n), (kv hi, n),
    // (kv lo, n+1), (kv hi, n+1)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1],
                             pa[2 * kk + 1][0], pa[2 * kk + 1][1]};
      const __nv_bfloat16* vr = vs + (kk * 16 + (lm % 2) * 8 + lr) * LDS + (lm / 2) * 8;
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];
        mdu::ldmatrix_x4_trans(b, vr + n * 8);
        mdu::mma_16816(acc[n], a, b[0], b[1]);
        mdu::mma_16816(acc[n + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                   // this stage is refilled next iteration
  }

  // the four lanes of a quad hold disjoint columns of the same rows
  den0 += __shfl_xor_sync(0xffffffffu, den0, 1);
  den0 += __shfl_xor_sync(0xffffffffu, den0, 2);
  den1 += __shfl_xor_sync(0xffffffffu, den1, 1);
  den1 += __shfl_xor_sync(0xffffffffu, den1, 2);
  const float inv0 = 1.f / fmaxf(den0, 1e-30f);
  const float inv1 = 1.f / fmaxf(den1, 1e-30f);

  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  __nv_bfloat16* ob = o + (size_t)bh * Lq * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n * 8 + 2 * t + j;
      if (col < D) {
        if (r0 < Lq) ob[(size_t)r0 * D + col] = __float2bfloat16_rn(acc[n][j] * inv0);
        if (r1 < Lq) ob[(size_t)r1 * D + col] = __float2bfloat16_rn(acc[n][2 + j] * inv1);
      }
    }
  }
}

template <int DP, bool BF16_EXP>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* o,
                     int bh, int Lq, int Lk, int D, float scale, float smax,
                     int clamp, int vec, cudaStream_t stream) {
  const int smem = (BQ + 4 * BK) * (DP + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fm_kernel<DP, BF16_EXP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, bh);
  flash_fm_kernel<DP, BF16_EXP><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Lq, Lk, D, scale, smax, clamp, vec);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int Lq, int Lk, int D, float scale, float smax,
                   int clamp, int bf16_exp, int vec, cudaStream_t stream) {
  if (bf16_exp)
    return launch_t<DP, true>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, vec, stream);
  return launch_t<DP, false>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, vec, stream);
}

}  // namespace

// q, k, v, o: contiguous bf16 [bh, L, D]; 1 <= D <= 160. Returns a
// cudaError_t (0 on a successful launch).
extern "C" int mdu_flash_attention_fm(const void* q, const void* k,
                                      const void* v, void* o, int bh, int Lq,
                                      int Lk, int D, float scale, float smax,
                                      int clamp, int bf16_exp, int vec,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 48) return launch<48>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, bf16_exp, vec, s);
  if (D <= 64) return launch<64>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, bf16_exp, vec, s);
  if (D <= 80) return launch<80>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, bf16_exp, vec, s);
  if (D <= 96) return launch<96>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, bf16_exp, vec, s);
  if (D <= 128) return launch<128>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, bf16_exp, vec, s);
  if (D <= 160) return launch<160>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, bf16_exp, vec, s);
  return (int)cudaErrorInvalidValue;
}

// The warpgroup form: q, k, v, o contiguous bf16 [bh, L, D], D % 8 == 0,
// 16 <= D <= 160, 16-byte aligned. Returns a cudaError_t (0 on a successful
// launch).
extern "C" int mdu_flash_attention_fm_sm90(const void* q, const void* k, const void* v,
                                           void* o, int bh, int Lq, int Lk, int D,
                                           float scale, float smax, int clamp, int bf16_exp,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using mdu::sm90::FixedShift;
  if (bf16_exp)
    return mdu::sm90::launch<FixedShift<true>>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, s);
  return mdu::sm90::launch<FixedShift<false>>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, s);
}
