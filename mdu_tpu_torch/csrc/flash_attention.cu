// Online-softmax flash attention for Hopper (sm_90a), bf16 in, fp32
// accumulate, for wide heads (D up to 512).
//
// Replaces the TPU kernel mdu_tpu/ops/pallas/flash_attention.py::
// flash_attention (body _flash_kernel): softmax(q k^T * scale) v with a
// running row max m, an fp32 denominator l of the unrounded p and an fp32
// accumulator; p is rounded to bf16 for the P.V product. The ragged kv edge
// is masked directly (scores -1e30), so the TPU's closed-form pad correction
// of l is not needed; l is still floored at 1e-30.
//
// What bounds it on an H100: on the main path it runs the VAE mid-block
// attention, one head at D = 512 over 9600 tokens: 4*L^2*D flops against
// 8*L*D bytes, so the tensor cores bound it. The design constraint is the
// accumulator: 64 query rows x 512 fp32 would be 128 KB of registers for one
// block. So a block takes 32 query rows and 8 warps, and splits D four ways:
// warp (r, c) owns rows 16r..16r+15 and columns c*D/4.. of the accumulator
// (64 registers a thread at D = 512). Q.K^T is split along D the same way;
// the four partial score tiles of a row group are summed through shared
// memory, and every warp of the group then runs the same online softmax on
// the full scores. A 64-row K tile and V tile live in dynamic shared memory
// (199 KB at D = 512, set with cudaFuncSetAttribute), so there is room for
// one stage only: K and V arrive by cp.async in two groups, and V's copy
// overlaps the Q.K^T products and the softmax. Fragments come from shared
// memory through ldmatrix.
//
// Two forms, chosen by the wrapper (ops/kernels/flash.py::bf16_form) on
// shape and alignment alone: the warpgroup form (wgmma and TMA, two
// consumer warpgroups splitting D; flash_attention_wide_sm90.cuh) for D % 8
// == 0, 160 < D <= 512 and 16-byte aligned inputs, entry points
// mdu_flash_attention_wide and mdu_flash_attention_fm_wide; this mma.sync
// kernel for any other bf16 input up to D = 512, entry points
// mdu_flash_attention and mdu_flash_attention_fm_wide_mma.
//
// With the template flag FIXED the same layout computes kernel #1's function
// (flash_attention_fm.cu, TPU kernel flash_attention_t_fm) for bf16 heads
// wider than 160, which the VAE's D = 512 needs under MDU_FLASH=fm|fm16: a
// fixed shift smax in place of the running max (no rescale), p =
// bf16(exp(min(s * scale, smax) - smax)) (BF16_EXP: the shifted score rounded
// to bf16 first), and a denominator that sums the rounded p over the real kv
// columns, floored at 1e-30 (entry point mdu_flash_attention_fm_wide_mma).
#include "mma_bf16.cuh"
#include "flash_attention_wide_sm90.cuh"

namespace {

constexpr int BQ = 32;
constexpr int BK = 64;
constexpr int NWARPS = 8;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int DP, bool FIXED, bool BF16_EXP>
__global__ void __launch_bounds__(NWARPS * 32)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             __nv_bfloat16* __restrict__ o, int Lq, int Lk, int D, float scale,
             float smax, int clamp, int vec) {
  constexpr int LDS = DP + 8;
  constexpr int DQ = DP / 4;           // accumulator columns of one warp
  constexpr int KB = DQ / 16;          // k-steps of the partial Q.K^T
  constexpr int NT = DQ / 8;           // n-tiles of P.V
  constexpr int ST = BK / 8;           // n-tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LDS;
  __nv_bfloat16* Vs = Ks + BK * LDS;
  float* Sp = reinterpret_cast<float*>(Vs + BK * LDS);   // [NWARPS][ST][32][4]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rg = warp / 4;             // row group
  const int dq = warp % 4;             // D quarter
  const int lm = lane / 8;             // ldmatrix: the matrix this lane addresses
  const int lr = lane % 8;             // ... and its row
  const __nv_bfloat16* qb = q + (size_t)bh * Lq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * Lk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Lk * D;

  mdu::load_tile<BQ, DP, LDS>(Qs, qb, q0, Lq, D, vec);
  __syncthreads();

  uint32_t qa[KB][4];
  const __nv_bfloat16* qw = Qs + rg * 16 * LDS + dq * DQ;
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
  float m0 = NEG, m1 = NEG;            // running max of rows g and g+8
  float l0 = 0.f, l1 = 0.f;            // this lane's share of the denominators

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();
    if (vec) {
      mdu::load_tile_async<BK, DP, LDS>(Ks, kb, k0, Lk, D);
      mdu::cp_async_commit();
      mdu::load_tile_async<BK, DP, LDS>(Vs, vb, k0, Lk, D);
      mdu::cp_async_commit();
      mdu::cp_async_wait<1>();           // K has landed; V is still in flight
    } else {
      mdu::load_tile<BK, DP, LDS>(Ks, kb, k0, Lk, D, false);
      mdu::load_tile<BK, DP, LDS>(Vs, vb, k0, Lk, D, false);
    }
    __syncthreads();

    // partial scores over this warp's quarter of D; B fragments of two
    // n-tiles at a time: matrices (n, d lo), (n, d hi), (n+1, d lo), (n+1, d hi)
    float* mine = Sp + warp * ST * 128;
#pragma unroll
    for (int n = 0; n < ST; n += 2) {
      float s0[4] = {0.f, 0.f, 0.f, 0.f};
      float s1[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* kr = Ks + ((n + lm / 2) * 8 + lr) * LDS + dq * DQ + (lm % 2) * 8;
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        uint32_t b[4];
        mdu::ldmatrix_x4(b, kr + kk * 16);
        mdu::mma_16816(s0, qa[kk], b[0], b[1]);
        mdu::mma_16816(s1, qa[kk], b[2], b[3]);
      }
      *reinterpret_cast<float4*>(mine + (n * 32 + lane) * 4) =
          make_float4(s0[0], s0[1], s0[2], s0[3]);
      *reinterpret_cast<float4*>(mine + ((n + 1) * 32 + lane) * 4) =
          make_float4(s1[0], s1[1], s1[2], s1[3]);
    }
    mdu::cp_async_wait<0>();             // V, visible to all after the barrier
    __syncthreads();

    // full scores of the row group, summed in a fixed order
    float s[ST][4];
    float mx0 = NEG, mx1 = NEG;
    uint32_t pa[ST][2];
#pragma unroll
    for (int n = 0; n < ST; ++n) {
      float4 acc4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float4 p4 = *reinterpret_cast<const float4*>(
            Sp + ((rg * 4 + w) * ST * 32 + n * 32 + lane) * 4);
        acc4.x += p4.x; acc4.y += p4.y; acc4.z += p4.z; acc4.w += p4.w;
      }
      const float sv[4] = {acc4.x, acc4.y, acc4.z, acc4.w};
      if constexpr (FIXED) {
        // the fixed shift: p rounded to bf16, the denominator sums the
        // rounded p; kv columns past Lk contribute 0
        float p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x;
          if constexpr (BF16_EXP) {
            const float e = clamp ? fminf(sv[j] * scale, smax) - smax
                                  : fmaf(sv[j], scale, -smax);
            x = __bfloat162float(__float2bfloat16_rn(e)) * LOG2E;
          } else {
            x = clamp ? fminf(sv[j] * scale * LOG2E, smax * LOG2E) - smax * LOG2E
                      : fmaf(sv[j], scale * LOG2E, -smax * LOG2E);
          }
          p[j] = k0 + n * 8 + 2 * t + (j & 1) < Lk ? mdu::ex2(x) : 0.f;
        }
        const __nv_bfloat162 lo = __floats2bfloat162_rn(p[0], p[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p[2], p[3]);
        const float2 flo = __bfloat1622float2(lo);
        const float2 fhi = __bfloat1622float2(hi);
        l0 += flo.x + flo.y;
        l1 += fhi.x + fhi.y;
        pa[n][0] = *reinterpret_cast<const uint32_t*>(&lo);
        pa[n][1] = *reinterpret_cast<const uint32_t*>(&hi);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + n * 8 + 2 * t + (j & 1);
          s[n][j] = col < Lk ? sv[j] * scale : NEG;
        }
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
    }
    if constexpr (!FIXED) {            // the online softmax
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      const float c0 = __expf(m0 - mn0);
      const float c1 = __expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= c0;
      l1 *= c1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= c0; acc[n][1] *= c0;
        acc[n][2] *= c1; acc[n][3] *= c1;
      }

#pragma unroll
      for (int n = 0; n < ST; ++n) {
        const float p0 = __expf(s[n][0] - mn0), p1 = __expf(s[n][1] - mn0);
        const float p2 = __expf(s[n][2] - mn1), p3 = __expf(s[n][3] - mn1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        pa[n][0] = mdu::pack_bf16(__float2bfloat16_rn(p0), __float2bfloat16_rn(p1));
        pa[n][1] = mdu::pack_bf16(__float2bfloat16_rn(p2), __float2bfloat16_rn(p3));
      }
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1],
                             pa[2 * kk + 1][0], pa[2 * kk + 1][1]};
      // matrices (kv lo, n), (kv hi, n), (kv lo, n+1), (kv hi, n+1)
      const __nv_bfloat16* vr =
          Vs + (kk * 16 + (lm % 2) * 8 + lr) * LDS + dq * DQ + (lm / 2) * 8;
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];
        mdu::ldmatrix_x4_trans(b, vr + n * 8);
        mdu::mma_16816(acc[n], a, b[0], b[1]);
        mdu::mma_16816(acc[n + 1], a, b[2], b[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);

  const int r0 = q0 + rg * 16 + g;
  const int r1 = r0 + 8;
  __nv_bfloat16* ob = o + (size_t)bh * Lq * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = dq * DQ + n * 8 + 2 * t + j;
      if (col < D) {
        if (r0 < Lq) ob[(size_t)r0 * D + col] = __float2bfloat16_rn(acc[n][j] * inv0);
        if (r1 < Lq) ob[(size_t)r1 * D + col] = __float2bfloat16_rn(acc[n][2 + j] * inv1);
      }
    }
  }
}

template <int DP, bool FIXED = false, bool BF16_EXP = false>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int Lq, int Lk, int D, float scale, int vec,
                   cudaStream_t stream, float smax = 0.f, int clamp = 0) {
  const int smem = (BQ + 2 * BK) * (DP + 8) * (int)sizeof(__nv_bfloat16) +
                   NWARPS * (BK / 8) * 32 * 4 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<DP, FIXED, BF16_EXP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, bh);
  flash_kernel<DP, FIXED, BF16_EXP><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Lq, Lk, D, scale, smax, clamp, vec);
  return cudaGetLastError();
}

template <bool BF16_EXP>
cudaError_t launch_fixed(const void* q, const void* k, const void* v, void* o,
                         int bh, int Lq, int Lk, int D, float scale, float smax,
                         int clamp, int vec, cudaStream_t s) {
  if (D <= 128) return launch<128, true, BF16_EXP>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s, smax, clamp);
  if (D <= 256) return launch<256, true, BF16_EXP>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s, smax, clamp);
  if (D <= 384) return launch<384, true, BF16_EXP>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s, smax, clamp);
  if (D <= 512) return launch<512, true, BF16_EXP>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s, smax, clamp);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: contiguous bf16 [bh, L, D]; 1 <= D <= 512 (padded to a
// multiple of 128). Returns a cudaError_t (0 on a successful launch).
extern "C" int mdu_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int bh, int Lq, int Lk, int D,
                                   float scale, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 128) return launch<128>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s);
  if (D <= 256) return launch<256>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s);
  if (D <= 384) return launch<384>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s);
  if (D <= 512) return launch<512>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel #1's fixed-shift function on the same split-D layout: q, k, v, o
// contiguous bf16 [bh, L, D]; 1 <= D <= 512. Returns a cudaError_t (0 on a
// successful launch).
extern "C" int mdu_flash_attention_fm_wide_mma(const void* q, const void* k, const void* v,
                                               void* o, int bh, int Lq, int Lk, int D,
                                               float scale, float smax, int clamp,
                                               int bf16_exp, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_exp) return launch_fixed<true>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, vec, s);
  return launch_fixed<false>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, vec, s);
}

// The warpgroup form (flash_attention_wide_sm90.cuh), online softmax: q, k,
// v, o contiguous bf16 [bh, L, D], D % 8 == 0, 160 < D <= 512, 16-byte
// aligned bases. Returns a cudaError_t (0 on a successful launch).
extern "C" int mdu_flash_attention_wide(const void* q, const void* k, const void* v, void* o,
                                        int bh, int Lq, int Lk, int D, float scale,
                                        void* stream) {
  return (int)mdu::wide::launch<mdu::wide::Online>(q, k, v, o, bh, Lq, Lk, D, scale, 0.f, 0,
                                                   static_cast<cudaStream_t>(stream));
}

// The warpgroup form with kernel #1's fixed shift, the same inputs. Returns
// a cudaError_t (0 on a successful launch).
extern "C" int mdu_flash_attention_fm_wide(const void* q, const void* k, const void* v,
                                           void* o, int bh, int Lq, int Lk, int D,
                                           float scale, float smax, int clamp, int bf16_exp,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using mdu::wide::FixedShift;
  if (bf16_exp)
    return (int)mdu::wide::launch<FixedShift<true>>(q, k, v, o, bh, Lq, Lk, D, scale, smax,
                                                    clamp, s);
  return (int)mdu::wide::launch<FixedShift<false>>(q, k, v, o, bh, Lq, Lk, D, scale, smax,
                                                   clamp, s);
}
