// Online-softmax flash attention for Hopper (sm_90a) with head dims padded
// to a multiple of 16, bf16 in, fp32 accumulate.
//
// Replaces the TPU kernel mdu_tpu/ops/pallas/flash_attention.py::
// flash_attention_t (body _flash_kernel_t), the kernel MDU_FLASH=trans
// selects. It computes the function of flash_attention (flash_attention.cu):
// softmax(q k^T * scale) v with a running row max m, an fp32 denominator l of
// the unrounded p, an fp32 accumulator rescaled when m grows, and p rounded to
// bf16 for the P.V product. The TPU kernel's [D, L] transpose existed to pad
// D only to a multiple of 16 (sublanes) instead of 128 (lanes); SD1.5's head
// dims are 40, 80 and 160. Here that padding is the whole point that carries
// over: D is padded to DP, a multiple of 16 (48 / 80 / 160 for SD1.5), with
// zero-filled loads, so Q.K^T contracts over about D, not 128. The ragged kv
// edge is masked (scores -inf), so the TPU's closed-form pad correction of l
// is not needed; l is still floored at 1e-30.
//
// What bounds it on an H100: at config 2's UNet self-attention shapes
// ([10, 8, 6144, 40], [10, 8, 1536, 80]) 4*L^2*D flops against 8*L*D bytes,
// far above the ridge, so the tensor cores, and close behind them the exp of
// every score (one MUFU op per 160 tensor-core flops at D = 40). Against the
// fixed-shift kernel (flash_attention_fm.cu) it adds per kv tile a row max
// (two quad shuffles), one exp2 per row for the correction and a rescale of
// the accumulator: the cost of not assuming a bound on the logits.
//
// Layout, as flash_attention_fm.cu: one block of 4 warps per (batch*head,
// 64-query tile); each warp owns 16 query rows and loops over 64-row kv tiles,
// double-buffered in shared memory with cp.async; fragments by ldmatrix.
#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG = -1e30f;

template <int DP>
__global__ void __launch_bounds__(NWARPS * 32)
flash_t_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int Lq, int Lk, int D,
               float scale, int vec) {
  constexpr int LDS = DP + 8;          // +16 bytes: conflict-free ldmatrix rows
  constexpr int KB = DP / 16;          // k-steps of Q.K^T
  constexpr int NT = DP / 8;           // n-tiles of P.V (even: DP % 16 == 0)
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
  // running max (log2 domain) and this lane's share of the denominator of
  // rows g and g+8
  float m0 = NEG, m1 = NEG;
  float l0 = 0.f, l1 = 0.f;
  const float sc = scale * LOG2E;      // exp(x) = exp2(x * log2 e)

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

    // scaled scores in the log2 domain; kv columns past Lk are -inf
    const bool ragged = k0 + BK > Lk;
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[n][j] * sc;
        if (ragged && k0 + n * 8 + 2 * t + (j & 1) >= Lk) x = NEG;
        s[n][j] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // the four lanes of a quad hold disjoint columns of the same rows
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float c0 = mdu::ex2(m0 - mn0);
    const float c1 = mdu::ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= c0; acc[n][1] *= c0;
      acc[n][2] *= c1; acc[n][3] *= c1;
    }

    // p: fp32 into the denominator, bf16 into the product
    uint32_t pa[BK / 8][2];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float p0 = mdu::ex2(s[n][0] - mn0), p1 = mdu::ex2(s[n][1] - mn0);
      const float p2 = mdu::ex2(s[n][2] - mn1), p3 = mdu::ex2(s[n][3] - mn1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[n][0] = mdu::pack_bf16(__float2bfloat16_rn(p0), __float2bfloat16_rn(p1));
      pa[n][1] = mdu::pack_bf16(__float2bfloat16_rn(p2), __float2bfloat16_rn(p3));
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

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);

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

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int Lq, int Lk, int D, float scale, int vec,
                   cudaStream_t stream) {
  const int smem = (BQ + 4 * BK) * (DP + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_t_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, bh);
  flash_t_kernel<DP><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Lq, Lk, D, scale, vec);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous bf16 [bh, L, D]; 1 <= D <= 160, padded to the next
// multiple of 16. Returns a cudaError_t (0 on a successful launch).
extern "C" int mdu_flash_attention_t(const void* q, const void* k, const void* v,
                                     void* o, int bh, int Lq, int Lk, int D,
                                     float scale, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return launch<16>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s);
    case 2: return launch<32>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s);
    case 3: return launch<48>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s);
    case 4: return launch<64>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s);
    case 5: return launch<80>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s);
    case 6: return launch<96>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s);
    case 7: return launch<112>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s);
    case 8: return launch<128>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s);
    case 9: return launch<144>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s);
    case 10: return launch<160>(q, k, v, o, bh, Lq, Lk, D, scale, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
