// The backward of flash attention on Hopper (sm_90a): dQ, dK and dV of
// O = softmax(Q K^T * scale) V on [bh, L, D], for fp32 or bf16 q, k, v, O and
// dO, fp32 accumulation, the gradients written in the inputs' dtype. This is
// the CUDA-core form (f32_simt, bf16_simt), which takes what the tensor-core
// forms (flash_attention_bwd_sm90.cuh: f32_sm90, bf16_sm90) do not: D off
// their multiples, unaligned views (ops/kernels/flash_bwd.py, bwd_form).
//
// Replaces no TPU kernel of its own: the TPU kernels of
// mdu_tpu/ops/pallas/flash_attention.py (flash_attention_t_fm,
// flash_attention, flash_attention_t) have no backward (``pallas_call`` has
// no transpose rule, so ``jax.grad`` through them fails). The port's wrappers
// (ops/kernels/flash.py) make each of the three a torch.autograd.Function
// whose backward is this kernel, so that a train step on the card keeps the
// gradient of every long self-attention. The gradient is that of exact
// softmax attention: the fixed shift of flash_attention_t_fm cancels, and the
// rounding of p to v's dtype in the forward is taken as the identity, as
// autograd through the plain version takes its ``.to(v.dtype)``.
//
// With P = exp(S * scale - lse) (lse: each query row's log-sum-exp), and
// delta = rowsum(dO o O) (the forward's O):
//   dV = P^T dO,   dP = dO V^T,   dS = P o (dP - delta),
//   dQ = scale * dS K,   dK = scale * dS^T Q.
// Three launches a call, never the [Lq, Lk] matrix in device memory:
//   lse_delta  one block per (bh, 64 query rows): the row log-sum-exp over
//              every kv tile (online max and sum) and delta;
//   dkdv       one block per (bh, 64 kv rows): loops over the query tiles,
//              recomputes S and dP, accumulates dK and dV in registers;
//   dq         one block per (bh, 64 query rows): loops over the kv tiles,
//              recomputes S and dP, accumulates dQ in registers. No atomics,
//              so the result is the same in every run.
//
// What bounds it on an H100: the work, five [L, L, D] products for the
// gradients and the recomputed Q K^T (2.5x the forward's flops and one more
// product), about 8 products in all with the two recomputations of S. It
// runs them as fp32 fused multiply-adds on the CUDA cores (67 TFLOP/s peak),
// fed from shared memory: a thread owns a 4 x 4 tile of a 64 x 64 score tile
// (rows ty + 16 i, columns tx + 16 j), so each depth step reads 8 values for
// 16 multiply-adds; rows are padded to DP + 1 floats, so the 16 rows that a
// half-warp reads fall in 16 banks. bf16 inputs are widened to fp32 as they
// are loaded.
//
// D <= 160 (every UNet head: 40, 80, 160, 64), any Lq and Lk (the ragged
// tiles are masked); the wrapper refuses wider heads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // rows of a query or kv tile
constexpr int NT = 256;         // threads: 16 (tx) x 16 (ty)
constexpr int PLD = BM + 1;     // row stride of the P and dS tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// rows [row0, row0 + BM) of src [L, D] into dst [BM][DP + 1] as fp32, zero
// past L and past D
template <int DP, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int L, int D) {
  constexpr int LD = DP + 1;
  for (int idx = threadIdx.x; idx < BM * DP; idx += NT) {
    const int r = idx / DP, d = idx - (idx / DP) * DP;
    const int gr = row0 + r;
    dst[r * LD + d] = (gr < L && d < D) ? to_f(src[(size_t)gr * D + d]) : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over DP
template <int DP>
__device__ __forceinline__ void rows_dot(float acc[4][4], const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int LD = DP + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r W[r][ty + 16 i] * X[r][tx + 16 j] over the BM rows of
// the tile (W: [BM][PLD], X: [BM][DP + 1]); transposed = W read as W^T
template <int DP, bool TRANSPOSED>
__device__ __forceinline__ void accumulate(float (*acc)[DP / 16], const float* W,
                                           const float* X, int ty, int tx) {
  constexpr int LD = DP + 1;
  constexpr int NJ = DP / 16;
#pragma unroll 2
  for (int r = 0; r < BM; ++r) {
    float w[4], x[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = TRANSPOSED ? W[r * PLD + ty + 16 * i] : W[(ty + 16 * i) * PLD + r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) x[j] = X[r * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(w[i], x[j], acc[i][j]);
  }
}

// the (max, sum) pair of a row over the 16 lanes of a half-warp (same ty)
__device__ __forceinline__ void merge_row(float& m, float& l) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    const float mm = fmaxf(m, m2);
    const float a = (m == -INFINITY) ? 0.f : l * expf(m - mm);
    const float b = (m2 == -INFINITY) ? 0.f : l2 * expf(m2 - mm);
    m = mm;
    l = a + b;
  }
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DP, typename T>
__global__ void __launch_bounds__(NT) lse_delta_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
    const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ delta,
    int Lq, int Lk, int D, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = DP + 1;
  float* Qs = smem;
  float* Ks = Qs + BM * LD;
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qb = q + (size_t)bh * Lq * D;
  const T* kb = k + (size_t)bh * Lk * D;
  load_tile<DP>(Qs, qb, q0, Lq, D);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  for (int k0 = 0; k0 < Lk; k0 += BM) {
    __syncthreads();
    load_tile<DP>(Ks, kb, k0, Lk, D);
    __syncthreads();
    float s[4][4];
    rows_dot<DP>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < Lk) mt = fmaxf(mt, s[i][j] * scale);
      if (mt == -INFINITY) continue;
      if (mt > m[i]) {
        l[i] = (m[i] == -INFINITY) ? 0.f : l[i] * expf(m[i] - mt);
        m[i] = mt;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < Lk) l[i] += expf(s[i][j] * scale - m[i]);
    }
  }
  const T* ob = o + (size_t)bh * Lq * D;
  const T* gb = dout + (size_t)bh * Lq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    merge_row(m[i], l[i]);
    const int r = q0 + ty + 16 * i;
    float dd = 0.f;
    if (r < Lq)
      for (int d = tx; d < D; d += 16)
        dd = fmaf(to_f(ob[(size_t)r * D + d]), to_f(gb[(size_t)r * D + d]), dd);
    dd = half_warp_sum(dd);
    if (tx == 0 && r < Lq) {
      lse[(size_t)bh * Lq + r] = m[i] + logf(l[i]);
      delta[(size_t)bh * Lq + r] = dd;
    }
  }
}

// P and dS of a (query tile, kv tile) pair, each thread's 4 x 4 entries
// (query rows q0 + ty + 16 i, kv columns k0 + tx + 16 j), from the tiles in
// shared memory and each query row's lse and delta
template <int DP>
__device__ __forceinline__ void p_and_ds(float p[4][4], float ds[4][4], const float* Qs,
                                         const float* Ks, const float* Vs, const float* dOs,
                                         const float lse_r[4], const float delta_r[4],
                                         int q0, int k0, int Lq, int Lk, float scale,
                                         int ty, int tx) {
  float dp[4][4];
  rows_dot<DP>(p, Qs, Ks, ty, tx);
  rows_dot<DP>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = (q0 + ty + 16 * i < Lq) && (k0 + tx + 16 * j < Lk);
      const float pv = ok ? expf(p[i][j] * scale - lse_r[i]) : 0.f;
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - delta_r[i]);
    }
}

template <int DP, typename T>
__global__ void __launch_bounds__(NT) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Lq, int Lk, int D, float scale) {
  extern __shared__ float smem[];
  constexpr int LD = DP + 1;
  constexpr int NJ = DP / 16;
  float* Ks = smem;
  float* Vs = Ks + BM * LD;
  float* Qs = Vs + BM * LD;
  float* dOs = Qs + BM * LD;
  float* Ps = dOs + BM * LD;
  float* dSs = Ps + BM * PLD;
  float* stats = dSs + BM * PLD;      // lse [BM], delta [BM]
  const int bh = blockIdx.y, k0 = blockIdx.x * BM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qoff = (size_t)bh * Lq * D, koff = (size_t)bh * Lk * D;
  load_tile<DP>(Ks, k + koff, k0, Lk, D);
  load_tile<DP>(Vs, v + koff, k0, Lk, D);
  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) { acc_k[i][j] = 0.f; acc_v[i][j] = 0.f; }
  for (int q0 = 0; q0 < Lq; q0 += BM) {
    __syncthreads();
    load_tile<DP>(Qs, q + qoff, q0, Lq, D);
    load_tile<DP>(dOs, dout + qoff, q0, Lq, D);
    if (threadIdx.x < BM) {
      const int r = q0 + threadIdx.x;
      stats[threadIdx.x] = r < Lq ? lse[(size_t)bh * Lq + r] : 0.f;
      stats[BM + threadIdx.x] = r < Lq ? delta[(size_t)bh * Lq + r] : 0.f;
    }
    __syncthreads();
    float lse_r[4], delta_r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lse_r[i] = stats[ty + 16 * i];
      delta_r[i] = stats[BM + ty + 16 * i];
    }
    float p[4][4], ds[4][4];
    p_and_ds<DP>(p, ds, Qs, Ks, Vs, dOs, lse_r, delta_r, q0, k0, Lq, Lk, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = p[i][j];
        dSs[(ty + 16 * i) * PLD + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // kv rows ty + 16 i: dV += P^T dO, dK += dS^T Q
    accumulate<DP, true>(acc_v, Ps, dOs, ty, tx);
    accumulate<DP, true>(acc_k, dSs, Qs, ty, tx);
  }
  T* dkb = dk + koff;
  T* dvb = dv + koff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= Lk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        store(dkb + (size_t)r * D + d, acc_k[i][j] * scale);
        store(dvb + (size_t)r * D + d, acc_v[i][j]);
      }
    }
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(NT) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Lq, int Lk, int D,
    float scale) {
  extern __shared__ float smem[];
  constexpr int LD = DP + 1;
  constexpr int NJ = DP / 16;
  float* Qs = smem;
  float* dOs = Qs + BM * LD;
  float* Ks = dOs + BM * LD;
  float* Vs = Ks + BM * LD;
  float* dSs = Vs + BM * LD;
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qoff = (size_t)bh * Lq * D, koff = (size_t)bh * Lk * D;
  load_tile<DP>(Qs, q + qoff, q0, Lq, D);
  load_tile<DP>(dOs, dout + qoff, q0, Lq, D);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < Lq ? lse[(size_t)bh * Lq + r] : 0.f;
    delta_r[i] = r < Lq ? delta[(size_t)bh * Lq + r] : 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < Lk; k0 += BM) {
    __syncthreads();
    load_tile<DP>(Ks, k + koff, k0, Lk, D);
    load_tile<DP>(Vs, v + koff, k0, Lk, D);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_and_ds<DP>(p, ds, Qs, Ks, Vs, dOs, lse_r, delta_r, q0, k0, Lq, Lk, scale, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(ty + 16 * i) * PLD + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // query rows ty + 16 i: dQ += dS K
    accumulate<DP, false>(acc, dSs, Ks, ty, tx);
  }
  T* dqb = dq + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Lq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(dqb + (size_t)r * D + d, acc[i][j] * scale);
    }
  }
}

template <int DP, typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, void* dq, void* dk, void* dv, float* lse,
                       float* delta, int bh, int Lq, int Lk, int D, float scale,
                       cudaStream_t stream) {
  constexpr int LD = DP + 1;
  const size_t smem_a = sizeof(float) * 2 * BM * LD;
  const size_t smem_b = sizeof(float) * (4 * BM * LD + 2 * BM * PLD + 2 * BM);
  const size_t smem_c = sizeof(float) * (4 * BM * LD + BM * PLD);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(lse_delta_kernel<DP, T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_a)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(dkdv_kernel<DP, T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_b)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(dq_kernel<DP, T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_c)) != cudaSuccess)
    return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* gt = static_cast<const T*>(dout);
  const dim3 gq((Lq + BM - 1) / BM, bh), gk((Lk + BM - 1) / BM, bh);
  lse_delta_kernel<DP, T><<<gq, NT, smem_a, stream>>>(qt, kt, ot, gt, lse, delta, Lq, Lk, D,
                                                      scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv_kernel<DP, T><<<gk, NT, smem_b, stream>>>(qt, kt, vt, gt, lse, delta,
                                                 static_cast<T*>(dk), static_cast<T*>(dv),
                                                 Lq, Lk, D, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<DP, T><<<gq, NT, smem_c, stream>>>(qt, kt, vt, gt, lse, delta,
                                               static_cast<T*>(dq), Lq, Lk, D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, void* dq, void* dk, void* dv, float* lse,
                     float* delta, int bh, int Lq, int Lk, int D, float scale,
                     cudaStream_t s) {
  switch ((D + 15) / 16) {
#define MDU_BWD_CASE(n)                                                                   \
  case n:                                                                                 \
    return launch_bwd<16 * n, T>(q, k, v, o, dout, dq, dk, dv, lse, delta, bh, Lq, Lk, D, \
                                 scale, s);
    MDU_BWD_CASE(1)
    MDU_BWD_CASE(2)
    MDU_BWD_CASE(3)
    MDU_BWD_CASE(4)
    MDU_BWD_CASE(5)
    MDU_BWD_CASE(6)
    MDU_BWD_CASE(7)
    MDU_BWD_CASE(8)
    MDU_BWD_CASE(9)
    MDU_BWD_CASE(10)
#undef MDU_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: contiguous [bh, L, D] (q, o, dout, dq: Lq
// rows; k, v, dk, dv: Lk rows), all fp32 (bf16 == 0) or all bf16; lse and
// delta: fp32 scratch of bh * Lq each. 1 <= D <= 160. Three launches on
// ``stream``; returns a cudaError_t (0 when every launch was taken).
extern "C" int mdu_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, void* dq, void* dk,
                                       void* dv, void* lse, void* delta, int bh, int Lq,
                                       int Lk, int D, float scale, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (D < 1 || D > 160 || Lq < 1 || Lk < 1 || bh < 1) return cudaErrorInvalidValue;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, l, dl, bh, Lq, Lk, D, scale,
                                   s);
  return dispatch<float>(q, k, v, o, dout, dq, dk, dv, l, dl, bh, Lq, Lk, D, scale, s);
}
