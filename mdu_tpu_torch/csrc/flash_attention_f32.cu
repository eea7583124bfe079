// Flash attention for fp32 inputs on Hopper (sm_90a): both softmax forms of
// the port, in three forms each.
//
// Replaces the TPU kernels of mdu_tpu/ops/pallas/flash_attention.py when
// they are given fp32 tensors, as a model built in fp32 gives them:
//   mdu_flash_attention_fm_f32*  flash_attention_t_fm (_flash_kernel_t_fm):
//       p = exp(min(s * scale, smax) - smax) (min only with clamp),
//       out = (sum_j p_j v_j) / max(sum_j p_j, 1e-30) over real kv columns;
//   mdu_flash_attention_f32*     flash_attention (_flash_kernel): online
//       softmax with a running row max, fp32 denominator, floored at 1e-30.
// With fp32 v the cast of p to v's dtype rounds nothing, so p enters both the
// denominator and the P.V product unrounded. With ``bf16_exp`` (the TPU
// kernel's flag, MDU_FLASH=fm16) the fixed-shift form computes
// p = bf16(exp(bf16(min(s * scale, smax) - smax))), as the TPU kernel does
// for fp32 inputs.
//
// The forms, chosen by the wrapper (ops/kernels/flash.py, f32_form) on
// shape and alignment alone:
//   *_sm90  D % 4 == 0, D <= 160, 16-byte aligned q, k, v: the tensor cores,
//           wgmma and TMA, each product as three TF32 products
//           (flash_attention_f32_sm90.cuh; config 2's heads in fp32);
//   *_wide  the same alignment with 160 < D <= 512: mma.sync in TF32, three
//           passes, on a split-D layout (the same header; the VAE's D = 512);
//   the entry points without a suffix: anything else, on the CUDA cores, the
//           kernel below.
// No tensor-core type keeps fp32's 24-bit mantissa in one pass: tf32 keeps
// 11 bits. Three passes over big = tf32(x) and small = x - big keep the
// result within a few fp32 ulps, which is what the 1e-4 bar against the
// fp32 plain version checks.
//
// What bounds the CUDA-core form on an H100: the products run as fp32 fused
// multiply-adds, fed from shared memory at one 16-byte read per four of them
// (a little more in Q.K^T), so shared-memory issue bounds it below the fp32
// peak (67 TFLOP/s). It takes the odd head widths and unaligned inputs.
//
// Layout of the CUDA-core form: one block of 256 threads per (batch*head,
// 32-query tile), looping over 32-row kv tiles. Thread (r, c) = (tid / 8, tid % 8) owns query row r:
// scores of kv columns c, c+8, c+16, c+24 of a tile, and accumulator columns
// 4c..4c+3 of every 32 (up to 64 registers at D = 512). Every shared-memory
// read is 16 bytes, four multiply-adds' worth. The eight threads of a row are
// eight lanes of one warp, so the row's max and sum take three shuffles and
// its probabilities pass through shared memory with a warp barrier only. Q
// and K rows are padded (q_stride), so the eight K rows that a quarter warp
// reads fall in different banks. K and V tiles arrive by cp.async in two
// groups, so V's copy overlaps the Q.K^T products and the softmax.
#include "flash_attention_f32_sm90.cuh"
#include "mma_bf16.cuh"                // cp.async helpers

namespace {

constexpr int BQ = 32;
constexpr int BK = 32;
constexpr int NTHREADS = 256;
constexpr int TPR = NTHREADS / BQ;     // threads of one query row
constexpr int SPT = BK / TPR;          // scores of one thread per kv tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// Rows [row0, row0 + ROWS) of a row-major [L, D] matrix into a shared tile of
// row stride ld; rows past L are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_rows(float* sm, int ld, const float* g,
                                          int row0, int L, int D) {
  for (int i = threadIdx.x; i < ROWS * D; i += NTHREADS) {
    const int r = i / D;
    const int c = i - r * D;
    sm[r * ld + c] = row0 + r < L ? g[(size_t)row0 * D + i] : 0.f;
  }
}

// The same with 16-byte cp.async copies (D % 4 == 0, 16-byte aligned base);
// commits no group.
template <int ROWS>
__device__ __forceinline__ void load_rows_async(float* sm, int ld, const float* g,
                                                int row0, int L, int D) {
  const int C4 = D >> 2;
  for (int i = threadIdx.x; i < ROWS * C4; i += NTHREADS) {
    const int r = i / C4;
    const int c = (i - r * C4) * 4;
    const bool in = row0 + r < L;
    mdu::cp_async_16(sm + r * ld + c, in ? g + (size_t)(row0 + r) * D + c : g, in ? 16 : 0);
  }
}

// Zero columns [c0, c1) of ROWS rows of stride ld (padding no load writes).
template <int ROWS>
__device__ __forceinline__ void zero_cols(float* sm, int ld, int c0, int c1) {
  const int w = c1 - c0;
  for (int i = threadIdx.x; i < ROWS * w; i += NTHREADS)
    sm[(i / w) * ld + c0 + i % w] = 0.f;
}

// Row stride of the Q and K tiles, in floats: at least D rounded up to 4,
// and an odd number of 16-byte units, so that eight rows read at the same
// column fall in eight different bank quads.
__host__ __device__ __forceinline__ int q_stride(int D) {
  return 4 * ((((D + 3) >> 2) + 1) | 1);
}

__device__ __forceinline__ void fma4(float& acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// NJ4 = accumulator float4s per thread (D <= 32 * NJ4); FIXED selects the
// fixed-shift softmax, else the online one.
template <int NJ4, bool FIXED>
__global__ void __launch_bounds__(NTHREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Lq,
                 int Lk, int D, float scale, float smax, int clamp,
                 int bf16_exp, int vec) {
  constexpr int VD = 4 * TPR * NJ4;    // V tile stride; columns past D are 0
  const int D4 = (D + 3) & ~3;         // Q.K^T runs over float4s; pad is 0
  const int LD = q_stride(D);
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][LD]
  float* Ks = Qs + BQ * LD;            // [BK][LD]
  float* Vs = Ks + BK * LD;            // [BK][VD]
  float* Ps = Vs + BK * VD;            // [BQ][BK + 1]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int r = threadIdx.x / TPR;
  const int c = threadIdx.x % TPR;
  const float* qb = q + (size_t)bh * Lq * D;
  const float* kb = k + (size_t)bh * Lk * D;
  const float* vb = v + (size_t)bh * Lk * D;

  load_rows<BQ>(Qs, LD, qb, q0, Lq, D);
  zero_cols<BQ>(Qs, LD, D, D4);
  zero_cols<BK>(Ks, LD, D, D4);
  zero_cols<BK>(Vs, VD, D, VD);

  float acc[NJ4][4];
#pragma unroll
  for (int j = 0; j < NJ4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m = NEG;                       // running max of row r (online form)
  float l = 0.f;                       // this thread's share of the denominator
  const float4* qr = reinterpret_cast<const float4*>(Qs + r * LD);
  float* pr = Ps + r * (BK + 1);

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    __syncthreads();                   // the previous tile is no longer read
    if (vec) {
      load_rows_async<BK>(Ks, LD, kb, k0, Lk, D);
      mdu::cp_async_commit();
      load_rows_async<BK>(Vs, VD, vb, k0, Lk, D);
      mdu::cp_async_commit();
      mdu::cp_async_wait<1>();         // K has landed; V is still in flight
    } else {
      load_rows<BK>(Ks, LD, kb, k0, Lk, D);
      load_rows<BK>(Vs, VD, vb, k0, Lk, D);
    }
    __syncthreads();

    // scores of kv columns c, c+8, c+16, c+24: per float4 of d, one Q and
    // four K loads of 16 bytes for 16 multiply-adds
    float s[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) s[j] = 0.f;
#pragma unroll 2
    for (int d4 = 0; d4 < D4 / 4; ++d4) {
      const float4 a = qr[d4];
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        fma4(s[j], a, reinterpret_cast<const float4*>(Ks + (c + TPR * j) * LD)[d4]);
    }

    float p[SPT];
    if (FIXED) {
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float x = s[j] * scale;
        float e = (clamp ? fminf(x, smax) : x) - smax;
        if (bf16_exp) e = __bfloat162float(__float2bfloat16_rn(e));
        float pe = expf(e);
        if (bf16_exp) pe = __bfloat162float(__float2bfloat16_rn(pe));
        p[j] = k0 + c + TPR * j < Lk ? pe : 0.f;
        l += p[j];
      }
    } else {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        s[j] = k0 + c + TPR * j < Lk ? s[j] * scale : NEG;
        mx = fmaxf(mx, s[j]);
      }
      const float mn = fmaxf(m, row_max(mx));
      const float corr = expf(m - mn);
      m = mn;
      l *= corr;
#pragma unroll
      for (int j = 0; j < NJ4; ++j) {
        acc[j][0] *= corr; acc[j][1] *= corr; acc[j][2] *= corr; acc[j][3] *= corr;
      }
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        p[j] = expf(s[j] - mn);
        l += p[j];
      }
    }
#pragma unroll
    for (int j = 0; j < SPT; ++j) pr[c + TPR * j] = p[j];
    if (vec) {
      mdu::cp_async_wait<0>();         // V, visible to all after the barrier
      __syncthreads();
    } else {
      __syncwarp();                    // row r's p comes from this warp only
    }

    // acc += P V over columns 4c + 32j .. 4c + 32j + 3: one 16-byte V load
    // for four multiply-adds
    for (int kv = 0; kv < BK; ++kv) {
      const float pv = pr[kv];
      const float4* vr = reinterpret_cast<const float4*>(Vs + kv * VD) + c;
#pragma unroll
      for (int j = 0; j < NJ4; ++j) {
        const float4 b = vr[TPR * j];
        acc[j][0] = fmaf(pv, b.x, acc[j][0]);
        acc[j][1] = fmaf(pv, b.y, acc[j][1]);
        acc[j][2] = fmaf(pv, b.z, acc[j][2]);
        acc[j][3] = fmaf(pv, b.w, acc[j][3]);
      }
    }
  }

  const float inv = 1.f / fmaxf(row_sum(l), 1e-30f);
  const int row = q0 + r;
  if (row < Lq) {
    float* orow = o + ((size_t)bh * Lq + row) * D;
#pragma unroll
    for (int j = 0; j < NJ4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * c + 4 * TPR * j + e;
        if (col < D) orow[col] = acc[j][e] * inv;
      }
  }
}

template <int NJ4, bool FIXED>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh,
                   int Lq, int Lk, int D, float scale, float smax, int clamp,
                   int bf16_exp, int vec, cudaStream_t stream) {
  const int ld = q_stride(D);
  const int smem = ((BQ + BK) * ld + BK * 4 * TPR * NJ4 + BQ * (BK + 1)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<NJ4, FIXED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, bh);
  flash_f32_kernel<NJ4, FIXED><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Lq, Lk, D, scale,
      smax, clamp, bf16_exp, vec);
  return cudaGetLastError();
}

template <bool FIXED>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int Lq, int Lk, int D, float scale, float smax, int clamp,
             int bf16_exp, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<2, FIXED>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, bf16_exp, vec, s);
  if (D <= 128) return launch<4, FIXED>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, bf16_exp, vec, s);
  if (D <= 256) return launch<8, FIXED>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, bf16_exp, vec, s);
  if (D <= 512) return launch<16, FIXED>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, bf16_exp, vec, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: contiguous fp32 [bh, L, D]; 1 <= D <= 512. ``vec`` allows
// 16-byte copies (D % 4 == 0 and 16-byte aligned bases). Each returns a
// cudaError_t (0 on a successful launch).
extern "C" int mdu_flash_attention_fm_f32(const void* q, const void* k,
                                          const void* v, void* o, int bh, int Lq,
                                          int Lk, int D, float scale, float smax,
                                          int clamp, int bf16_exp, int vec,
                                          void* stream) {
  return dispatch<true>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp, bf16_exp, vec,
                        stream);
}

extern "C" int mdu_flash_attention_f32(const void* q, const void* k, const void* v,
                                       void* o, int bh, int Lq, int Lk, int D,
                                       float scale, int vec, void* stream) {
  return dispatch<false>(q, k, v, o, bh, Lq, Lk, D, scale, 0.f, 0, 0, vec, stream);
}

// The tensor-core forms: q, k, v, o contiguous fp32 [bh, L, D], D % 4 == 0,
// 16-byte aligned; D <= 160 (sm90) or 160 < D <= 512 (wide). Each returns a
// cudaError_t (0 on a successful launch).
extern "C" int mdu_flash_attention_fm_f32_sm90(const void* q, const void* k, const void* v,
                                               void* o, int bh, int Lq, int Lk, int D,
                                               float scale, float smax, int clamp,
                                               int bf16_exp, void* stream) {
  return mdu::f32::launch_sm90<mdu::f32::Fixed>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp,
                                                bf16_exp, static_cast<cudaStream_t>(stream));
}

extern "C" int mdu_flash_attention_f32_sm90(const void* q, const void* k, const void* v,
                                            void* o, int bh, int Lq, int Lk, int D,
                                            float scale, void* stream) {
  return mdu::f32::launch_sm90<mdu::f32::Online>(q, k, v, o, bh, Lq, Lk, D, scale, 0.f, 0, 0,
                                                 static_cast<cudaStream_t>(stream));
}

extern "C" int mdu_flash_attention_fm_f32_wide(const void* q, const void* k, const void* v,
                                               void* o, int bh, int Lq, int Lk, int D,
                                               float scale, float smax, int clamp,
                                               int bf16_exp, void* stream) {
  return mdu::f32::launch_wide<mdu::f32::Fixed>(q, k, v, o, bh, Lq, Lk, D, scale, smax, clamp,
                                                bf16_exp, static_cast<cudaStream_t>(stream));
}

extern "C" int mdu_flash_attention_f32_wide(const void* q, const void* k, const void* v,
                                            void* o, int bh, int Lq, int Lk, int D,
                                            float scale, void* stream) {
  return mdu::f32::launch_wide<mdu::f32::Online>(q, k, v, o, bh, Lq, Lk, D, scale, 0.f, 0, 0,
                                                 static_cast<cudaStream_t>(stream));
}
