// Fused (GroupNorm affine -> SiLU ->) 3x3 convolution for Hopper (sm_90a),
// NHWC, stride 1, 'same' padding; bf16 on the tensor cores, fp32 on the CUDA
// cores.
//
// Replaces the TPU kernel mdu_tpu/ops/pallas/conv3x3.py::fused_conv3x3 (body
// _conv_kernel). It computes
//   y[b, h, w, o] = sum_{dy, dx, c} a(x)[b, h+dy-1, w+dx-1, c] * W[dy, dx, c, o]
// with a(x) = silu(x * scale[b, c] + shift[b, c]) in fp32, rounded to x's
// dtype (a(x) = x without ``fuse_act``), fp32 accumulation, output in x's
// dtype. Positions outside the image are zero AFTER the activation (the
// 'same' padding pads the activated input: silu(0 * a + b) is not 0), so the
// pad is never activated. scale and shift are the folded GroupNorm affine of
// ops/groupnorm.py::group_norm_affine. The bias is added by the caller.
//
// As an implicit GEMM: M = B*H*W output pixels, N = Co, K = 9*C. The weight
// arrives re-laid out once per module as [Co][9][Cp] (tap-major K, C padded
// to Cp, a multiple of 32, with zeros). A block owns an 8 x 16 tile of output
// pixels of one image and 128 output channels. For each chunk of 32 input
// channels it loads the tile's 10 x 18 input pixels with their halo (16-byte
// loads of 8 channels), applies the affine and SiLU in fp32 once per loaded
// element and stores the bf16 result in shared memory, while the chunk's
// weights for all 9 taps arrive by cp.async (92 KB); then 8 warps run the 9
// taps' mma.sync m16n8k16 products (fp32 accumulate), each tap reading the
// halo tile shifted by the tap (ldmatrix takes a row address per lane). This
// is the counterpart of the TPU kernel's activated-input block held in VMEM
// across its output-channel steps: each input element is activated about
// 1.4 x (Co / 128) times (the halo, the output-channel blocks), not once
// per tap.
//
// What bounds it on an H100: at config 2's ResBlock shapes (C, Co of 320 and
// 640 on 64x96 and 32x48 latents, batch 10) 2*M*9*C*Co flops against a few
// tens of MB, far above the ridge, so the tensor cores at 989 TFLOP/s. It is
// single-staged (loads, barrier, products, barrier) with two blocks an SM
// (107 KB of shared memory each); double-buffered chunks and wgmma are the
// steps toward the bound.
//
// The fp32 form (a model built in fp32) is a plain shared-memory tiled
// product: 64 pixels x 64 channels a block, 4 x 4 outputs a thread.
#include "mma_bf16.cuh"

namespace {

// ---------------------------------------------------------------- bf16
constexpr int TH = 8;            // output rows of a block's spatial tile
constexpr int TW = 16;           // output columns
constexpr int HALO = (TH + 2) * (TW + 2);   // 180 input pixels with the halo
constexpr int BN = 128;          // output channels of a block
constexpr int BKC = 32;          // input channels of a K chunk
constexpr int NWARPS = 8;        // warp (wm, wn): pixels 32 wm.., channels 64 wn..
constexpr int NT = NWARPS * 32;
constexpr int LDA = BKC + 8;     // 80-byte rows: 16-byte aligned, ldmatrix conflict-free
constexpr int SMEM_BYTES = (HALO + 9 * BN) * LDA * (int)sizeof(__nv_bfloat16);

__device__ __forceinline__ float silu_fast(float f) {
  return __fdividef(f, 1.f + __expf(-f));   // the result is rounded to bf16
}

template <bool ACT>
__global__ void __launch_bounds__(NT, 2)
conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,   // [B, H, W, C]
                 const __nv_bfloat16* __restrict__ w,   // [Co, 9 * Cp]
                 const float* __restrict__ scale,       // [B, C]
                 const float* __restrict__ shift,       // [B, C]
                 __nv_bfloat16* __restrict__ y,         // [B, H, W, Co]
                 int B, int H, int W, int C, int Cp, int Co, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Hs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [HALO][LDA]
  __nv_bfloat16* Bs = Hs + HALO * LDA;                               // [9][BN][LDA]
  const int K = 9 * Cp;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int tyx = blockIdx.x % (tiles_x * tiles_y);
  const int y0 = (tyx / tiles_x) * TH;
  const int x0 = (tyx % tiles_x) * TW;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp % 4;
  const int wn = warp / 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const int lm = lane / 8;             // ldmatrix: the matrix this lane addresses
  const int lr = lane % 8;             // ... and its row
  const float* scb = scale + (size_t)b * C;
  const float* shb = shift + (size_t)b * C;

  // the halo pixel of tap (1, 1) of the A row this lane addresses, per m16 tile
  int hrow[2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int p = wm * 32 + mi * 16 + (lm % 2) * 8 + lr;
    hrow[mi] = (p / TW + 1) * (TW + 2) + p % TW + 1;
  }

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[mi][n][0] = acc[mi][n][1] = acc[mi][n][2] = acc[mi][n][3] = 0.f;

  for (int c0 = 0; c0 < Cp; c0 += BKC) {
    // B: the 9 taps x 128 output channels x 32 input channels of this chunk
    // by cp.async (zero past Co); they land while the halo is activated
    for (int i = tid; i < 9 * BN * (BKC / 8); i += NT) {
      const int tap = i / (BN * (BKC / 8));
      const int rem = i % (BN * (BKC / 8));
      const int n = rem / (BKC / 8);
      const int kv = (rem % (BKC / 8)) * 8;
      const bool in = n0 + n < Co;
      mdu::cp_async_16(Bs + (tap * BN + n) * LDA + kv,
                       in ? w + (size_t)(n0 + n) * K + tap * Cp + c0 + kv : w, in ? 16 : 0);
    }
    mdu::cp_async_commit();

    // the halo tile, activated once: zero outside the image and past C (the
    // activation is never applied to the pad)
    for (int i = tid; i < HALO * (BKC / 8); i += NT) {
      const int hp = i / (BKC / 8);
      const int cv = (i % (BKC / 8)) * 8;
      const int gy = y0 - 1 + hp / (TW + 2);
      const int gx = x0 - 1 + hp % (TW + 2);
      const int c = c0 + cv;
      __align__(16) __nv_bfloat16 e[8];
      *reinterpret_cast<uint4*>(e) = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C) {
        const __nv_bfloat16* src = x + (((size_t)b * H + gy) * W + gx) * C + c;
        if (vec) {
          *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(src);
          if (ACT) {
            const float4 s0 = reinterpret_cast<const float4*>(scb + c)[0];
            const float4 s1 = reinterpret_cast<const float4*>(scb + c)[1];
            const float4 h0 = reinterpret_cast<const float4*>(shb + c)[0];
            const float4 h1 = reinterpret_cast<const float4*>(shb + c)[1];
            const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
            const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
            for (int q = 0; q < 8; ++q)
              e[q] = __float2bfloat16_rn(silu_fast(__bfloat162float(e[q]) * sv[q] + hv[q]));
          }
        } else {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (c + q < C) {
              float f = __bfloat162float(src[q]);
              if (ACT) f = silu_fast(f * scb[c + q] + shb[c + q]);
              e[q] = __float2bfloat16_rn(f);
            }
          }
        }
      }
      *reinterpret_cast<uint4*>(Hs + hp * LDA + cv) = *reinterpret_cast<const uint4*>(e);
    }
    mdu::cp_async_wait<0>();
    __syncthreads();

    // 9 taps x 2 k-steps: A rows are the halo pixels shifted by the tap
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int shift_px = (tap / 3 - 1) * (TW + 2) + (tap % 3 - 1);
      const __nv_bfloat16* bt = Bs + (tap * BN + wn * 64) * LDA;
#pragma unroll
      for (int ks = 0; ks < BKC / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mdu::ldmatrix_x4(a[mi], Hs + (hrow[mi] + shift_px) * LDA + ks * 16 + (lm / 2) * 8);
        // B fragments of two n-tiles at a time: matrices (n, k lo), (n, k hi),
        // (n+1, k lo), (n+1, k hi)
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          uint32_t bf[4];
          mdu::ldmatrix_x4(bf, bt + ((n + lm / 2) * 8 + lr) * LDA + ks * 16 + (lm % 2) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mdu::mma_16816(acc[mi][n], a[mi], bf[0], bf[1]);
            mdu::mma_16816(acc[mi][n + 1], a[mi], bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();                   // the tiles are refilled next chunk
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = wm * 32 + mi * 16 + g + 8 * half;
      const int gy = y0 + p / TW;
      const int gx = x0 + p % TW;
      if (gy >= H || gx >= W) continue;
      __nv_bfloat16* yr = y + (((size_t)b * H + gy) * W + gx) * Co;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + wn * 64 + n * 8 + 2 * t + e;
          if (co < Co) yr[co] = __float2bfloat16_rn(acc[mi][n][2 * half + e]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- fp32
constexpr int FBM = 64;
constexpr int FBN = 64;
constexpr int FBK = 16;
constexpr int FNT = 256;   // 16 x 16 threads, 4 x 4 outputs each

template <bool ACT>
__global__ void __launch_bounds__(FNT)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ scale, const float* __restrict__ shift,
                float* __restrict__ y, int B, int H, int W, int C, int Cp, int Co) {
  __shared__ float As[FBK][FBM + 4];
  __shared__ float Bs[FBK][FBN + 4];
  const int HW = H * W;
  const int M = B * HW;
  const int K = 9 * Cp;
  const int m0 = blockIdx.x * FBM;
  const int n0 = blockIdx.y * FBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // the A rows this thread loads: ty + 16 j, channel tx of the chunk
  int pb[4], py[4], px[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + ty + 16 * j;
    if (m < M) {
      pb[j] = m / HW;
      const int rem = m - pb[j] * HW;
      py[j] = rem / W;
      px[j] = rem - py[j] * W;
    } else {
      pb[j] = -1;
      py[j] = px[j] = 0;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    for (int c0 = 0; c0 < Cp; c0 += FBK) {
      const int c = c0 + tx;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float f = 0.f;
        const int ys = py[j] + dy;
        const int xs = px[j] + dx;
        if (pb[j] >= 0 && ys >= 0 && ys < H && xs >= 0 && xs < W && c < C) {
          f = x[(((size_t)pb[j] * H + ys) * W + xs) * C + c];
          if (ACT) {
            f = f * scale[(size_t)pb[j] * C + c] + shift[(size_t)pb[j] * C + c];
            f = f / (1.f + expf(-f));
          }
        }
        As[tx][ty + 16 * j] = f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = ty + 16 * j;
        Bs[tx][n] = n0 + n < Co ? w[(size_t)(n0 + n) * K + tap * Cp + c0 + tx] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FBK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = As[kk][ty * 4 + i];
          b[i] = Bs[kk][tx * 4 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int co = n0 + tx * 4 + jj;
      if (co < Co) y[(size_t)m * Co + co] = acc[i][jj];
    }
  }
}

}  // namespace

// x: contiguous NHWC [B, H, W, C]; w: contiguous [Co, 9 * Cp] (Cp = C rounded
// up to a multiple of 32, zero-filled), the dtype of x; scale, shift: fp32
// [B, C], read only with ``fuse_act``; y: contiguous NHWC [B, H, W, Co], the
// dtype of x. ``is_bf16`` selects bf16 (tensor cores) or fp32; ``vec`` allows
// 16-byte loads of x (C % 8 == 0, 16-byte aligned x, scale and shift).
// Returns a cudaError_t (0 on a successful launch).
extern "C" int mdu_conv3x3(const void* x, const void* w, const void* scale,
                           const void* shift, void* y, int B, int H, int W, int C,
                           int Cp, int Co, int fuse_act, int is_bf16, int vec,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long M = (long)B * H * W;   // output pixels
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (is_bf16) {
    const long tiles = (long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
    dim3 grid((unsigned)tiles, (Co + BN - 1) / BN);
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
    __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y);
    cudaError_t err = cudaFuncSetAttribute(
        fuse_act ? conv_bf16_kernel<true> : conv_bf16_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    if (fuse_act)
      conv_bf16_kernel<true><<<grid, NT, SMEM_BYTES, s>>>(xp, wp, sc, sh, yp, B, H, W, C, Cp,
                                                          Co, vec);
    else
      conv_bf16_kernel<false><<<grid, NT, SMEM_BYTES, s>>>(xp, wp, sc, sh, yp, B, H, W, C, Cp,
                                                           Co, vec);
  } else {
    dim3 grid((unsigned)((M + FBM - 1) / FBM), (Co + FBN - 1) / FBN);
    const float* xp = static_cast<const float*>(x);
    const float* wp = static_cast<const float*>(w);
    float* yp = static_cast<float*>(y);
    if (fuse_act)
      conv_f32_kernel<true><<<grid, FNT, 0, s>>>(xp, wp, sc, sh, yp, B, H, W, C, Cp, Co);
    else
      conv_f32_kernel<false><<<grid, FNT, 0, s>>>(xp, wp, sc, sh, yp, B, H, W, C, Cp, Co);
  }
  return (int)cudaGetLastError();
}
