// Fused GroupNorm for Hopper (sm_90a): statistics and normalisation of one
// (batch, group) in one block, NCHW, bf16 or fp32 in and out.
//
// Replaces the TPU kernel mdu_tpu/ops/pallas/group_norm.py::fused_group_norm
// (body _gn_kernel). Per (b, g), over the Cg * H * W elements of the group:
//   mean = E[x], var = max(E[x^2] - mean^2, 0), rstd = rsqrt(var + eps),
//   y    = ((x - mean) * rstd) * w[c] + b[c]   in fp32, cast to x's dtype.
// The clamp of var at 0 is the port's decision (the XLA GroupNorm clamps, the
// Pallas body does not); the statistics are fp32 sums in a fixed order (per
// thread, then a shuffle tree, then the warps in order), so the result does
// not change from run to run.
//
// What bounds it on an H100: it moves bytes and does ~8 flops per element, so
// memory bounds it (x read once, y written once at 3.35 TB/s is its bound).
// The TPU kernel held a group in VMEM for one read; a group here can reach
// 4 MiB (the dispatch cap the JAX caller sets), more than a block's shared
// memory, so the block reads its group twice: once for the statistics and
// once to normalise. At config 2's UNet widths all groups together (at most
// 39 MB in bf16) fit the 50 MB L2, so the second read mostly comes from L2.
// Loads and stores are 16 bytes a thread where H * W allows it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 512;
constexpr int NWARPS = NTHREADS / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Sum of (a, b) over the block in a fixed order; every thread gets it.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    const float2 v = lane < NWARPS ? red[lane] : make_float2(0.f, 0.f);
    a = v.x;
    b = v.y;
#pragma unroll
    for (int o = NWARPS / 2; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) red[NWARPS] = make_float2(a, b);
  }
  __syncthreads();
  return red[NWARPS];
}

// V elements a thread moves at once: 16 bytes, or 1 when H * W or the
// alignment does not allow it.
template <typename T, typename WT, int V>
__global__ void __launch_bounds__(NTHREADS)
gn_kernel(const T* __restrict__ x, const WT* __restrict__ w,
          const WT* __restrict__ b, T* __restrict__ y, int C, int G, int HW,
          float eps) {
  __shared__ float2 red[NWARPS + 1];
  const int bg = blockIdx.x;           // b * G + g
  const int g = bg % G;
  const int Cg = C / G;
  const int n = Cg * HW;               // elements of the group (< 2^31)
  const int nv = n / V;
  const T* xg = x + (size_t)bg * n;
  T* yg = y + (size_t)bg * n;

  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < nv; i += NTHREADS) {
    __align__(16) T e[V];
    if constexpr (V > 1) {
      *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(xg)[i];
    } else {
      e[0] = xg[i];
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f(e[j]);
      s1 += f;
      s2 = fmaf(f, f, s2);
    }
  }
  const float2 s = block_sum2(s1, s2, red);
  const float mean = s.x / (float)n;   // divisions, as E[x] = sum / n rounds
  const float var = fmaxf(s.y / (float)n - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);

  for (int i = threadIdx.x; i < nv; i += NTHREADS) {
    __align__(16) T e[V];
    if constexpr (V > 1) {
      *reinterpret_cast<uint4*>(e) = reinterpret_cast<const uint4*>(xg)[i];
    } else {
      e[0] = xg[i];
    }
    const int c = g * Cg + (i * V) / HW;   // V divides HW: one channel per vector
    const float wc = to_f(w[c]);
    const float bc = to_f(b[c]);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = from_f<T>(((to_f(e[j]) - mean) * rstd) * wc + bc);
    if constexpr (V > 1) {
      reinterpret_cast<uint4*>(yg)[i] = *reinterpret_cast<const uint4*>(e);
    } else {
      yg[i] = e[0];
    }
  }
}

template <typename T, typename WT>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int B,
                   int C, int G, int HW, float eps, int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    gn_kernel<T, WT, V><<<B * G, NTHREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const WT*>(w), static_cast<const WT*>(b),
        static_cast<T*>(y), C, G, HW, eps);
  } else {
    gn_kernel<T, WT, 1><<<B * G, NTHREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const WT*>(w), static_cast<const WT*>(b),
        static_cast<T*>(y), C, G, HW, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x, y: contiguous [B, C, H, W] (HW = H * W), bf16 (x_bf16) or fp32; w, b:
// [C], bf16 (w_bf16) or fp32. ``vec`` allows 16-byte loads and stores (H * W
// a multiple of 16 bytes' worth of elements, 16-byte aligned x and y).
// Returns a cudaError_t (0 on a successful launch).
extern "C" int mdu_group_norm(const void* x, const void* w, const void* b, void* y,
                              int B, int C, int G, int HW, float eps, int x_bf16,
                              int w_bf16, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, b, y, B, C, G, HW, eps, vec, s);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, w, b, y, B, C, G, HW, eps, vec, s);
  if (w_bf16)
    return launch<float, __nv_bfloat16>(x, w, b, y, B, C, G, HW, eps, vec, s);
  return launch<float, float>(x, w, b, y, B, C, G, HW, eps, vec, s);
}
