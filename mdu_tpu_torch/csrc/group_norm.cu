// Fused GroupNorm for Hopper (sm_90a): NCHW, bf16 or fp32 in and out, the
// statistics and the normalisation of each (batch, group) in one launch.
//
// Replaces the TPU kernel mdu_tpu/ops/pallas/group_norm.py::fused_group_norm
// (body _gn_kernel). Per (b, g), over the Cg * H * W elements of the group:
//   mean = E[x], var = max(E[x^2] - mean^2, 0), rstd = rsqrt(var + eps),
//   y    = ((x - mean) * rstd) * w[c] + b[c]   in fp32, cast to x's dtype.
// The clamp of var at 0 is the port's decision (the XLA GroupNorm clamps, the
// Pallas body does not); the statistics are fp32 sums in a fixed order, so
// the result does not change from run to run.
//
// What bounds it on an H100: it moves bytes and does ~8 flops per element, so
// memory bounds it: x read once and y written once at 3.35 TB/s. The TPU
// kernel held a group in VMEM for one read. Two forms, chosen by shape alone
// (ops/kernels/group_norm.py, ``gn_plan``):
//
// cluster: the group held on chip across a thread-block cluster of CL <= 8
//   CTAs, one HBM read. Each CTA takes a contiguous part of the group (32 KB
//   where 8 CTAs allow it, up to 192 KB), pulls it into shared memory with
//   bulk asynchronous copies (cp.async.bulk, in NCHUNK chunks on their own
//   mbarriers, so that the sums start on the first chunk while the rest are
//   in flight; the elements before the part's first and after its last
//   16-byte boundary with plain loads), and sums (x, x^2) in fp32 in a fixed
//   order. The CTAs' partials are exchanged through distributed shared
//   memory behind a cluster barrier and summed in rank order by every CTA
//   (so every CTA, and every run, has the same statistics); each CTA then
//   normalises its part from shared memory with 16-byte stores. Parts of
//   32 KB let 6-7 CTAs share an SM, so that one CTA's loads overlap
//   another's sums and stores.
// two_read: one block of 512 threads per (b, g) reads its group twice, once
//   for the statistics and once to normalise (16-byte loads and stores where
//   H * W and alignment allow). Its second read comes from L2 when the
//   tensor fits there beside its output, and then it is the faster form: a
//   block streams its group with no barrier between CTAs, where a cluster
//   CTA loads all of its part, waits for the cluster, and only then stores
//   (at config 2's [10, 1280, 8, 12] 0.0036 against 0.0059 ms, at [10, 640,
//   32, 48] 0.0111 against 0.0167; both forms tie at level 0's 39 MB, 0.040
//   ms; the cluster form wins past L2: 0.064 against 0.084 ms at level 0 in
//   fp32, 0.103 against 0.124 at [10, 960, 64, 96] in bf16; H100 80GB HBM3,
//   700 W). So the cluster form takes a tensor past 32 MiB whose group fits
//   a cluster, two_read the rest (and a group larger than 8 x 192 KB; the
//   JAX caller caps a group at 4 MiB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using namespace mdu::sm90;

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

// Sum of (a, b) over a block of NT threads in a fixed order; every thread
// gets it. ``red`` holds NT / 32 + 1 values.
template <int NT>
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
  constexpr int NW = NT / 32;
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
    const float2 v = lane < NW ? red[lane] : make_float2(0.f, 0.f);
    a = v.x;
    b = v.y;
#pragma unroll
    for (int o = NW / 2; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) red[NW] = make_float2(a, b);
  }
  __syncthreads();
  return red[NW];
}

// ---------------------------------------------------------- the two_read form
//
// V elements a thread moves at once: 16 bytes, or 1 when H * W or the
// alignment does not allow it.
template <typename T, typename WT, int V>
__global__ void __launch_bounds__(NTHREADS)
gn_two_read_kernel(const T* __restrict__ x, const WT* __restrict__ w,
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
  const float2 s = block_sum2<NTHREADS>(s1, s2, red);
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
cudaError_t launch_two_read(const void* x, const void* w, const void* b, void* y, int B,
                   int C, int G, int HW, float eps, int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    gn_two_read_kernel<T, WT, V><<<B * G, NTHREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const WT*>(w), static_cast<const WT*>(b),
        static_cast<T*>(y), C, G, HW, eps);
  } else {
    gn_two_read_kernel<T, WT, 1><<<B * G, NTHREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const WT*>(w), static_cast<const WT*>(b),
        static_cast<T*>(y), C, G, HW, eps);
  }
  return cudaGetLastError();
}


// ----------------------------------------------------------- the cluster form

namespace cl {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int NCHUNK = 4;       // bulk copies of a part, each on its own mbarrier
constexpr int HEAD = 128;       // shared bytes before the part: partial, mbarriers

__device__ __forceinline__ uint32_t ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// (x, y) at shared address ``addr`` of the cluster's CTA ``rank``
__device__ __forceinline__ float2 ld_cluster_f2(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(remote) : "memory");
  return v;
}

// The channel's affine of group element ``e`` (of group g), kept across the
// elements of a thread's vector: ``next`` is the first element of the next
// channel.
template <typename WT>
struct Affine {
  const WT* w;
  const WT* b;
  int HW, c, next;
  float wc, bc;
  __device__ __forceinline__ Affine(const WT* w_, const WT* b_, int g, int Cg, int HW_, int e)
      : w(w_ + g * Cg), b(b_ + g * Cg), HW(HW_), c(e / HW_), next((e / HW_ + 1) * HW_) {
    wc = to_f(w[c]);
    bc = to_f(b[c]);
  }
  // the affine of element e, for e not below the last one asked
  __device__ __forceinline__ void at(int e) {
    if (e >= next) {
      c = e / HW;
      next = (c + 1) * HW;
      wc = to_f(w[c]);
      bc = to_f(b[c]);
    }
  }
};

// Grid: B * G clusters of CL CTAs (CL = the cluster's size, 1 to 8). CTA r
// of the cluster of group bg takes elements [r * part, min((r + 1) * part,
// n)) of it; ``part`` is a multiple of 16 bytes' worth of elements.
template <typename T, typename WT>
__global__ void __launch_bounds__(NTHREADS)
gn_cluster_kernel(const T* __restrict__ x, const WT* __restrict__ w, const WT* __restrict__ b,
                  T* __restrict__ y, int C, int G, int HW, int part, float eps) {
  constexpr int E = sizeof(T);
  constexpr int V = 16 / E;
  __shared__ float2 red[NWARPS + 1];
  extern __shared__ __align__(128) unsigned char smem[];
  // [0, 8): this CTA's partial (sum x, sum x^2), read by the whole cluster;
  // [8, 8 + 8 NCHUNK): the chunks' mbarriers; from HEAD: the 16-byte lines
  // that hold the part, in the order of global memory
  const uint32_t sbase = mdu::smem_addr(smem);
  const uint32_t partial = sbase;
  auto bar = [&](int k) { return sbase + 8u + 8u * k; };
  unsigned char* const buf = smem + HEAD;

  const int CL = (int)nctarank();
  const int rank = (int)ctarank();
  const int bg = blockIdx.x / CL;
  const int g = bg % G;
  const int Cg = C / G;
  const int n = Cg * HW;
  const int p0 = rank * part;
  const int m = max(min(part, n - p0), 0);      // elements of this CTA's part
  const T* xs = x + (size_t)bg * n + p0;
  T* ys = y + (size_t)bg * n + p0;

  // the part's bytes [a0, a1): 16-byte lines from a0 & ~15, the whole lines
  // [mid0, mid1) by bulk copies, the rest by plain loads
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(xs);
  const uintptr_t a1 = a0 + (uintptr_t)m * E;
  const int lead = (int)(a0 & 15u);             // buf's bytes before the part
  uintptr_t mid0 = (a0 + 15u) & ~(uintptr_t)15u;
  uintptr_t mid1 = a1 & ~(uintptr_t)15u;
  if (mid1 <= mid0) mid0 = mid1 = a1;           // no whole line: all plain loads
  const int nh = (int)(mid0 - a0) / E;          // elements before mid0
  const int nt = (int)(mid1 - a0) / E;          // first element after mid1
  const int mid_bytes = (int)(mid1 - mid0);
  const int chunk = ((mid_bytes + NCHUNK * 16 - 1) / (NCHUNK * 16)) * 16;
  const int line0 = lead + (int)(mid0 - a0);    // buf offset of mid0

  if (threadIdx.x == 0) {
    for (int k = 0; k < NCHUNK; ++k) mbar_init(bar(k), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < NCHUNK; ++k) {
      const int lo = k * chunk;
      const int len = min(chunk, mid_bytes - lo);
      if (len <= 0) break;
      mbar_arrive_expect_tx(bar(k), (uint32_t)len);
      bulk_load(sbase + HEAD + line0 + lo, reinterpret_cast<const void*>(mid0 + lo),
                (uint32_t)len, bar(k));
    }
  }

  float s1 = 0.f, s2 = 0.f;
  // the elements outside the whole lines, into buf as well
  for (int i = threadIdx.x; i < nh + (m - nt); i += NTHREADS) {
    const int e = i < nh ? i : nt + (i - nh);
    const T v = xs[e];
    *reinterpret_cast<T*>(buf + lead + e * E) = v;
    const float f = to_f(v);
    s1 += f;
    s2 = fmaf(f, f, s2);
  }
  __syncthreads();                              // the mbarriers are initialised
  for (int k = 0; k < NCHUNK; ++k) {
    const int lo = k * chunk;
    const int len = min(chunk, mid_bytes - lo);
    if (len <= 0) break;
    mbar_wait(bar(k), 0);
    for (int i = threadIdx.x; i < len / 16; i += NTHREADS) {
      __align__(16) T e[V];
      *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(buf + line0 + lo + 16 * i);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f(e[j]);
        s1 += f;
        s2 = fmaf(f, f, s2);
      }
    }
  }
  const float2 mine = block_sum2<NTHREADS>(s1, s2, red);
  if (threadIdx.x == 0) *reinterpret_cast<float2*>(smem) = mine;
  cluster_arrive();                             // the partial is written
  cluster_wait();
  float t1 = 0.f, t2 = 0.f;
  for (int r = 0; r < CL; ++r) {                // rank order: the same sums everywhere
    const float2 v = ld_cluster_f2(partial, (uint32_t)r);
    t1 += v.x;
    t2 += v.y;
  }
  cluster_arrive();                             // done reading the others' partials
  const float mean = t1 / (float)n;
  const float var = fmaxf(t2 / (float)n - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);

  const uintptr_t b0 = reinterpret_cast<uintptr_t>(ys);
  if ((b0 & 15u) == (uintptr_t)lead) {
    // y's lines match buf's: 16-byte stores, plain ones at the part's ends
    T* yl = reinterpret_cast<T*>(b0 - lead);    // y at buf's offset 0
    const int nl = m > 0 ? (lead + m * E + 15) / 16 : 0;
    for (int l = threadIdx.x; l < nl; l += NTHREADS) {
      const int e0 = (16 * l - lead) / E;       // the line's first element (< 0 before the part)
      __align__(16) T e[V];
      *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(buf + 16 * l);
      const int ge = p0 + max(e0, 0);           // its first element in the group
      const int c = ge / HW;
      if (e0 >= 0 && e0 + V <= m && ge - c * HW + V <= HW) {
        // a whole line of one channel: its affine once
        const float wc = to_f(w[g * Cg + c]);
        const float bc = to_f(b[g * Cg + c]);
#pragma unroll
        for (int j = 0; j < V; ++j) e[j] = from_f<T>(((to_f(e[j]) - mean) * rstd) * wc + bc);
        *reinterpret_cast<uint4*>(yl + 16 / E * l) = *reinterpret_cast<const uint4*>(e);
      } else {
        Affine<WT> af(w, b, g, Cg, HW, ge);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (e0 + j < 0 || e0 + j >= m) continue;   // outside the part
          af.at(p0 + e0 + j);
          ys[e0 + j] = from_f<T>(((to_f(e[j]) - mean) * rstd) * af.wc + af.bc);
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < m; i += NTHREADS) {
      Affine<WT> af(w, b, g, Cg, HW, p0 + i);
      const float f = to_f(*reinterpret_cast<const T*>(buf + lead + i * E));
      ys[i] = from_f<T>(((f - mean) * rstd) * af.wc + af.bc);
    }
  }
  cluster_wait();                               // no CTA leaves while its partial is read
}

template <typename T, typename WT>
cudaError_t launch_cluster(const void* x, const void* w, const void* b, void* y, int B, int C,
                           int G, int HW, int cluster, int part, float eps,
                           cudaStream_t stream) {
  if (cluster < 1 || cluster > 8 || part < 1 || part % (16 / (int)sizeof(T)) != 0 ||
      (long)cluster * part < (long)(C / G) * HW)
    return cudaErrorInvalidValue;
  auto kernel = gn_cluster_kernel<T, WT>;
  const int smem = HEAD + part * (int)sizeof(T) + 32;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * G * cluster);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<const WT*>(w),
                           static_cast<const WT*>(b), static_cast<T*>(y), C, G, HW, part, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace cl

}  // namespace

// x, y: contiguous [B, C, H, W] (HW = H * W), bf16 (x_bf16) or fp32; w, b:
// [C], bf16 (w_bf16) or fp32. Each returns a cudaError_t (0 on a successful
// launch).
//
// The two_read form. ``vec`` allows 16-byte loads and stores (H * W a
// multiple of 16 bytes' worth of elements, 16-byte aligned x and y).
extern "C" int mdu_group_norm(const void* x, const void* w, const void* b, void* y,
                              int B, int C, int G, int HW, float eps, int x_bf16,
                              int w_bf16, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16)
    return launch_two_read<__nv_bfloat16, __nv_bfloat16>(x, w, b, y, B, C, G, HW, eps, vec, s);
  if (x_bf16)
    return launch_two_read<__nv_bfloat16, float>(x, w, b, y, B, C, G, HW, eps, vec, s);
  if (w_bf16)
    return launch_two_read<float, __nv_bfloat16>(x, w, b, y, B, C, G, HW, eps, vec, s);
  return launch_two_read<float, float>(x, w, b, y, B, C, G, HW, eps, vec, s);
}

// The cluster form: clusters of ``cluster`` CTAs, each holding ``part``
// elements of a group (a multiple of 16 bytes' worth; cluster * part >= the
// group). Any alignment of x and y.
extern "C" int mdu_group_norm_cluster(const void* x, const void* w, const void* b, void* y,
                                      int B, int C, int G, int HW, int cluster, int part,
                                      float eps, int x_bf16, int w_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16)
    return cl::launch_cluster<__nv_bfloat16, __nv_bfloat16>(x, w, b, y, B, C, G, HW, cluster,
                                                            part, eps, s);
  if (x_bf16)
    return cl::launch_cluster<__nv_bfloat16, float>(x, w, b, y, B, C, G, HW, cluster, part,
                                                    eps, s);
  if (w_bf16)
    return cl::launch_cluster<float, __nv_bfloat16>(x, w, b, y, B, C, G, HW, cluster, part,
                                                    eps, s);
  return cl::launch_cluster<float, float>(x, w, b, y, B, C, G, HW, cluster, part, eps, s);
}
