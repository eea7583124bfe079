// Fused tile blend for Hopper (sm_90a): MultiDiffusion's fusion of the tile
// outputs into the canvas as a gather, fp32 or bf16 tiles.
//
// Replaces the TPU kernel mdu_tpu/ops/pallas/fused_blend.py::fused_tile_blend
// (body _blend_kernel). One thread per canvas element (c, y, x): it looks up
// the contributor table row of its canvas block (tile ids in bbox order, -1
// padded, and each tile's origin relative to the block, built once per plan
// on the host by utils/blend_table.py), sums the elements of its
// contributor tiles that cover it in fp32, in table order, then with
// ``normalize`` divides by the paint count where it is > 1, and casts to the
// tiles' dtype. The order is the bbox order of the scatter-add it replaces,
// so in fp32 the two agree bit for bit. The TPU's cyclic-roll staging of a
// tile window in VMEM (a Mosaic workaround) has no counterpart: each thread
// reads its tile elements directly, neighbouring threads neighbouring
// addresses.
//
// What bounds it on an H100: bytes (each tile element read once, each canvas
// element written once): at config 2 (5 tiles [4, 64, 96] onto [4, 64, 256],
// fp32) 0.75 MB, 0.0002 ms at 3.35 TB/s, far below a launch. An empty
// kernel on the same grid (floor_kernel, launched the same way) gives the
// launch floor on the device: 0.95 us, against this kernel's 2.8 us (H100
// 80GB HBM3, 700 W). The rest is latency: a thread's table entry, then its
// tile element, then its store. One block per canvas block, the table row
// read once into shared memory and 16-byte lines along x (tried: 2.8 us, on
// a floor of 0.84 for its 32 blocks) keeps the same chain of dependent
// loads, so this simpler form stays.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

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

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
blend_kernel(const T* __restrict__ tiles,     // [T, BC, th, tw]
             const int* __restrict__ idx,     // [nblocks, k_max]
             const int* __restrict__ offs,    // [nblocks, k_max, 2] (dy, dx)
             const float* __restrict__ wgt,   // [h, w] paint counts
             T* __restrict__ out,             // [BC, h, w]
             int BC, int h, int w, int th, int tw, int bh, int bw, int nbx,
             int k_max, int normalize) {
  const long total = (long)BC * h * w;
  for (long i = (long)blockIdx.x * NTHREADS + threadIdx.x; i < total;
       i += (long)gridDim.x * NTHREADS) {
    const int x = (int)(i % w);
    const long r = i / w;
    const int y = (int)(r % h);
    const int c = (int)(r / h);
    const int by = y / bh;
    const int bx = x / bw;
    const int blk = by * nbx + bx;
    const int ly = y - by * bh;          // position inside the canvas block
    const int lx = x - bx * bw;
    float acc = 0.f;
    for (int k = 0; k < k_max; ++k) {
      const int e = blk * k_max + k;
      const int t = idx[e];
      if (t < 0) break;                  // the padding comes after every real entry
      const int ty = ly - offs[2 * e];
      const int tx = lx - offs[2 * e + 1];
      if (ty >= 0 && ty < th && tx >= 0 && tx < tw)
        acc += to_f(tiles[(((size_t)t * BC + c) * th + ty) * tw + tx]);
    }
    if (normalize) {
      const float wv = wgt[(size_t)y * w + x];
      if (wv > 1.f) acc = acc / wv;
    }
    out[i] = from_f<T>(acc);
  }
}

// the grid of blend_kernel for a canvas of ``total`` elements
inline int blend_blocks(long total) {
  const long want = (total + NTHREADS - 1) / NTHREADS;
  return (int)(want < 65535 ? want : 65535);
}

template <typename T>
cudaError_t launch(const void* tiles, const int* idx, const int* offs,
                   const float* wgt, void* out, int BC, int h, int w, int th,
                   int tw, int bh, int bw, int nbx, int k_max, int normalize,
                   cudaStream_t stream) {
  blend_kernel<T><<<blend_blocks((long)BC * h * w), NTHREADS, 0, stream>>>(
      static_cast<const T*>(tiles), idx, offs, wgt, static_cast<T*>(out), BC, h, w,
      th, tw, bh, bw, nbx, k_max, normalize);
  return cudaGetLastError();
}

// does nothing: the device time of a launch of blend_kernel's grid
__global__ void __launch_bounds__(NTHREADS) floor_kernel() {}

}  // namespace

// tiles: contiguous [T, BC, th, tw], fp32 or bf16 (is_bf16); out: contiguous
// [BC, h, w] of the same dtype; idx / offs: the int32 contributor table of
// canvas blocks bh x bw (nbx blocks a row); wgt: fp32 [h, w], read only with
// ``normalize``. Returns a cudaError_t (0 on a successful launch).
extern "C" int mdu_tile_blend(const void* tiles, const void* idx, const void* offs,
                              const void* wgt, void* out, int BC, int h, int w,
                              int th, int tw, int bh, int bw, int nbx, int k_max,
                              int normalize, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const int* op = static_cast<const int*>(offs);
  const float* wp = static_cast<const float*>(wgt);
  if (is_bf16)
    return launch<__nv_bfloat16>(tiles, ip, op, wp, out, BC, h, w, th, tw, bh, bw,
                                 nbx, k_max, normalize, s);
  return launch<float>(tiles, ip, op, wp, out, BC, h, w, th, tw, bh, bw, nbx,
                       k_max, normalize, s);
}

// mdu_tile_blend's signature; launches an empty kernel on its grid and
// writes nothing
extern "C" int mdu_tile_blend_floor(const void*, const void*, const void*, const void*,
                                    void*, int BC, int h, int w, int, int, int, int, int, int,
                                    int, int, void* stream) {
  floor_kernel<<<blend_blocks((long)BC * h * w), NTHREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
