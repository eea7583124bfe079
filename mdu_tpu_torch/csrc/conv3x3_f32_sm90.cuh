// The fp32 warpgroup form of the fused (GroupNorm affine -> SiLU ->) 3x3
// convolution (conv3x3.cu has the entry points, the bf16 forms and the
// CUDA-core fp32 form for what this form does not take): wgmma and TMA on
// Hopper (sm_90a), each product as three TF32 products.
//
// The function is conv_f32_kernel's, and the TPU kernel's
// (mdu_tpu/ops/pallas/conv3x3.py::fused_conv3x3) for fp32 inputs:
//   y[b, h, w, o] = sum_{dy, dx, c} a(x)[b, h+dy-1, w+dx-1, c] * W[dy, dx, c, o]
// with a(x) = silu(x * scale[b, c] + shift[b, c]) in fp32 (a(x) = x without
// ``fuse_act``), the zero pad after the activation, fp32 accumulation, no
// bias.
//
// The arithmetic, as in flash_attention_f32_sm90.cuh: each fp32 operand u
// splits into big = tf32(u) (rounded to the nearest in integer operations,
// its low 13 mantissa bits zero, so the tensor cores read it exactly) and
// small = u - big (exact in fp32). A.B runs as As.Bb + Ab.Bs + Ab.Bb into
// one fp32 accumulator; the dropped small.small term and the tf32 reading of
// small are each about 2^-22 of a term, the order of fp32's own rounding.
// The tensor cores' own fp32 accumulation rounds toward zero, so each of the
// 3 * 9 * C / 8 products into one accumulator loses up to an ulp of it, the
// same way: with one accumulator over all of K the error grew with C (1.7e-4
// at C = 640, 8.4e-5 at C = 320, against 1.4e-5 on the CUDA cores). So each
// 16-channel chunk (54 products) runs into an accumulator of its own, which
// the consumer then adds to the output's in fp32 on the CUDA cores.
// The weight is a constant: pack_conv3x3_weight splits it once per module,
// [2][Co][9 * Cp] (big, then small), and TMA brings both parts. Only the
// activated input is split on the card.
//
// Inputs: contiguous NHWC fp32 x with C % 16 == 0, the packed weight, scale
// and shift, all 16-byte aligned; Co % 8 == 0 (the epilogue stores pairs).
// As an implicit GEMM: M = B*H*W output pixels, N = Co, K = 9*C.
//
// Layout of a block: 32 x 8 output pixels of one image and 80 output
// channels, with 16-channel chunks (the bf16 warpgroup form in conv3x3.cu
// takes 160 channels and 64-channel chunks).
// - Warpgroup 0: warp 0 is the producer (one thread issues every TMA load),
//   warps 1-3 activate and split each chunk's halo once it has landed.
// - Two consumer warpgroups own 16 x 8 pixels each, two m64 tiles of 8 rows
//   x 8 columns; setmaxnreg moves registers from warpgroup 0 (80) to them
//   (208): the chunk's and the output's m64n80 accumulators of both tiles
//   are 160 registers a thread. That is why a block takes 80 channels: at
//   160 they would be 320.
// - A (the activated input) from shared memory. A tf32 core matrix is 8
//   rows x 16 bytes, 4 channels, so a chunk's halo (34 x 10 pixels x 16
//   channels) arrives by TMA as 4 planes [pixel][4 channels], one box each,
//   zero-filled outside the image. A tap's window is then a wgmma descriptor
//   without swizzle: a core matrix is 8 consecutive pixels of one plane, 128
//   contiguous bytes at any 16-byte aligned start, so the window shifted by
//   (dy, dx) starts (dy * 10 + dx) * 16 bytes on; the next 8 pixels down are
//   SBO = 160 bytes on, the next 4 channels LBO = one plane on. The
//   activation warps write big in place of the raw input and small into the
//   buffer beside it, zero outside the image (the TMA's zero fill is not
//   enough: silu(0 * a + b) != 0), then release the chunk by an mbarrier.
//   Three halo buffers let them work on chunk k + 1 while the consumers run
//   chunk k and the producer loads chunk k + 2.
// - B (the weights) by TMA: per (chunk, tap) one box of 8 K columns x 80
//   rows a k-step and part, 32-byte swizzled (one box is one tf32 k-step),
//   into a ring of 8 stages of both parts. Per tap a consumer issues 2
//   k-steps x 2 m64 tiles x 3 passes of wgmma.m64n80k8, keeps two taps'
//   products in flight (wait 1), then returns the previous tap's stage; at
//   the chunk's last tap it waits for all of them, returns the stages and
//   the halo, and adds the chunk's accumulator to the output's.
// - The epilogue stores pairs of fp32 from the accumulators, masked at the
//   ragged edges (32 contiguous bytes a quad).
//
// Shared memory: halo buffers 3 x 2 x 4 x 5504 bytes (132 KB), weight ring
// 8 x 10 KB, barriers: 210 KB of 227 KB. What that gave up against bf16's
// 64-channel chunks: 4x the mbarrier handshakes per K and three halo
// buffers of 16 channels instead of 64, so each activation pass is short.
// What the 80 channels gave up against 160: each halo is loaded and
// activated Co / 80 times, and each wgmma reads its A tile (2 KB) from
// shared memory for 80 columns instead of 160.
//
// What bounds it on an H100 (495 TFLOP/s dense TF32, three passes; 67
// TFLOP/s fp32 on the CUDA cores), config 2's ResBlock convs at batch 10, 132
// SMs and one block an SM, L2 traffic of weights (9 * C * 80 * 8 bytes a
// block) and halo (34 * 10 * C * 4 bytes a block):
//   [10, 64, 96, 320] -> 320: 3xTF32 0.686 ms, FMA 1.690 ms; 960 blocks,
//     7.27 waves; weights 1.77 GB + halo 418 MB
//   [10, 64, 96, 640] -> 320: 1.373 / 3.380 ms; 960 blocks, 7.27 waves;
//     3.54 GB + 835 MB
//   [10, 32, 48, 320] -> 640: 0.343 / 0.845 ms; 480 blocks, 3.64 waves;
//     885 MB + 209 MB
//   [10, 32, 48, 640] -> 640: 0.686 / 1.690 ms; 480 blocks, 3.64 waves;
//     1.77 GB + 418 MB
// The bytes of device memory (under 80 MB at each shape) are no bound. The
// tensor work per element is about 6x bf16's (half the rate, three passes),
// so the activation and the split (two MUFU operations and a few integer
// ones an element, in three warps) have 6x as long to hide behind it.
#pragma once

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace mdu {
namespace conv_f32 {

using namespace mdu::sm90;

constexpr int TH = 32;                    // output rows of a block
constexpr int TW = 8;                     // output columns: one core matrix of A
constexpr int HH = TH + 2;                // 34 halo rows
constexpr int HW = TW + 2;                // 10 halo columns
constexpr int HP = HH * HW;               // 340 halo pixels
constexpr int BKC = 16;                   // input channels of a chunk
constexpr int NPL = BKC / 4;              // 4-channel planes of a chunk
constexpr int PLANE_BOX = HP * 16;        // one plane of the halo: 5440 bytes
constexpr int PLANE_BYTES = 5504;         // ... rounded up to 128 (a TMA destination)
constexpr int PART_BYTES = NPL * PLANE_BYTES;     // big or small of a chunk
constexpr int HALO_BYTES = 2 * PART_BYTES;        // big, then small
constexpr int NH = 3;                     // halo buffers
constexpr int BN = 80;                    // output channels of a block
constexpr int NACC = BN / 2;              // accumulator registers of one m64 tile
constexpr int W_BOX = BN * 8 * 4;         // 8 K columns of 80 rows: one k-step, 2560 bytes
constexpr int W_STAGE = 2 * (BKC / 8) * W_BOX;    // one tap of a chunk, both parts: 10240
constexpr int STAGES = 8;                 // the weight ring
constexpr int OFF_HALO = STAGES * W_STAGE;
constexpr int OFF_BAR = OFF_HALO + NH * HALO_BYTES;
constexpr int SMEM_BYTES = OFF_BAR + 8 * (2 * STAGES + 3 * NH) + 1024;
constexpr int NTHREADS = 384;             // the producer warpgroup and two consumers
constexpr int ACT_THREADS = 96;           // warps 1-3: the activation and the split
constexpr int ACT_LANES = ACT_THREADS / NPL;      // threads of one plane: 24
constexpr int ACT_Q = (HP + ACT_LANES - 1) / ACT_LANES;   // pixels a thread: 15
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
static_assert(W_BOX % 256 == 0 && OFF_HALO % 1024 == 0, "32-byte swizzle atoms");
static_assert(PLANE_BYTES >= PLANE_BOX && PLANE_BYTES % 128 == 0, "TMA destinations");

__device__ __forceinline__ float silu(float f) {
  return __fdividef(f, 1.f + __expf(-f));
}

// A block: output rows y0 .. y0 + 31, columns x0 .. x0 + 7 of image b, output
// channels n0 .. n0 + 79.
template <bool ACT>
__global__ void __launch_bounds__(NTHREADS, 1)
conv_f32_sm90_kernel(const __grid_constant__ CUtensorMap mx,
                     const __grid_constant__ CUtensorMap mw,
                     const float* __restrict__ scale, const float* __restrict__ shift,
                     float* __restrict__ y, int H, int W, int C, int Cp, int Co) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (mdu::smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t sb = mdu::smem_addr(base);
  const uint32_t bars = sb + OFF_BAR;
  auto wstage = [&](int st) { return sb + (uint32_t)(st * W_STAGE); };
  auto halo = [&](int h) { return sb + (uint32_t)(OFF_HALO + h * HALO_BYTES); };
  auto wfull = [&](int st) { return bars + 8u * st; };
  auto wempty = [&](int st) { return bars + 8u * (STAGES + st); };
  auto hfull = [&](int h) { return bars + 8u * (2 * STAGES + h); };
  auto hready = [&](int h) { return bars + 8u * (2 * STAGES + NH + h); };
  auto hempty = [&](int h) { return bars + 8u * (2 * STAGES + 2 * NH + h); };

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int tyx = blockIdx.x % (tiles_x * tiles_y);
  const int y0 = (tyx / tiles_x) * TH;
  const int x0 = (tyx % tiles_x) * TW;
  const int n0 = blockIdx.y * BN;
  const int nchunks = C / BKC;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(wfull(st), 1);
      mbar_init(wempty(st), 8);           // one arrival per consumer warp
    }
    for (int h = 0; h < NH; ++h) {
      mbar_init(hfull(h), 1);
      mbar_init(hready(h), ACT_THREADS);
      mbar_init(hempty(h), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n");
    if (threadIdx.x == 0) {
      // ------------------------------------------------------------ producer
      // the raw halo of chunk k into the big half of its buffer: one box of
      // 4 channels x 10 x 34 pixels per plane, zero-filled outside the image
      auto load_halo = [&](int k) {
        const int h = k % NH;
        mbar_arrive_expect_tx(hfull(h), NPL * PLANE_BOX);
        for (int j = 0; j < NPL; ++j)
          tma_load_4d(halo(h) + j * PLANE_BYTES, &mx, hfull(h), k * BKC + 4 * j, x0 - 1,
                      y0 - 1, b);
      };
      load_halo(0);
      for (int k = 0; k < nchunks; ++k) {
        if (k + 1 < nchunks) {            // a chunk ahead of the consumers
          if (k + 1 >= NH) mbar_wait(hempty((k + 1) % NH), ((k + 1) / NH - 1) & 1);
          load_halo(k + 1);
        }
        for (int tap = 0; tap < 9; ++tap) {
          const int it = k * 9 + tap;
          const int st = it % STAGES;
          if (it >= STAGES) mbar_wait(wempty(st), (it / STAGES - 1) & 1);
          mbar_arrive_expect_tx(wfull(st), W_STAGE);
          // box (part, s): K columns tap * Cp + 16 k + 8 s, part 0 big, 1 small
          for (int part = 0; part < 2; ++part)
            for (int s = 0; s < BKC / 8; ++s)
              tma_load_3d(wstage(st) + (part * (BKC / 8) + s) * W_BOX, &mw, wfull(st),
                          tap * Cp + k * BKC + 8 * s, n0, part);
        }
      }
    } else if (threadIdx.x >= 32) {
      // ---------------------------------------------- activation and split
      // Thread at owns plane at / 24 (its 4 channels' scale and shift stay
      // in registers) and every 24th pixel from at % 24; it loads four
      // pixels before it computes them, so that their latencies overlap.
      const int at = threadIdx.x - 32;
      const int j = at / ACT_LANES;
      const int p0 = at % ACT_LANES;
      for (int k = 0; k < nchunks; ++k) {
        const int h = k % NH;
        const int c = k * BKC + 4 * j;
        float4 sv = make_float4(0.f, 0.f, 0.f, 0.f), hv = sv;
        if (ACT) {
          sv = __ldg(reinterpret_cast<const float4*>(scale + (size_t)b * C + c));
          hv = __ldg(reinterpret_cast<const float4*>(shift + (size_t)b * C + c));
        }
        unsigned char* hb = base + OFF_HALO + h * HALO_BYTES + j * PLANE_BYTES;
        mbar_wait(hfull(h), (k / NH) & 1);
        for (int q0 = 0; q0 < ACT_Q; q0 += 4) {
          float4 v[4];
          bool in[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int hp = p0 + ACT_LANES * (q0 + u);
            const int gy = y0 - 1 + hp / HW;
            const int gx = x0 - 1 + hp % HW;
            in[u] = hp < HP && gy >= 0 && gy < H && gx >= 0 && gx < W;
            v[u] = in[u] ? *reinterpret_cast<const float4*>(hb + hp * 16)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int hp = p0 + ACT_LANES * (q0 + u);
            if (hp >= HP) continue;
            float a[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
            if (ACT && in[u]) {           // the pad stays zero after the activation
              a[0] = silu(fmaf(a[0], sv.x, hv.x));
              a[1] = silu(fmaf(a[1], sv.y, hv.y));
              a[2] = silu(fmaf(a[2], sv.z, hv.z));
              a[3] = silu(fmaf(a[3], sv.w, hv.w));
            }
            uint4 big, small;
            big.x = to_tf32(a[0]); small.x = __float_as_uint(a[0] - __uint_as_float(big.x));
            big.y = to_tf32(a[1]); small.y = __float_as_uint(a[1] - __uint_as_float(big.y));
            big.z = to_tf32(a[2]); small.z = __float_as_uint(a[2] - __uint_as_float(big.z));
            big.w = to_tf32(a[3]); small.w = __float_as_uint(a[3] - __uint_as_float(big.w));
            *reinterpret_cast<uint4*>(hb + hp * 16) = big;
            *reinterpret_cast<uint4*>(hb + PART_BYTES + hp * 16) = small;
          }
        }
        fence_proxy_async();              // seen by wgmma
        mbar_arrive(hready(h));
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;

    float acc[2][NACC];                   // the chunk's products
    float out[2][NACC];                   // the output's sum, in fp32 on the CUDA cores
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < NACC; ++r) acc[i][r] = out[i][r] = 0.f;

    const int orow = 16 * cw;             // this consumer's first output row
    // the products of one tap of chunk k (stage st, halo buffer h); the
    // chunk's first product overwrites its accumulator
    auto issue_tap = [&](int h, int tap, int st) {
      // the tap's window of the big part: the halo shifted by (dy, dx); 8
      // rows of 8 pixels an m64 tile, the next 8-pixel row 10 pixels on (SBO
      // = 160 bytes), the next 4 channels one plane on (LBO)
      const uint32_t a0 = halo(h) + ((orow + tap / 3) * HW + tap % 3) * 16;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < BKC / 8; ++s) {
        const uint64_t bb = desc_b32(wstage(st) + s * W_BOX, 16, 256);
        const uint64_t bs = desc_b32(wstage(st) + (BKC / 8 + s) * W_BOX, 16, 256);
        const int keep = tap > 0 || s > 0;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t ai = a0 + 2 * s * PLANE_BYTES + i * 8 * HW * 16;
          const uint64_t ab = desc_plain(ai, PLANE_BYTES, HW * 16);
          const uint64_t as = desc_plain(ai + PART_BYTES, PLANE_BYTES, HW * 16);
          Tf32<BN>::ss(acc[i], as, bb, keep);
          Tf32<BN>::ss(acc[i], ab, bs, 1);
          Tf32<BN>::ss(acc[i], ab, bb, 1);
        }
      }
      wgmma_commit();
    };
    int it = 0;                           // chunk * 9 + tap
    for (int k = 0; k < nchunks; ++k) {
      const int h = k % NH;
      mbar_wait(hready(h), (k / NH) & 1);
#pragma unroll 1
      for (int tap = 0; tap < 8; ++tap, ++it) {
        mbar_wait(wfull(it % STAGES), (it / STAGES) & 1);
        issue_tap(h, tap, it % STAGES);
        wgmma_wait<1>();                  // the previous tap's products are done
        if (tap > 0 && lane == 0) mbar_arrive(wempty((it - 1) % STAGES));
      }
      // the last tap (peeled off, so that the loop body is straight-line code
      // for the compiler's tracking of the asynchronous products); then all
      // of the chunk's products are done, its stages and halo go back, and
      // its accumulator is added to the output's
      mbar_wait(wfull(it % STAGES), (it / STAGES) & 1);
      issue_tap(h, 8, it % STAGES);
      wgmma_wait<0>();
      if (lane == 0) {
        mbar_arrive(wempty((it - 1) % STAGES));
        mbar_arrive(wempty(it % STAGES));
        mbar_arrive(hempty(h));
      }
      ++it;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < NACC; ++r) {
          fence_reg(acc[i][r]);
          out[i][r] += acc[i][r];
        }
    }

    // out[i][4j + 2hh + e]: m64 row 16 warp + g + 8 hh = row r = 8 i + 2 warp
    // + hh of this consumer's 16 x 8 pixels, column g; output channel n0 + 8 j
    // + 2 t + e. Co % 8 == 0, so co < Co covers co + 1.
    const int g = lane / 4;
    const int t = lane % 4;
    const int gx = x0 + g;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int gy = y0 + orow + 8 * i + 2 * warp + hh;
        if (gy >= H || gx >= W) continue;
        float* yr = y + (((size_t)b * H + gy) * W + gx) * Co;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int co = n0 + 8 * j + 2 * t;
          if (co < Co)
            *reinterpret_cast<float2*>(yr + co) =
                make_float2(out[i][4 * j + 2 * hh], out[i][4 * j + 2 * hh + 1]);
        }
      }
    }
  }
}

// x: contiguous NHWC [B, H, W, C] fp32, C % 16 == 0; w: the packed weight
// [2][Co][9 * Cp] fp32 (big, small; Cp = C rounded up to 32); scale, shift:
// fp32 [B, C], read only with ``fuse_act``; y: contiguous NHWC [B, H, W, Co],
// Co % 8 == 0. Every base 16-byte aligned.
inline cudaError_t launch(const void* x, const void* w, const void* scale, const void* shift,
                          void* y, int B, int H, int W, int C, int Cp, int Co, int fuse_act,
                          cudaStream_t stream) {
  if (C % BKC != 0 || Cp < C || Cp % 32 != 0 || Co % 8 != 0) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  // x as {C, W, H, B}; a box is one 4-channel plane of the 10 x 34 halo
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)C * 4, (cuuint64_t)W * C * 4,
                                  (cuuint64_t)H * W * C * 4};
  const cuuint32_t xbox[4] = {4, HW, HH, 1};
  // the packed weight as {9 * Cp, Co, part}; a box is 8 K columns of 80
  // rows, 32-byte swizzled; rows past Co are zero-filled
  const cuuint64_t wdims[3] = {(cuuint64_t)9 * Cp, (cuuint64_t)Co, 2};
  const cuuint64_t wstrides[2] = {(cuuint64_t)9 * Cp * 4, (cuuint64_t)Co * 9 * Cp * 4};
  const cuuint32_t wbox[3] = {8, BN, 1};
  if (encode(&mx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x), xdims, xstrides,
             xbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&mw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(w), wdims, wstrides,
             wbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kernel = fuse_act ? conv_f32_sm90_kernel<true> : conv_f32_sm90_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long tiles = (long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  dim3 grid((unsigned)tiles, (Co + BN - 1) / BN);
  kernel<<<grid, NTHREADS, SMEM_BYTES, stream>>>(mx, mw, static_cast<const float*>(scale),
                                                 static_cast<const float*>(shift),
                                                 static_cast<float*>(y), H, W, C, Cp, Co);
  return cudaGetLastError();
}

}  // namespace conv_f32
}  // namespace mdu
