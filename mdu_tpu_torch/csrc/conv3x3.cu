// Fused (GroupNorm affine -> SiLU ->) 3x3 convolution for Hopper (sm_90a),
// NHWC, stride 1, 'same' padding; bf16 on the tensor cores, fp32 on the
// tensor cores as three TF32 products (conv3x3_f32_sm90.cuh) or on the CUDA
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
// to Cp, a multiple of 32, with zeros); in fp32 as [2][Co][9][Cp], its
// tf32-rounded big part and the small rest, which sum to it exactly. What
// bounds it on an H100: at config 2's ResBlock shapes (C, Co of 320 and 640
// on 64x96 and 32x48 latents, batch 10) 2*M*9*C*Co flops against a few tens
// of MB, far above the ridge, so the tensor cores at 989 TFLOP/s: 0.1145 ms
// at [10, 64, 96, 320] -> 320 and at [10, 32, 48, 640] -> 640.
//
// Two bf16 forms, chosen by the wrapper (ops/kernels/conv3x3.py::conv_form)
// on shape and alignment alone:
//
// mdu_conv3x3_sm90, the warpgroup form (C % 64 == 0, Co % 8 == 0, 16-byte
// aligned operands: all of config 2). A block owns 32 x 8 output pixels of
// one image and 160 output channels (m64n160 divides Co = 320 and 640);
// warpgroup 0 holds the producer warp and three activation warps, two
// consumer warpgroups own 16 x 8 pixels each (two m64 tiles of 8 rows x 8
// columns). setmaxnreg moves registers from warpgroup 0 (80) to the
// consumers (208).
// - B (the weights) by TMA: one box per (chunk of 64 input channels, tap),
//   160 rows x 128 bytes with the 128-byte swizzle, into a ring of 4 stages
//   with full / empty mbarriers, kept full by one producer thread.
// - A (the activated input) from shared memory too. The halo of a chunk
//   (34 x 10 pixels x 64 channels) arrives by TMA, 8 boxes of one 8-channel
//   group each, as planes [group][pixel][8 channels] (zero-filled outside
//   the image). In this layout a tap's window is a wgmma descriptor with no
//   swizzle: a core matrix is 8 consecutive pixels of one group, 128
//   contiguous bytes at any 16-byte aligned start, so the window shifted by
//   (dy, dx) starts (dy * 10 + dx) * 16 bytes on; the next 8 pixels down are
//   SBO = 160 bytes on, the next 8 channels LBO = one plane on. That is why
//   the tile is 8 pixels wide. No A fragment passes through registers and
//   no ldmatrix runs: each consumer issues per tap 2 x 4 wgmma.m64n160k16.
// - The three activation warps activate each chunk's halo in place once,
//   zeroing by coordinates what lies outside the image (the TMA's zero fill
//   is not enough: silu(0 * a + b) != 0), and release it to the consumers
//   by an mbarrier. Three halo buffers let them activate chunk k + 1 while
//   the consumers run the products of chunk k and the producer loads chunk
//   k + 2's raw halo. Each thread keeps one channel group's scale and shift
//   in registers and works on four pixels at once.
// - Per tap a consumer keeps two groups of products in flight (wait 1),
//   then returns the previous tap's weight stage.
// - The epilogue goes through shared memory (a free halo buffer, 32-byte
//   swizzled, conflict-free) and TMA stores, which clip the ragged edges.
// L2 traffic and waves per SM (132 SMs, one block an SM; weights 9 * C * 160
// * 2 bytes a block, halo 8 * 5440 bytes a chunk a block):
//   [10, 64, 96, 320] -> 320: 480 blocks, 3.64 waves, weights 442 MB + halo
//     104 MB (the mma.sync form: 1.06 GB + 166 MB)
//   [10, 64, 96, 640] -> 320: 480 blocks, 3.64 waves, 885 MB + 209 MB
//   [10, 32, 48, 320] -> 640: 240 blocks, 1.82 waves, 221 MB + 52 MB
//   [10, 32, 48, 640] -> 640: 240 blocks, 1.82 waves, 442 MB + 104 MB
// The last wave runs 64 % (64x96) and 82 % (32x48) full, about 9 % of the
// time at both. The design leaves that as it is: with tiles of equal work a
// persistent grid runs the same ceil(blocks / 132) tile times per SM, and a
// smaller tile at small H*W would read the weights more often.
//
// mdu_conv3x3, the mma.sync form (any other bf16 input: C = 12, 24, unaligned
// operands). A block owns an 8 x 16 tile of output pixels of one image and
// 128 output channels. For each chunk of 32 input channels it loads the
// tile's 10 x 18 input pixels with their halo (16-byte loads of 8 channels),
// applies the affine and SiLU in fp32 once per loaded element and stores the
// bf16 result in shared memory, while the chunk's weights for all 9 taps
// arrive by cp.async (92 KB); then 8 warps run the 9 taps' mma.sync m16n8k16
// products (fp32 accumulate), each tap reading the halo tile shifted by the
// tap (ldmatrix takes a row address per lane). Single-staged (loads,
// barrier, products, barrier), two blocks an SM.
//
// Two fp32 forms (a model built in fp32), chosen by the wrapper
// (ops/kernels/conv3x3.py::conv_f32_form) on shape and alignment alone:
// mdu_conv3x3_f32_sm90, the warpgroup form in three TF32 products, for C %
// 16 == 0, Co % 8 == 0 and 16-byte aligned operands (all of config 2;
// conv3x3_f32_sm90.cuh has its design), and the CUDA-core form (any other
// fp32 input: the tiny UNet's C = 12, 24, unaligned operands), a plain
// shared-memory tiled product: 64 pixels x 64 channels a block, 4 x 4
// outputs a thread, the weight read as big + small.
#include "mma_bf16.cuh"
#include "sm90.cuh"
#include "conv3x3_f32_sm90.cuh"

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

// ------------------------------------------------- bf16, warpgroup form
namespace wg {

constexpr int TH = 32;                    // output rows of a block
constexpr int TW = 8;                     // output columns: one core matrix of A
constexpr int HH = TH + 2;                // 34 halo rows
constexpr int HW = TW + 2;                // 10 halo columns
constexpr int HP = HH * HW;               // 340 halo pixels
constexpr int BKC = 64;                   // input channels of a chunk
constexpr int NG = BKC / 8;               // 8-channel groups of a chunk
constexpr int BOX_BYTES = HP * 16;        // one group of the halo: 5440 bytes
constexpr int GROUP_BYTES = 5504;         // ... rounded up to 128 (a TMA destination)
constexpr int HALO_BYTES = NG * GROUP_BYTES;
constexpr int NH = 3;                     // halo buffers
constexpr int BN = 160;                   // output channels of a block
constexpr int W_STAGE = BN * BKC * 2;     // one tap's weights of a chunk: 20480 bytes
constexpr int STAGES = 4;                 // the weight ring
constexpr int OFF_HALO = STAGES * W_STAGE;
constexpr int OFF_BAR = OFF_HALO + NH * HALO_BYTES;
constexpr int SMEM_BYTES = OFF_BAR + 8 * (2 * STAGES + 3 * NH) + 1024;
constexpr int NTHREADS = 384;             // the producer warpgroup and two consumers
constexpr int ACT_THREADS = 96;           // warps 1-3: the activation
constexpr int ACT_LANES = ACT_THREADS / NG;       // threads of one channel group: 12
constexpr int ACT_Q = (HP + ACT_LANES - 1) / ACT_LANES;   // pixels a thread: 29
constexpr int OUT_BOX = 16 * TW * 16 * 2; // one output box: 16 rows x 8 pixels x 16 channels
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
static_assert(W_STAGE % 1024 == 0 && OFF_HALO % 1024 == 0, "128-byte swizzle atoms");
static_assert(GROUP_BYTES >= BOX_BYTES && GROUP_BYTES % 128 == 0, "TMA destinations");
static_assert(HALO_BYTES % 1024 == 0 && (BN / 16) * OUT_BOX <= HALO_BYTES, "output staging");

// D += A B, m64n160k16: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n160(float (&d)[80], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(1));
}

// A block: output rows y0 .. y0 + 31, columns x0 .. x0 + 7 of image b, output
// channels n0 .. n0 + 159.
// - Warpgroup 0: warp 0 is the producer (one thread issues every TMA load);
//   warps 1-3 activate each chunk's halo in place once it has landed.
// - Consumer warpgroup cw = 0, 1 owns output rows 16 cw .. 16 cw + 15 as two
//   m64 tiles of 8 rows x 8 columns, and stores them through shared memory
//   by TMA.
template <bool ACT>
__global__ void __launch_bounds__(NTHREADS, 1)
conv_sm90_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
                 const __grid_constant__ CUtensorMap my, const float* __restrict__ scale,
                 const float* __restrict__ shift, __nv_bfloat16* __restrict__ y, int H, int W,
                 int C, int Cp, int Co) {
  using namespace mdu::sm90;
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
  const int nchunks = Cp / BKC;

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
      // the raw halo of chunk k: one box of 8 channels x 10 x 34 pixels per
      // channel group, zero-filled outside the image and past C
      auto load_halo = [&](int k) {
        const int h = k % NH;
        mbar_arrive_expect_tx(hfull(h), NG * BOX_BYTES);
        for (int j = 0; j < NG; ++j)
          tma_load_4d(halo(h) + j * GROUP_BYTES, &mx, hfull(h), k * BKC + 8 * j, x0 - 1,
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
          tma_load_2d(wstage(st), &mw, wfull(st), tap * Cp + k * BKC, n0);
        }
      }
    } else if (ACT && threadIdx.x >= 32) {
      // ---------------------------------------------------------- activation
      // Each chunk's halo in place, once, while the consumers run the
      // products of the chunk before: zero outside the image and past C (the
      // TMA's zero fill is not enough: silu(0 * a + b) != 0), silu(x * scale
      // + shift) rounded to bf16 elsewhere; then seen by wgmma. Thread at
      // owns channel group at / 12 (its scale and shift stay in registers)
      // and every 12th pixel from at % 12; it loads four pixels before it
      // computes them, so that their latencies overlap.
      const int at = threadIdx.x - 32;
      const int j = at / ACT_LANES;
      const int p0 = at % ACT_LANES;
      for (int k = 0; k < nchunks; ++k) {
        const int h = k % NH;
        const int c = k * BKC + 8 * j;
        float sv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        float hv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (c < C) {
          const float4* sc = reinterpret_cast<const float4*>(scale + (size_t)b * C + c);
          const float4* sh = reinterpret_cast<const float4*>(shift + (size_t)b * C + c);
          const float4 s0 = __ldg(sc), s1 = __ldg(sc + 1);
          const float4 h0 = __ldg(sh), h1 = __ldg(sh + 1);
          sv[0] = s0.x; sv[1] = s0.y; sv[2] = s0.z; sv[3] = s0.w;
          sv[4] = s1.x; sv[5] = s1.y; sv[6] = s1.z; sv[7] = s1.w;
          hv[0] = h0.x; hv[1] = h0.y; hv[2] = h0.z; hv[3] = h0.w;
          hv[4] = h1.x; hv[5] = h1.y; hv[6] = h1.z; hv[7] = h1.w;
        }
        unsigned char* hb = base + OFF_HALO + h * HALO_BYTES + j * GROUP_BYTES;
        mbar_wait(hfull(h), (k / NH) & 1);
        for (int q0 = 0; q0 < ACT_Q; q0 += 4) {
          uint4 v[4];
          bool in[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int hp = p0 + ACT_LANES * (q0 + u);
            const int gy = y0 - 1 + hp / HW;
            const int gx = x0 - 1 + hp % HW;
            in[u] = hp < HP && gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
            v[u] = hp < HP ? *reinterpret_cast<const uint4*>(hb + hp * 16)
                           : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v[u]);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float2 f = __bfloat1622float2(e[r]);
              e[r] = __floats2bfloat162_rn(silu_fast(f.x * sv[2 * r] + hv[2 * r]),
                                           silu_fast(f.y * sv[2 * r + 1] + hv[2 * r + 1]));
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int hp = p0 + ACT_LANES * (q0 + u);
            if (hp < HP)                    // the pad stays zero after the activation
              *reinterpret_cast<uint4*>(hb + hp * 16) = in[u] ? v[u] : make_uint4(0u, 0u, 0u, 0u);
          }
        }
        fence_proxy_async();
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

    float acc[2][80];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 80; ++r) acc[i][r] = 0.f;

    const int orow = 16 * cw;             // this consumer's first output row
    int it = 0;                           // chunk * 9 + tap
    for (int k = 0; k < nchunks; ++k) {
      const int h = k % NH;
      mbar_wait(ACT ? hready(h) : hfull(h), (k / NH) & 1);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap, ++it) {
        const int st = it % STAGES;
        // the tap's window: the halo shifted by (dy, dx); 8 rows of 8 pixels
        // an m64 tile, the next 8-pixel row 10 pixels on (SBO = 160 bytes),
        // the next 8 channels one group on (LBO)
        const uint32_t a0 = halo(h) + ((orow + tap / 3) * HW + tap % 3) * 16;
        mbar_wait(wfull(st), (it / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < BKC / 16; ++s) {
          const uint64_t db = desc_sw128(wstage(st) + 32 * s);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wgmma_ss_n160(acc[i], desc_plain(a0 + 2 * s * GROUP_BYTES + i * 8 * HW * 16,
                                             GROUP_BYTES, HW * 16), db);
        }
        wgmma_commit();
        wgmma_wait<1>();                  // the previous tap's products are done
        if (it > 0 && lane == 0) {
          mbar_arrive(wempty((it - 1) % STAGES));
          if (tap == 0) mbar_arrive(hempty((k - 1) % NH));
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 80; ++r) fence_reg(acc[i][r]);

    // acc[i][4j + 2hh + e]: m64 row 16 warp + g + 8 hh = row r = 8 i + 2 warp
    // + hh of this consumer's 16 x 8 pixels, column g; output channel n0 + 8 j
    // + 2 t + e.
    const int g = lane / 4;
    const int t = lane % 4;
    // Through shared memory: the halo buffer of chunk nchunks + cw (mod 3),
    // which no load, activation or product touches any more (the other
    // consumer is at most STAGES taps behind, in the last chunk), as 10
    // boxes of 16 rows x 8 pixels x 16 channels with the 32-byte swizzle (the
    // 16-byte half of a 32-byte row flips every 4 rows): conflict-free
    // stores, and the TMA writes only what lies inside y.
    const uint32_t out = halo((nchunks + cw) % NH);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = (8 * i + 2 * warp + hh) * 8 + g;     // box row: (r, pixel)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const uint32_t addr = out + (j / 2) * OUT_BOX + row * 32 +
                                (((j & 1) ^ ((row >> 2) & 1)) << 4) + 4 * t;
          const uint32_t v = mdu::pack_bf16(__float2bfloat16_rn(acc[i][4 * j + 2 * hh]),
                                            __float2bfloat16_rn(acc[i][4 * j + 2 * hh + 1]));
          asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
        }
      }
    }
    fence_proxy_async();                  // seen by the TMA
    named_sync(2 + cw, 128);
    if (tid == 0) {
      for (int c = 0; c < BN / 16; ++c)
        tma_store_4d(&my, out + c * OUT_BOX, n0 + 16 * c, x0, y0 + orow, b);
      tma_store_commit();
      tma_store_wait_read();
    }
  }
}

}  // namespace wg

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
        const size_t at = (size_t)(n0 + n) * K + tap * Cp + c0 + tx;
        Bs[tx][n] = n0 + n < Co ? w[at] + w[(size_t)Co * K + at] : 0.f;   // big + small
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
// up to a multiple of 32, zero-filled), the dtype of x, in fp32 [2, Co, 9 *
// Cp] (big, small); scale, shift: fp32
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

// The warpgroup form. x: contiguous NHWC [B, H, W, C] bf16 with C % 64 == 0
// and a 16-byte aligned base; w: the packed [Co, 9 * Cp] bf16 weight (Cp = C),
// 16-byte aligned; scale, shift: fp32 [B, C], 16-byte aligned, read only with
// ``fuse_act``; y: contiguous NHWC [B, H, W, Co] bf16, Co % 8 == 0, 16-byte
// aligned. Returns a cudaError_t
// (0 on a successful launch).
extern "C" int mdu_conv3x3_sm90(const void* x, const void* w, const void* scale,
                                const void* shift, void* y, int B, int H, int W, int C,
                                int Cp, int Co, int fuse_act, void* stream) {
  using namespace mdu::sm90;
  if (C % wg::BKC != 0 || Cp != C || Co % 8 != 0) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw, my;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  // x as {C, W, H, B}; a box is one 8-channel group of the 10 x 34 halo
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                  (cuuint64_t)H * W * C * 2};
  const cuuint32_t xbox[4] = {8, wg::HW, wg::HH, 1};
  // the packed weight as {9 * Cp, Co}; a box is 64 K columns of 160 rows,
  // 128-byte swizzled; rows past Co are zero-filled
  const cuuint64_t wdims[2] = {(cuuint64_t)9 * Cp, (cuuint64_t)Co};
  const cuuint64_t wstrides[1] = {(cuuint64_t)9 * Cp * 2};
  const cuuint32_t wbox[2] = {wg::BKC, wg::BN};
  // y as {Co, W, H, B}; a box is 16 channels x 8 pixels x 16 rows,
  // 32-byte swizzled; the parts outside y are not written
  const cuuint64_t ydims[4] = {(cuuint64_t)Co, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t ystrides[3] = {(cuuint64_t)Co * 2, (cuuint64_t)W * Co * 2,
                                  (cuuint64_t)H * W * Co * 2};
  const cuuint32_t ybox[4] = {16, wg::TW, wg::TH / 2, 1};
  if (encode(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdims, xstrides,
             xbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), wdims, wstrides,
             wbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&my, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, y, ydims, ystrides, ybox, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  auto kernel = fuse_act ? wg::conv_sm90_kernel<true> : wg::conv_sm90_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         wg::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long tiles = (long)B * ((H + wg::TH - 1) / wg::TH) * ((W + wg::TW - 1) / wg::TW);
  dim3 grid((unsigned)tiles, (Co + wg::BN - 1) / wg::BN);
  kernel<<<grid, wg::NTHREADS, wg::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      mx, mw, my, static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<__nv_bfloat16*>(y), H, W, C, Cp, Co);
  return (int)cudaGetLastError();
}

// The fp32 warpgroup form (conv3x3_f32_sm90.cuh). x: contiguous NHWC [B, H,
// W, C] fp32 with C % 16 == 0; w: the packed [2, Co, 9 * Cp] fp32 weight
// (big, small); scale, shift: fp32 [B, C], read only with ``fuse_act``; y:
// contiguous NHWC [B, H, W, Co] fp32, Co % 8 == 0; every base 16-byte
// aligned. Returns a cudaError_t (0 on a successful launch).
extern "C" int mdu_conv3x3_f32_sm90(const void* x, const void* w, const void* scale,
                                    const void* shift, void* y, int B, int H, int W, int C,
                                    int Cp, int Co, int fuse_act, void* stream) {
  return (int)mdu::conv_f32::launch(x, w, scale, shift, y, B, H, W, C, Cp, Co, fuse_act,
                                    static_cast<cudaStream_t>(stream));
}
