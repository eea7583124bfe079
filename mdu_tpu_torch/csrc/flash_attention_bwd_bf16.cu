// The bf16_sm90 form of the attention backward: flash_attention_bwd_sm90.cuh
// (which holds the design note) instantiated for bf16, as a library of its
// own so that nvcc builds it beside the fp32 form.
#include "flash_attention_bwd_sm90.cuh"

// q, k, v, o, dout, dq, dk, dv: contiguous bf16 [bh, L, D] (q, o, dout, dq: Lq
// rows; k, v, dk, dv: Lk rows), D % 8 == 0, 16 <= D <= 160, q, k, v and dout
// 16-byte aligned; lse and delta: 16-byte aligned fp32 scratch of bh x ((Lq +
// 63) / 64 x 64) each. D is padded to the next multiple of 16. Two launches on
// ``stream``; returns a cudaError_t (0 when both were taken).
extern "C" int mdu_flash_attention_bwd_bf16_sm90(const void* q, const void* k, const void* v,
                                                 const void* o, const void* dout, void* dq,
                                                 void* dk, void* dv, void* lse, void* delta,
                                                 int bh, int Lq, int Lk, int D, float scale,
                                                 void* stream) {
  using namespace mdu::bwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 != 0 || D < 16 || D > 160 || Lq < 1 || Lk < 1 || bh < 1 || !aligned16(lse) ||
      !aligned16(delta))
    return cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch ((D + 15) / 16) {
#define MDU_BWD_BF16(n)                                                                       \
  case n:                                                                                     \
    return launch_bf16_dp<16 * n>(q, k, v, o, dout, dq, dk, dv, l, dl, bh, Lq, Lk, D, scale, \
                                  s);
    MDU_BWD_BF16(1)
    MDU_BWD_BF16(2)
    MDU_BWD_BF16(3)
    MDU_BWD_BF16(4)
    MDU_BWD_BF16(5)
    MDU_BWD_BF16(6)
    MDU_BWD_BF16(7)
    MDU_BWD_BF16(8)
    MDU_BWD_BF16(9)
    MDU_BWD_BF16(10)
#undef MDU_BWD_BF16
    default:
      return cudaErrorInvalidValue;
  }
}
