// The f32_sm90 form of the attention backward: flash_attention_bwd_sm90.cuh
// (which holds the design note) instantiated for fp32, as a library of its
// own so that nvcc builds it beside the bf16 form.
#include "flash_attention_bwd_sm90.cuh"

// q, k, v, o, dout, dq, dk, dv: contiguous fp32 [bh, L, D] (q, o, dout, dq: Lq
// rows; k, v, dk, dv: Lk rows), D % 4 == 0, D <= 160, q, k, v and dout 16-byte
// aligned; lse and delta: 16-byte aligned fp32 scratch of bh x ((Lq + 63) / 64
// x 64) each. D is padded to the next width of {8, 16, 24, 32, 40, 48, 64, 80,
// 96, 128, 160}. Two launches on ``stream``; returns a cudaError_t (0 when
// both were taken).
extern "C" int mdu_flash_attention_bwd_f32_sm90(const void* q, const void* k, const void* v,
                                                const void* o, const void* dout, void* dq,
                                                void* dk, void* dv, void* lse, void* delta,
                                                int bh, int Lq, int Lk, int D, float scale,
                                                void* stream) {
  using namespace mdu::bwd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 != 0 || D < 4 || D > 160 || Lq < 1 || Lk < 1 || bh < 1 || !aligned16(lse) ||
      !aligned16(delta))
    return cudaErrorInvalidValue;
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
#define MDU_BWD_F32(DP)                                                                     \
  if (D <= DP)                                                                              \
    return launch_f32_dp<DP>(q, k, v, o, dout, dq, dk, dv, l, dl, bh, Lq, Lk, D, scale, s);
  MDU_BWD_F32(8) MDU_BWD_F32(16) MDU_BWD_F32(24) MDU_BWD_F32(32) MDU_BWD_F32(40)
  MDU_BWD_F32(48) MDU_BWD_F32(64) MDU_BWD_F32(80) MDU_BWD_F32(96) MDU_BWD_F32(128)
  MDU_BWD_F32(160)
#undef MDU_BWD_F32
  return cudaErrorInvalidValue;
}
