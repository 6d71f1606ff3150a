// The int8 and bf16 tensor-core GEMMs for Hopper (sm_90a), all on
// ptq_int8.cuh's wgmma + TMA GEMM (hopper_gemm.cuh's engine):
//
//   int8_spike_bf16    bf16 x (M, K) @ bf16 w packed (N, Kp) K-major, f32
//                      accumulation -> bf16 or f32 (M, N)
//   int8_spike_direct  int8 x (M, K) @ int8 w packed (N, Kp) -> s32 (M, N)
//   ptq_int8_quantize  f32 or bf16 x -> int8 clamp(rint(x * inv_s), +-127)
//   ptq_int8_conv      that int8 x @ int8 per-output-channel weights
//                      (N, Kp), s32 accumulation -> f32(acc) * colscale[n]
//                      (+ bias[n]) -> f32 or bf16. A is either rows of an
//                      (M, K) matrix (a Dense site, a 1x1 stride-1 conv) or
//                      an implicit-GEMM gather from NHWC x (a k x k or
//                      strided conv): row m = (b, oh, ow), column
//                      k = (kh, kw, c), zeros in the symmetric padding.
//
// The three spike bodies replace the TPU kernel `_call` of
// tools/int8_pallas_spike.py (`_bf16_kernel`, `_int8_direct_kernel` and
// `_int8_kernel`, one pallas_call over row tiles of x against the whole of w
// in VMEM). `_int8_kernel` (x quantized with a static scale sx, the s32 sum
// times sx) is ptq_int8_quantize then ptq_int8_conv with colscale[n] = sx and
// no bias, or ptq_int8_conv alone on bf16 rows where the GEMM quantizes them
// itself (ops/kernels/int8_gemm.py: int8_spike_int8); the PTQ pair replaces
// XLA's int8 conv_general_dilated / dot_general of
// vip_cup_2022_tpu/quant/ptq.py (`_int8_conv`, `_handle_dense`).
//
// Numerics, bit for bit with the JAX package: the activation is multiplied
// by the f32 reciprocal of its scale (the wrapper rounds the f64 1 / s once)
// and rounded half to even, then clamped; the s32 sum is converted with
// round to nearest, multiplied by the f32 scale (PTQ: then the f32 bias is
// added; no fused multiply-add).
//
// What bounds the spike bodies on this card: at the spike's shapes (M 625 ...
// 4096, K 384 / 768, N 1536 / 3072) the products once K N / (K + N) passes
// about 600 for a bf16 x, else the bytes of x, w and the output (a few
// microseconds each). The GEMM's design (ptq_int8.cuh, hopper_gemm.cuh):
// wgmma m64nBNk32 s8 (m64nBNk16 bf16) from 128-byte-swizzled tiles that TMA
// brings through an mbarrier ring, persistent CTAs with a producer
// warpgroup and two consumer pairs in ping-pong (or 256-row items where W
// streams), the epilogue staged through shared memory into whole-sector
// stores. The tiles come from int8_gemm.py: ptq_plan.
//
// The launchers have a plain C interface for ctypes and return
// cudaGetLastError() as an int, so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ptq_int8.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kWhole = hopper_gemm::kWhole;

}  // namespace

extern "C" {

// x (M, K) bf16 rows, K a multiple of 8; w (N, ldw) bf16 K-major, zeros
// past K; the plan (bn, stages, resident, tall) from int8_gemm.py: ptq_plan
int int8_spike_bf16(const void* x, const void* w, int ldw, void* out, int out_f32, int M, int K,
                    int N, int bn, int stages, int resident, int tall, void* stream) {
  const ptq_int8::Params p{(const int8_t*)x, 0.f, nullptr, nullptr, out, M, K, N, ldw, 1, 1, K,
                           1, 1, 0, 1, 1, stages, resident};
  const cudaStream_t st = (cudaStream_t)stream;
  const int src = ptq_int8::kRows;
  return (int)(out_f32 ? ptq_int8::launch_gemm<float, kWhole, bf16, false>(p, w, src, bn,
                                                                            tall != 0, st)
                       : ptq_int8::launch_gemm<bf16, kWhole, bf16, false>(p, w, src, bn,
                                                                           tall != 0, st));
}

// a: int8 (M, K) rows (src 0) or, where K is not a multiple of 16, the same
// rows gathered as M images of 1 x 1 x K (src 1, C = K); w (N, ldw) int8
// K-major; -> s32 (M, N)
int int8_spike_direct(const void* a, const void* w, int ldw, void* out, int M, int K, int N,
                      int src, int H, int W, int C, int KW, int stride, int pad, int Ho, int Wo,
                      int bn, int stages, int resident, int tall, void* stream) {
  const ptq_int8::Params p{(const int8_t*)a, 0.f, nullptr, nullptr, out, M, K, N, ldw, H, W, C,
                           KW, stride, pad, Ho, Wo, stages, resident};
  return (int)ptq_int8::launch_gemm<int, kWhole, int8_t, false>(p, w, src, bn, tall != 0,
                                                                (cudaStream_t)stream);
}

// n values of f32 (x_f32) or bf16 x -> int8 q, n a multiple of 4
int ptq_int8_quantize(const void* x, int x_f32, void* q, long long n, float inv_s, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(x_f32 ? ptq_int8::launch_quantize<float>(x, q, n, inv_s, st)
                     : ptq_int8::launch_quantize<bf16>(x, q, n, inv_s, st));
}

// a: the quantized x (src 0: (M, K) rows; src 1: NHWC (B, H, W, C), the conv
// KH x KW at `stride` with symmetric `pad`, output (B, Ho, Wo, N) with M = B
// Ho Wo and K = KH KW C) or, with src 2, the bf16 x rows themselves,
// quantized in the GEMM with inv_s (bf16 output only); w (N, ldw) int8,
// K-major; the plan from ops/kernels/int8_gemm.py:
// ptq_plan (bn, stages, resident, tall)
int ptq_int8_conv(const void* a, const void* w, int ldw, const float* colscale,
                  const float* bias, void* out, int out_f32, int M, int K, int N, int src,
                  float inv_s, int H, int W, int C, int KW, int stride, int pad, int Ho, int Wo,
                  int bn, int stages, int resident, int tall, void* stream) {
  const ptq_int8::Params p{(const int8_t*)a, inv_s, colscale, bias, out, M, K, N, ldw, H, W,
                           C, KW, stride, pad, Ho, Wo, stages, resident};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(out_f32 ? ptq_int8::launch_gemm<float, kWhole>(p, w, src, bn, tall != 0, st)
                       : ptq_int8::launch_gemm<bf16, kWhole>(p, w, src, bn, tall != 0, st));
}

}  // extern "C"
