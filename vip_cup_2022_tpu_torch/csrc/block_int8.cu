// The fused blocks' in-kernel int8 mode (VIPTPU_INT8_KERNELS=1) for Hopper
// (sm_90a): the kernels of block_int8.cuh behind a plain C interface for
// ctypes (ops/kernels/block_int8.py). One ConvNeXt block runs
//   dwconv7x7_nhwc -> ln_fc1_gelu_int8 -> quantize_rows -> fc2_scale_residual_int8
// and one GCViT block at C >= VIPTPU_GCVIT_INT8_MIN_C
//   ln_qkv_int8 -> window_attention -> quantize_rows -> proj_scale_residual_int8
//   -> ln_fc1_gelu_int8 -> quantize_rows -> fc2_scale_residual_int8
// (dwconv7x7_nhwc and window_attention stay bf16, as the TPU kernels keep
// the depthwise taps and the attention products out of int8). The plans
// come from ops/kernels/block_int8.py: int8_plan.
//
// Every launcher returns cudaGetLastError() as an int, so a refused launch
// reaches the caller.

#include "block_int8.cuh"

using block_int8::bf16;

extern "C" {

int ln_fc1_gelu_int8(const void* x, const void* ln_g, const void* ln_b, const void* w,
                     const void* colscale, const void* bias, void* out, int M, int C, int N,
                     float eps, int bn, int stages, int a_buffers, int resident, void* stream) {
  const block_int8::LnParams p{x, (const float*)ln_g, (const float*)ln_b, (const float*)colscale,
                               (const float*)bias, {out, nullptr, nullptr}, M, C, N, eps, stages,
                               a_buffers, resident};
  return (int)block_int8::launch_ln<float, false>(p, w, bn, (cudaStream_t)stream);
}

int ln_qkv_int8(const void* x, const void* ln_g, const void* ln_b, const void* w,
                const void* colscale, const void* bias, void* q, void* k, void* v, int M, int C,
                int S, float eps, int bn, int stages, int a_buffers, int resident, void* stream) {
  const block_int8::LnParams p{x, (const float*)ln_g, (const float*)ln_b, (const float*)colscale,
                               (const float*)bias, {q, k, v}, M, C, S * C, eps, stages,
                               a_buffers, resident};
  return (int)block_int8::launch_ln<bf16, true>(p, w, bn, (cudaStream_t)stream);
}

// x f32 (x_f32 = 1) or bf16 rows (M, K) -> s8 codes (M, K) and f32 scales (M,)
int quantize_rows(const void* x, void* q, void* scale, int M, int K, int x_f32, void* stream) {
  return x_f32 ? (int)block_int8::launch_quantize_rows<float>(x, q, (float*)scale, M, K,
                                                              (cudaStream_t)stream)
               : (int)block_int8::launch_quantize_rows<bf16>(x, q, (float*)scale, M, K,
                                                             (cudaStream_t)stream);
}

// s8 a (M, K) with row scales @ s8 w (C, K)^T: (+ bias) * gamma + residual;
// res_f32 / out_f32 pick the residual's and the output's type (bf16 or f32):
// ConvNeXt's fc2 bf16 / bf16, GCViT's fc2 f32 / bf16, its proj bf16 / f32
int res_gemm_int8(const void* a, const void* row_scale, const void* w, const void* colscale,
                  const void* bias, const void* gamma, const void* res, void* out, int M, int K,
                  int C, int res_f32, int out_f32, int bn, int stages, int resident,
                  void* stream) {
  const block_int8::ResParams p{(const float*)row_scale, (const float*)colscale,
                                (const float*)bias, (const float*)gamma, res, out, M, K, C, stages,
                                resident};
  const cudaStream_t s = (cudaStream_t)stream;
  if (!res_f32 && !out_f32) return (int)block_int8::launch_res<bf16, bf16>(p, a, w, bn, s);
  if (res_f32 && !out_f32) return (int)block_int8::launch_res<float, bf16>(p, a, w, bn, s);
  if (!res_f32 && out_f32) return (int)block_int8::launch_res<bf16, float>(p, a, w, bn, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
