// The fused blocks' in-kernel int8 mode (VIPTPU_INT8_KERNELS=1) for Hopper
// (sm_90a): the kernels of block_int8.cuh behind a plain C interface for
// ctypes (ops/kernels/block_int8.py). One ConvNeXt block runs
//   dwconv7x7_nhwc -> ln_fc1_rowmax_int8 -> mlp_int8_scale_residual
// and one GCViT block at C >= VIPTPU_GCVIT_INT8_MIN_C
//   ln_qkv_int8 -> window_attention -> quantize_rows -> proj_scale_residual_int8
//   -> ln_fc1_rowmax_int8 -> mlp_int8_scale_residual
// In an f32 block (VIPTPU_DTYPE=float32) x, the residuals and the outputs
// are f32: ln_qkv_int8 reads f32 x and writes f32 q, k, v, the residual GEMM
// takes the f32 residual beside an f32 output, and mlp_int8_scale_residual
// writes f32 (the flags below pick the instantiation); quantize_rows and
// ln_fc1_rowmax_int8 take f32 already. Under VIPTPU_GCVIT_MM=f32 a bf16
// block's ln_qkv_int8 writes f32 q, k, v (bf16 x), as the monoblock keeps
// them.
// ln_fc1_gelu_int8 -> quantize_rows -> fc2_scale_residual_int8, the MLP
// chain the pair replaced, stays as its yardstick: nothing on the model path
// calls it.
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
  return (int)block_int8::launch_ln<float, block_int8::kHidden>(p, w, bn, (cudaStream_t)stream);
}

// x_f32 / out_f32: x's and the outputs' type (bf16 or f32); bf16 x with f32
// outputs is the bf16 block under VIPTPU_GCVIT_MM=f32, f32 x with bf16 ones
// is refused
int ln_qkv_int8(const void* x, const void* ln_g, const void* ln_b, const void* w,
                const void* colscale, const void* bias, void* q, void* k, void* v, int M, int C,
                int S, float eps, int x_f32, int out_f32, int bn, int stages, int a_buffers,
                int resident, void* stream) {
  const block_int8::LnParams p{x, (const float*)ln_g, (const float*)ln_b, (const float*)colscale,
                               (const float*)bias, {q, k, v}, M, C, S * C, eps, stages,
                               a_buffers, resident};
  const cudaStream_t s = (cudaStream_t)stream;
  if (!x_f32 && !out_f32) return (int)block_int8::launch_ln<bf16, block_int8::kQkv>(p, w, bn, s);
  if (!x_f32 && out_f32)
    return (int)block_int8::launch_ln<bf16, block_int8::kQkv, float>(p, w, bn, s);
  if (x_f32 && out_f32)
    return (int)block_int8::launch_ln<float, block_int8::kQkv, float>(p, w, bn, s);
  return (int)cudaErrorInvalidValue;
}

// pass 1 of the MLP pair: f32 x (M, C) -> LN -> x's codes (M, C) and row
// scales (M,) -> fc1 -> GELU -> the hidden's row scales (M,); no hidden
int ln_fc1_rowmax_int8(const void* x, const void* ln_g, const void* ln_b, const void* w,
                       const void* colscale, const void* bias, void* x_codes, void* x_scale,
                       void* h_scale, int M, int C, int N, float eps, int bn, int stages,
                       int a_buffers, int resident, void* stream) {
  const block_int8::LnParams p{x, (const float*)ln_g, (const float*)ln_b, (const float*)colscale,
                               (const float*)bias, {nullptr, nullptr, nullptr}, M, C, N, eps,
                               stages, a_buffers, resident, (int8_t*)x_codes, (float*)x_scale,
                               (float*)h_scale};
  return (int)block_int8::launch_ln<float, block_int8::kRowMax>(p, w, bn, (cudaStream_t)stream);
}

// pass 2: x's codes @ W1 (N, C)^T -> GELU -> codes with pass 1's scales @ W2
// (C, N)^T -> (+ b2) * gamma + residual -> bf16 (M, C); the residual bf16
// (ConvNeXt) or f32 (res_f32 = 1, GCViT's r1); out_f32 = 1: an f32 block's
// f32 output beside its f32 residual
int mlp_int8_scale_residual(const void* x_codes, const void* x_scale, const void* h_scale,
                            const void* w1, const void* colscale1, const void* b1, const void* w2,
                            const void* colscale2, const void* b2, const void* gamma,
                            const void* res, void* out, int M, int C, int N, int res_f32,
                            int out_f32, int col_tiles, int s1, int s2, int x_buffers,
                            int resident, void* stream) {
  const block_int8::MlpParams p{(const float*)x_scale, (const float*)h_scale,
                                (const float*)colscale1, (const float*)b1,
                                (const float*)colscale2, (const float*)b2, (const float*)gamma,
                                res, out, M, C, N, col_tiles, s1, s2, x_buffers, resident};
  const cudaStream_t s = (cudaStream_t)stream;
  if (out_f32)
    return res_f32 ? (int)block_int8::launch_mlp<float, float>(p, x_codes, w1, w2, s)
                   : (int)cudaErrorInvalidValue;
  return res_f32 ? (int)block_int8::launch_mlp<float, bf16>(p, x_codes, w1, w2, s)
                 : (int)block_int8::launch_mlp<bf16, bf16>(p, x_codes, w1, w2, s);
}

// counts (2 uint64, zeroed but for counts[1] = ~0): inputs where the pair's
// GELU and ln_fc1_gelu_int8's differ, and the smallest such input's bits
int gelu_bits_check(void* counts, void* stream) {
  return (int)block_int8::launch_gelu_bits((unsigned long long*)counts, (cudaStream_t)stream);
}

// counts (4 uint64, zeroed): the GELU facts pass 1 leans on, broken at how
// many f32 inputs (gelu_mono_kernel); counts[3]: inputs at the bound
int gelu_mono_check(void* counts, void* stream) {
  return (int)block_int8::launch_gelu_mono((unsigned long long*)counts, (cudaStream_t)stream);
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
// ConvNeXt's fc2 bf16 / bf16, GCViT's fc2 f32 / bf16, its proj bf16 / f32;
// f32 / f32 in an f32 block (GCViT's proj and both blocks' fc2)
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
  return (int)block_int8::launch_res<float, float>(p, a, w, bn, s);
}

}  // extern "C"
