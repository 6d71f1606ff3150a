// Phase cuts of the 3xTF32 f32 GEMMs (tf32_gemm.cuh's kCut), for timing off
// the model path (tools/exp_f32_mlp.py): cut 0 loads (the TMA ring and, for
// the LN kinds, the statistics' reads), cut 2 + the A fragments, the split
// and the wgmmas (with passes = 1: a_hi w_hi alone), cut 5 the kernel
// without its stores. The kernels themselves (cut 3) are convnext_block.cu's
// (ln_fc1_gelu_f32, fc2_scale_residual_f32 / _mmf32) and gcvit_block.cu's
// (ln_qkv_f32, proj_scale_residual_f32: kResidual with K = N = C).
//
// The launcher has a plain C interface for ctypes and returns
// cudaGetLastError() (or cudaErrorInvalidValue for what the kernels do not
// take) as an int.

#include "tf32_gemm.cuh"

using hopper_gemm::bf16;

namespace {

template <int kKind, int kCut, int kPasses>
int tf32_cut(const tf32_gemm::Params& p, const void* a, const void* w_hi, const void* w_lo,
             int bn, int promote, int out_bf16, cudaStream_t stream) {
  if constexpr (kKind == tf32_gemm::kResidual) {
    if (out_bf16)
      return (int)tf32_gemm::launch<kKind, kCut, bf16, kPasses>(p, a, w_hi, w_lo, bn, promote,
                                                                stream);
  } else if (out_bf16) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)tf32_gemm::launch<kKind, kCut, float, kPasses>(p, a, w_hi, w_lo, bn, promote,
                                                             stream);
}

template <int kKind>
int tf32_cut_of(int cut, int passes, const tf32_gemm::Params& p, const void* a,
                const void* w_hi, const void* w_lo, int bn, int promote, int out_bf16,
                cudaStream_t stream) {
  using namespace hopper_gemm;
  const auto args = [&](auto cut_fn) {
    return cut_fn(p, a, w_hi, w_lo, bn, promote, out_bf16, stream);
  };
  if (cut == kLoads && passes == 3) return args(tf32_cut<kKind, kLoads, 3>);
  if (cut == kProducts && passes == 3) return args(tf32_cut<kKind, kProducts, 3>);
  if (cut == kProducts && passes == 1) return args(tf32_cut<kKind, kProducts, 1>);
  if (cut == kNoStores && passes == 3) return args(tf32_cut<kKind, kNoStores, 3>);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// kind 0: ln_fc1_gelu_f32 (a = x, N the hidden width); 1: fc2_scale_residual_f32
// (a = the hidden, K its width, N = C; out_bf16 for the _mmf32 output) or
// proj_scale_residual_f32 (a = the attention output, K = N = C); 2: ln_qkv_f32
// (a = x, K = C, N = S C; the cuts write nothing, so every output is `out`)
int tf32_mlp_cut(int kind, int cut, int passes, const void* a, const void* ln_g, const void* ln_b,
                 const void* w_hi, const void* w_lo, const void* bias, const void* gamma,
                 const void* res, void* out, int M, int K, int N, float eps, int bn, int stages,
                 int promote, int out_bf16, void* stream) {
  tf32_gemm::Params p{kind != 1 ? a : nullptr, (const float*)ln_g, (const float*)ln_b,
                      (const float*)bias, (const float*)gamma, res, out, M, N, K, stages, eps};
  const cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    return tf32_cut_of<tf32_gemm::kGelu>(cut, passes, p, a, w_hi, w_lo, bn, promote, out_bf16,
                                         s);
  if (kind == 1)
    return tf32_cut_of<tf32_gemm::kResidual>(cut, passes, p, a, w_hi, w_lo, bn, promote,
                                             out_bf16, s);
  if (kind == 2) {
    p.out1 = p.out2 = out;
    p.split = K;
    return tf32_cut_of<tf32_gemm::kQkv>(cut, passes, p, a, w_hi, w_lo, bn, promote, out_bf16, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
