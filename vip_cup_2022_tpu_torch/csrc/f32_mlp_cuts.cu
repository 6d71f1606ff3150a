// The f32 MLP GEMMs for timing, off the model path (tools/exp_f32_mlp.py):
//
// - the FFMA kernels that tf32_gemm.cuh's 3xTF32 kernels replaced on the
//   model path (f32_gemm.cuh: kGelu, the f32-product kResidual with an f32
//   or a bf16 output), the before of a same-call comparison;
// - phase cuts of the 3xTF32 kernels (tf32_gemm.cuh's kCut): cut 0 loads
//   (the TMA ring and, for the LN kind, the statistics' reads), cut 2 + the
//   A fragments, the split and the wgmmas (with passes = 1: a_hi w_hi
//   alone), cut 5 the kernel without its stores. The kernel itself (cut 3)
//   is convnext_block.cu's.
//
// Each launcher has a plain C interface for ctypes and returns
// cudaGetLastError() (or cudaErrorInvalidValue for what the kernels do not
// take) as an int.

#include "f32_gemm.cuh"
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

int ffma_ln_fc1_gelu(const void* x, const void* ln_g, const void* ln_b, const void* w1,
                     const void* b1, void* hidden, int M, int C, int N, float eps, void* stream) {
  f32_gemm::Params p{};
  p.a = x;
  p.w = (const float*)w1;
  p.bias = (const float*)b1;
  p.ln_g = (const float*)ln_g;
  p.ln_b = (const float*)ln_b;
  p.out[0] = hidden;
  p.M = M;
  p.N = N;
  p.K = C;
  p.eps = eps;
  return (int)f32_gemm::launch<f32_gemm::kGelu>(p, (cudaStream_t)stream);
}

int ffma_fc2_scale_residual(const void* hidden, const void* w2, const void* b2,
                            const void* gamma, const void* res, void* out, int M, int K, int C,
                            int out_bf16, void* stream) {
  f32_gemm::Params p{};
  p.a = hidden;
  p.w = (const float*)w2;
  p.bias = (const float*)b2;
  p.gamma = (const float*)gamma;
  p.res = res;
  p.out[0] = out;
  p.M = M;
  p.N = C;
  p.K = K;
  return out_bf16
             ? (int)f32_gemm::launch<f32_gemm::kResidual, float, float, bf16>(p, (cudaStream_t)stream)
             : (int)f32_gemm::launch<f32_gemm::kResidual>(p, (cudaStream_t)stream);
}

// kind 0: ln_fc1_gelu_f32 (a = x, N the hidden width), 1: fc2_scale_residual_f32
// (a = the hidden, K its width, N = C; out_bf16 for the _mmf32 output)
int tf32_mlp_cut(int kind, int cut, int passes, const void* a, const void* ln_g, const void* ln_b,
                 const void* w_hi, const void* w_lo, const void* bias, const void* gamma,
                 const void* res, void* out, int M, int K, int N, float eps, int bn, int stages,
                 int promote, int out_bf16, void* stream) {
  const tf32_gemm::Params p{kind == 0 ? (const float*)a : nullptr, (const float*)ln_g,
                            (const float*)ln_b, (const float*)bias, (const float*)gamma,
                            (const float*)res, out, M, N, K, stages, eps};
  const cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    return tf32_cut_of<tf32_gemm::kGelu>(cut, passes, p, a, w_hi, w_lo, bn, promote, out_bf16,
                                         s);
  if (kind == 1)
    return tf32_cut_of<tf32_gemm::kResidual>(cut, passes, p, a, w_hi, w_lo, bn, promote,
                                             out_bf16, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
