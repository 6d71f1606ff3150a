// Phase cuts of the kernels on hopper_gemm.cuh's engine for timing, at the
// widths of the main path's shapes (ConvNeXt s1-s4, GCViT L1-L4; for ln_qkv,
// proj_scale_residual and the f32 GEMMs of VIPTPU_GCVIT_MM=bf16 on f32
// activations, ln_qkv_mmbf16, fc2_scale_residual_mmbf16 and
// proj_scale_residual_mmbf16, GCViT's column tiles of 64 and 128):
//
//   cut 0  loads: the TMA loads of W (and of the hidden for fc2, of attn
//          for proj) and the reads of x, nothing computed or written
//   cut 1  + the LN and the A tile writes (ln_fc1_gelu and ln_qkv; for
//          fc2_scale_residual the same as cut 0)
//   cut 2  + the wgmma products
//   cut 3  + the epilogue: the kernel itself (convnext_block.cu,
//          gcvit_block.cu)
//   cut 4  cut 2 + the accumulators stored as bf16 (the MLP GEMMs)
//   cut 5  cut 3 without its stores
//
// ln_qkv_mmbf16 (f32 x -> LN -> bf16 A, f32 q, k, v) has cuts 0, 1, 2 and 5
// of the kernel its plan takes (ln_qkv_tma_kernel at C = 64, the LN kernel
// with f32 outputs at C = 128 ... 512); the kernel itself (cut 3) is
// gcvit_block.cu's.
//
// The cut kernels are other instantiations of the same templates, under
// other mangled names, so they load beside convnext_block.cu's library.
// tools/exp_mlp_gemm.py times them. Each launcher returns
// cudaGetLastError() as an int.

#include "hopper_gemm.cuh"

using hopper_gemm::bf16;

namespace {

template <int kCut>
int ln_cut(const void* x, const void* ln_g, const void* ln_b, const void* w1, const void* b1,
           void* hidden, int M, int C, int N, float eps, int bn, int stages, int a_buffers,
           int resident, int split_n, void* stream) {
  const hopper_gemm::LnParams p{x, (const float*)ln_g, (const float*)ln_b, (const float*)b1,
                                {(bf16*)hidden, nullptr, nullptr}, M, C, N, eps, stages,
                                a_buffers, resident};
  return (int)hopper_gemm::launch_ln<kCut, false>(p, w1, bn, split_n, (cudaStream_t)stream);
}

template <typename ResT, int kCut>
int res_cut(const void* hidden, const void* w2, const void* b2, const void* gamma,
            const void* res, void* out, int M, int K, int C, int bn, int stages,
            void* stream) {
  const hopper_gemm::ResParams p{(const float*)b2, (const float*)gamma, res, (bf16*)out,
                                 M, K, C, stages};
  return (int)hopper_gemm::launch_res<ResT, kCut, false>(p, hidden, w2, bn,
                                                          (cudaStream_t)stream);
}

// the f32 residual GEMMs of VIPTPU_GCVIT_MM=bf16 (tma_res_kernel), A of type TA
template <typename TA>
int tma_res_cut(const void* a, const void* w, const void* bias, const void* gamma,
                const void* res, void* out, int M, int K, int C, int bn, int stages, int resident,
                int cut, void* stream) {
  const hopper_gemm::TmaResParams p{(const float*)bias, (const float*)gamma, M, K, C, stages,
                                    resident};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (cut) {
    case 0: return (int)hopper_gemm::launch_tma_res<TA, 0, false>(p, a, w, res, out, bn, st);
    case 2: return (int)hopper_gemm::launch_tma_res<TA, 2, false>(p, a, w, res, out, bn, st);
    case 3: return (int)hopper_gemm::launch_tma_res<TA, 3, false>(p, a, w, res, out, bn, st);
    case 5: return (int)hopper_gemm::launch_tma_res<TA, 5, false>(p, a, w, res, out, bn, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ln_qkv (XT = OutT = bf16) and ln_qkv_mmbf16's LN-kernel path (XT = OutT = f32)
template <int kCut, typename XT, typename OutT>
int qkv_cut(const hopper_gemm::LnParams& p, const void* w, int bn, int split_n,
            cudaStream_t stream) {
  if (p.M == 0) return 0;
  if (split_n) return (int)cudaErrorInvalidValue;
  switch (bn) {  // GCViTTiny's levels: C = 64 -> 64, C = 128 ... 512 -> 128
    case 64:
      return (int)hopper_gemm::launch_ln_bn<64, kCut, false, XT, hopper_gemm::kEpiQkv, OutT>(
          p, w, stream);
    case 128:
      return (int)hopper_gemm::launch_ln_bn<128, kCut, false, XT, hopper_gemm::kEpiQkv, OutT>(
          p, w, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename XT, typename OutT>
int qkv_cuts(const hopper_gemm::LnParams& p, const void* w, int bn, int split_n, int cut,
             cudaStream_t st) {
  switch (cut) {
    case 0: return qkv_cut<0, XT, OutT>(p, w, bn, split_n, st);
    case 1: return qkv_cut<1, XT, OutT>(p, w, bn, split_n, st);
    case 2: return qkv_cut<2, XT, OutT>(p, w, bn, split_n, st);
    case 5: return qkv_cut<5, XT, OutT>(p, w, bn, split_n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int kCut>
int proj_cut(const hopper_gemm::ResParams& p, const void* a, const void* w, int bn,
             cudaStream_t stream) {
  if (p.M == 0) return 0;
  switch (bn) {  // GCViTTiny's levels: C = 64 -> 64, C = 128 ... 512 -> 128
    case 64:
      return (int)hopper_gemm::launch_res_bn<64, bf16, kCut, float>(p, a, w, stream);
    case 128:
      return (int)hopper_gemm::launch_res_bn<128, bf16, kCut, float>(p, a, w, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int fc2_scale_residual_mmbf16_cut(const void* hidden, const void* w2, const void* b2,
                                  const void* gamma, const void* res, void* out, int M, int K,
                                  int C, int bn, int stages, int resident, int cut,
                                  void* stream) {
  return tma_res_cut<bf16>(hidden, w2, b2, gamma, res, out, M, K, C, bn, stages, resident, cut,
                           stream);
}

int proj_scale_residual_mmbf16_cut(const void* a, const void* wp, const void* bp,
                                   const void* gamma, const void* x, void* out, int M, int C,
                                   int bn, int stages, int resident, int cut, void* stream) {
  return tma_res_cut<float>(a, wp, bp, gamma, x, out, M, C, C, bn, stages, resident, cut,
                            stream);
}

int proj_scale_residual_cut(const void* a, const void* wp, const void* bp, const void* gamma,
                            const void* x, void* out, int M, int C, int bn, int stages,
                            int resident, int cut, void* stream) {
  const hopper_gemm::ResParams p{(const float*)bp, (const float*)gamma, x, out, M, C, C, stages,
                                 resident};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (cut) {
    case 0: return proj_cut<0>(p, a, wp, bn, st);
    case 2: return proj_cut<2>(p, a, wp, bn, st);
    case 5: return proj_cut<5>(p, a, wp, bn, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ln_qkv_cut(const void* x, const void* ln_g, const void* ln_b, const void* w,
               const void* bias, void* q, void* k, void* v, int M, int C, int S, float eps,
               int bn, int stages, int a_buffers, int resident, int split_n, int cut,
               void* stream) {
  const hopper_gemm::LnParams p{x, (const float*)ln_g, (const float*)ln_b, (const float*)bias,
                                {q, k, v}, M, C, S * C, eps, stages, a_buffers, resident};
  return qkv_cuts<bf16, bf16>(p, w, bn, split_n, cut, (cudaStream_t)stream);
}

// ln_qkv_mmbf16's kernel by its plan (gcvit_block.cu's ln_qkv_mmbf16)
int ln_qkv_mmbf16_cut(const void* x, const void* ln_g, const void* ln_b, const void* w,
                      const void* bias, void* q, void* k, void* v, int M, int C, int S,
                      float eps, int tma, int bn, int stages, int a_buffers, int resident,
                      int flag, int cut, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (!tma) {
    const hopper_gemm::LnParams p{x, (const float*)ln_g, (const float*)ln_b, (const float*)bias,
                                  {q, k, v}, M, C, S * C, eps, stages, a_buffers, resident};
    return qkv_cuts<float, float>(p, w, bn, flag, cut, st);
  }
  const hopper_gemm::QkvTmaParams p{(const float*)x, (const float*)ln_g, (const float*)ln_b,
                                    (const float*)bias, M, C, S * C, eps, stages, a_buffers,
                                    resident};
  void* const out[3] = {q, k, v};
  switch (cut) {
    case 0: return (int)hopper_gemm::launch_qkv_tma<0, false>(p, w, out, bn, st);
    case 1: return (int)hopper_gemm::launch_qkv_tma<1, false>(p, w, out, bn, st);
    case 2: return (int)hopper_gemm::launch_qkv_tma<2, false>(p, w, out, bn, st);
    case 5: return (int)hopper_gemm::launch_qkv_tma<5, false>(p, w, out, bn, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ln_fc1_gelu_cut(const void* x, const void* ln_g, const void* ln_b, const void* w1,
                    const void* b1, void* hidden, int M, int C, int N, float eps, int bn,
                    int stages, int a_buffers, int resident, int split_n, int cut,
                    void* stream) {
  switch (cut) {
    case 0: return ln_cut<0>(x, ln_g, ln_b, w1, b1, hidden, M, C, N, eps, bn, stages, a_buffers,
                             resident, split_n, stream);
    case 1: return ln_cut<1>(x, ln_g, ln_b, w1, b1, hidden, M, C, N, eps, bn, stages, a_buffers,
                             resident, split_n, stream);
    case 2: return ln_cut<2>(x, ln_g, ln_b, w1, b1, hidden, M, C, N, eps, bn, stages, a_buffers,
                             resident, split_n, stream);
    case 4: return ln_cut<4>(x, ln_g, ln_b, w1, b1, hidden, M, C, N, eps, bn, stages, a_buffers,
                             resident, split_n, stream);
    case 5: return ln_cut<5>(x, ln_g, ln_b, w1, b1, hidden, M, C, N, eps, bn, stages, a_buffers,
                             resident, split_n, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int fc2_scale_residual_cut(const void* hidden, const void* w2, const void* b2, const void* gamma,
                           const void* res, void* out, int M, int K, int C, int bn,
                           int stages, int f32_residual, int cut, void* stream) {
  if (cut == 0 || cut == 1) {
    return f32_residual ? res_cut<float, 0>(hidden, w2, b2, gamma, res, out, M, K, C, bn,
                                            stages, stream)
                        : res_cut<bf16, 0>(hidden, w2, b2, gamma, res, out, M, K, C, bn,
                                           stages, stream);
  }
  if (cut == 2) {
    return f32_residual ? res_cut<float, 2>(hidden, w2, b2, gamma, res, out, M, K, C, bn,
                                            stages, stream)
                        : res_cut<bf16, 2>(hidden, w2, b2, gamma, res, out, M, K, C, bn,
                                           stages, stream);
  }
  if (cut == 4) {
    return f32_residual ? res_cut<float, 4>(hidden, w2, b2, gamma, res, out, M, K, C, bn,
                                            stages, stream)
                        : res_cut<bf16, 4>(hidden, w2, b2, gamma, res, out, M, K, C, bn,
                                           stages, stream);
  }
  if (cut == 5) {
    return f32_residual ? res_cut<float, 5>(hidden, w2, b2, gamma, res, out, M, K, C, bn,
                                            stages, stream)
                        : res_cut<bf16, 5>(hidden, w2, b2, gamma, res, out, M, K, C, bn,
                                           stages, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
