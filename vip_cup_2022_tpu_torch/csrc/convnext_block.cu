// ConvNeXt block kernels for Hopper (sm_90a), channels-last.
//
// One ConvNeXt block is  x + gamma * fc2(gelu(fc1(LN(dw7x7(x) + dw_bias))))
// and runs here as three launches:
//
//   dwconv7x7_nhwc      bf16 NHWC x, f32 (7,7,C) taps, f32 bias -> f32 (M, C)
//   ln_fc1_gelu         f32 (M, C) -> two-pass f32 LN -> bf16 A tile in
//                       shared memory -> wgmma against fc1 (N, C) -> +b1,
//                       exact GELU (erff) -> bf16 hidden (M, N)
//   fc2_scale_residual  bf16 hidden (M, N) @ fc2 (C, N)^T by wgmma, f32
//                       accumulation -> (+b2) * gamma + residual -> bf16
//                       (M, C); the residual is bf16 (ConvNeXt) or f32 (the
//                       GCViT block's unrounded first residual)
//
// M = B*H*W rows; N = 4C for ConvNeXt, 3C for GCViT's MLP. The GEMM halves
// replace those of the TPU kernels fused_convnext_block and
// fused_ln_mlp_residual_batchlane (vip_cup_2022_tpu/ops/pallas/
// convnext_block.py) and of proj_res_ln_mlp / mono_window_transformer_block
// (ops/pallas/gcvit_block.py, whose MLP half GCViT's fused path runs here).
//
// What bounds them: the bytes of x, the hidden and the output at s1/s2 and
// GCViT L1-L3, the products at s3/s4. The two GEMM kernels are
// hopper_gemm.cuh's engine (wgmma fed by TMA through an mbarrier ring,
// persistent CTAs, two consumer warpgroups in ping-pong so that the erff
// GELU and the gamma-residual epilogues overlap the products, LN computed
// once per row from registers, W1 kept in shared memory where it fits); its
// note says how. The per-shape plan comes from the caller
// (ops/kernels/convnext_block.py: mlp_gemm_plan). The depthwise pass is
// depthwise.cuh's shared-memory-tiled template (bound by its bytes, with its
// 49 f32 FMAs an element close behind); its note says how.
//
// Every launcher has a plain C interface for ctypes and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a plan the kernels do not
// take) as an int, so a refused launch reaches the caller.

#include "depthwise.cuh"
#include "hopper_gemm.cuh"

using hopper_gemm::bf16;

extern "C" {

int dwconv7x7_nhwc(const void* x, const void* w, const void* bias, void* out,
                   int B, int H, int W, int C, void* stream) {
  return (int)depthwise::run<7, true, float, depthwise::kWhole>(x, w, bias, out, B, H, W, C, H, W,
                                                                3, 3, (cudaStream_t)stream);
}

int ln_fc1_gelu(const void* x, const void* ln_g, const void* ln_b, const void* w1,
                const void* b1, void* hidden, int M, int C, int N, float eps, int bn, int stages,
                int a_buffers, int resident, int split_n, void* stream) {
  const hopper_gemm::LnParams p{x, (const float*)ln_g, (const float*)ln_b, (const float*)b1,
                                {(bf16*)hidden, nullptr, nullptr}, M, C, N, eps, stages,
                                a_buffers, resident};
  return (int)hopper_gemm::launch_ln<hopper_gemm::kWhole, true>(p, w1, bn, split_n,
                                                                 (cudaStream_t)stream);
}

int fc2_scale_residual(const void* hidden, const void* w2, const void* b2, const void* gamma,
                       const void* res, void* out, int M, int K, int C, int bn, int stages,
                       void* stream) {
  const hopper_gemm::ResParams p{(const float*)b2, (const float*)gamma, res, (bf16*)out,
                                 M, K, C, stages};
  return (int)hopper_gemm::launch_res<bf16, hopper_gemm::kWhole, true>(p, hidden, w2, bn,
                                                                        (cudaStream_t)stream);
}

int fc2_scale_residual_f32res(const void* hidden, const void* w2, const void* b2,
                              const void* gamma, const void* res, void* out, int M, int K,
                              int C, int bn, int stages, void* stream) {
  const hopper_gemm::ResParams p{(const float*)b2, (const float*)gamma, res, (bf16*)out,
                                 M, K, C, stages};
  return (int)hopper_gemm::launch_res<float, hopper_gemm::kWhole, true>(p, hidden, w2, bn,
                                                                         (cudaStream_t)stream);
}

}  // extern "C"
