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
// memory-bound (a 7x7 tap window per output) and reads its halo through L1.
//
// Every launcher has a plain C interface for ctypes and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a plan the kernels do not
// take) as an int, so a refused launch reaches the caller.

#include "hopper_gemm.cuh"

using hopper_gemm::bf16;

namespace {

constexpr int kDwThreads = 256;

// ---------------------------------------------------------------------------
// depthwise 7x7, stride 1, zero padding 3, + bias. Each thread owns two
// neighbouring channels and kTW neighbouring output columns, so one loaded
// input row segment of kTW+6 pixels feeds kTW*7 taps.
// ---------------------------------------------------------------------------
constexpr int kTW = 8;

__global__ void __launch_bounds__(kDwThreads)
dwconv7x7_nhwc_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int B, int H, int W, int C) {
  const int C2 = C / 2;
  const int WT = (W + kTW - 1) / kTW;
  const long long total = (long long)B * H * WT * C2;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int cp = (int)(idx % C2);
  long long t = idx / C2;
  const int wt = (int)(t % WT);
  t /= WT;
  const int h = (int)(t % H);
  const int b = (int)(t / H);
  const int c = cp * 2;
  const int w0 = wt * kTW;

  float acc0[kTW], acc1[kTW];
#pragma unroll
  for (int i = 0; i < kTW; ++i) {
    acc0[i] = 0.f;
    acc1[i] = 0.f;
  }
  for (int dy = 0; dy < 7; ++dy) {
    const int hh = h + dy - 3;
    if (hh < 0 || hh >= H) continue;
    const bf16* row = x + ((long long)b * H + hh) * W * C + c;
    float r0[kTW + 6], r1[kTW + 6];
#pragma unroll
    for (int j = 0; j < kTW + 6; ++j) {
      const int ww = w0 + j - 3;
      if (ww >= 0 && ww < W) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(row + (long long)ww * C));
        r0[j] = f.x;
        r1[j] = f.y;
      } else {
        r0[j] = 0.f;
        r1[j] = 0.f;
      }
    }
#pragma unroll
    for (int dx = 0; dx < 7; ++dx) {
      const float2 wv = *reinterpret_cast<const float2*>(w + (dy * 7 + dx) * C + c);
#pragma unroll
      for (int i = 0; i < kTW; ++i) {
        acc0[i] = fmaf(r0[i + dx], wv.x, acc0[i]);
        acc1[i] = fmaf(r1[i + dx], wv.y, acc1[i]);
      }
    }
  }
  const float b0 = bias[c], b1 = bias[c + 1];
  float* o = out + (((long long)b * H + h) * W + w0) * C + c;
#pragma unroll
  for (int i = 0; i < kTW; ++i) {
    if (w0 + i < W) {
      *reinterpret_cast<float2*>(o + (long long)i * C) =
          make_float2(acc0[i] + b0, acc1[i] + b1);
    }
  }
}

}  // namespace

extern "C" {

int dwconv7x7_nhwc(const void* x, const void* w, const void* bias, void* out,
                   int B, int H, int W, int C, void* stream) {
  const long long total = (long long)B * H * ((W + kTW - 1) / kTW) * (C / 2);
  if (total == 0) return 0;
  const long long blocks = (total + kDwThreads - 1) / kDwThreads;
  dwconv7x7_nhwc_kernel<<<(unsigned)blocks, kDwThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)w, (const float*)bias, (float*)out, B, H, W, C);
  return (int)cudaGetLastError();
}

int ln_fc1_gelu(const void* x, const void* ln_g, const void* ln_b, const void* w1,
                const void* b1, void* hidden, int M, int C, int N, float eps, int bn, int stages,
                int a_buffers, int resident, int split_n, void* stream) {
  const hopper_gemm::LnParams p{(const float*)x, (const float*)ln_g, (const float*)ln_b,
                                (const float*)b1, (bf16*)hidden, M, C, N, eps, stages,
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
