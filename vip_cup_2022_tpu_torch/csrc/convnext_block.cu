// ConvNeXt block kernels for Hopper (sm_90a), channels-last.
//
// One ConvNeXt block is  x + gamma * fc2(gelu(fc1(LN(dw7x7(x) + dw_bias))))
// and runs here as three launches:
//
//   dwconv7x7_nhwc      bf16 NHWC x, f32 (7,7,C) taps, f32 bias -> f32 (M, C)
//   ln_fc1_gelu         f32 (M, C) -> two-pass f32 LN -> bf16 tile in shared
//                       memory -> bf16 tensor-core GEMM against fc1 (N, C)
//                       -> +b1, exact GELU (erff) -> bf16 hidden (M, N)
//   fc2_scale_residual  bf16 hidden (M, N) @ fc2 (C, N)^T, f32 accumulation
//                       -> (+b2) * gamma + residual -> bf16 (M, C); the
//                       residual is bf16 (ConvNeXt) or f32 (the GCViT
//                       block's unrounded first residual)
//
// M = B*H*W rows; N = 4C for ConvNeXt, 3C for GCViT's MLP. The two GEMM
// kernels are instantiations of block_gemm.cuh's templates, which the GCViT
// block kernels (gcvit_block.cu) share.
//
// Every launcher has a plain C interface for ctypes and returns
// cudaGetLastError() as an int, so a refused launch reaches the caller.

#include "block_gemm.cuh"

using namespace block_gemm;

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
                const void* b1, void* hidden, int M, int C, int N, float eps,
                void* stream) {
  return (int)launch_ln_gemm<float, true>(
      (const float*)x, (const float*)ln_g, (const float*)ln_b, (const bf16*)w1,
      (const float*)b1, (bf16*)hidden, nullptr, nullptr, M, C, N, N, eps,
      (cudaStream_t)stream);
}

int fc2_scale_residual(const void* hidden, const void* w2, const void* b2,
                       const void* gamma, const void* res, void* out, int M, int K,
                       int C, void* stream) {
  return (int)launch_gemm_scale_residual<bf16, bf16>(
      (const bf16*)hidden, (const bf16*)w2, (const float*)b2, (const float*)gamma,
      (const bf16*)res, (bf16*)out, M, K, C, (cudaStream_t)stream);
}

int fc2_scale_residual_f32res(const void* hidden, const void* w2, const void* b2,
                              const void* gamma, const void* res, void* out, int M, int K,
                              int C, void* stream) {
  return (int)launch_gemm_scale_residual<float, bf16>(
      (const bf16*)hidden, (const bf16*)w2, (const float*)b2, (const float*)gamma,
      (const float*)res, (bf16*)out, M, K, C, (cudaStream_t)stream);
}

}  // extern "C"
