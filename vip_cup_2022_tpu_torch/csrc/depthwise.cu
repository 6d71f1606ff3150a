// Stride-1 k x k depthwise convolution in NHWC for Hopper (sm_90a).
//
//   depthwise_conv_nhwc   bf16 x (B, H, W, C), f32 taps (k, k, C), explicit
//                         zero padding ((top, bottom), (left, right)), no
//                         bias, f32 accumulation -> bf16 (B, Ho, Wo, C),
//                         k in {3, 5, 7}
//
// Replaces the TPU kernel `depthwise_conv_nhwc` (body `_dw_kernel`) of
// vip_cup_2022_tpu/ops/pallas/depthwise.py, a tap loop of f32 FMAs over
// whole (W, C) tiles of a padded image group in VMEM.
//
// What bounds it: a depthwise conv has no channel contraction, so it is
// CUDA-core work of 2 k^2 FLOPs per output element against 4 bytes moved
// (bf16 in and out): at k = 3 memory bandwidth bounds it, at k = 5 and 7 the
// f32 FMA rate comes close. Each thread owns two neighbouring channels
// (one 4-byte bf16x2 load, so a warp reads 128 contiguous bytes) and kTW
// neighbouring output columns: one loaded input row segment of kTW + k - 1
// pixels feeds kTW * k taps from registers. The halo is not materialised:
// taps that fall in the padding read zeros. The taps come through L1.
//
// The launcher has a plain C interface for ctypes and returns
// cudaGetLastError() as an int, so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kTW = 8;  // output columns per thread

template <int K>
__global__ void __launch_bounds__(kThreads)
depthwise_nhwc_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                      bf16* __restrict__ out, int B, int H, int W, int C, int Ho, int Wo,
                      int pad_top, int pad_left) {
  const int C2 = C / 2;
  const int WT = (Wo + kTW - 1) / kTW;
  const long long total = (long long)B * Ho * WT * C2;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int cp = (int)(idx % C2);
  long long t = idx / C2;
  const int wt = (int)(t % WT);
  t /= WT;
  const int ho = (int)(t % Ho);
  const int b = (int)(t / Ho);
  const int c = cp * 2;
  const int w0 = wt * kTW;

  float acc0[kTW], acc1[kTW];
#pragma unroll
  for (int i = 0; i < kTW; ++i) {
    acc0[i] = 0.f;
    acc1[i] = 0.f;
  }
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    const int hh = ho + dy - pad_top;
    if (hh < 0 || hh >= H) continue;
    const bf16* row = x + ((long long)b * H + hh) * W * C + c;
    float r0[kTW + K - 1], r1[kTW + K - 1];
#pragma unroll
    for (int j = 0; j < kTW + K - 1; ++j) {
      const int ww = w0 + j - pad_left;
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
    for (int dx = 0; dx < K; ++dx) {
      const float2 wv = *reinterpret_cast<const float2*>(w + (dy * K + dx) * C + c);
#pragma unroll
      for (int i = 0; i < kTW; ++i) {
        acc0[i] = fmaf(r0[i + dx], wv.x, acc0[i]);
        acc1[i] = fmaf(r1[i + dx], wv.y, acc1[i]);
      }
    }
  }
  bf16* o = out + (((long long)b * Ho + ho) * Wo + w0) * C + c;
#pragma unroll
  for (int i = 0; i < kTW; ++i) {
    if (w0 + i < Wo) {
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)i * C) =
          __floats2bfloat162_rn(acc0[i], acc1[i]);
    }
  }
}

}  // namespace

extern "C" {

int depthwise_conv_nhwc(const void* x, const void* w, void* out, int B, int H, int W, int C,
                        int k, int pad_top, int pad_bottom, int pad_left, int pad_right,
                        void* stream) {
  const int Ho = H + pad_top + pad_bottom - k + 1;
  const int Wo = W + pad_left + pad_right - k + 1;
  if (C % 2 || Ho < 0 || Wo < 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * Ho * ((Wo + kTW - 1) / kTW) * (C / 2);
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bf16* xb = (const bf16*)x;
  const float* wf = (const float*)w;
  bf16* ob = (bf16*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 3:
      depthwise_nhwc_kernel<3><<<(unsigned)blocks, kThreads, 0, s>>>(xb, wf, ob, B, H, W, C, Ho,
                                                                     Wo, pad_top, pad_left);
      break;
    case 5:
      depthwise_nhwc_kernel<5><<<(unsigned)blocks, kThreads, 0, s>>>(xb, wf, ob, B, H, W, C, Ho,
                                                                     Wo, pad_top, pad_left);
      break;
    case 7:
      depthwise_nhwc_kernel<7><<<(unsigned)blocks, kThreads, 0, s>>>(xb, wf, ob, B, H, W, C, Ho,
                                                                     Wo, pad_top, pad_left);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
