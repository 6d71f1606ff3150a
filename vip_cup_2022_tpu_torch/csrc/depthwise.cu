// Stride-1 k x k depthwise convolution in NHWC for Hopper (sm_90a).
//
//   depthwise_conv_nhwc   bf16 x (B, H, W, C), f32 taps (k, k, C), explicit
//                         zero padding ((top, bottom), (left, right)), no
//                         bias, f32 accumulation -> bf16 (B, Ho, Wo, C),
//                         k in {3, 5, 7}, C even
//
// Replaces the TPU kernel `depthwise_conv_nhwc` (body `_dw_kernel`) of
// vip_cup_2022_tpu/ops/pallas/depthwise.py, a tap loop of f32 FMAs over
// whole (W, C) tiles of a padded image group in VMEM.
//
// What bounds it: a depthwise conv has no channel contraction, so it is
// CUDA-core work of 2 k^2 FLOPs per output element against 4 bytes moved
// (bf16 in and out): at k = 3 and 5 the bytes bound it, at k = 7 the f32
// FMAs. It runs depthwise.cuh's shared-memory-tiled template (the one
// dwconv7x7_nhwc runs for ConvNeXt), which copies each output tile's halo
// into shared memory once by cp.async (the padding zero-filled), the next
// tile's copy overlapping this one's FMAs, with a thread's K x K taps in
// registers; at C not a multiple of 32 its last channel slice is a tail.
//
// The launchers have a plain C interface for ctypes and return
// cudaGetLastError() (or cudaErrorInvalidValue for what the kernel does not
// take) as an int, so a refused launch reaches the caller.

#include "depthwise.cuh"

extern "C" {

int depthwise_conv_nhwc(const void* x, const void* w, void* out, int B, int H, int W, int C,
                        int k, int pad_top, int pad_bottom, int pad_left, int pad_right,
                        void* stream) {
  const int Ho = H + pad_top + pad_bottom - k + 1;
  const int Wo = W + pad_left + pad_right - k + 1;
  if (C % 2 || Ho < 0 || Wo < 0 || pad_top < 0 || pad_left < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  using depthwise::bf16;
  using depthwise::kWhole;
  switch (k) {
    case 3:
      return (int)depthwise::run<3, false, bf16, kWhole, true>(x, w, nullptr, out, B, H, W, C, Ho,
                                                               Wo, pad_top, pad_left, s);
    case 5:
      return (int)depthwise::run<5, false, bf16, kWhole, true>(x, w, nullptr, out, B, H, W, C, Ho,
                                                               Wo, pad_top, pad_left, s);
    case 7:
      return (int)depthwise::run<7, false, bf16, kWhole, true>(x, w, nullptr, out, B, H, W, C, Ho,
                                                               Wo, pad_top, pad_left, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the tile plan a launch at this output size takes: plan[0..5] = column
// strips and row blocks of a tile (8 columns and 4 rows each), tiles across
// and down an image, channel slices, bytes a halo copy moves
int depthwise_conv_nhwc_plan(int Ho, int Wo, int C, int* plan) {
  if (Ho <= 0 || Wo <= 0 || C <= 0 || C % 2) return (int)cudaErrorInvalidValue;
  depthwise::Params p{};
  p.Ho = Ho;
  p.Wo = Wo;
  p.C = C;
  depthwise::plan(p);
  const int v[6] = {p.strips, p.blocks, p.tiles_w, p.tiles_h, p.slices, p.vec};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
  return 0;
}

}  // extern "C"
