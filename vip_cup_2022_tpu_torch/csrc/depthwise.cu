// Stride-1 k x k depthwise convolution in NHWC for Hopper (sm_90a).
//
//   depthwise_conv_nhwc       bf16 x (B, H, W, C), f32 taps (k, k, C),
//                             explicit zero padding ((top, bottom), (left,
//                             right)), no bias, f32 accumulation -> bf16
//                             (B, Ho, Wo, C), k in {3, 5, 7}, C even
//   depthwise_conv_nhwc_f32   the same on f32 x -> f32 (B, Ho, Wo, C), any C
//
// Replaces the TPU kernel `depthwise_conv_nhwc` (body `_dw_kernel`) of
// vip_cup_2022_tpu/ops/pallas/depthwise.py, a tap loop of f32 FMAs over
// whole (W, C) tiles of a padded image group in VMEM, whose output takes
// x's dtype: bf16 when the models compute in bf16, f32 under
// VIPTPU_DTYPE=float32. Both sum the taps in (dy, dx) order, as the TPU
// kernel does (here by FMA: the product is not rounded apart).
//
// What bounds it: a depthwise conv has no channel contraction, so it is
// CUDA-core work of 2 k^2 FLOPs per output element against 4 bytes moved
// (bf16 in and out; 8 in f32): at k = 3 and 5 the bytes bound it, at k = 7
// the f32 FMAs (in f32 the bytes as well). It runs depthwise.cuh's
// shared-memory-tiled template (the one dwconv7x7_nhwc runs for ConvNeXt),
// which copies each output tile's halo into shared memory once by cp.async
// (the padding zero-filled), the next tile's copy overlapping this one's
// FMAs, with a thread's K x K taps in registers; at C not a multiple of 32
// its last channel slice is a tail. The f32 mode takes the same tiles with
// 128-byte halo pixels (depthwise.cuh's note).
//
// The launchers have a plain C interface for ctypes and return
// cudaGetLastError() (or cudaErrorInvalidValue for what the kernel does not
// take) as an int, so a refused launch reaches the caller.

#include "depthwise.cuh"

namespace {

template <typename T>
int run_k(const void* x, const void* w, void* out, int B, int H, int W, int C, int k,
          int pad_top, int pad_bottom, int pad_left, int pad_right, void* stream) {
  const int Ho = H + pad_top + pad_bottom - k + 1;
  const int Wo = W + pad_left + pad_right - k + 1;
  if (C * (int)sizeof(T) % 4 || Ho < 0 || Wo < 0 || pad_top < 0 || pad_left < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  using depthwise::kWhole;
  switch (k) {
    case 3:
      return (int)depthwise::run<3, false, T, kWhole, true, T>(x, w, nullptr, out, B, H, W, C, Ho,
                                                                Wo, pad_top, pad_left, s);
    case 5:
      return (int)depthwise::run<5, false, T, kWhole, true, T>(x, w, nullptr, out, B, H, W, C, Ho,
                                                                Wo, pad_top, pad_left, s);
    case 7:
      return (int)depthwise::run<7, false, T, kWhole, true, T>(x, w, nullptr, out, B, H, W, C, Ho,
                                                                Wo, pad_top, pad_left, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int depthwise_conv_nhwc(const void* x, const void* w, void* out, int B, int H, int W, int C,
                        int k, int pad_top, int pad_bottom, int pad_left, int pad_right,
                        void* stream) {
  return run_k<depthwise::bf16>(x, w, out, B, H, W, C, k, pad_top, pad_bottom, pad_left,
                                pad_right, stream);
}

int depthwise_conv_nhwc_f32(const void* x, const void* w, void* out, int B, int H, int W, int C,
                            int k, int pad_top, int pad_bottom, int pad_left, int pad_right,
                            void* stream) {
  return run_k<float>(x, w, out, B, H, W, C, k, pad_top, pad_bottom, pad_left, pad_right, stream);
}

// the tile plan a launch at this output size takes for an input of `elem`
// bytes an element (2 bf16, 4 f32): plan[0..6] = column strips and row
// blocks of a tile (8 columns and 4 rows each), tiles across and down an
// image, channel slices, bytes a halo copy moves, shared memory bytes of the
// two halo buffers at kernel size k
int depthwise_conv_nhwc_plan(int Ho, int Wo, int C, int elem, int k, int* plan) {
  if (Ho <= 0 || Wo <= 0 || C <= 0 || (elem != 2 && elem != 4) || C * elem % 4 || k <= 0)
    return (int)cudaErrorInvalidValue;
  depthwise::Params p{};
  p.Ho = Ho;
  p.Wo = Wo;
  p.C = C;
  depthwise::plan(p, elem);
  const int v[7] = {p.strips, p.blocks, p.tiles_w, p.tiles_h, p.slices, p.vec,
                    depthwise::smem_bytes(p.strips, p.blocks, k, depthwise::kCB * elem)};
  for (int i = 0; i < 7; ++i) plan[i] = v[i];
  return 0;
}

}  // extern "C"
