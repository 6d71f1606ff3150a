// Phase cuts of dwconv7x7_nhwc (depthwise.cuh's template at K = 7, bias, f32
// out, padding 3) for timing:
//
//   cut 0  loads: the halo copies into shared memory, nothing read back,
//          computed or written
//   cut 1  + the shared-memory reads and the FMAs, nothing stored
//   cut 2  + the stores: the kernel itself (convnext_block.cu)
//   cut 3  cut 1 with the halo values made in registers: the FMAs without
//          their shared-memory reads
//
// The cut kernels are other instantiations of the same template, under other
// mangled names, so they load beside convnext_block.cu's library.
// tools/exp_dwconv.py times them. The launcher returns cudaGetLastError() as
// an int.

#include "depthwise.cuh"

extern "C" {

int dwconv7x7_nhwc_cut(const void* x, const void* w, const void* bias, void* out, int B, int H,
                       int W, int C, int cut, void* stream) {
  switch (cut) {
    case depthwise::kLoads:
      return (int)depthwise::run<7, true, float, depthwise::kLoads>(
          x, w, bias, out, B, H, W, C, H, W, 3, 3, (cudaStream_t)stream);
    case depthwise::kFmas:
      return (int)depthwise::run<7, true, float, depthwise::kFmas>(
          x, w, bias, out, B, H, W, C, H, W, 3, 3, (cudaStream_t)stream);
    case depthwise::kRegs:
      return (int)depthwise::run<7, true, float, depthwise::kRegs>(
          x, w, bias, out, B, H, W, C, H, W, 3, 3, (cudaStream_t)stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
