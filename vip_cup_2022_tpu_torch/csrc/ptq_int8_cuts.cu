// Phase cuts of ptq_int8_conv's GEMM (ptq_int8.cuh) for timing, at the
// main path's types (bf16 output) and column tiles (64, 128), rows and
// gathered:
//
//   cut 0  loads: the TMA loads of W and the TMA loads (rows) or cp.async
//          gather (conv) of A, nothing computed or written
//   cut 2  + the wgmma products (and, for a site quantized in the GEMM,
//          the consumers' quantizing)
//   cut 3  + the epilogue: the kernel itself (int8_gemm.cu)
//   cut 5  cut 3 without its stores
//
// The cut kernels are other instantiations of the same template, under
// other mangled names, so they load beside int8_gemm.cu's library.
// tools/exp_ptq_int8.py times them beside the quantize pass. The launcher
// returns cudaGetLastError() as an int.

#include "ptq_int8.cuh"

extern "C" {

// the arguments of int8_gemm.cu's ptq_int8_conv with a bf16 output, + the cut
int ptq_int8_conv_cut(const void* a, const void* w, int ldw, const float* colscale,
                      const float* bias, void* out, int M, int K, int N, int src, float inv_s,
                      int H, int W, int C, int KW, int stride, int pad, int Ho, int Wo, int bn,
                      int stages, int resident, int tall, int cut, void* stream) {
  const ptq_int8::Params p{(const int8_t*)a, inv_s, colscale, bias, out, M, K, N, ldw, H, W,
                           C, KW, stride, pad, Ho, Wo, stages, resident};
  const cudaStream_t st = (cudaStream_t)stream;
  const bool t = tall != 0;
  switch (cut) {
    case 0: return (int)ptq_int8::launch_gemm<ptq_int8::bf16, 0>(p, w, src, bn, t, st);
    case 2: return (int)ptq_int8::launch_gemm<ptq_int8::bf16, 2>(p, w, src, bn, t, st);
    case 5: return (int)ptq_int8::launch_gemm<ptq_int8::bf16, 5>(p, w, src, bn, t, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
