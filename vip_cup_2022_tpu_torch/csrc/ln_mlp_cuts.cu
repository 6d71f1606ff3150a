// Phase cuts of the LN-MLP kernel (ln_mlp.cuh) in the rows layout, for
// timing:
//
//   cut 0  loads: the weights' stream (TMA, the consumers waiting for and
//          releasing every stage) and the x tile's copy into shared memory
//   cut 1  + the LN in place
//   cut 2  + fc1 and fc2 by wgmma, the hidden stored as fc1's raw sums,
//          nothing stored to device memory
//   cut 3  + b1 and the GELU
//   cut 4  + the residual epilogue: the kernel itself (ln_mlp.cu)
//
// The cut kernels are other instantiations of the same template, under other
// mangled names, so they load beside ln_mlp.cu's library.
// tools/exp_lnmlp_dw.py times them. The launcher takes ln_mlp_rows's
// arguments and the cut, and returns cudaGetLastError() as an int.

#include "ln_mlp.cuh"

extern "C" {

int ln_mlp_rows_cut(const void* x, const void* res, const void* ln_g, const void* ln_b,
                    const void* w1, const void* b1, const void* w2, const void* b2,
                    const void* gamma, void* out, long long M, int C, int hidden, float eps,
                    int cs, int stages1, int stages2, int cut, void* stream) {
  const ln_mlp::Params p = ln_mlp::make_params(x, res, ln_g, ln_b, b1, b2, gamma, out, M, C, hidden,
                                               1, eps, cs, stages1, stages2);
  const cudaStream_t s = (cudaStream_t)stream;
  using ln_mlp::kRowsLayout;
  switch (cut) {
    case ln_mlp::kLoads: return (int)ln_mlp::dispatch<kRowsLayout, ln_mlp::kLoads>(p, w1, w2, s);
    case ln_mlp::kLn: return (int)ln_mlp::dispatch<kRowsLayout, ln_mlp::kLn>(p, w1, w2, s);
    case ln_mlp::kProducts:
      return (int)ln_mlp::dispatch<kRowsLayout, ln_mlp::kProducts>(p, w1, w2, s);
    case ln_mlp::kGelu: return (int)ln_mlp::dispatch<kRowsLayout, ln_mlp::kGelu>(p, w1, w2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
