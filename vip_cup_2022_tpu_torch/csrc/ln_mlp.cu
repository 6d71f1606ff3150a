// LN -> MLP -> layer scale -> residual in one pass, for Hopper (sm_90a), in
// three layouts of x, residual and out (bf16 all three):
//
//   ln_mlp_rows        (M, C) row-major
//   ln_mlp_batchlane   (P = H*W, C, B), row r = p*B + b
//   ln_mlp_chanfirst   (C, N = H*W*B)
//
// Replaces three TPU kernels of one function, which differ only in the
// TPU's layout: `fused_ln_mlp_residual` (body `_lnmlp_kernel`) of
// vip_cup_2022_tpu/ops/pallas/convnext_block.py (rows), and the experiment
// tool's `lnmlp_batchlane` (`_lnmlp_bl_kernel`) and `lnmlp_chanfirst`
// (`_lnmlp_cf_kernel`) of tools/exp_convnext_s12.py. The kernel template,
// what bounds it and what its design does about it: ln_mlp.cuh.
//
// Every launcher has a plain C interface for ctypes and returns
// cudaGetLastError() (or cudaErrorInvalidValue for what the kernel does not
// take) as an int, so a refused launch reaches the caller.

#include "ln_mlp.cuh"

extern "C" {

// rows: x, res, out (M, C); the plan: column splits, W1 and W2 ring depths
int ln_mlp_rows(const void* x, const void* res, const void* ln_g, const void* ln_b,
                const void* w1, const void* b1, const void* w2, const void* b2,
                const void* gamma, void* out, long long M, int C, int hidden, float eps, int cs,
                int stages1, int stages2, void* stream) {
  return (int)ln_mlp::dispatch<ln_mlp::kRowsLayout>(
      ln_mlp::make_params(x, res, ln_g, ln_b, b1, b2, gamma, out, M, C, hidden, 1, eps, cs,
                          stages1, stages2),
      w1, w2, (cudaStream_t)stream);
}

// batch-lane: x, res, out (P, C, B), M = P * B
int ln_mlp_batchlane(const void* x, const void* res, const void* ln_g, const void* ln_b,
                     const void* w1, const void* b1, const void* w2, const void* b2,
                     const void* gamma, void* out, long long M, int C, int hidden, int B,
                     float eps, int cs, int stages1, int stages2, void* stream) {
  return (int)ln_mlp::dispatch<ln_mlp::kBatchLane>(
      ln_mlp::make_params(x, res, ln_g, ln_b, b1, b2, gamma, out, M, C, hidden, B, eps, cs,
                          stages1, stages2),
      w1, w2, (cudaStream_t)stream);
}

// channel-first: x, res, out (C, M)
int ln_mlp_chanfirst(const void* x, const void* res, const void* ln_g, const void* ln_b,
                     const void* w1, const void* b1, const void* w2, const void* b2,
                     const void* gamma, void* out, long long M, int C, int hidden, float eps,
                     int cs, int stages1, int stages2, void* stream) {
  return (int)ln_mlp::dispatch<ln_mlp::kChanFirst>(
      ln_mlp::make_params(x, res, ln_g, ln_b, b1, b2, gamma, out, M, C, hidden, 1, eps, cs,
                          stages1, stages2),
      w1, w2, (cudaStream_t)stream);
}

}  // extern "C"
