// GCViT window-block kernels for Hopper (sm_90a), on window-ordered tokens.
//
// One GCViT block on (B, nWin*N, C) tokens is
//   r1  = x + gamma1 * proj(WindowAttention(LN1(x)))      kept in f32
//   out = r1 + gamma2 * fc2(gelu(fc1(LN2(r1))))           bf16
// and runs as five launches, three of them here:
//
//   ln_qkv               bf16 x (M, C) -> two-pass f32 LN -> bf16 tile in
//                        shared memory -> wgmma against W_qkv (S*C, C)
//                        + bias -> S separate bf16 (M, C) outputs: q, k, v
//                        (S = 3), or k, v (S = 2, global-query blocks);
//                        hopper_gemm.cuh's engine, its LN read of bf16 x
//                        and its bias-only epilogue (kQkv), whose column
//                        tiles divide C so that each lies in one output
//   window_attention     per (window, head): softmax(q k^T + rel-pos bias) v
//                        with hd = 32, q scaled in f32 and rounded to bf16,
//                        P normalised after P.V by the sum of its bf16
//                        values, one query per image with q_is_global;
//                        window_attention.cuh's template on token rows
//                        (Layout::kTokens): persistent CTAs with a two-stage
//                        cp.async ring of K and V, the scores, softmax and P
//                        in registers, the bias of the CTA's head in shared
//                        memory
//   proj_scale_residual  bf16 attn (M, C) @ W_p (C, C)^T + b_p, * gamma1
//                        + bf16 x -> f32 r1 (M, C); hopper_gemm.cuh's
//                        residual GEMM (res_gemm_kernel) with K = C and an
//                        f32 output: the epilogue computes (acc + b_p) *
//                        gamma1 in f32, then adds f32(x), and a lane stores
//                        8 consecutive f32 as two 16-byte stores; W_p stays
//                        in shared memory where it fits beside four A stages
//                        (L1-L3: 8, 32, 128 KB)
//
// then ln_fc1_gelu and fc2_scale_residual_f32res of convnext_block.cu on r1.
// All three GEMMs of the block and the MLP half run on hopper_gemm.cuh's
// wgmma + TMA engine; the plans come from ops/kernels/convnext_block.py:
// mlp_gemm_plan (kinds "qkv" and "proj").
//
// proj_scale_residual replaces the proj half of the TPU kernels
// proj_res_ln_mlp (body _tail_kernel) and mono_window_transformer_block.
// What bounds it: bytes (K = C gives 2 C products per 2 + 2 + 4 bytes of
// attn, x and r1 per element); its design reads each of them once in whole
// sectors, with the products of one pair of warpgroups overlapping the
// other pair's epilogue.
//
// `window_attention` replaces the TPU kernel `grouped_window_attention`
// (bodies `_attn_kernel`, `_attn_kernel_perwin`) of vip_cup_2022_tpu/ops/
// pallas/gcvit_block.py. What bounds it on this card: not the products
// (~10 GFLOP a batch-256 launch at hd = 32) but, at N = 49, the bytes of q,
// k, v and the output, and at N = 196 the on-chip path between the two
// products. The template keeps that path in registers, loads K and V once
// per (window, head) and reads the bias from shared memory; its note says
// how.
//
// The f32 mode (VIPTPU_DTYPE=float32: f32 activations and weights, as the
// TPU kernels take them when x is f32) is three more launchers:
//
//   ln_qkv_f32               f32 x, W_qkv as its 3xTF32 pair (W_hi, W_lo)
//                            -> S f32 (M, C) outputs (tf32_gemm.cuh, kQkv)
//   window_attention_f32     f32 q, k, v -> f32 (tf32_attention.cuh: both
//                            products as 3xTF32 mma.sync, P.V divided by the
//                            row sum after, as the TPU kernel's default "mxu"
//                            softmax does)
//   proj_scale_residual_f32  f32 attn, W_p's pair, f32 x -> f32 r1
//                            (tf32_gemm.cuh, kResidual with K = C)
//
// then ln_fc1_gelu_f32 and fc2_scale_residual_f32 of convnext_block.cu.
//
// The mixed modes of VIPTPU_GCVIT_MM (the TPU kernels' GEMM operands in the
// other dtype than the activations, which keep theirs) are six more:
//
//   VIPTPU_GCVIT_MM=f32 on bf16 activations (the 3xTF32 kernels on a bf16 A
//   tile, widened to f32 in registers; q, k, v kept f32 as the monoblock,
//   which the TPU takes at every GCViTTiny level, keeps them):
//   ln_qkv_mmf32               bf16 x, W_qkv's pair -> S f32 outputs (kQkv)
//   window_attention_mmf32     f32 q (or a bf16 global query), f32 k, v ->
//                              bf16 (tf32_attention.cuh)
//   proj_scale_residual_mmf32  bf16 attn and x, W_p's pair -> f32 r1
//                              (kResidual: a bf16 A is exact in TF32, so
//                              two passes a k8 step)
//   then ln_fc1_gelu_f32 and fc2_scale_residual_mmf32 (convnext_block.cu).
//
//   VIPTPU_GCVIT_MM=bf16 on f32 activations (the wgmma engine and the
//   window-attention template; every operand rounded to bf16 on chip):
//   ln_qkv_mmbf16              f32 x -> LN -> bf16 A -> W_qkv bf16 -> S f32
//                              outputs: at C = 32, 64 each warpgroup's f32
//                              tile out by TMA (the engine's
//                              ln_qkv_tma_kernel, plan kind "qkv_tma"), else
//                              the LN kernel's f32 outputs from the
//                              accumulators
//   window_attention_mmbf16    f32 q, k, v -> f32 (k, v and the scaled q
//                              rounded to bf16 on load)
//   proj_scale_residual_mmbf16 f32 attn by TMA into the ring, each lane's
//                              fragment rounded to bf16 in registers, @ W_p
//                              bf16 (wgmma with A from registers) -> (+ b_p)
//                              * gamma1 + f32 x -> f32 r1, x in and r1 out
//                              by TMA (the engine's tma_res_kernel)
//   then ln_fc1_gelu and fc2_scale_residual_mmbf16 (convnext_block.cu).
//
// Every launcher has a plain C interface for ctypes and returns
// cudaGetLastError() as an int, so a refused launch reaches the caller.

#include "hopper_gemm.cuh"
#include "tf32_attention.cuh"
#include "tf32_gemm.cuh"
#include "window_attention.cuh"

using hopper_gemm::bf16;

namespace {

// ln_qkv's 3xTF32 kernel on x of type TA (f32, or bf16 for ln_qkv_mmf32)
template <typename TA>
int ln_qkv_tf32(const void* x, const void* ln_g, const void* ln_b, const void* w_hi,
                const void* w_lo, const void* bias, void* q, void* k, void* v, int M, int C,
                int S, float eps, int bn, int stages, int promote, void* stream) {
  tf32_gemm::Params p{};
  p.x = x;
  p.ln_g = (const float*)ln_g;
  p.ln_b = (const float*)ln_b;
  p.bias = (const float*)bias;
  p.out = q;
  p.out1 = k;
  p.out2 = v;
  p.M = M;
  p.N = S * C;
  p.K = C;
  p.split = C;
  p.stages = stages;
  p.eps = eps;
  return (int)tf32_gemm::launch<tf32_gemm::kQkv, hopper_gemm::kWhole, float, 3, TA>(
      p, x, w_hi, w_lo, bn, promote, (cudaStream_t)stream);
}

// the f32-product attention's parameters: q of the launch's TQ, f32 k, v and bias
tf32_attn::Params tf32_params(const void* q, const void* k, const void* v, const void* bias,
                              void* out, int B, int nwin, int N, int C, int heads, float scale,
                              int q_is_global) {
  tf32_attn::Params p{};
  p.q = q;
  p.k = (const float*)k;
  p.v = (const float*)v;
  p.bias = (const float*)bias;
  p.out = out;
  p.items = (long long)B * nwin * heads;
  p.heads = heads;
  p.n = N;
  p.nwin = nwin;
  p.c = C;
  p.scale = scale;
  p.q_is_global = q_is_global;
  return p;
}

// proj_scale_residual's: attention output a and residual x of type T (f32, or
// bf16 for proj_scale_residual_mmf32), K = N = C, f32 r1
template <typename T>
int proj_tf32(const void* a, const void* w_hi, const void* w_lo, const void* bp,
              const void* gamma, const void* x, void* out, int M, int C, int bn, int stages,
              int promote, void* stream) {
  tf32_gemm::Params p{};
  p.bias = (const float*)bp;
  p.gamma = (const float*)gamma;
  p.res = x;
  p.out = out;
  p.M = M;
  p.N = C;
  p.K = C;
  p.stages = stages;
  return (int)tf32_gemm::launch<tf32_gemm::kResidual, hopper_gemm::kWhole, float, 3, T, T>(
      p, a, w_hi, w_lo, bn, promote, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

int ln_qkv(const void* x, const void* ln_g, const void* ln_b, const void* w, const void* bias,
           void* q, void* k, void* v, int M, int C, int S, float eps, int bn, int stages,
           int a_buffers, int resident, int split_n, void* stream) {
  const hopper_gemm::LnParams p{x, (const float*)ln_g, (const float*)ln_b, (const float*)bias,
                                {(bf16*)q, (bf16*)k, (bf16*)v}, M, C, S * C, eps, stages,
                                a_buffers, resident};
  return (int)hopper_gemm::launch_ln<hopper_gemm::kWhole, true, bf16, hopper_gemm::kEpiQkv>(
      p, w, bn, split_n, (cudaStream_t)stream);
}

int window_attention(const void* q, const void* k, const void* v, const void* bias, void* out,
                     int B, int nwin, int N, int C, int heads, float scale, int q_is_global,
                     void* stream) {
  const long long items = (long long)B * nwin * heads;
  if (items == 0) return 0;
  if (C != heads * window_attn::kHd || items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  window_attn::Params p{};
  p.q = (const bf16*)q;
  p.k = (const bf16*)k;
  p.v = (const bf16*)v;
  p.bias = (const float*)bias;
  p.out = (bf16*)out;
  p.items = (int)items;
  p.heads = heads;
  p.n = N;
  p.nwin = nwin;
  p.c = C;
  p.scale = scale;
  p.q_is_global = q_is_global;
  return (int)window_attn::launch<true, true, window_attn::Layout::kTokens>(
      p, (cudaStream_t)stream);
}

int proj_scale_residual(const void* a, const void* wp, const void* bp, const void* gamma,
                        const void* x, void* out, int M, int C, int bn, int stages, int resident,
                        void* stream) {
  const hopper_gemm::ResParams p{(const float*)bp, (const float*)gamma, x, out, M, C, C, stages,
                                 resident};
  return (int)hopper_gemm::launch_res<bf16, hopper_gemm::kWhole, true, float>(
      p, a, wp, bn, (cudaStream_t)stream);
}

int ln_qkv_f32(const void* x, const void* ln_g, const void* ln_b, const void* w_hi,
               const void* w_lo, const void* bias, void* q, void* k, void* v, int M, int C, int S,
               float eps, int bn, int stages, int promote, void* stream) {
  return ln_qkv_tf32<float>(x, ln_g, ln_b, w_hi, w_lo, bias, q, k, v, M, C, S, eps, bn, stages,
                            promote, stream);
}

int window_attention_f32(const void* q, const void* k, const void* v, const void* bias,
                         void* out, int B, int nwin, int N, int C, int heads, float scale,
                         int q_is_global, void* stream) {
  return (int)tf32_attn::launch<float, float>(
      tf32_params(q, k, v, bias, out, B, nwin, N, C, heads, scale, q_is_global),
      (cudaStream_t)stream);
}

// window_attention_f32 stopped after a phase, for tools/exp_window_attention.py:
// cut 1 after the loads, 2 after the scores and the row max, 3 after the
// softmax (tf32_attention.cuh's kCut). The output holds a checksum, not
// attention.
int window_attention_f32_cut(const void* q, const void* k, const void* v, const void* bias,
                             void* out, int B, int nwin, int N, int C, int heads, float scale,
                             int q_is_global, int cut, void* stream) {
  const tf32_attn::Params p =
      tf32_params(q, k, v, bias, out, B, nwin, N, C, heads, scale, q_is_global);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (cut) {
    case 1: return (int)tf32_attn::launch<float, float, tf32_attn::kLoads>(p, s);
    case 2: return (int)tf32_attn::launch<float, float, tf32_attn::kScores>(p, s);
    case 3: return (int)tf32_attn::launch<float, float, tf32_attn::kSoftmax>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int proj_scale_residual_f32(const void* a, const void* w_hi, const void* w_lo, const void* bp,
                            const void* gamma, const void* x, void* out, int M, int C, int bn,
                            int stages, int promote, void* stream) {
  return proj_tf32<float>(a, w_hi, w_lo, bp, gamma, x, out, M, C, bn, stages, promote, stream);
}

// tma (C = 32, 64): ln_qkv_tma_kernel, its f32 outputs stored by TMA; else the LN kernel
// with its f32 outputs stored from the accumulators (flag: split_n). The choice and the
// plan: ops/kernels/convnext_block.py::_qkv_tma_plan_args
int ln_qkv_mmbf16(const void* x, const void* ln_g, const void* ln_b, const void* w,
                  const void* bias, void* q, void* k, void* v, int M, int C, int S, float eps,
                  int tma, int bn, int stages, int a_buffers, int resident, int flag,
                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (!tma) {
    const hopper_gemm::LnParams p{x, (const float*)ln_g, (const float*)ln_b, (const float*)bias,
                                  {q, k, v}, M, C, S * C, eps, stages, a_buffers, resident};
    return (int)hopper_gemm::launch_ln<hopper_gemm::kWhole, true, float, hopper_gemm::kEpiQkv,
                                       float>(p, w, bn, flag, st);
  }
  const hopper_gemm::QkvTmaParams p{(const float*)x, (const float*)ln_g, (const float*)ln_b,
                                    (const float*)bias, M, C, S * C, eps, stages, a_buffers,
                                    resident};
  void* const out[3] = {q, k, v};
  return (int)hopper_gemm::launch_qkv_tma<hopper_gemm::kWhole, true>(p, w, out, bn, st);
}

int window_attention_mmbf16(const void* q, const void* k, const void* v, const void* bias,
                            void* out, int B, int nwin, int N, int C, int heads, float scale,
                            int q_is_global, void* stream) {
  const long long items = (long long)B * nwin * heads;
  if (items == 0) return 0;
  if (C != heads * window_attn::kHd || items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  window_attn::Params p{};  // f32 tensors behind the pointers (the template's T = float)
  p.q = (const bf16*)q;
  p.k = (const bf16*)k;
  p.v = (const bf16*)v;
  p.bias = (const float*)bias;
  p.out = (bf16*)out;
  p.items = (int)items;
  p.heads = heads;
  p.n = N;
  p.nwin = nwin;
  p.c = C;
  p.scale = scale;
  p.q_is_global = q_is_global;
  return (int)window_attn::launch<true, true, window_attn::Layout::kTokens, 0, float>(
      p, (cudaStream_t)stream);
}

int proj_scale_residual_mmbf16(const void* a, const void* wp, const void* bp, const void* gamma,
                               const void* x, void* out, int M, int C, int bn, int stages,
                               int resident, void* stream) {
  const hopper_gemm::TmaResParams p{(const float*)bp, (const float*)gamma, M, C, C, stages,
                                    resident};
  return (int)hopper_gemm::launch_tma_res<float, hopper_gemm::kWhole, true>(
      p, a, wp, x, out, bn, (cudaStream_t)stream);
}

int ln_qkv_mmf32(const void* x, const void* ln_g, const void* ln_b, const void* w_hi,
                 const void* w_lo, const void* bias, void* q, void* k, void* v, int M, int C,
                 int S, float eps, int bn, int stages, int promote, void* stream) {
  return ln_qkv_tf32<bf16>(x, ln_g, ln_b, w_hi, w_lo, bias, q, k, v, M, C, S, eps, bn, stages,
                           promote, stream);
}

// q f32, or bf16 (q_bf16 = 1: a global query in the activations' dtype)
int window_attention_mmf32(const void* q, const void* k, const void* v, const void* bias,
                           void* out, int B, int nwin, int N, int C, int heads, float scale,
                           int q_is_global, int q_bf16, void* stream) {
  const tf32_attn::Params p =
      tf32_params(q, k, v, bias, out, B, nwin, N, C, heads, scale, q_is_global);
  const cudaStream_t s = (cudaStream_t)stream;
  return q_bf16 ? (int)tf32_attn::launch<bf16, bf16>(p, s)
                : (int)tf32_attn::launch<float, bf16>(p, s);
}

int proj_scale_residual_mmf32(const void* a, const void* w_hi, const void* w_lo, const void* bp,
                              const void* gamma, const void* x, void* out, int M, int C, int bn,
                              int stages, int promote, void* stream) {
  return proj_tf32<bf16>(a, w_hi, w_lo, bp, gamma, x, out, M, C, bn, stages, promote, stream);
}

}  // extern "C"
