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
// Every launcher has a plain C interface for ctypes and returns
// cudaGetLastError() as an int, so a refused launch reaches the caller.

#include "hopper_gemm.cuh"
#include "window_attention.cuh"

using hopper_gemm::bf16;

extern "C" {

int ln_qkv(const void* x, const void* ln_g, const void* ln_b, const void* w, const void* bias,
           void* q, void* k, void* v, int M, int C, int S, float eps, int bn, int stages,
           int a_buffers, int resident, int split_n, void* stream) {
  const hopper_gemm::LnParams p{x, (const float*)ln_g, (const float*)ln_b, (const float*)bias,
                                {(bf16*)q, (bf16*)k, (bf16*)v}, M, C, S * C, eps, stages,
                                a_buffers, resident};
  return (int)hopper_gemm::launch_ln<hopper_gemm::kWhole, true, bf16, true>(
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

}  // extern "C"
