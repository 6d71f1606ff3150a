// Grouped window attention with removable parts, for Hopper (sm_90a), on
// window_attention.cuh's template.
//
//   attn_parts        per (image, window group, head): q scaled in f32 and
//                     rounded to bf16; S = q k^T (f32 accumulation);
//                     [+ bias] [- row max] [exp]; P rounded to bf16;
//                     O = P V and den = sum(P), both in f32; [O / den];
//                     -> bf16 (B, nWin*N, C)
//   attn_parts_copy   q + v, elementwise (the "empty" variant's floor)
//
// Replaces the TPU kernel of the experiment tool tools/exp_attn_parts.py
// (`build`, bodies `_kernel` and `_copy_kernel`), which prices each part
// of the grouped window-attention softmax by removing it. The bracketed
// steps are the template's part flags (window_attn::Part: kBias, kMax, kExp,
// kDiv); a removed part makes the output wrong on purpose, as on the TPU.
// Tokens are (B, nWin*N, C) with heads of 32 channels; a group is g
// consecutive windows, gN tokens, and every query attends over all gN keys
// of its group. The (heads, gN, gN) f32 bias is an input: the tool's
// block-diagonal bias with -1e9 off the diagonal blocks, but the variants
// without it attend across the whole group, so no block is skipped.
//
// With all four parts this is K5's function (gcvit_block.cu's
// `window_attention`: q scaled and rounded, P normalised after P V by the sum
// of its bf16 values, token rows), on the same template:
//   - attn_parts: the template's streamed-key mode at every gN up to 1024,
//     two passes over 16-key tiles in registers, persistent CTAs that each
//     keep one (head, stripe of query rows) and its stripe of the bias in
//     shared memory (window_attention.cuh says how), the parts as
//     compile-time flags;
//   - attn_parts_copy: the template header's elementwise add_kernel.
//
// What bounds it: it moves q, k, v and the output once and the bias once
// (the bound the tool asks about) and does 6 gN^2 32 tensor-core FLOPs per
// group and head (the second pass computes the scores again; 4 gN^2 32
// without the max) and, with the exp, gN^2 exps on the SFUs; at gN = 392
// the per-score softmax work on the CUDA cores and the shared-memory reads
// of K, V and the bias set the pace (PERF.md).
//
// The launchers have a plain C interface for ctypes and return
// cudaGetLastError() as an int, so a refused launch reaches the caller.

#include "window_attention.cuh"

namespace {

namespace wa = window_attn;

wa::StreamParams params(const void* q, const void* k, const void* v, const void* mb, void* out,
                        long long groups, int heads, int gN, int C, float scale, int tiles,
                        int splits, int stripes, int stages) {
  wa::StreamParams sp{};
  sp.p.q = (const wa::bf16*)q;
  sp.p.k = (const wa::bf16*)k;
  sp.p.v = (const wa::bf16*)v;
  sp.p.bias = (const float*)mb;
  sp.p.out = (wa::bf16*)out;
  sp.p.items = (int)(groups * heads);
  sp.p.heads = heads;
  sp.p.n = gN;
  sp.p.nwin = 1;
  sp.p.c = C;
  sp.p.scale = scale;
  sp.np = wa::padded_keys(gN);
  sp.tiles = tiles;
  sp.splits = splits;
  sp.stripes = stripes;
  sp.stages = stages;
  return sp;
}

bool valid(long long groups, int heads, int gN, int C) {
  return gN > 0 && gN <= wa::kMaxStreamN && heads > 0 && C == heads * wa::kHd &&
         groups * heads <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

// q, k, v, out (B, nWin*N, C) bf16 with groups = B * nWin / g groups of gN =
// g*N tokens; mb (heads, gN, gN) f32; parts: a mask of 1 bias, 2 max,
// 4 exp, 8 div; the streamed mode's plan (tiles, splits, stripes, stages)
// from ops/kernels/attn_parts.py: stripe_plan
int attn_parts(const void* q, const void* k, const void* v, const void* mb, void* out,
               long long groups, int heads, int gN, int C, float scale, int parts, int tiles,
               int splits, int stripes, int stages, void* stream) {
  if (groups == 0) return 0;
  if (!valid(groups, heads, gN, C) || parts < 0 || parts > wa::kAllParts)
    return (int)cudaErrorInvalidValue;
  const wa::StreamParams sp = params(q, k, v, mb, out, groups, heads, gN, C, scale, tiles,
                                     splits, stripes, stages);
  const cudaStream_t s = (cudaStream_t)stream;
#define ATTN_PARTS_CASE(P) \
  case P: return (int)wa::launch_streamed<P>(sp, s);
  switch (parts) {
    ATTN_PARTS_CASE(0) ATTN_PARTS_CASE(1) ATTN_PARTS_CASE(2) ATTN_PARTS_CASE(3)
    ATTN_PARTS_CASE(4) ATTN_PARTS_CASE(5) ATTN_PARTS_CASE(6) ATTN_PARTS_CASE(7)
    ATTN_PARTS_CASE(8) ATTN_PARTS_CASE(9) ATTN_PARTS_CASE(10) ATTN_PARTS_CASE(11)
    ATTN_PARTS_CASE(12) ATTN_PARTS_CASE(13) ATTN_PARTS_CASE(14) ATTN_PARTS_CASE(15)
  }
#undef ATTN_PARTS_CASE
  return (int)cudaErrorInvalidValue;
}

// attn_parts with every part, stopped after a phase for
// tools/exp_attn_parts.py: cut 1 after the loads, 2 after pass 1 (the row
// max), 3 after pass 2's softmax (no P V). The output holds checksums.
int attn_parts_cut(const void* q, const void* k, const void* v, const void* mb, void* out,
                   long long groups, int heads, int gN, int C, float scale, int tiles, int splits,
                   int stripes, int stages, int cut, void* stream) {
  if (groups == 0) return 0;
  if (!valid(groups, heads, gN, C)) return (int)cudaErrorInvalidValue;
  const wa::StreamParams sp = params(q, k, v, mb, out, groups, heads, gN, C, scale, tiles,
                                     splits, stripes, stages);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (cut) {
    case 1: return (int)wa::launch_streamed<wa::kAllParts, 1>(sp, s);
    case 2: return (int)wa::launch_streamed<wa::kAllParts, 2>(sp, s);
    case 3: return (int)wa::launch_streamed<wa::kAllParts, 3>(sp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out = q + v on n bf16 elements, n a multiple of 8
int attn_parts_copy(const void* q, const void* v, void* out, long long n, void* stream) {
  return (int)wa::launch_add((const wa::bf16*)q, (const wa::bf16*)v, (wa::bf16*)out, n,
                             (cudaStream_t)stream);
}

}  // extern "C"
