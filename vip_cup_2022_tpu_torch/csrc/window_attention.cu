// Window attention on (B, H, N, D) q/k/v for Hopper (sm_90a).
//
//   window_attention_bhnd   per (window, head): s = (q k^T) * scale + bias
//                           in f32, an f32 softmax normalised before P.V, P
//                           rounded to bf16, O = P V with f32 accumulation
//                           -> bf16 (B, H, N, 32)
//
// Replaces the TPU kernel `window_attention` (body `_attention_kernel`) of
// vip_cup_2022_tpu/ops/pallas/window_attention.py, one (window, head) per
// grid step with the scores in VMEM. q, k and v arrive in bf16, so q k^T
// on the tensor cores (bf16 products, f32 accumulation) is the TPU's f32
// product of the same values; the scale multiplies the f32 scores, not a
// rounded q (gcvit_block.cu's `window_attention` rounds the scaled q instead
// and normalises after P.V: the same template with the other two choices).
//
// The kernel is window_attention.cuh's template on contiguous (N, 32) tiles
// (Layout::kHeads): persistent CTAs (4 warps at N <= 64, 8 above) walk the
// (window, head) items with the next one's K and V in flight, each warp's
// scores, softmax and P stay in registers (mma.sync m16n8k16, quad
// reductions), and a CTA keeps one head, whose bias it holds in shared
// memory in fragment order. What bounds it: at N = 49 the bytes of q, k, v
// and the output; at N = 196 the on-chip path between the two products
// (see the template's note, and PERF.md for the phase cuts).
//
// The launchers have a plain C interface for ctypes and return
// cudaGetLastError() as an int, so a refused launch reaches the caller.

#include "window_attention.cuh"

namespace {

window_attn::Params bhnd_params(const void* q, const void* k, const void* v, const void* bias,
                                void* out, long long BH, int H, int N, float scale) {
  window_attn::Params p{};
  p.q = (const window_attn::bf16*)q;
  p.k = (const window_attn::bf16*)k;
  p.v = (const window_attn::bf16*)v;
  p.bias = (const float*)bias;
  p.out = (window_attn::bf16*)out;
  p.items = (int)BH;
  p.heads = H;
  p.n = N;
  p.nwin = 1;
  p.c = H * window_attn::kHd;
  p.scale = scale;
  return p;
}

template <int kCut>
int launch_bhnd(const void* q, const void* k, const void* v, const void* bias, void* out,
                long long BH, int H, int N, float scale, void* stream) {
  if (BH == 0) return 0;
  if (H <= 0 || BH % H || BH > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return (int)window_attn::launch<false, false, window_attn::Layout::kHeads, kCut>(
      bhnd_params(q, k, v, bias, out, BH, H, N, scale), (cudaStream_t)stream);
}

}  // namespace

extern "C" {

int window_attention_bhnd(const void* q, const void* k, const void* v, const void* bias,
                          void* out, long long BH, int H, int N, float scale, void* stream) {
  return launch_bhnd<0>(q, k, v, bias, out, BH, H, N, scale, stream);
}

// The kernel stopped after a phase, for tools/exp_window_attention.py: cut 1
// after the loads, 2 after the scores, 3 after the softmax. The output holds
// checksums of the last phase, not attention.
int window_attention_bhnd_cut(const void* q, const void* k, const void* v, const void* bias,
                              void* out, long long BH, int H, int N, float scale, int cut,
                              void* stream) {
  switch (cut) {
    case 1: return launch_bhnd<1>(q, k, v, bias, out, BH, H, N, scale, stream);
    case 2: return launch_bhnd<2>(q, k, v, bias, out, BH, H, N, scale, stream);
    case 3: return launch_bhnd<3>(q, k, v, bias, out, BH, H, N, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
