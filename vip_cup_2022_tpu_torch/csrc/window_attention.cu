// Window attention on (B, H, N, D) q/k/v for Hopper (sm_90a).
//
//   window_attention_bhnd       per (window, head): s = (q k^T) * scale +
//                               bias in f32, an f32 softmax normalised before
//                               P.V, P rounded to bf16, O = P V with f32
//                               accumulation -> bf16 (B, H, N, 32)
//   window_attention_bhnd_f32   the same in f32 throughout (VIPTPU_DTYPE=
//                               float32): f32 q, k, v and out, P in f32
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
// window_attention_bhnd_f32 is the TPU kernel's f32 mode: its dots take f32
// operands, which the tensor cores cannot (TF32 keeps 10 bits of mantissa),
// so it runs the f32 FMAs on the CUDA cores (f32_attention below) in the
// TPU kernel's order: q times the scale in f32, s = q k^T + bias, the row
// max subtracted, exp, each P divided by the row sum, then P.V in f32.
//
// The launchers have a plain C interface for ctypes and return
// cudaGetLastError() as an int, so a refused launch reaches the caller.

#include <math.h>

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

// f32_attention: one CTA of kWarps warps per (window, head) item, q, k and
// v of the item in shared memory. What bounds it on this card: the bytes
// (q, k, v and out in f32, 512 bytes a token and head; the bias is read
// from L2) at N = 49, where its 4 N^2 32 FLOPs an item at 67 TFLOP/s take
// about half as long; at N = 196 the FLOPs. The design keeps the FMAs fed
// from shared memory with few other instructions:
//   - scores: a warp takes kR query rows at once and a lane its keys lane,
//     lane + 32, ... (kNJ of them, keys past N masked to -inf); per 4
//     columns of d it reads each row's scaled q as one broadcast float4 and
//     its keys' k from rows padded to 33 floats (conflict-free), kR kNJ
//     FMAs for kNJ + kR reads a column;
//   - softmax: the bias added from global memory (consecutive keys across
//     the lanes), the row max and sum by warp shuffles, P = e / sum into the
//     warp's rows in shared memory;
//   - P.V: a lane owns one of the 32 output columns; per 4 keys a float4
//     of P per row (broadcast) and 4 rows of v (consecutive), 4 kR FMAs.
// Keys are padded to kNJ x 32 with zero k and v rows, so every loop runs
// over whole float4s.
namespace f32_attn {

constexpr int kHd = window_attn::kHd;
constexpr int kWarps = 4;
constexpr int kR = 4;          // query rows a warp computes at once
constexpr int kKs = kHd + 1;   // k's row stride in shared memory

__host__ __device__ constexpr size_t smem_bytes(int nj) {
  return (size_t)nj * 32 * (kKs + 2 * kHd + kWarps * kR) * sizeof(float);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int kNJ>
__global__ void __launch_bounds__(kWarps * 32) kernel(const float* __restrict__ q,
                                                       const float* __restrict__ k,
                                                       const float* __restrict__ v,
                                                       const float* __restrict__ bias,
                                                       float* __restrict__ out, int heads, int n,
                                                       float scale) {
  constexpr int NP = kNJ * 32;  // keys held, padded
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;              // NP x kKs
  float* vs = ks + NP * kKs;     // NP x 32
  float* qs = vs + NP * kHd;     // NP x 32, q * scale
  float* ps = qs + NP * kHd;     // kWarps x kR x NP, P of a warp's rows
  const long long item = blockIdx.x;
  const int head = (int)(item % heads);
  const long long base = item * n * kHd;
  for (int i = threadIdx.x; i < NP * (kHd / 4); i += kWarps * 32) {
    const int r = i / (kHd / 4), c = (i % (kHd / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a, d = a;
    if (r < n) {
      a = __ldg(reinterpret_cast<const float4*>(q + base) + i);
      b = __ldg(reinterpret_cast<const float4*>(k + base) + i);
      d = __ldg(reinterpret_cast<const float4*>(v + base) + i);
    }
    *reinterpret_cast<float4*>(qs + r * kHd + c) =
        make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
    ks[r * kKs + c] = b.x;
    ks[r * kKs + c + 1] = b.y;
    ks[r * kKs + c + 2] = b.z;
    ks[r * kKs + c + 3] = b.w;
    *reinterpret_cast<float4*>(vs + r * kHd + c) = d;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* pw = ps + warp * kR * NP;
  const float* brow = bias + (long long)head * n * n;
  for (int r0 = warp * kR; r0 < n; r0 += kWarps * kR) {
    float s[kR][kNJ];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) s[r][jj] = 0.f;
#pragma unroll 2
    for (int d = 0; d < kHd; d += 4) {
      float4 qv[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r)  // rows past N read row 0: computed, never kept
        qv[r] = *reinterpret_cast<const float4*>(qs + (r0 + r < n ? r0 + r : 0) * kHd + d);
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
        const float* kr = ks + (lane + 32 * jj) * kKs + d;
        const float k0 = kr[0], k1 = kr[1], k2 = kr[2], k3 = kr[3];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          s[r][jj] = fmaf(qv[r].x, k0, s[r][jj]);
          s[r][jj] = fmaf(qv[r].y, k1, s[r][jj]);
          s[r][jj] = fmaf(qv[r].z, k2, s[r][jj]);
          s[r][jj] = fmaf(qv[r].w, k3, s[r][jj]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = r0 + r;
      if (i >= n) break;  // the same for the whole warp
      float m = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
        const int j = lane + 32 * jj;
        s[r][jj] = j < n ? s[r][jj] + __ldg(brow + (long long)i * n + j) : -INFINITY;
        m = fmaxf(m, s[r][jj]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
        s[r][jj] = lane + 32 * jj < n ? expf(s[r][jj] - m) : 0.f;
        sum += s[r][jj];
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) pw[r * NP + lane + 32 * jj] = s[r][jj] / sum;
    }
    __syncwarp();
    float o[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) o[r] = 0.f;
    const int nk = (n + 3) & ~3;  // P and v are 0 past N
    for (int j = 0; j < nk; j += 4) {
      const float v0 = vs[j * kHd + lane], v1 = vs[(j + 1) * kHd + lane],
                  v2 = vs[(j + 2) * kHd + lane], v3 = vs[(j + 3) * kHd + lane];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(pw + r * NP + j);
        o[r] = fmaf(pv.x, v0, o[r]);
        o[r] = fmaf(pv.y, v1, o[r]);
        o[r] = fmaf(pv.z, v2, o[r]);
        o[r] = fmaf(pv.w, v3, o[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (r0 + r < n) out[base + (long long)(r0 + r) * kHd + lane] = o[r];
    __syncwarp();  // every lane's P reads are done before the next rows overwrite them
  }
}

template <int kNJ>
int launch(const float* q, const float* k, const float* v, const float* bias, float* out,
           long long items, int heads, int n, float scale, cudaStream_t stream) {
  static smem_grant::SmemGrant grant;
  const void* fn = (const void*)kernel<kNJ>;
  const size_t smem = smem_bytes(kNJ);
  cudaError_t err = smem_grant::grant_smem(fn, smem, grant);
  if (err != cudaSuccess) return (int)err;
  kernel<kNJ><<<(unsigned)items, kWarps * 32, smem, stream>>>(q, k, v, bias, out, heads, n,
                                                                scale);
  return (int)cudaGetLastError();
}

}  // namespace f32_attn

}  // namespace

extern "C" {

int window_attention_bhnd(const void* q, const void* k, const void* v, const void* bias,
                          void* out, long long BH, int H, int N, float scale, void* stream) {
  return launch_bhnd<0>(q, k, v, bias, out, BH, H, N, scale, stream);
}

// f32 q, k, v (BH, N, 32) and bias (H, N, N) -> f32 out (BH, N, 32), N <= 224
int window_attention_bhnd_f32(const void* q, const void* k, const void* v, const void* bias,
                              void* out, long long BH, int H, int N, float scale, void* stream) {
  if (BH == 0) return 0;
  if (H <= 0 || BH % H || BH > 0x7fffffffLL || N <= 0 || N > window_attn::kMaxN)
    return (int)cudaErrorInvalidValue;
  const float *fq = (const float*)q, *fk = (const float*)k, *fv = (const float*)v,
              *fb = (const float*)bias;
  const cudaStream_t s = (cudaStream_t)stream;
  if (N <= 64) return f32_attn::launch<2>(fq, fk, fv, fb, (float*)out, BH, H, N, scale, s);
  return f32_attn::launch<7>(fq, fk, fv, fb, (float*)out, BH, H, N, scale, s);
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
