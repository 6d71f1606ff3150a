// Window attention in f32 for Hopper (sm_90a): f32 q, k, v, bias and out,
// f32 products and sums on the CUDA cores, head width 32, N <= 224.
//
//   f32_attn::launch   (BH, N, 32) tiles, P divided by its row sum before
//       P.V: window_attention_bhnd_f32 (window_attention.cu), the f32 mode
//       of the TPU kernel window_attention (vip_cup_2022_tpu/ops/pallas/
//       window_attention.py), on GCViT's unfused block (training and
//       VIPTPU_NO_FUSED_BLOCK=1)
//
// It follows the TPU kernel's f32 order: q times the scale in f32, s = q k^T
// + bias, the row max subtracted, exp, each P divided by the row sum of exp,
// then P.V, all as f32 FMAs. The tensor cores serve f32 products too, as
// three TF32 products of split operands (3xTF32): the fused block's
// attention on token rows (window_attention_f32 and _mmf32) left this file
// for tf32_attention.cuh, which runs them so. This kernel is the next to
// move there (ROADMAP.md).
//
// One CTA of kWarps warps per (window, head) item, the item's q, k and v in
// shared memory. What bounds it on this card: the bytes (q, k, v and out in
// f32, 512 bytes a token and head; the bias is read from L2) at N = 49,
// where its 4 N^2 32 FLOPs an item at 67 TFLOP/s take about half as long;
// at N = 196 the FLOPs. The design keeps the FMAs fed from shared memory
// with few other instructions:
//   - scores: a warp takes kR query rows at once and a lane its keys lane,
//     lane + 32, ... (kNJ of them, keys past N masked to -inf); per 4
//     columns of d it reads each row's scaled q as one broadcast float4 and
//     its keys' k from rows padded to 33 floats (conflict-free), kR kNJ
//     FMAs for kNJ + kR reads a column;
//   - softmax: the bias added from global memory (consecutive keys across
//     the lanes), the row max and sum by warp shuffles, P / sum into the
//     warp's rows in shared memory;
//   - P.V: a lane owns one of the 32 output columns; per 4 keys a float4
//     of P per row (broadcast) and 4 rows of v (consecutive), 4 kR FMAs.
// Keys are padded to kNJ x 32 with zero k and v rows, so every loop runs
// over whole float4s; a (token, head) row is 128 contiguous bytes, loaded
// 16 bytes a thread.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "smem_grant.cuh"

namespace f32_attn {

constexpr int kHd = 32;
constexpr int kWarps = 4;
constexpr int kR = 4;         // query rows a warp computes at once
constexpr int kKs = kHd + 1;  // k's row stride in shared memory
constexpr int kMaxN = 224;

struct Params {
  const float* q;     // (BH, N, 32)
  const float* k;
  const float* v;
  const float* bias;  // (heads, N, N)
  float* out;         // (BH, N, 32)
  long long items;    // (window, head) items: BH
  int heads, n;
  float scale;
};

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <int kNJ>
__global__ void __launch_bounds__(kWarps * 32) kernel(const Params p) {
  constexpr int NP = kNJ * 32;  // keys held, padded
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;              // NP x kKs
  float* vs = ks + NP * kKs;     // NP x 32
  float* qs = vs + NP * kHd;     // NP x 32, q * scale
  float* ps = qs + NP * kHd;     // kWarps x kR x NP, P of a warp's rows
  const int n = p.n;
  const long long item = blockIdx.x;
  const int head = (int)(item % p.heads);
  // element (r, d) of the item's q, k, v and out at base + r * kHd + d
  const long long base = item * n * kHd;
  for (int i = threadIdx.x; i < NP * (kHd / 4); i += kWarps * 32) {
    const int r = i / (kHd / 4), c = (i % (kHd / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a, d = a;
    if (r < n) {
      const long long off = base + (long long)r * kHd + c;
      a = ld4(p.q + off);
      b = ld4(p.k + off);
      d = ld4(p.v + off);
    }
    *reinterpret_cast<float4*>(qs + r * kHd + c) =
        make_float4(a.x * p.scale, a.y * p.scale, a.z * p.scale, a.w * p.scale);
    ks[r * kKs + c] = b.x;
    ks[r * kKs + c + 1] = b.y;
    ks[r * kKs + c + 2] = b.z;
    ks[r * kKs + c + 3] = b.w;
    *reinterpret_cast<float4*>(vs + r * kHd + c) = d;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* pw = ps + warp * kR * NP;
  const float* brow = p.bias + (long long)head * n * n;
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
      for (int jj = 0; jj < kNJ; ++jj)
        pw[r * NP + lane + 32 * jj] = s[r][jj] / sum;
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
      if (r0 + r < n)
        p.out[base + (long long)(r0 + r) * kHd + lane] = o[r];
    __syncwarp();  // every lane's P reads are done before the next rows overwrite them
  }
}

template <int kNJ>
cudaError_t launch_nj(const Params& p, cudaStream_t stream) {
  static smem_grant::SmemGrant grant;
  const void* fn = (const void*)kernel<kNJ>;
  const size_t smem = smem_bytes(kNJ);
  cudaError_t err = smem_grant::grant_smem(fn, smem, grant);
  if (err != cudaSuccess) return err;
  kernel<kNJ><<<(unsigned)p.items, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// N <= 64 keys in a 64-key tile, else 224
inline cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.items == 0) return cudaSuccess;
  if (p.heads <= 0 || p.items % p.heads || p.items > 0x7fffffffLL || p.n <= 0 || p.n > kMaxN)
    return cudaErrorInvalidValue;
  if (p.n <= 64) return launch_nj<2>(p, stream);
  return launch_nj<7>(p, stream);
}

}  // namespace f32_attn
