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
// rounded q (gcvit_block.cu's `window_attention` rounds the scaled q instead and
// normalises after P.V: a different function).
//
// A CTA of kWarps warps owns kRows query rows of one (window, head); each
// warp owns 16 of them. The window's keys and values are padded to NP (N
// rounded up to 16: 49 -> 64, 196 -> 208) with zero rows; padded keys are
// masked to -inf before the softmax and padded query rows are never stored.
// Shared memory: Q (64, 40), K and V (NP, 40) bf16; the scores S (64, NP + 4)
// f32, over which each row's bf16 probabilities are written in place; a
// 16x32 f32 output stage per warp.
//
// What bounds it: at N = 49 and D = 32 it moves q, k, v and the output once
// (256 bytes a token a head) for ~4 N D FLOPs a token a head, far below the
// card's FLOP-per-byte ridge, so memory bandwidth; the softmax runs on the
// CUDA cores in f32 from the staged scores, each lane holding kSlots of a
// row's keys (2 for N <= 64, 7 for N <= 224).
//
// The launcher has a plain C interface for ctypes and returns
// cudaGetLastError() as an int, so a refused launch reaches the caller.

#include "block_gemm.cuh"

using namespace block_gemm;

namespace {

constexpr int kHd = 32;
constexpr int kWarps = 4;
constexpr int kAttnThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;
constexpr int kLdT = kHd + 8;  // bf16 row stride of the Q, K, V tiles (80 bytes)
constexpr int kMaxNP = 224;

inline int padded_keys(int n) { return (n + 15) / 16 * 16; }

inline size_t smem_bytes(int np) {
  return (size_t)(kRows + 2 * np) * kLdT * sizeof(bf16) +
         (size_t)kRows * (np + 4) * sizeof(float) + (size_t)kWarps * 16 * kHd * sizeof(float);
}

template <int kSlots>
__global__ void __launch_bounds__(kAttnThreads)
window_attention_bhnd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const float* __restrict__ bias,
                             bf16* __restrict__ out, int H, int N, int NP, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long bh = blockIdx.x;  // window * H + head
  const int h = (int)(bh % H);
  const int q0 = blockIdx.y * kRows;
  const int lds = NP + 4;

  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kRows * kLdT;
  bf16* Vs = Ks + NP * kLdT;
  float* S = reinterpret_cast<float*>(Vs + NP * kLdT);
  float* Os = S + kRows * lds;

  const long long base = bh * N * kHd;  // this (window, head)'s (N, 32) tiles
  // K and V: NP rows of 4 16-byte vectors, zero past N; then this tile's Q rows
  for (int i = threadIdx.x; i < NP * 4; i += kAttnThreads) {
    const int r = i / 4, c8 = (i % 4) * 8;
    const bool ok = r < N;
    const long long g = base + (long long)(ok ? r : 0) * kHd + c8;
    cp_async16(Ks + r * kLdT + c8, k + g, ok);
    cp_async16(Vs + r * kLdT + c8, v + g, ok);
  }
  for (int i = threadIdx.x; i < kRows * 4; i += kAttnThreads) {
    const int r = i / 4, c8 = (i % 4) * 8;
    const bool ok = q0 + r < N;
    cp_async16(Qs + r * kLdT + c8, q + base + (long long)(ok ? q0 + r : 0) * kHd + c8, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int wr0 = warp * 16;  // this warp's first row in the tile
  if (q0 + wr0 >= N) return;  // all 16 rows are padding; no barrier follows

  // scores: (16, NP) = Q (16, 32) . K^T, f32 accumulation
  FragA fq[2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) wmma::load_matrix_sync(fq[kk], Qs + wr0 * kLdT + kk * 16, kLdT);
  for (int j = 0; j < NP; j += 16) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      FragB fk;
      wmma::load_matrix_sync(fk, Ks + j * kLdT + kk * 16, kLdT);
      wmma::mma_sync(acc, fq[kk], fk, acc);
    }
    wmma::store_matrix_sync(S + wr0 * lds + j, acc, lds, wmma::mem_row_major);
  }
  __syncwarp();

  // softmax of each row: scale, + bias, padded keys masked, normalised; the
  // bf16 probabilities are written over the row's scores
  const float* bias_h = bias + (long long)h * N * N;
  for (int rr = 0; rr < 16; ++rr) {
    const int i = q0 + wr0 + rr;
    float* srow = S + (wr0 + rr) * lds;
    float s[kSlots];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      if (j < N && i < N) {
        s[t] = srow[j] * scale + bias_h[(long long)i * N + j];
        mx = fmaxf(mx, s[t]);
      }
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      s[t] = s[t] == -INFINITY ? 0.f : __expf(s[t] - mx);
      sum += s[t];
    }
    sum = warp_sum(sum);
    const float inv = i < N ? 1.f / sum : 0.f;
    __syncwarp();  // every lane has read its scores before P overwrites them
    bf16* prow = reinterpret_cast<bf16*>(srow);
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int j = lane + 32 * t;
      if (j < NP) prow[j] = __float2bfloat16(s[t] * inv);
    }
  }
  __syncwarp();

  // O (16, 32) = P (16, NP) . V (NP, 32)
  const bf16* P = reinterpret_cast<const bf16*>(S + wr0 * lds);
  const int ldp = 2 * lds;
  FragC acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int j = 0; j < NP; j += 16) {
    FragA fp;
    wmma::load_matrix_sync(fp, P + j, ldp);
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      FragBRow fv;
      wmma::load_matrix_sync(fv, Vs + j * kLdT + d * 16, kLdT);
      wmma::mma_sync(acc[d], fp, fv, acc[d]);
    }
  }
  float* ostage = Os + warp * 16 * kHd;
  wmma::store_matrix_sync(ostage, acc[0], kHd, wmma::mem_row_major);
  wmma::store_matrix_sync(ostage + 16, acc[1], kHd, wmma::mem_row_major);
  __syncwarp();

  // lane l stores row l/2, 16 columns from (l%2)*16
  const int r = lane >> 1, c16 = (lane & 1) * 16;
  const int i = q0 + wr0 + r;
  if (i < N) {
    bf16* dst = out + base + (long long)i * kHd + c16;
    store8(dst, ostage + r * kHd + c16);
    store8(dst + 8, ostage + r * kHd + c16 + 8);
  }
}

template <int kSlots>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const float* bias, bf16* out,
                   long long BH, int H, int N, float scale, cudaStream_t stream) {
  static SmemGrant grant;
  const int np = padded_keys(N);
  const size_t smem = smem_bytes(np);
  const cudaError_t err =
      grant_smem((const void*)window_attention_bhnd_kernel<kSlots>, smem, grant);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)BH, (unsigned)((N + kRows - 1) / kRows));
  window_attention_bhnd_kernel<kSlots><<<grid, kAttnThreads, smem, stream>>>(
      q, k, v, bias, out, H, N, np, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int window_attention_bhnd(const void* q, const void* k, const void* v, const void* bias,
                          void* out, long long BH, int H, int N, float scale, void* stream) {
  if (BH == 0) return 0;
  if (N <= 0 || padded_keys(N) > kMaxNP || H <= 0 || BH % H || BH > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v;
  if (padded_keys(N) <= 64)
    return (int)launch<2>(qb, kb, vb, (const float*)bias, (bf16*)out, BH, H, N, scale,
                          (cudaStream_t)stream);
  return (int)launch<kMaxNP / 32>(qb, kb, vb, (const float*)bias, (bf16*)out, BH, H, N, scale,
                                  (cudaStream_t)stream);
}

}  // extern "C"
