// GCViT window-block kernels for Hopper (sm_90a), on window-ordered tokens.
//
// One GCViT block on (B, nWin*N, C) tokens is
//   r1  = x + gamma1 * proj(WindowAttention(LN1(x)))      kept in f32
//   out = r1 + gamma2 * fc2(gelu(fc1(LN2(r1))))           bf16
// and runs as five launches, three of them here:
//
//   ln_qkv               bf16 x (M, C) -> two-pass f32 LN -> bf16 tile in
//                        shared memory -> bf16 GEMM against W_qkv (S*C, C)
//                        + bias -> S separate bf16 (M, C) outputs: q, k, v
//                        (S = 3), or k, v (S = 2, global-query blocks)
//   window_attention     per (window, head, 64-query-row tile):
//                        softmax(q k^T + rel-pos bias) v with hd = 32; the
//                        window's K and V staged in shared memory, scores and
//                        probabilities never leave the chip
//   proj_scale_residual  bf16 attn (M, C) @ W_p (C, C)^T + b_p, * gamma1
//                        + bf16 x -> f32 r1 (M, C)
//
// then ln_fc1_gelu and fc2_scale_residual_f32res of convnext_block.cu on r1.
// ln_qkv and proj_scale_residual instantiate block_gemm.cuh's templates (the
// same wmma + cp.async mainloops as the ConvNeXt kernels).
//
// Every launcher has a plain C interface for ctypes and returns
// cudaGetLastError() as an int, so a refused launch reaches the caller.

#include "block_gemm.cuh"

using namespace block_gemm;

namespace {

// ---------------------------------------------------------------------------
// Window attention. hd = 32 at every GCViT level (dim / heads). A CTA of
// kAttnWarps warps owns kAttnRows query rows of one (window, head); each
// warp owns 16 of them. The window's keys and values are padded to NP (N
// rounded up to 16: 49 -> 64, 196 -> 208) with zero rows; padded keys are
// masked to -inf before the softmax and padded query rows are never stored.
// Shared memory: Q (64, 40), K and V (NP, 40) bf16; scores S (64, NP + 4)
// f32, over which each row's bf16 probabilities are written in place; a
// 16x32 f32 output stage per warp and the 64 row sums.
// q is scaled by hd^-1/2 in f32 and rounded to bf16 on its way into shared
// memory, as the TPU kernel scales it; the softmax is normalised after P.V
// by the sum of the bf16 probabilities that entered the product.
// ---------------------------------------------------------------------------
constexpr int kHd = 32;
constexpr int kAttnWarps = 4;
constexpr int kAttnThreads = kAttnWarps * 32;
constexpr int kAttnRows = 16 * kAttnWarps;
constexpr int kLdQKV = kHd + 8;  // bf16 row stride of the Q, K, V tiles (80 bytes)
constexpr int kMaxNP = 224;      // keys per window the per-lane row buffer holds
constexpr int kMaxPerLane = kMaxNP / 32;

inline int padded_keys(int n) { return (n + 15) / 16 * 16; }

inline size_t attn_smem_bytes(int np) {
  return (size_t)(kAttnRows + 2 * np) * kLdQKV * sizeof(bf16) +
         (size_t)kAttnRows * (np + 4) * sizeof(float) +
         (size_t)kAttnWarps * 16 * kHd * sizeof(float) + (size_t)kAttnRows * sizeof(float);
}

__global__ void __launch_bounds__(kAttnThreads)
window_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        bf16* __restrict__ out, int N, int NP, int nwin, int C,
                        float scale, int q_is_global) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long bw = blockIdx.x;  // image * nwin + window
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * kAttnRows;
  const int lds = NP + 4;

  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kAttnRows * kLdQKV;
  bf16* Vs = Ks + NP * kLdQKV;
  float* S = reinterpret_cast<float*>(Vs + NP * kLdQKV);
  float* Os = S + kAttnRows * lds;
  float* rowsum = Os + kAttnWarps * 16 * kHd;

  const long long kv_row0 = bw * N;
  const long long q_row0 = q_is_global ? (bw / nwin) * N : bw * N;
  const int col = h * kHd;

  // K and V of the window: NP rows of 4 16-byte vectors, zero past N
  for (int i = threadIdx.x; i < NP * 4; i += kAttnThreads) {
    const int r = i / 4, c8 = (i % 4) * 8;
    const bool ok = r < N;
    const long long g = (kv_row0 + (ok ? r : 0)) * C + col + c8;
    cp_async16(Ks + r * kLdQKV + c8, k + g, ok);
    cp_async16(Vs + r * kLdQKV + c8, v + g, ok);
  }
  cp_async_commit();
  // Q rows of this tile, scaled in f32 and rounded to bf16
  for (int i = threadIdx.x; i < kAttnRows * 4; i += kAttnThreads) {
    const int r = i / 4, c8 = (i % 4) * 8;
    float f[8];
    if (q0 + r < N) {
      load8(q + (q_row0 + q0 + r) * C + col + c8, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
    }
    store8(Qs + r * kLdQKV + c8, f);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int wr0 = warp * 16;  // this warp's first row in the tile
  if (q0 + wr0 >= N) return;  // all 16 rows are padding; no barrier follows

  // scores: (16, NP) = Q (16, 32) . K^T
  FragA fq[2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) wmma::load_matrix_sync(fq[kk], Qs + wr0 * kLdQKV + kk * 16, kLdQKV);
  for (int j = 0; j < NP; j += 16) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      FragB fk;
      wmma::load_matrix_sync(fk, Ks + j * kLdQKV + kk * 16, kLdQKV);
      wmma::mma_sync(acc, fq[kk], fk, acc);
    }
    wmma::store_matrix_sync(S + wr0 * lds + j, acc, lds, wmma::mem_row_major);
  }
  __syncwarp();

  // softmax of each row, + bias, padded keys masked; bf16 P written over S
  const float* bias_h = bias + (long long)h * N * N;
  for (int rr = 0; rr < 16; ++rr) {
    const int i = q0 + wr0 + rr;
    float* srow = S + (wr0 + rr) * lds;
    float s[kMaxPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      if (j < N && i < N) {
        s[t] = srow[j] + bias_h[(long long)i * N + j];
        mx = fmaxf(mx, s[t]);
      }
    }
    mx = warp_max(mx);
    __syncwarp();  // every lane has read its scores before P overwrites them
    bf16* prow = reinterpret_cast<bf16*>(srow);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < NP) {
        const bf16 p = __float2bfloat16(s[t] == -INFINITY ? 0.f : __expf(s[t] - mx));
        sum += __bfloat162float(p);
        prow[j] = p;
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) rowsum[wr0 + rr] = i < N ? sum : 1.f;
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
      wmma::load_matrix_sync(fv, Vs + j * kLdQKV + d * 16, kLdQKV);
      wmma::mma_sync(acc[d], fp, fv, acc[d]);
    }
  }
  float* ostage = Os + warp * 16 * kHd;
  wmma::store_matrix_sync(ostage, acc[0], kHd, wmma::mem_row_major);
  wmma::store_matrix_sync(ostage + 16, acc[1], kHd, wmma::mem_row_major);
  __syncwarp();

  // lane l stores row l/2, 16 columns from (l%2)*16, divided by the row sum
  const int r = lane >> 1, c16 = (lane & 1) * 16;
  const int i = q0 + wr0 + r;
  if (i < N) {
    const float inv = 1.f / rowsum[wr0 + r];
    float o[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) o[e] = ostage[r * kHd + c16 + e] * inv;
    bf16* dst = out + (kv_row0 + i) * C + col + c16;
    store8(dst, o);
    store8(dst + 8, o + 8);
  }
}

SmemGrant attn_grant;

}  // namespace

extern "C" {

int ln_qkv(const void* x, const void* ln_g, const void* ln_b, const void* w, const void* bias,
           void* q, void* k, void* v, int M, int C, int S, float eps, void* stream) {
  return (int)launch_ln_gemm<bf16, false>(
      (const bf16*)x, (const float*)ln_g, (const float*)ln_b, (const bf16*)w,
      (const float*)bias, (bf16*)q, (bf16*)k, (bf16*)v, M, C, S * C, C, eps,
      (cudaStream_t)stream);
}

int window_attention(const void* q, const void* k, const void* v, const void* bias, void* out,
                     int B, int nwin, int N, int C, int heads, float scale, int q_is_global,
                     void* stream) {
  if ((long long)B * nwin == 0) return 0;
  const int np = padded_keys(N);
  if (np > kMaxNP || C != heads * kHd) return (int)cudaErrorInvalidValue;
  const size_t smem = attn_smem_bytes(np);
  const cudaError_t err = grant_smem((const void*)window_attention_kernel, smem, attn_grant);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * nwin), (unsigned)heads, (unsigned)((N + kAttnRows - 1) / kAttnRows));
  window_attention_kernel<<<grid, kAttnThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias, (bf16*)out, N, np,
      nwin, C, scale, q_is_global);
  return (int)cudaGetLastError();
}

int proj_scale_residual(const void* a, const void* wp, const void* bp, const void* gamma,
                        const void* x, void* out, int M, int C, void* stream) {
  return (int)launch_gemm_scale_residual<bf16, float>(
      (const bf16*)a, (const bf16*)wp, (const float*)bp, (const float*)gamma,
      (const bf16*)x, (float*)out, M, C, C, (cudaStream_t)stream);
}

}  // extern "C"
