// Grouped window attention with removable parts, for Hopper (sm_90a).
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
// steps are template flags (BIAS, MAX, EXP, DIV); a removed part makes the
// output wrong on purpose, as on the TPU. Tokens are (B, nWin*N, C) with
// heads of 32 channels; a group is g consecutive windows, gN tokens, and
// every query attends over all gN keys of its group. The (heads, gN, gN)
// f32 bias is an input read from memory: the tool's block-diagonal bias
// with -1e9 off the diagonal blocks, but the variants without it attend
// across the whole group, so no block is skipped.
//
// A CTA of 4 warps owns 64 query rows of one (image, group, head); each
// warp owns 16 and walks the keys in tiles of 16. Shared memory holds Q
// (64, 40) and K, V (NP, 40) bf16, NP = gN rounded up to 16 (392 -> 400 at
// the tool's shapes; padded keys are zero and excluded), and per warp a
// 16 x 16 f32 score stage and a 16 x 16 bf16 P tile: 75 KB at gN = 392,
// three CTAs an SM (above the default 48 KB, so the launcher raises the
// CTA's dynamic shared-memory limit). No score row is kept: with MAX, a
// first pass over the key tiles takes the row max of the (biased) scores,
// and the second recomputes each 16 x 16 score tile (two tensor-core
// products, cheap at a head width of 32), applies the parts, rounds P to
// bf16 into the warp's tile and accumulates P V and sum(P) at once. The
// result is the same function step by step: P is rounded after the final
// row max is subtracted, as on the TPU.
//
// What bounds it: it moves q, k, v and the output once (the bound that
// the tool asks about), does 4 gN^2 32 tensor-core FLOPs per group and head
// (6 gN^2 32 with the recomputed scores) and, with EXP, gN^2 exps on the
// SFUs; the per-element parts run on the CUDA cores, 8 elements a lane per
// score tile.
//
// The launchers have a plain C interface for ctypes and return
// cudaGetLastError() as an int, so a refused launch reaches the caller.

#include "block_gemm.cuh"

using namespace block_gemm;

namespace {

constexpr int kHd = 32;
constexpr int kWarps = 4;
constexpr int kAttnThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;
constexpr int kLdT = kHd + 8;  // bf16 row stride of the Q, K, V tiles
constexpr int kMaxNP = 1024;   // keys of a group the K and V tiles hold
constexpr int kBias = 1, kMax = 2, kExp = 4, kDiv = 8;

inline int padded_keys(int gn) { return (gn + 15) / 16 * 16; }

inline size_t smem_bytes(int np) {
  return (size_t)(kRows + 2 * np) * kLdT * sizeof(bf16) +
         (size_t)kWarps * (256 * sizeof(float) + 256 * sizeof(bf16));
}

template <bool BIAS, bool MAX, bool EXP, bool DIV>
__global__ void __launch_bounds__(kAttnThreads)
attn_parts_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ mb,
                  bf16* __restrict__ out, int heads, int gN, int NP, int C,
                  float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x % heads;
  const long long grp = blockIdx.x / heads;  // image * (nWin / g) + window group
  const int q0 = blockIdx.y * kRows;

  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kRows * kLdT;
  bf16* Vs = Ks + NP * kLdT;
  float* stage = reinterpret_cast<float*>(Vs + NP * kLdT) + warp * 256;
  bf16* Pt = reinterpret_cast<bf16*>(reinterpret_cast<float*>(Vs + NP * kLdT) + kWarps * 256) +
             warp * 256;

  // token j of the group is row grp * gN + j of the (B * nWin * N, C) matrix
  const long long base = grp * gN * (long long)C + h * kHd;
  for (int i = threadIdx.x; i < NP * 4; i += kAttnThreads) {
    const int r = i / 4, c8 = (i % 4) * 8;
    const bool ok = r < gN;
    const long long g = base + (long long)(ok ? r : 0) * C + c8;
    cp_async16(Ks + r * kLdT + c8, k + g, ok);
    cp_async16(Vs + r * kLdT + c8, v + g, ok);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < kRows * 4; i += kAttnThreads) {  // q * scale -> bf16
    const int r = i / 4, c8 = (i % 4) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + r < gN) load8(q + base + (long long)(q0 + r) * C + c8, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] *= scale;
    store8(Qs + r * kLdT + c8, x);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int wr0 = warp * 16;  // this warp's first row in the tile
  if (q0 + wr0 >= gN) return;  // all 16 rows are padding; no barrier follows

  FragA fq[2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) wmma::load_matrix_sync(fq[kk], Qs + wr0 * kLdT + kk * 16, kLdT);

  // lane l owns row l/2 of each 16 x 16 score tile, columns (l%2)*8 ... +8
  const int i = q0 + wr0 + (lane >> 1), cc = (lane & 1) * 8;
  const float* mb_row = mb + ((long long)h * gN + (i < gN ? i : 0)) * gN;
  // the score tile of keys [j0, j0+16), biased if BIAS, into s (8 per lane)
  auto scores = [&](int j0, float s[8]) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      FragB fk;
      wmma::load_matrix_sync(fk, Ks + j0 * kLdT + kk * 16, kLdT);
      wmma::mma_sync(acc, fq[kk], fk, acc);
    }
    stage_fragment(stage, acc, s);
    if constexpr (BIAS) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = j0 + cc + e;
        if (j < gN && i < gN) s[e] += mb_row[j];
      }
    }
  };

  float mx = -INFINITY;
  if constexpr (MAX) {  // pass 1: the row max over the group's real keys
    for (int j0 = 0; j0 < NP; j0 += 16) {
      float s[8];
      scores(j0, s);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (j0 + cc + e < gN) mx = fmaxf(mx, s[e]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  }

  // pass 2: P = bf16([exp]([s - max])) per tile, then P V and sum(P)
  FragC o[2];
  wmma::fill_fragment(o[0], 0.f);
  wmma::fill_fragment(o[1], 0.f);
  float den = 0.f;
  for (int j0 = 0; j0 < NP; j0 += 16) {
    float s[8];
    scores(j0, s);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float p = 0.f;
      if (j0 + cc + e < gN) {
        p = s[e];
        if constexpr (MAX) p -= mx;
        if constexpr (EXP) p = __expf(p);
      }
      s[e] = __bfloat162float(__float2bfloat16(p));
      den += s[e];
    }
    store8(Pt + (lane >> 1) * 16 + cc, s);  // exact: s already holds bf16 values
    __syncwarp();
    FragA fp;
    wmma::load_matrix_sync(fp, Pt, 16);
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      FragBRow fv;
      wmma::load_matrix_sync(fv, Vs + j0 * kLdT + d * 16, kLdT);
      wmma::mma_sync(o[d], fp, fv, o[d]);
    }
    __syncwarp();  // the P tile is read before the next tile overwrites it
  }
  den += __shfl_xor_sync(0xffffffffu, den, 1);

  // [O / den] -> bf16; lane l stores row l/2, 8 columns of each half
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    float r[8];
    stage_fragment(stage, o[d], r);
    if constexpr (DIV) {
#pragma unroll
      for (int e = 0; e < 8; ++e) r[e] /= den;
    }
    if (i < gN) store8(out + base + (long long)i * C + d * 16 + cc, r);
  }
}

template <bool BIAS, bool MAX, bool EXP, bool DIV>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const float* mb, bf16* out,
                   long long groups, int heads, int gN, int C, float scale,
                   cudaStream_t stream) {
  static SmemGrant grant;
  const int np = padded_keys(gN);
  const size_t smem = smem_bytes(np);
  const cudaError_t err =
      grant_smem((const void*)attn_parts_kernel<BIAS, MAX, EXP, DIV>, smem, grant);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(groups * heads), (unsigned)((gN + kRows - 1) / kRows));
  attn_parts_kernel<BIAS, MAX, EXP, DIV><<<grid, kAttnThreads, smem, stream>>>(
      q, k, v, mb, out, heads, gN, np, C, scale);
  return cudaGetLastError();
}

constexpr int kCopyThreads = 256;

__global__ void __launch_bounds__(kCopyThreads)
attn_parts_copy_kernel(const bf16* __restrict__ q, const bf16* __restrict__ v,
                       bf16* __restrict__ out, long long n8) {
  const long long i = (long long)blockIdx.x * kCopyThreads + threadIdx.x;
  if (i >= n8) return;
  float a[8], b[8];
  load8(q + i * 8, a);
  load8(v + i * 8, b);
#pragma unroll
  for (int e = 0; e < 8; ++e) a[e] += b[e];
  store8(out + i * 8, a);
}

}  // namespace

extern "C" {

// q, k, v, out (B, nWin*N, C) bf16 with groups = B * nWin / g groups of gN =
// g*N tokens; mb (heads, gN, gN) f32; parts: a mask of 1 bias, 2 max,
// 4 exp, 8 div
int attn_parts(const void* q, const void* k, const void* v, const void* mb, void* out,
               long long groups, int heads, int gN, int C, float scale, int parts,
               void* stream) {
  if (groups == 0) return 0;
  if (gN <= 0 || padded_keys(gN) > kMaxNP || heads <= 0 || C != heads * kHd ||
      groups * heads > 0x7fffffffLL || parts < 0 || parts > 15)
    return (int)cudaErrorInvalidValue;
  const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k, *vb = (const bf16*)v;
  const float* m = (const float*)mb;
  bf16* o = (bf16*)out;
  cudaStream_t s = (cudaStream_t)stream;
#define ATTN_PARTS_CASE(P)                                                                  \
  case P:                                                                                   \
    return (int)launch<((P) & kBias) != 0, ((P) & kMax) != 0, ((P) & kExp) != 0,            \
                       ((P) & kDiv) != 0>(qb, kb, vb, m, o, groups, heads, gN, C, scale, s);
  switch (parts) {
    ATTN_PARTS_CASE(0) ATTN_PARTS_CASE(1) ATTN_PARTS_CASE(2) ATTN_PARTS_CASE(3)
    ATTN_PARTS_CASE(4) ATTN_PARTS_CASE(5) ATTN_PARTS_CASE(6) ATTN_PARTS_CASE(7)
    ATTN_PARTS_CASE(8) ATTN_PARTS_CASE(9) ATTN_PARTS_CASE(10) ATTN_PARTS_CASE(11)
    ATTN_PARTS_CASE(12) ATTN_PARTS_CASE(13) ATTN_PARTS_CASE(14) ATTN_PARTS_CASE(15)
  }
#undef ATTN_PARTS_CASE
  return (int)cudaErrorInvalidValue;
}

// out = q + v on n bf16 elements, n a multiple of 8
int attn_parts_copy(const void* q, const void* v, void* out, long long n, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || n % 8) return (int)cudaErrorInvalidValue;
  const long long n8 = n / 8;
  const long long blocks = (n8 + kCopyThreads - 1) / kCopyThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  attn_parts_copy_kernel<<<(unsigned)blocks, kCopyThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)v, (bf16*)out, n8);
  return (int)cudaGetLastError();
}

}  // extern "C"
