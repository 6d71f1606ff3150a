// One window-attention template for Hopper (sm_90a): softmax(q k^T + bias) v
// per (window, head) with head width 32 and N <= 224 tokens a window, the
// scores kept in registers from the product to P.V; and, for groups of up
// to 1024 keys, a streamed-key mode (below) that walks the keys twice in
// registers.
//
// Instantiated by three entry points, each replacing a TPU kernel:
//   gcvit_block.cu      `window_attention`: vip_cup_2022_tpu/ops/pallas/
//                       gcvit_block.py::grouped_window_attention (bodies
//                       `_attn_kernel`, `_attn_kernel_perwin`), on
//                       (B, nWin*N, C) tokens, q scaled in f32 and rounded
//                       to bf16, P normalised after P.V by the sum of its
//                       bf16 values, optionally one query per image
//                       (`q_is_global`, a runtime argument);
//   window_attention.cu `window_attention_bhnd`: vip_cup_2022_tpu/ops/pallas/
//                       window_attention.py::window_attention (body
//                       `_attention_kernel`), on contiguous (B*nWin, H, N, 32)
//                       tiles, the f32 scores scaled, P normalised before P.V;
//   attn_parts.cu       `attn_parts`: the experiment tool
//                       tools/exp_attn_parts.py::build (body `_kernel`), K5's
//                       function on groups of g windows with each part of
//                       the softmax removable (Part), in the streamed-key
//                       mode at every group size.
// The register-resident kernel's three compile-time choices are the layout
// (Layout), the q mode (kScaleQ: round the scaled q, else scale the f32
// scores) and the normalisation (kNormAfter: after P.V over the bf16 sums,
// else before).
//
// What bounds it on this card. Per (window, head) it reads q, k, v and
// writes the output once (256 bytes a token) and needs the (N, N) f32 bias
// of its head; at hd = 32 the two products are ~4 N hd FLOPs a token,
// ~10 GFLOP a batch-256 launch, about 10 us at the bf16 peak. So neither
// the tensor cores nor, at N = 196, device memory set the pace, but the
// on-chip path from the scores through the softmax to P.V, and the bias:
// read per (window, head) it is 315 MB through L2 a batch-256 launch at
// N = 49 and at N = 196, against 411 / 103 MB of q, k, v and out. The design:
//   - a warp owns 16 query rows; q k^T is mma.sync m16n8k16 (bf16 in, f32
//     accumulators), so the warp holds its 16 x NP scores as NP/8
//     accumulator tiles: NP/2 f32 registers a thread;
//   - the bias is added in registers and keys j >= N are -inf there;
//   - a row lives in the 4 lanes of a quad: its max and its sum are two
//     __shfl_xor steps, and all 16 rows of the warp are reduced at once;
//   - the exps are rounded to bf16 in registers and two adjacent m16n8
//     accumulator tiles become one m16k16 A fragment of P.V; V comes in
//     through ldmatrix.trans. S and P never touch shared memory;
//   - the key tile NP is a template argument: 64 for N <= 64 (N = 49), 208
//     up to 208 (N = 196), 224 above; a thread holds no slot beyond NP;
//   - a CTA covers every query row of its (window, head): 4 warps at
//     NP = 64, 8 above, each walking the 16-row tiles warp, warp + kWarps,
//     ... (13 tiles over 8 warps at N = 196), so K and V are loaded once
//     per (window, head);
//   - CTAs are persistent: each walks the items blockIdx.x, + gridDim.x, ...
//     with a two-stage cp.async ring of K and V in shared memory (64-byte
//     rows with XOR-swizzled 16-byte chunks, conflict-free for ldmatrix),
//     the next item's K and V in flight while the current one computes; a
//     warp's q fragments come from global memory into registers one row
//     tile ahead;
//   - the grid is a multiple of the head count (or one item a CTA), so a
//     CTA keeps one head for its lifetime: up to NP = 208 it copies that
//     head's bias once into shared memory in fragment order, with the -inf
//     of keys past N baked in, and adds it with one 16-byte load per score
//     tile (173 KB at NP = 208, which is why K and V rows carry no padding).
//     At NP = 224 it does not fit beside the ring and is read from global
//     memory (L2 / L1) in fragment order instead.
// mma.sync rather than wgmma: wgmma's 64-row tiles would spread a row block
// over a warpgroup, and the bias and softmax with it; at hd = 32 the
// products are not what bounds the kernel, and mma.sync keeps each warp's
// 16 rows independent, with no warpgroup barrier between softmax and P.V.
// Registers (-Xptxas -v for sm_90a, no spills): K5 72 / 170 / 176 at NP =
// 64 / 208 / 224, K8 79 / 186 / 194. So at NP = 64 (32 KB of shared memory)
// 7 (K5) or 6 (K8) CTAs of 4 warps fit an SM; at NP = 208 one CTA of 8
// warps (226 KB), 2 warps a scheduler: the L3 softmax has little latency
// hiding, and one item ahead in the ring is all the shared memory allows.
#pragma once

#include "block_gemm.cuh"

namespace window_attn {

using block_gemm::bf16;
using block_gemm::cp_async16;
using block_gemm::cp_async_commit;
using block_gemm::cp_async_wait;

constexpr int kHd = 32;     // head width at every GCViT level
constexpr int kMaxN = 224;  // tokens a window (14 x 14 fits, 16 x 14 is the edge)

// (B, nWin*N, C) token rows with the head's 32 columns at h*32 (q of shape
// (B, N, C) with a global query), or contiguous (B*nWin, H, N, 32) tiles
enum class Layout { kTokens, kHeads };

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* bias;  // (heads, N, N) f32
  bf16* out;
  int items;          // (window, head) pairs: item = window * heads + head
  int heads;
  int n;              // tokens a window
  int nwin;           // windows an image (kTokens with a global query)
  int c;              // row stride of kTokens (heads * 32)
  float scale;
  int q_is_global;
};

__host__ __device__ constexpr int warps_for(int np) { return np <= 64 ? 4 : 8; }
__host__ __device__ constexpr bool bias_in_smem(int np) { return np <= 208; }
__host__ __device__ constexpr int stage_elems(int np) { return 2 * np * kHd; }  // K, V
__host__ __device__ constexpr size_t bias_bytes(int np) {
  return bias_in_smem(np) ? (size_t)np * np * sizeof(float) : 0;
}
__host__ __device__ constexpr size_t smem_bytes(int np) {
  return bias_bytes(np) + 2 * (size_t)stage_elems(np) * sizeof(bf16);
}
static_assert(smem_bytes(208) <= block_gemm::kSmemLimit,
              "NP = 208 must fit one CTA's shared memory");

__host__ __device__ inline int padded_keys(int n) { return (n + 15) / 16 * 16; }

// element offset of chunk c (8 bf16) of row r in a K or V tile: 64-byte
// rows, chunks XOR-swizzled so that 8 consecutive rows hit 8 bank groups
__device__ __forceinline__ int swz(int r, int c) { return r * kHd + ((c ^ ((r >> 1) & 3)) << 3); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// Where one item's rows start and how far apart they are, in elements:
// k / v / out rows, and q rows (the image's query with q_is_global).
template <Layout L>
__device__ __forceinline__ void item_rows(const Params& p, int item, long long& kv,
                                          long long& q, int& stride) {
  const int head = item % p.heads;
  if (L == Layout::kHeads) {
    kv = q = (long long)item * p.n * kHd;
    stride = kHd;
  } else {
    const long long win = item / p.heads;
    const long long qwin = p.q_is_global ? win / p.nwin : win;
    kv = win * p.n * p.c + head * kHd;
    q = qwin * p.n * p.c + head * kHd;
    stride = p.c;
  }
}

// Queue one item's K and V (NP rows, zero past N) into a stage.
template <int NP, Layout L>
__device__ __forceinline__ void load_kv(const Params& p, int item, bf16* st) {
  long long kv, qr;
  int stride;
  item_rows<L>(p, item, kv, qr, stride);
  for (int i = threadIdx.x; i < NP * 4; i += warps_for(NP) * 32) {
    const int r = i >> 2, c = i & 3;
    const bool ok = r < p.n;
    const long long g = kv + (long long)(ok ? r : 0) * stride + c * 8;
    cp_async16(st + swz(r, c), p.k + g, ok);
    cp_async16(st + NP * kHd + swz(r, c), p.v + g, ok);
  }
}

// A warp's q rows [r0, r0 + 16) of one item as two m16k16 A fragments,
// straight from global memory (rows past N clamped: computed, never stored)
template <Layout L>
__device__ __forceinline__ void load_q(const Params& p, int item, int r0, uint32_t (&qa)[2][4]) {
  long long kv, qr;
  int stride;
  item_rows<L>(p, item, kv, qr, stride);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* q0 = p.q + qr + (long long)min(r0 + g, p.n - 1) * stride + t * 2;
  const bf16* q1 = p.q + qr + (long long)min(r0 + g + 8, p.n - 1) * stride + t * 2;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    qa[kk][0] = __ldg(reinterpret_cast<const unsigned*>(q0 + kk * 16));
    qa[kk][1] = __ldg(reinterpret_cast<const unsigned*>(q1 + kk * 16));
    qa[kk][2] = __ldg(reinterpret_cast<const unsigned*>(q0 + kk * 16 + 8));
    qa[kk][3] = __ldg(reinterpret_cast<const unsigned*>(q1 + kk * 16 + 8));
  }
}

// 4-byte cp.async (zero-filled when pred is false): the bias has odd rows
__device__ __forceinline__ void cp_async4(void* smem_ptr, const void* gmem_ptr, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem_ptr)),
               "l"(gmem_ptr), "r"(pred ? 4 : 0));
}

// Queue the CTA's head's bias in fragment order: float4 (rt * NP/8 + nt) *
// 32 + lane holds rows g, g + 8 x keys 2t, 2t + 1 of score tile (rt, nt),
// -inf at keys past N (stored now), 0 at rows past N. The copies are
// asynchronous (up to 43 K of them at N = 196), so they join the caller's
// next cp.async group instead of costing one L2 round trip each.
template <int NP>
__device__ __forceinline__ void fill_bias(const Params& p, int head, float* bs) {
  constexpr int kTiles = NP / 8;
  const int n = p.n;
  const float* bh = p.bias + (long long)head * n * n;
  const int count = (n + 15) / 16 * kTiles * 128;
  for (int idx = threadIdx.x; idx < count; idx += warps_for(NP) * 32) {
    const int e = idx & 3, ln = (idx >> 2) & 31, tile = idx >> 7;
    const int i = (tile / kTiles) * 16 + (ln >> 2) + (e >> 1) * 8;
    const int j = (tile % kTiles) * 8 + (ln & 3) * 2 + (e & 1);
    if (j >= n)
      bs[idx] = -INFINITY;
    else
      cp_async4(bs + idx, bh + (long long)(i < n ? i : 0) * n + j, i < n);
  }
}

// A phase cut's output: x in both of this thread's rows, so that the cut
// phase and everything before it stay in the compiled kernel.
__device__ __forceinline__ void store_cut(const Params& p, long long kv, int stride, int i0,
                                          float x) {
  const int t = threadIdx.x & 3;
  if (i0 < p.n) *reinterpret_cast<uint32_t*>(p.out + kv + (long long)i0 * stride + t * 2) =
      pack_bf16(x, x);
  if (i0 + 8 < p.n) *reinterpret_cast<uint32_t*>(p.out + kv + (long long)(i0 + 8) * stride + t * 2) =
      pack_bf16(x, x);
}

// One warp: query rows [rt*16, rt*16 + 16) of one item, from q fragments and
// the staged K, V to the output rows.
template <int NP, bool kScaleQ, bool kNormAfter, Layout L, int kCut>
__device__ __forceinline__ void attend_rows(const Params& p, int item, int rt, uint32_t (&qa)[2][4],
                                            const bf16* st, const float4* bias_s) {
  constexpr int kTiles = NP / 8;  // m16n8 score tiles a warp holds
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // a fragment's row in the 8-row group, its quad lane
  const int n = p.n;
  const bf16* Ks = st;
  const bf16* Vs = st + NP * kHd;
  long long kv, qr;
  int stride;
  item_rows<L>(p, item, kv, qr, stride);

  if (kScaleQ) {  // K5: q * hd^-1/2 in f32, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16(qa[kk][e]);
        qa[kk][e] = pack_bf16(f.x * p.scale, f.y * p.scale);
      }
  }

  const int i0 = rt * 16 + g, i1 = i0 + 8;
  if (kCut == 1) {  // the loads: K, V and the bias staged, q in registers
    uint32_t x = 0;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) x ^= qa[kk][e];
    store_cut(p, kv, stride, i0, __uint_as_float(x & 0x3f7fffffu));
    return;
  }

  // S (16 x NP) = Q K^T in registers
  float s[kTiles][4];
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    uint32_t kb[4];
    ldsm_x4(kb, Ks + swz(nt * 8 + (lane & 7), lane >> 3));
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    mma16816(s[nt], qa[0], kb[0], kb[1]);
    mma16816(s[nt], qa[1], kb[2], kb[3]);
  }
  // (* scale) + bias; keys past N at -inf
  const float f = kScaleQ ? 1.f : p.scale;
  if (bias_in_smem(NP)) {
    const float4* bt = bias_s + rt * kTiles * 32 + lane;
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      const float4 b = bt[nt * 32];
      s[nt][0] = s[nt][0] * f + b.x;
      s[nt][1] = s[nt][1] * f + b.y;
      s[nt][2] = s[nt][2] * f + b.z;
      s[nt][3] = s[nt][3] * f + b.w;
    }
  } else {
    const long long head_rows = (long long)(item % p.heads) * n;
    const float* b0 = p.bias + (head_rows + min(i0, n - 1)) * n;
    const float* b1 = p.bias + (head_rows + min(i1, n - 1)) * n;
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + t * 2 + e;
        s[nt][e] = j < n ? s[nt][e] * f + __ldg(b0 + j) : -INFINITY;
        s[nt][2 + e] = j < n ? s[nt][2 + e] * f + __ldg(b1 + j) : -INFINITY;
      }
    }
  }

  if (kCut == 2) {  // + the scores: q k^T, scale and bias
    float x = 0.f;
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
      x += fmaxf(fmaxf(s[nt][0], s[nt][1]), fmaxf(s[nt][2], s[nt][3]));
    store_cut(p, kv, stride, i0, x);
    return;
  }

  // row max and exps; a row is spread over the 4 lanes of a quad
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) {
    m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
    m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
  // P as m16k16 A fragments: accumulator tiles 2kk and 2kk + 1 are the
  // k-halves of k-step kk
  uint32_t pa[NP / 16][4];
  float l0 = 0.f, l1 = 0.f;
  if (kNormAfter) {  // bf16 exps into P; the sums are of the rounded values
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      const uint32_t lo = pack_bf16(__expf(s[nt][0] - m0), __expf(s[nt][1] - m0));
      const uint32_t hi = pack_bf16(__expf(s[nt][2] - m1), __expf(s[nt][3] - m1));
      const float2 flo = unpack_bf16(lo), fhi = unpack_bf16(hi);
      l0 += flo.x + flo.y;
      l1 += fhi.x + fhi.y;
      pa[nt >> 1][(nt & 1) * 2] = lo;
      pa[nt >> 1][(nt & 1) * 2 + 1] = hi;
    }
  } else {  // f32 exps, normalised, then rounded into P
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      s[nt][0] = __expf(s[nt][0] - m0);
      s[nt][1] = __expf(s[nt][1] - m0);
      s[nt][2] = __expf(s[nt][2] - m1);
      s[nt][3] = __expf(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  if (!kNormAfter) {
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(s[nt][0] * inv0, s[nt][1] * inv0);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(s[nt][2] * inv1, s[nt][3] * inv1);
    }
  }

  if (kCut == 3) {  // + the softmax: max, exps, sums, P packed
    uint32_t x = 0;
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) x ^= pa[kk][e];
    store_cut(p, kv, stride, i0, __uint_as_float(x & 0x3f7fffffu) + inv0 + inv1);
    return;
  }

  // O (16 x 32) = P V, V's k16 x n8 fragments through ldmatrix.trans
  float o[4][4];
#pragma unroll
  for (int d = 0; d < 4; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk) {
#pragma unroll
    for (int d2 = 0; d2 < 2; ++d2) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, Vs + swz(kk * 16 + (lane & 15), d2 * 2 + (lane >> 4)));
      mma16816(o[2 * d2], pa[kk], vb[0], vb[1]);
      mma16816(o[2 * d2 + 1], pa[kk], vb[2], vb[3]);
    }
  }
  const float f0 = kNormAfter ? inv0 : 1.f, f1 = kNormAfter ? inv1 : 1.f;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int col = d * 8 + t * 2;
    if (i0 < n)
      *reinterpret_cast<uint32_t*>(p.out + kv + (long long)i0 * stride + col) =
          pack_bf16(o[d][0] * f0, o[d][1] * f0);
    if (i1 < n)
      *reinterpret_cast<uint32_t*>(p.out + kv + (long long)i1 * stride + col) =
          pack_bf16(o[d][2] * f1, o[d][3] * f1);
  }
}

// Persistent CTAs over (window, head) items with a two-stage cp.async ring
// of K and V; every item of a CTA has the head blockIdx.x % heads (the
// launcher makes gridDim.x a multiple of heads or gives a CTA one item).
template <int NP, bool kScaleQ, bool kNormAfter, Layout L, int kCut>
__global__ void __launch_bounds__(warps_for(NP) * 32)
window_attention_kernel(const Params p) {
  constexpr int kWarps = warps_for(NP);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* bias_s = reinterpret_cast<float*>(smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + bias_bytes(NP));
  const int warp = threadIdx.x >> 5;
  const int row_tiles = (p.n + 15) / 16;
  int item = blockIdx.x;
  if (item >= p.items) return;
  load_kv<NP, L>(p, item, ring);
  if (bias_in_smem(NP)) fill_bias<NP>(p, item % p.heads, bias_s);  // lands with the first item
  cp_async_commit();
  uint32_t qn[2][4];  // the warp's next q tile
  if (warp < row_tiles) load_q<L>(p, item, warp * 16, qn);
  for (int it = 0; item < p.items; ++it, item += gridDim.x) {
    const int next = item + gridDim.x;
    if (next < p.items) load_kv<NP, L>(p, next, ring + ((it + 1) & 1) * stage_elems(NP));
    cp_async_commit();
    cp_async_wait<1>();  // this item's K and V have landed; the next ones stay in flight
    __syncthreads();
    const bf16* st = ring + (it & 1) * stage_elems(NP);
    for (int rt = warp; rt < row_tiles; rt += kWarps) {
      uint32_t qa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[kk][e] = qn[kk][e];
      if (rt + kWarps < row_tiles)
        load_q<L>(p, item, (rt + kWarps) * 16, qn);
      else if (next < p.items)
        load_q<L>(p, next, warp * 16, qn);
      attend_rows<NP, kScaleQ, kNormAfter, L, kCut>(p, item, rt, qa, st,
                                              reinterpret_cast<const float4*>(bias_s));
    }
    __syncthreads();  // the stage is free for the item after next
  }
}

// CTAs that fit on the card at once for one instantiation, cached per device.
struct GridCache {
  std::mutex mu;
  int ctas[block_gemm::kMaxDevices] = {};
};

inline cudaError_t resident_ctas(const void* kernel, int threads, size_t smem, GridCache& cache,
                                 int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= block_gemm::kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(cache.mu);
  if (cache.ctas[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    cache.ctas[dev] = per_sm * sms;
  }
  *out = cache.ctas[dev];
  return cudaSuccess;
}

template <int NP, bool kScaleQ, bool kNormAfter, Layout L, int kCut>
cudaError_t launch_np(const Params& p, cudaStream_t stream) {
  static block_gemm::SmemGrant grant;
  static GridCache cache;
  const void* kernel = (const void*)window_attention_kernel<NP, kScaleQ, kNormAfter, L, kCut>;
  constexpr int threads = warps_for(NP) * 32;
  constexpr size_t smem = smem_bytes(NP);
  cudaError_t err = block_gemm::grant_smem(kernel, smem, grant);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  err = resident_ctas(kernel, threads, smem, cache, &ctas);
  if (err != cudaSuccess) return err;
  // a multiple of the head count, so that a CTA keeps one head
  ctas = ctas < p.heads ? p.heads : ctas - ctas % p.heads;
  const int grid = p.items < ctas ? p.items : ctas;
  window_attention_kernel<NP, kScaleQ, kNormAfter, L, kCut><<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// N -> the key tile: 64, 208 or 224
template <bool kScaleQ, bool kNormAfter, Layout L, int kCut = 0>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.items == 0) return cudaSuccess;
  if (p.n <= 0 || p.n > kMaxN || p.heads <= 0 || p.items % p.heads)
    return cudaErrorInvalidValue;
  const int np = padded_keys(p.n);
  if (np <= 64) return launch_np<64, kScaleQ, kNormAfter, L, kCut>(p, stream);
  if (np <= 208) return launch_np<208, kScaleQ, kNormAfter, L, kCut>(p, stream);
  return launch_np<224, kScaleQ, kNormAfter, L, kCut>(p, stream);
}

// ---------------------------------------------------------------------------
// The streamed-key mode (attn_parts): groups of g windows, gN = g N tokens up
// to kMaxStreamN, whose 16 x NP scores a warp cannot hold in registers (NP =
// 400 at gN = 392 would be 200 registers a thread). A warp keeps its 16 query
// rows and walks the keys 16 at a time, twice: pass 1 takes the row max of
// the (biased) scores, pass 2 computes each 16-key tile again, subtracts the
// final max, exps, rounds P to bf16, sums the bf16 values and multiplies P V
// (the two m16n8 accumulator tiles become one m16k16 A fragment; V through
// ldmatrix.trans; the row sums as P times a tile of ones). S and P stay in
// registers; recomputing q k^T at hd = 32 is cheap beside the softmax. The
// exps, the rounding of P and its packing are the per-score work left on
// the SFUs and the CUDA cores; the bias rides in as the products'
// accumulator. Each removed part (kParts) drops its step; without the max
// there is no pass 1.
//
// Schedule: a CTA keeps one (head, stripe of `tiles` x 16 query rows) for its
// lifetime, each row tile's keys split over `splits` warps (so that enough
// warps hide the latencies of the products and the softmax; the splits
// combine their row maxima and their sums through shared memory), and walks
// the groups blockIdx.x / combos, + gridDim.x / combos, ... (combos = heads x
// stripes), so the CTAs of one group's stripes run at about the same time
// and share its K and V through L2. It copies its stripe of the head's bias once, in
// fragment order with -inf at keys past gN, and adds it with one 16-byte
// shared-memory load per score tile and pass: the bias is read from device
// memory once per CTA, not per (group, head). K and V come through a
// cp.async ring of `stages` (2, or 1 where two do not fit beside the bias),
// the next group's in flight while this one computes.
// ---------------------------------------------------------------------------
constexpr int kMaxStreamN = 1024;  // keys a group may have
constexpr int kMaxStripeTiles = 8;
constexpr int kMaxStreamWarps = 16;  // tiles x splits

// The parts of the softmax (attn_parts prices each by removing it): the bias
// add, the row-max subtraction, the exp and the division by the row sum; a
// removed part makes the output wrong on purpose.
enum Part : int { kBias = 1, kMax = 2, kExp = 4, kDiv = 8, kAllParts = 15 };

struct StreamParams {
  Params p;     // items = groups * heads, n = gN, layout kTokens
  int np;       // keys padded to 16
  int tiles;    // 16-row tiles a stripe
  int splits;   // warps a tile's keys are split over: the CTA has tiles x splits warps
  int stripes;  // stripes a (group, head)
  int stages;   // K and V stages of the ring: 1 or 2
};

__host__ __device__ inline size_t stripe_bias_bytes(int tiles, int np) {
  return (size_t)tiles * (np / 8) * 32 * sizeof(float4);
}
__host__ __device__ inline size_t stream_stage_bytes(int np) {
  return 2 * (size_t)np * kHd * sizeof(bf16);
}
// the stripe's bias, the ring, and the splits' row maxima (16 rows each)
__host__ __device__ inline size_t stream_smem_bytes(int tiles, int splits, int np, int stages) {
  return stripe_bias_bytes(tiles, np) + stages * stream_stage_bytes(np) +
         (size_t)tiles * splits * 16 * sizeof(float);
}

// Queue one item's K and V (np rows, zero past gN) into a stage.
__device__ __forceinline__ void load_kv_streamed(const Params& p, int item, bf16* st, int np) {
  long long kv, qr;
  int stride;
  item_rows<Layout::kTokens>(p, item, kv, qr, stride);
  for (int i = threadIdx.x; i < np * 4; i += blockDim.x) {
    const int r = i >> 2, c = i & 3;
    const bool ok = r < p.n;
    const long long g = kv + (long long)(ok ? r : 0) * stride + c * 8;
    cp_async16(st + swz(r, c), p.k + g, ok);
    cp_async16(st + np * kHd + swz(r, c), p.v + g, ok);
  }
}

// Queue the stripe's rows of the head's bias in fragment order: float4
// (tile * np/8 + nt) * 32 + lane holds rows g, g + 8 x keys 2t, 2t + 1 of
// score tile nt of the stripe's tile `tile`; -inf at keys past gN, 0 at
// rows past gN.
__device__ __forceinline__ void fill_stripe_bias(const Params& p, int head, int row0, int tiles,
                                                 int np, float* bs) {
  const int n = p.n, kt = np / 8;
  const float* bh = p.bias + (long long)head * n * n;
  const int count = tiles * kt * 128;
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
    const int e = idx & 3, ln = (idx >> 2) & 31, tile = idx >> 7;
    const int i = row0 + (tile / kt) * 16 + (ln >> 2) + (e >> 1) * 8;
    const int j = (tile % kt) * 8 + (ln & 3) * 2 + (e & 1);
    if (j >= n)
      bs[idx] = -INFINITY;
    else
      cp_async4(bs + idx, bh + (long long)(i < n ? i : 0) * n + j, i < n);
  }
}

// The scores of keys [16c, 16c + 16) for the warp's rows: two m16n8 tiles,
// keys past gN at -inf. The bias (-inf baked in past gN) is the products'
// accumulator input, so its add costs no instruction.
template <int kParts>
__device__ __forceinline__ void stream_scores(float (&s)[2][4], const uint32_t (&qa)[2][4],
                                              const bf16* Ks, const float4* bias_w, int c,
                                              bool edge, int n, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int nt = 2 * c + h;
    uint32_t kb[4];
    ldsm_x4(kb, Ks + swz(nt * 8 + (lane & 7), lane >> 3));
    if constexpr ((kParts & kBias) != 0) {
      const float4 b = bias_w[nt * 32 + lane];
      s[h][0] = b.x;
      s[h][1] = b.y;
      s[h][2] = b.z;
      s[h][3] = b.w;
    } else {
      s[h][0] = s[h][1] = s[h][2] = s[h][3] = 0.f;
    }
    mma16816(s[h], qa[0], kb[0], kb[1]);
    mma16816(s[h], qa[1], kb[2], kb[3]);
    if constexpr ((kParts & kBias) == 0) {
      if (edge) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (nt * 8 + (lane & 3) * 2 + (e & 1) >= n) s[h][e] = -INFINITY;
      }
    }
  }
}

// A key's probability before rounding without the exp: the shifted score
// itself, 0 at keys past gN (their score is -inf)
__device__ __forceinline__ float shifted_score(float s, float m) {
  return s == -INFINITY ? 0.f : s - m;
}

// 2^x (MUFU.EX2, as __expf's)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The streamed mode's probability before rounding: exp(s - m) as 2^(s log2e -
// m log2e), one FFMA and the SFU's 2^x; without the exp the shifted score
template <int kParts>
__device__ __forceinline__ float stream_p(float s, float m_log2e, float m) {
  if constexpr ((kParts & kExp) != 0) return ex2_approx(fmaf(s, 1.4426950408889634f, -m_log2e));
  else return shifted_score(s, m);
}

// Pass 1 of one warp over key chunks [c0, c1): the row max of its 16 rows,
// reduced over the quad that holds a row
template <int kParts>
__device__ __forceinline__ void stream_max(const uint32_t (&qa)[2][4], const bf16* Ks,
                                           const float4* bias_w, int c0, int c1, int chunks,
                                           int n, int lane, float& m0, float& m1) {
  m0 = m1 = -INFINITY;
#pragma unroll 2
  for (int c = c0; c < c1; ++c) {
    float s[2][4];
    stream_scores<kParts>(s, qa, Ks, bias_w, c, c == chunks - 1, n, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m0 = fmaxf(m0, fmaxf(s[h][0], s[h][1]));
      m1 = fmaxf(m1, fmaxf(s[h][2], s[h][3]));
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }
}

// Pass 2 of one warp over key chunks [c0, c1): P = bf16([exp]([s - max])) a
// 16-key tile at a time, o += P V, and the row sums l of the bf16 P as the
// product of P with a tile of ones (the TPU kernel's P [V | 1]): the sums
// of a row's rounded values, f32 accumulation, whole rows in every lane of
// its quad, no CUDA-core work. kCut 3 leaves out P V.
template <int kParts, int kCut>
__device__ __forceinline__ void stream_pv(const uint32_t (&qa)[2][4], const bf16* Ks,
                                          const bf16* Vs, const float4* bias_w, int c0, int c1,
                                          int chunks, int n, int lane, float m0, float m1,
                                          float (&o)[4][4], float& l0, float& l1) {
  constexpr uint32_t kOnes = 0x3f803f80u;  // two bf16 1.0
  float l[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int d = 0; d < 4; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  const float ml0 = m0 * 1.4426950408889634f, ml1 = m1 * 1.4426950408889634f;
#pragma unroll 2
  for (int c = c0; c < c1; ++c) {
    float s[2][4];
    stream_scores<kParts>(s, qa, Ks, bias_w, c, c == chunks - 1, n, lane);
    uint32_t pa[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pa[2 * h] =
          pack_bf16(stream_p<kParts>(s[h][0], ml0, m0), stream_p<kParts>(s[h][1], ml0, m0));
      pa[2 * h + 1] =
          pack_bf16(stream_p<kParts>(s[h][2], ml1, m1), stream_p<kParts>(s[h][3], ml1, m1));
    }
    mma16816(l, pa, kOnes, kOnes);
    if (kCut == 3) {  // no P V: keep P live
      o[0][0] += __uint_as_float((pa[0] ^ pa[1] ^ pa[2] ^ pa[3]) & 0x3f7fffffu);
      continue;
    }
#pragma unroll
    for (int d2 = 0; d2 < 2; ++d2) {
      uint32_t vb[4];
      ldsm_x4_trans(vb, Vs + swz(c * 16 + (lane & 15), d2 * 2 + (lane >> 4)));
      mma16816(o[2 * d2], pa, vb[0], vb[1]);
      mma16816(o[2 * d2 + 1], pa, vb[2], vb[3]);
    }
  }
  l0 = l[0];
  l1 = l[2];
}

// Persistent CTAs, each one (head, stripe) walking the groups (see above).
// Warp w takes row tile w % tiles of the stripe and key split w / tiles: the
// chunks [split * chunks / splits, (split + 1) * chunks / splits). The
// splits of a row tile meet twice in shared memory: their row maxima after
// pass 1 (red_m), and their o and l after pass 2, which splits 1 ... S - 1
// leave in the item's K and V stage (all its reads are done by then) for
// split 0 to add up, divide and store. kCut stops after a phase for timing
// (the output then holds checksums, not attention): 1 the loads, 2 + pass 1
// (the row max), 3 + pass 2 without P V.
template <int kParts, int kCut>
__global__ void __launch_bounds__(kMaxStreamWarps * 32, 1)
streamed_attention_kernel(const StreamParams sp) {
  const Params& p = sp.p;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int np = sp.np, kt = np / 8, chunks = np / 16, T = sp.tiles, S = sp.splits;
  float4* bias_s = reinterpret_cast<float4*>(smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + stripe_bias_bytes(T, np));
  float* red_m = reinterpret_cast<float*>(smem_raw + stripe_bias_bytes(T, np) +
                                          sp.stages * stream_stage_bytes(np));
  const int stage = np * kHd * 2;  // elements of a stage: K and V
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = warp % T, split = warp / T;
  const int c0 = split * chunks / S, c1 = (split + 1) * chunks / S;
  const int combos = p.heads * sp.stripes, groups = p.items / p.heads;
  const int combo = blockIdx.x % combos, step = gridDim.x / combos;
  const int head = combo % p.heads, stripe = combo / p.heads;
  int grp = blockIdx.x / combos;
  if (grp >= groups) return;
  const int rt = stripe * T + tile;  // this warp's row tile
  const bool live = rt * 16 < p.n;
  const float4* bias_w = bias_s + tile * kt * 32;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = rt * 16 + g, i1 = i0 + 8;
  load_kv_streamed(p, grp * p.heads + head, ring, np);
  fill_stripe_bias(p, head, stripe * T * 16, T, np,
                   reinterpret_cast<float*>(bias_s));  // lands with the first item
  cp_async_commit();
  uint32_t qn[2][4];  // the warp's q tile of the next group
  if (live) load_q<Layout::kTokens>(p, grp * p.heads + head, rt * 16, qn);
  for (int it = 0; grp < groups; ++it, grp += step) {
    const int item = grp * p.heads + head, next = grp + step;
    if (sp.stages == 2) {
      if (next < groups)
        load_kv_streamed(p, next * p.heads + head, ring + ((it + 1) & 1) * stage, np);
      cp_async_commit();
      cp_async_wait<1>();  // this group's K and V have landed; the next ones stay in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    bf16* st = ring + (sp.stages == 2 ? (it & 1) * stage : 0);
    const bf16* Ks = st;
    const bf16* Vs = st + np * kHd;
    long long kv, qr;
    int stride;
    item_rows<Layout::kTokens>(p, item, kv, qr, stride);
    uint32_t qa[2][4];
    if (live) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[kk][e] = qn[kk][e];
      if (next < groups) load_q<Layout::kTokens>(p, next * p.heads + head, rt * 16, qn);
    }
    if (kCut == 1) {  // the loads: K, V and the bias staged, q in registers
      if (live) {
        uint32_t x = 0;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) x ^= qa[kk][e];
        store_cut(p, kv, stride, i0, __uint_as_float(x & 0x3f7fffffu));
      }
      __syncthreads();
      continue;
    }
    if (live) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)  // q * hd^-1/2 in f32, rounded to bf16
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack_bf16(qa[kk][e]);
          qa[kk][e] = pack_bf16(f.x * p.scale, f.y * p.scale);
        }
    }
    float m0 = 0.f, m1 = 0.f;
    if constexpr ((kParts & kMax) != 0) {
      if (live) stream_max<kParts>(qa, Ks, bias_w, c0, c1, chunks, p.n, lane, m0, m1);
      if (S > 1) {  // the row max over the splits
        if (live && t == 0) {
          red_m[(tile * S + split) * 16 + g] = m0;
          red_m[(tile * S + split) * 16 + g + 8] = m1;
        }
        __syncthreads();
        if (live)
          for (int j = 0; j < S; ++j) {
            m0 = fmaxf(m0, red_m[(tile * S + j) * 16 + g]);
            m1 = fmaxf(m1, red_m[(tile * S + j) * 16 + g + 8]);
          }
      }
    }
    if (kCut == 2) {  // + pass 1: the scores and the row max
      if (live) store_cut(p, kv, stride, i0, m0 + m1);
      __syncthreads();
      continue;
    }
    float o[4][4], l0 = 0.f, l1 = 0.f;
    if (live) stream_pv<kParts, kCut>(qa, Ks, Vs, bias_w, c0, c1, chunks, p.n, lane, m0, m1, o,
                                      l0, l1);
    if (S > 1) {  // splits 1 ... S - 1 hand o and l to split 0 through the stage
      float* red = reinterpret_cast<float*>(st);
      __syncthreads();  // every read of the stage is done
      if (live && split > 0) {
        float* slot = red + ((tile * (S - 1) + split - 1) * 32 + lane) * 18;
#pragma unroll
        for (int d = 0; d < 4; ++d)
#pragma unroll
          for (int e = 0; e < 4; ++e) slot[d * 4 + e] = o[d][e];
        slot[16] = l0;
        slot[17] = l1;
      }
      __syncthreads();
      if (live && split == 0)
        for (int j = 1; j < S; ++j) {
          const float* slot = red + ((tile * (S - 1) + j - 1) * 32 + lane) * 18;
#pragma unroll
          for (int d = 0; d < 4; ++d)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[d][e] += slot[d * 4 + e];
          l0 += slot[16];
          l1 += slot[17];
        }
    }
    if (live && split == 0) {
      if (kCut == 3) {
        store_cut(p, kv, stride, i0, o[0][0] + l0 + l1);
      } else {
        float f0 = 1.f, f1 = 1.f;
        if constexpr ((kParts & kDiv) != 0) {  // l: the whole row's sum in every lane
          f0 = 1.f / l0;
          f1 = 1.f / l1;
        }
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const int col = d * 8 + t * 2;
          if (i0 < p.n)
            *reinterpret_cast<uint32_t*>(p.out + kv + (long long)i0 * stride + col) =
                pack_bf16(o[d][0] * f0, o[d][1] * f0);
          if (i1 < p.n)
            *reinterpret_cast<uint32_t*>(p.out + kv + (long long)i1 * stride + col) =
                pack_bf16(o[d][2] * f1, o[d][3] * f1);
        }
      }
    }
    __syncthreads();  // the stage is free for the group after next
    if (sp.stages == 1 && next < groups) {
      load_kv_streamed(p, next * p.heads + head, ring, np);
      cp_async_commit();
    }
  }
}

// The plan (np, tiles, splits, stripes, stages) comes from the caller
// (ops/kernels/attn_parts.py: stripe_plan) and is checked here; the grid is
// as many CTAs as fit the card at once, a multiple of heads x stripes, and
// no more than one for each (group, head, stripe).
template <int kParts, int kCut = 0>
cudaError_t launch_streamed(const StreamParams& sp, cudaStream_t stream) {
  static block_gemm::SmemGrant grant;
  const Params& p = sp.p;
  if (p.items == 0) return cudaSuccess;
  if (p.n <= 0 || p.n > kMaxStreamN || p.heads <= 0 || p.items % p.heads ||
      sp.np != padded_keys(p.n) || sp.tiles < 1 || sp.tiles > kMaxStripeTiles ||
      sp.splits < 1 || sp.tiles * sp.splits > kMaxStreamWarps || sp.splits > sp.np / 16 ||
      sp.stripes < 1 || sp.stripes * sp.tiles * 16 < p.n ||
      (sp.stripes - 1) * sp.tiles * 16 >= p.n ||
      sp.stages < 1 || sp.stages > 2)
    return cudaErrorInvalidValue;
  // the splits' o and l (18 floats a lane) must fit the stage they are handed over in
  if ((size_t)(sp.splits - 1) * sp.tiles * 32 * 18 * sizeof(float) > stream_stage_bytes(sp.np))
    return cudaErrorInvalidValue;
  const size_t smem = stream_smem_bytes(sp.tiles, sp.splits, sp.np, sp.stages);
  if (smem > block_gemm::kSmemLimit) return cudaErrorInvalidValue;
  const void* kernel = (const void*)streamed_attention_kernel<kParts, kCut>;
  cudaError_t err = block_gemm::grant_smem(kernel, smem, grant);
  if (err != cudaSuccess) return err;
  int dev = 0, per_sm = 0, sms = 0;
  const int threads = sp.tiles * sp.splits * 32;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  const long long combos = (long long)p.heads * sp.stripes, groups = p.items / p.heads;
  long long per_combo = (long long)per_sm * sms / combos;
  per_combo = per_combo < 1 ? 1 : per_combo > groups ? groups : per_combo;
  if (combos * per_combo > 0x7fffffffLL) return cudaErrorInvalidValue;
  streamed_attention_kernel<kParts, kCut>
      <<<(unsigned)(combos * per_combo), threads, smem, stream>>>(sp);
  return cudaGetLastError();
}

// out = q + v on n bf16 values, 8 (16 bytes) a thread: attn_parts' `empty`
// variant (tools/exp_attn_parts.py's `_copy_kernel`), the floor of the
// launch and its bytes that the other variants are read against
constexpr int kAddThreads = 256;

__global__ void __launch_bounds__(kAddThreads)
add_kernel(const bf16* __restrict__ q, const bf16* __restrict__ v, bf16* __restrict__ out,
           long long n8) {
  const long long i = (long long)blockIdx.x * kAddThreads + threadIdx.x;
  if (i >= n8) return;
  float a[8], b[8];
  block_gemm::load8(q + i * 8, a);
  block_gemm::load8(v + i * 8, b);
#pragma unroll
  for (int e = 0; e < 8; ++e) a[e] += b[e];
  block_gemm::store8(out + i * 8, a);
}

inline cudaError_t launch_add(const bf16* q, const bf16* v, bf16* out, long long n,
                              cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || n % 8) return cudaErrorInvalidValue;
  const long long blocks = (n / 8 + kAddThreads - 1) / kAddThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  add_kernel<<<(unsigned)blocks, kAddThreads, 0, stream>>>(q, v, out, n / 8);
  return cudaGetLastError();
}

}  // namespace window_attn
