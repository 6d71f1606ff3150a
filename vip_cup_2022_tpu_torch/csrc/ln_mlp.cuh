// The LN-MLP kernel template of ln_mlp.cu's entry points (and of the phase
// cuts, ln_mlp_cuts.cu): LN -> MLP -> layer scale -> residual in one pass,
// for Hopper (sm_90a).
//
//   out = residual + gamma * (fc2(gelu(fc1(LN(x)) + b1)) + b2)
//
// on M rows of C channels, with the (M, hidden) hidden kept on chip, in three
// memory layouts of x, residual and out (bf16 all three):
//
//   rows        (M, C) row-major                 element (r, c) at r*C + c
//   batchlane   (P = H*W, C, B)                   element (r, c) at
//               r = p*B + b                       (r/B)*C*B + c*B + r%B
//   chanfirst   (C, N = H*W*B)                   element (r, c) at c*N + r
//
// Replaces three TPU kernels of one function, which differ only in the
// TPU's layout: `fused_ln_mlp_residual` (body `_lnmlp_kernel`) of
// vip_cup_2022_tpu/ops/pallas/convnext_block.py (rows), and the experiment
// tool's `lnmlp_batchlane` (`_lnmlp_bl_kernel`) and `lnmlp_chanfirst`
// (`_lnmlp_cf_kernel`) of tools/exp_convnext_s12.py.
//
// What bounds it on the card: 4 M C hidden bf16 tensor-core operations
// against 6 M C bytes of activations (at ConvNeXt's s1-s4 both near 0.4 ms
// at batch 256). As built, at s1 and s2 the exact GELU of every hidden
// element on the CUDA cores (~30 instructions each: ~1 ms at s1) and the
// latency of the per-chunk products; at s3 and s4 the shared-memory port,
// which carries both the weights' TMA stream (16 C^2 bytes a 64-row tile
// where hidden = 4 C) and the wgmma operands (PERF.md: the phase cuts). It
// runs on hopper_gemm.cuh's engine:
//
// - A persistent CTA of four consumer warpgroups and a producer warpgroup
//   (setmaxnreg 24 / 112) walks items of RH x 64 rows x CN output columns.
//   At C <= 256 (RH = 2) the consumers are two groups of two warpgroups,
//   each with its own 64 rows, A tile, hidden tiles and barrier, that
//   multiply the same weight stages: the weights cross from L2 once per 128
//   rows, and one group's GELU or LN can run beside the other's products.
//   Above (RH = 1) the four share one 64-row tile, as fc2's f32
//   accumulators need all four; CN = C, or C / 2 at C = 768, where 64 x 768
//   would not fit the register file (the two halves then compute fc1 each).
// - Loads: two producer threads, one a ring, stream W1 (hidden, C) and W2
//   (C, hidden) by TMA under full / empty mbarriers, each in the order the
//   consumers multiply: per hidden chunk of HN, fc1's C / 64 K tiles (HN
//   rows x 128 bytes, 128-byte swizzle, zeros past C), then fc2's HN / 64 K
//   tiles of CN rows (in boxes of at most 256 rows). Every consumer warp
//   releases every stage.
// - LN: a group copies its x tile into its swizzled A tile (rows: 16 bytes
//   of a row a thread; the strided layouts: 16 bytes of 8 rows of one
//   channel along r where 8 rows are contiguous, into a swizzled staging
//   tile that ldmatrix.trans / stmatrix transpose into A), then each warp
//   normalises its rows in place, a power-of-two lane group a row and all
//   its rows in flight together, two-pass f32 statistics from registers,
//   rounded to bf16 (fence.proxy.async before the barrier that publishes).
// - Per hidden chunk: fc1 chunk = A W1[chunk]^T by wgmma (HW of the chunk's
//   columns a warpgroup: 64 where the accumulators allow, so each wgmma
//   wait covers more products), + b1 and the engine's branch-free erf GELU
//   in the accumulators' registers, bf16 into one of the group's two
//   swizzled hidden tiles, the group's barrier; then fc2 += hidden
//   W2[:, chunk]^T by wgmma, each warpgroup its CN / WG columns,
//   accumulated in registers over all the chunks. With two hidden tiles,
//   chunk j + 1's GELU never overwrites the tile fc2 of chunk j reads: a
//   warpgroup reaches the barrier of chunk j + 1 only after its fc1 of chunk
//   j + 1 has waited for every earlier product.
// - Epilogue: (acc + b2) gamma in f32 through a staging tile in the group's
//   hidden tiles (rows: swizzled, a thread then holds 8 consecutive columns
//   of a row; strided: column-major, 8 consecutive rows of a channel), +
//   the residual in f32, one rounding to bf16, 16-byte stores.
//
// Tried on the H100 and dropped (PERF.md keeps the numbers): four
// warpgroups on one 64-row tile at every C (the weights' stream 1.6x as
// long at s1); two CTAs an SM of two warpgroups; each weight tile
// multicast by TMA to a cluster of two CTAs (the stream 4-5x slower: every
// stage waits for the slower CTA's release); the two groups taking turns
// to issue their products (the stream then follows the turns).
//
// The plan (ops/kernels/ln_mlp.py: ln_mlp_plan: row groups, the C split,
// ring depths) comes from Python; the launcher checks it.
//
// kCut makes phase-cut instantiations for timing (csrc/ln_mlp_cuts.cu):
// kLoads (the weights' stream and the x tile's copy), kLn (+ the LN),
// kProducts (+ fc1 and fc2, the hidden stored raw), kGelu (+ b1 and the
// GELU), kWhole (+ the residual epilogue: the kernel itself).
#pragma once

#include "hopper_gemm.cuh"

namespace ln_mlp {

using namespace hopper_gemm;

enum Layout { kRowsLayout = 0, kBatchLane = 1, kChanFirst = 2 };

constexpr int kTM = 64;                      // rows of a group's tile
constexpr int kTileBytes = kTM * kRowBytes;  // a 64-row K tile: 8 KB
constexpr int kStageBytes = kTM * 32 * 4;    // a warpgroup's f32 epilogue staging: 8 KB
constexpr int kRing1Thread = kConsumers * kWarpgroup;       // the producers: warp 0 of the
constexpr int kRing2Thread = kConsumers * kWarpgroup + 32;  // producer warpgroup, and warp 1
constexpr int kGroupBar = 1;                 // named barriers 1, 2: the groups'
constexpr int kStageBar = 3;                 // 3 ... 6: each warpgroup's epilogue staging

enum Cut : int {
  kLoads = 0,     // the weights' stream and the x tile's copy only
  kLn = 1,        // + the LN in place
  kProducts = 2,  // + fc1 and fc2 (the hidden stored as fc1's raw sums), nothing stored
  kGelu = 3,      // + b1 and the GELU, nothing stored
  kWhole = 4,     // + the residual epilogue's loads and stores: the kernel itself
};

// RH row groups of WG = 4 / RH warpgroups of CW fc2 columns each; a
// warpgroup multiplies HW fc1 columns of each hidden chunk of HN = HW WG:
// 64 where its f32 accumulators (CW / 2 + HW / 2 a thread) stay within 80
// registers, else 32
template <int CW, int RH>
struct Cfg {
  static constexpr int kWG = kConsumers / RH;
  static constexpr int kHW = CW / 2 + 32 <= 80 && RH == 2 ? 64 : 32;
  static constexpr int kHN = kHW * kWG;               // hidden chunk: 128, or 64 at C = 256
  static constexpr int kHiddenBytes = kTM * kHN * 2;  // one hidden tile
  static constexpr int kSlot1 = kHN * kRowBytes;      // a W1 stage
  static_assert(kWG * kStageBytes <= 2 * kHiddenBytes, "the epilogue stages in the hidden tiles");
};

// rows of a W2 stage: CN, or at CN > 256 (TMA's largest box) a divisor of
// CN that holds whole warpgroup column blocks
__host__ __device__ constexpr int w2_rows(int cn) {
  return cn <= 256 ? cn : cn % 256 == 0 ? 256 : cn / 2;
}
__host__ __device__ constexpr int cpad(int c) { return (c + kBK - 1) / kBK * kBK; }

inline size_t smem_bytes(int C, int rh, int cn, int hn, int stages1, int stages2) {
  return (size_t)16 * (stages1 + stages2) + kAlign +
         (size_t)rh * (kTM * cpad(C) * 2 + 2 * kTM * hn * 2) + (size_t)stages1 * hn * kRowBytes +
         (size_t)stages2 * w2_rows(cn) * kRowBytes;
}

struct Params {
  const bf16* x;
  const bf16* res;
  const float* ln_g;
  const float* ln_b;
  const float* b1;
  const float* b2;
  const float* gamma;
  bf16* out;
  long long M;
  int C, hidden, B;
  float eps;
  int cs;                // column splits of C: an item's CN = C / cs output columns
  int stages1, stages2;  // W1 and W2 ring depths
};

// global offset of element (r, c) of the activation in layout L
// (r < 2^31: the launcher checks M; the batch-lane split by 32-bit division)
template <int L>
__device__ __forceinline__ long long act_offset(long long r, int c, int C, long long M, int B) {
  if constexpr (L == kRowsLayout) return r * C + c;
  if constexpr (L == kBatchLane) {
    const uint32_t p = (uint32_t)r / (uint32_t)B, b = (uint32_t)r - p * (uint32_t)B;
    return (long long)p * C * B + (long long)c * B + b;
  }
  return (long long)c * M + r;
}

__device__ __forceinline__ void sts128(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w));
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v));
}
__device__ __forceinline__ void sts16(uint32_t addr, unsigned short v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v));
}
__device__ __forceinline__ float lds32f(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// four 8x8 bf16 matrices, transposed, from shared memory (lane l addresses
// row l % 8 of matrix l / 8); register i holds matrix i in the mma fragment
// layout (lane l: row l / 4, columns 2 (l % 4) and + 1 of the transpose)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// byte offset of f32 column col (< 32) of row r (< 64) in a warpgroup's
// rows-layout staging tile (128-byte rows); the 16-byte chunk is XORed with
// (r ^ r / 8) % 8, so that the 8 rows of an accumulator store and the 8
// consecutive rows a read covers each hit 8 different chunks
__device__ __forceinline__ uint32_t stage_off(int r, int col) {
  return (uint32_t)(r * 128 + ((((col >> 2) ^ ((r ^ (r >> 3)) & 7))) << 4) + ((col & 3) << 2));
}

// the strided layouts' staging is column-major, 68 f32 a column (4 mod 32
// banks: the 8 rows x 4 column pairs of an accumulator store hit 32 banks),
// so that a thread reads a channel's 8 consecutive rows as 32 bytes
constexpr int kColPitch = 68 * 4;
__device__ __forceinline__ uint32_t col_off(int r, int col) {
  return (uint32_t)(col * kColPitch + r * 4);
}

// ---------------------------------------------------------------------------
// the x tile -> the swizzled A tile (raw bf16, normalised in place after)
// ---------------------------------------------------------------------------
template <int L, int WG, int HN>
__device__ __forceinline__ void load_x(const Params& p, long long row0, uint32_t a, uint32_t raw,
                                       int ct, int bar) {
  const int lane = ct & 31;
  constexpr int kThreadsG = WG * kWarpgroup;  // the group's threads
  const int C = p.C;
  if constexpr (L == kRowsLayout) {  // 16 bytes (8 channels) of a row a thread
    const int cq = C / 8;
    for (int i = ct; i < kTM * cq; i += kThreadsG) {
      const int r = i / cq, q = i - r * cq;
      const long long row = row0 + r;
      const uint4 v = row < p.M ? __ldg(reinterpret_cast<const uint4*>(p.x + row * C + 8 * q))
                                : make_uint4(0u, 0u, 0u, 0u);
      sts128(a + a_offset(r, 8 * q, kTM), v);
    }
  } else {
    const bool vec8 = L == kChanFirst ? p.M % 8 == 0 : p.B % 8 == 0;
    if (vec8) {  // 16 bytes (8 rows of one channel) a thread, along r, through the staging
      constexpr int kPass = 2 * kTM * HN * 2 / 128;  // channels the hidden tiles hold
      for (int c0 = 0; c0 < C; c0 += kPass) {
        const int nc = C - c0 < kPass ? C - c0 : kPass;
        if (c0 > 0) named_bar_sync(bar, kThreadsG);  // the last pass's reads
        for (int i = ct; i < nc * 8; i += kThreadsG) {
          const int rg = i & 7, c = c0 + (i >> 3);
          const long long row = row0 + 8 * rg;  // 8 rows all below M or all past it
          const uint4 v =
              row < p.M
                  ? __ldg(reinterpret_cast<const uint4*>(p.x + act_offset<L>(row, c, C, p.M, p.B)))
                  : make_uint4(0u, 0u, 0u, 0u);
          sts128(raw + (uint32_t)((c - c0) * 128 + ((rg ^ (c & 7)) << 4)), v);
        }
        named_bar_sync(bar, kThreadsG);
        // the staging's 8 x 8 blocks (8 channels x 8 rows) into A, four a warp
        // instruction: lane l addresses row l % 8 of block l / 8, channel
        // c of the staging for ldmatrix.trans, row r of A for stmatrix
        const int lr = lane & 7;
        for (int i4 = ct / 32; i4 < 2 * (nc / 8); i4 += kThreadsG / 32) {
          const int blk = 4 * i4 + (lane >> 3), rg = blk & 7, cg = blk >> 3;
          uint32_t m0, m1, m2, m3;
          ldmatrix_x4_trans(raw + (uint32_t)((8 * cg + lr) * 128 + ((rg ^ lr) << 4)), m0, m1, m2,
                            m3);
          stmatrix_x4(a + a_offset(8 * rg + lr, c0 + 8 * cg, kTM), m0, m1, m2, m3);
        }
      }
    } else {  // one element at a time, along r
      for (int i = ct; i < kTM * C; i += kThreadsG) {
        const int r = i & (kTM - 1), c = i >> 6;
        const long long row = row0 + r;
        const unsigned short v =
            row < p.M ? __bfloat16_as_ushort(p.x[act_offset<L>(row, c, C, p.M, p.B)]) : 0;
        sts16(a + a_offset(r, c, kTM), v);
      }
    }
  }
}

// warp wi of a group normalises rows RPW wi ... of its A tile in place: a
// row takes LPR lanes (the power of two >= its C / 8 16-byte pieces, at most
// 32; a lane holds CV pieces of 8 channels), so a warp holds 32 / LPR rows
// at once, and all RPW of its rows' loads and reductions are in flight
// together; two-pass f32 statistics from registers
template <int CV, int kLanes, int RPW>
__device__ __forceinline__ void ln_in_place(const Params& p, uint32_t a, int wi, int lane) {
  constexpr int LPR = kLanes * RPW < 32 ? 32 / RPW : kLanes;  // no more rows a pass than RPW
  constexpr int RPP = 32 / LPR;  // rows a pass of the warp holds
  constexpr int PASSES = RPW / RPP, PB = CV == 1 ? PASSES : 2;  // passes in flight
  static_assert(RPW % RPP == 0 && PASSES % PB == 0, "a warp's rows fill whole passes");
  const int C = p.C, li = lane % LPR;
  const float inv_c = 1.0f / (float)C;
#pragma unroll 1
  for (int p0 = 0; p0 < PASSES; p0 += PB) {
    float v[PB][CV][8];
    float mean[PB], rstd[PB];
#pragma unroll
    for (int ps = 0; ps < PB; ++ps) {
      const int r = RPW * wi + (p0 + ps) * RPP + lane / LPR;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        const int c = 8 * (li + LPR * i);
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (c < C) u = lds128(a + a_offset(r, c, kTM));
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[ps][i][2 * e] = bf_lo(w[e]);
          v[ps][i][2 * e + 1] = bf_hi(w[e]);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[ps][i][e];
      }
      mean[ps] = lane_group_sum(s, LPR) * inv_c;
    }
#pragma unroll
    for (int ps = 0; ps < PB; ++ps) {
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        if (8 * (li + LPR * i) < C) {
#pragma unroll
          for (int e = 0; e < 8; ++e) q += (v[ps][i][e] - mean[ps]) * (v[ps][i][e] - mean[ps]);
        }
      }
      rstd[ps] = rsqrtf(lane_group_sum(q, LPR) * inv_c + p.eps);
    }
#pragma unroll
    for (int i = 0; i < CV; ++i) {
      const int c = 8 * (li + LPR * i);
      if (c >= C) continue;
      const float4 g0 = __ldg(reinterpret_cast<const float4*>(p.ln_g + c));
      const float4 g1 = __ldg(reinterpret_cast<const float4*>(p.ln_g + c) + 1);
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(p.ln_b + c));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(p.ln_b + c) + 1);
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int ps = 0; ps < PB; ++ps) {
        const float m = mean[ps], sd = rstd[ps];
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = pack_bf16((v[ps][i][2 * e] - m) * sd * g[2 * e] + b[2 * e],
                           (v[ps][i][2 * e + 1] - m) * sd * g[2 * e + 1] + b[2 * e + 1]);
        sts128(a + a_offset(RPW * wi + (p0 + ps) * RPP + lane / LPR, c, kTM),
               make_uint4(o[0], o[1], o[2], o[3]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the epilogue of one warpgroup's CW columns (from column cbase) of a 64-row
// tile: (acc + b2) gamma in f32 through its staging tile, + the residual,
// bf16 out in the layout; PW columns at a time
// ---------------------------------------------------------------------------
template <int CW, int L>
__device__ __forceinline__ void store_tile(const Params& p, const float (&acc)[CW / 2],
                                         long long row0, int cbase, uint32_t st, int bar, int warp,
                                         int lane) {
  // columns a piece: 32 (rows), or 16 for the strided layouts' column-major staging
  constexpr int PW = CW % 32 == 0 && L == kRowsLayout ? 32 : CW % 16 == 0 ? 16 : 8;
  static_assert(L == kRowsLayout || PW * kColPitch <= kStageBytes, "a piece fits the staging");
  const int C = p.C, tid = threadIdx.x % kWarpgroup;
  const bool vec8 = L == kRowsLayout || (L == kChanFirst ? p.M % 8 == 0 : p.B % 8 == 0);
#pragma unroll
  for (int pc = 0; pc < CW / PW; ++pc) {
#pragma unroll
    for (int jj = 0; jj < PW / 8; ++jj) {
      const int j8 = pc * (PW / 8) + jj;  // the accumulators' 8-column group
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + (lane >> 2) + 8 * h, col = 8 * jj + 2 * (lane & 3);
        const int cg = cbase + 8 * j8 + 2 * (lane & 3);
        const float2 bv = load_pair(p.b2 + cg), gv = load_pair(p.gamma + cg);
        const float a = (acc[4 * j8 + 2 * h] + bv.x) * gv.x;
        const float b = (acc[4 * j8 + 2 * h + 1] + bv.y) * gv.y;
        if constexpr (L == kRowsLayout) {
          sts64(st + stage_off(row, col), a, b);
        } else {
          sts32(st + col_off(row, col), __float_as_uint(a));
          sts32(st + col_off(row, col + 1), __float_as_uint(b));
        }
      }
    }
    named_bar_sync(bar, kWarpgroup);
    const int c0 = cbase + pc * PW;
    if constexpr (L == kRowsLayout) {  // a thread: 8 consecutive columns of a row
      for (int i = tid; i < kTM * (PW / 8); i += kWarpgroup) {
        const int r = i / (PW / 8), q = i % (PW / 8);
        const long long row = row0 + r;
        if (row >= p.M) continue;
        const uint4 lo = lds128(st + stage_off(r, 8 * q));
        const uint4 hi = lds128(st + stage_off(r, 8 * q + 4));
        const long long off = row * C + c0 + 8 * q;
        const uint4 rv = __ldg(reinterpret_cast<const uint4*>(p.res + off));
        const uint4 o = make_uint4(
            pack_bf16(__uint_as_float(lo.x) + bf_lo(rv.x), __uint_as_float(lo.y) + bf_hi(rv.x)),
            pack_bf16(__uint_as_float(lo.z) + bf_lo(rv.y), __uint_as_float(lo.w) + bf_hi(rv.y)),
            pack_bf16(__uint_as_float(hi.x) + bf_lo(rv.z), __uint_as_float(hi.y) + bf_hi(rv.z)),
            pack_bf16(__uint_as_float(hi.z) + bf_lo(rv.w), __uint_as_float(hi.w) + bf_hi(rv.w)));
        *reinterpret_cast<uint4*>(p.out + off) = o;
      }
    } else if (vec8) {  // a thread: 8 consecutive rows of a channel
      for (int i = tid; i < PW * 8; i += kWarpgroup) {
        const int rg = i & 7, c = i >> 3;
        const long long row = row0 + 8 * rg;
        if (row >= p.M) continue;
        const uint4 lo = lds128(st + col_off(8 * rg, c)), hi = lds128(st + col_off(8 * rg + 4, c));
        const float f[8] = {__uint_as_float(lo.x), __uint_as_float(lo.y), __uint_as_float(lo.z),
                            __uint_as_float(lo.w), __uint_as_float(hi.x), __uint_as_float(hi.y),
                            __uint_as_float(hi.z), __uint_as_float(hi.w)};
        const long long off = act_offset<L>(row, c0 + c, C, p.M, p.B);
        const uint4 rv = __ldg(reinterpret_cast<const uint4*>(p.res + off));
        const uint4 o = make_uint4(pack_bf16(f[0] + bf_lo(rv.x), f[1] + bf_hi(rv.x)),
                                   pack_bf16(f[2] + bf_lo(rv.y), f[3] + bf_hi(rv.y)),
                                   pack_bf16(f[4] + bf_lo(rv.z), f[5] + bf_hi(rv.z)),
                                   pack_bf16(f[6] + bf_lo(rv.w), f[7] + bf_hi(rv.w)));
        *reinterpret_cast<uint4*>(p.out + off) = o;
      }
    } else {  // one element at a time, along r
      for (int i = tid; i < kTM * PW; i += kWarpgroup) {
        const int r = i & (kTM - 1), c = i >> 6;
        const long long row = row0 + r;
        if (row >= p.M) continue;
        const long long off = act_offset<L>(row, c0 + c, C, p.M, p.B);
        p.out[off] = __float2bfloat16(lds32f(st + col_off(r, c)) + __bfloat162float(p.res[off]));
      }
    }
    named_bar_sync(bar, kWarpgroup);  // the staging is read before the next piece
  }
}

// ---------------------------------------------------------------------------
// the kernel: RH row groups of WG warpgroups of CW fc2 columns, layout L
// ---------------------------------------------------------------------------
template <int CW, int L, int RH, int kCut>
__global__ void __launch_bounds__(kThreads, 1)
fused_kernel(const __grid_constant__ CUtensorMap w1_map, const __grid_constant__ CUtensorMap w2_map,
             const Params p) {
  using K = Cfg<CW, RH>;
  constexpr int WG = K::kWG, HW = K::kHW, HN = K::kHN, CN = WG * CW;
  constexpr int R2 = w2_rows(CN), NQ = CN / R2, KH = HN / kBK;
  constexpr int kSlot1 = K::kSlot1, kSlot2 = R2 * kRowBytes;
  constexpr int kThreadsG = WG * kWarpgroup;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int C = p.C, KT1 = ceil_div(C, kBK), nch = p.hidden / HN;
  const int S1 = p.stages1, S2 = p.stages2;
  const long long items = (long long)ceil_div(p.M, RH * kTM) * p.cs;
  uint64_t* full1 = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty1 = full1 + S1;
  uint64_t* full2 = empty1 + S1;
  uint64_t* empty2 = full2 + S2;
  uint8_t* base = smem + 16 * (S1 + S2);
  base += (kAlign - (smem_u32(base) % kAlign)) % kAlign;
  const int a_bytes = kTM * KT1 * kRowBytes;
  uint8_t* groups = base;  // per group: its A tile, then its two hidden tiles
  const int group_bytes = a_bytes + 2 * K::kHiddenBytes;
  uint8_t* ring1 = groups + (size_t)RH * group_bytes;
  uint8_t* ring2 = ring1 + (size_t)S1 * kSlot1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S1; ++s) {
      mbar_init(&full1[s], 1);
      mbar_init(&empty1[s], kConsumers * 4);  // lane 0 of every consumer warp
    }
    for (int s = 0; s < S2; ++s) {
      mbar_init(&full2[s], 1);
      mbar_init(&empty2[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the A columns past C (and nothing else) are never written again: zero all once
  for (int g = 0; g < RH; ++g)
    for (int i = threadIdx.x; i < a_bytes / 16; i += kThreads)
      reinterpret_cast<uint4*>(groups + (size_t)g * group_bytes)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  const int lane = threadIdx.x % 32;
  if (wg == kConsumers) {  // producer warpgroup: one thread a ring issues its TMA loads
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == kRing1Thread) {
      long long g1 = 0;
      for (long long t = blockIdx.x; t < items; t += gridDim.x)
        for (int j = 0; j < nch; ++j)
          for (int kt = 0; kt < KT1; ++kt, ++g1) {
            const int s = (int)(g1 % S1);
            mbar_wait(&empty1[s], (int)(((g1 / S1) & 1) ^ 1));
            mbar_expect_tx(&full1[s], kSlot1);
            tma_load(ring1 + (size_t)s * kSlot1, &w1_map, &full1[s], kt * kBK, j * HN);
          }
    } else if (threadIdx.x == kRing2Thread) {
      long long g2 = 0;
      for (long long t = blockIdx.x; t < items; t += gridDim.x) {
        const int cs = (int)(t % p.cs);
        for (int j = 0; j < nch; ++j)
          for (int kq = 0; kq < KH * NQ; ++kq, ++g2) {
            const int s = (int)(g2 % S2);
            mbar_wait(&empty2[s], (int)(((g2 / S2) & 1) ^ 1));
            mbar_expect_tx(&full2[s], kSlot2);
            tma_load(ring2 + (size_t)s * kSlot2, &w2_map, &full2[s], j * HN + (kq / NQ) * kBK,
                     cs * CN + (kq % NQ) * R2);
          }
      }
    }
    return;
  }

  // consumers: group gr of warpgroups gr WG ...; warpgroup w of the group
  // multiplies fc1 columns w * HW ... of each chunk and owns fc2 columns
  // w * CW ... of the item's CN
  reg_alloc<kConsumerRegs>();
  const int gr = wg / WG, w = wg % WG, warp = (threadIdx.x % kWarpgroup) / 32;
  const int ct = threadIdx.x - gr * kThreadsG, wi = ct / 32;  // within the group
  const int bar = kGroupBar + gr;
  const int myq = (w * CW) / R2;  // the W2 row block holding mine
  const uint32_t b2_off = (uint32_t)(w * CW - myq * R2) * kRowBytes;
  const uint32_t a_addr = smem_u32(groups + (size_t)gr * group_bytes);
  const uint32_t h_addr = a_addr + a_bytes;
  const uint32_t r1_addr = smem_u32(ring1), r2_addr = smem_u32(ring2);
  long long g1 = 0, g2 = 0;
  uint64_t* pending = nullptr;  // the empty barrier of the stage whose products are newest
  auto release = [&]() {
    if (pending != nullptr && lane == 0) mbar_arrive(pending);
    pending = nullptr;
  };
  float acc1[HW / 2];
  float acc2[CW / 2];
  for (long long t = blockIdx.x; t < items; t += gridDim.x) {
    const long long row0 = (t / p.cs) * (RH * kTM) + gr * kTM;
    const int cs = (int)(t % p.cs);
    named_bar_sync(bar, kThreadsG);  // the group's last staging reads are done
    load_x<L, WG, HN>(p, row0, a_addr, h_addr, ct, bar);
    named_bar_sync(bar, kThreadsG);
    if constexpr (kCut >= kLn) {
      switch (C) {  // lanes a row, and its 16-byte pieces a lane
        case 32: ln_in_place<1, 4, 16 / WG>(p, a_addr, wi, lane); break;
        case 64: ln_in_place<1, 8, 16 / WG>(p, a_addr, wi, lane); break;
        case 96:
        case 128: ln_in_place<1, 16, 16 / WG>(p, a_addr, wi, lane); break;
        case 192:
        case 256: ln_in_place<1, 32, 16 / WG>(p, a_addr, wi, lane); break;
        case 384:
        case 512: ln_in_place<2, 32, 16 / WG>(p, a_addr, wi, lane); break;
        default: ln_in_place<3, 32, 16 / WG>(p, a_addr, wi, lane); break;
      }
    }
    fence_proxy_async();
    named_bar_sync(bar, kThreadsG);  // the A tile is written
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) acc2[i] = 0.f;
    fence_acc(acc2);
    for (int j = 0; j < nch; ++j) {
      // fc1: this warpgroup's HW columns of chunk j, K = C
#pragma unroll
      for (int i = 0; i < HW / 2; ++i) acc1[i] = 0.f;
      fence_acc(acc1);
      for (int kt = 0; kt < KT1; ++kt, ++g1) {
        const int s = (int)(g1 % S1);
        mbar_wait(&full1[s], (int)((g1 / S1) & 1));
        wgmma_fence();
        const uint32_t a0 = a_addr + kt * kTileBytes;
        const uint32_t b0 = r1_addr + (uint32_t)s * kSlot1 + w * HW * kRowBytes;
        if constexpr (kCut >= kProducts) {
#pragma unroll
          for (int k = 0; k < kRowBytes / 32; ++k)
            Wgmma<HW>::mma(acc1, desc_sw128(a0 + k * 32), desc_sw128(b0 + k * 32), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
        release();
        pending = &empty1[s];
      }
      wgmma_wait<0>();
      fence_acc(acc1);
      release();
      // + b1, GELU, bf16 into the group's hidden tile j % 2 (columns w * HW ...)
      const uint32_t h = h_addr + (j & 1) * K::kHiddenBytes;
#pragma unroll
      for (int jj = 0; jj < HW / 8; ++jj) {
        const int col = w * HW + 8 * jj + 2 * (lane & 3);
        const float2 bv = kCut >= kGelu ? load_pair(p.b1 + j * HN + col) : make_float2(0.f, 0.f);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = warp * 16 + (lane >> 2) + 8 * hh;
          float a = acc1[4 * jj + 2 * hh], b = acc1[4 * jj + 2 * hh + 1];
          if constexpr (kCut >= kGelu) {
            a = gelu_erf(a + bv.x);
            b = gelu_erf(b + bv.y);
          }
          if constexpr (kCut >= kProducts) sts32(h + a_offset(row, col, kTM), pack_bf16(a, b));
        }
      }
      fence_proxy_async();
      named_bar_sync(bar, kThreadsG);  // the group's hidden tile j % 2 is written
      // fc2: this warpgroup's CW columns += hidden chunk j W2[:, chunk]^T, K = HN
      for (int kq = 0; kq < KH * NQ; ++kq, ++g2) {
        const int q = kq % NQ;
        const int s = (int)(g2 % S2);
        mbar_wait(&full2[s], (int)((g2 / S2) & 1));
        wgmma_fence();
        if (q == myq) {
          const uint32_t a0 = h + (kq / NQ) * kTileBytes;
          const uint32_t b0 = r2_addr + (uint32_t)s * kSlot2 + b2_off;
          if constexpr (kCut >= kProducts) {
#pragma unroll
            for (int k = 0; k < kRowBytes / 32; ++k)
              Wgmma<CW>::mma(acc2, desc_sw128(a0 + k * 32), desc_sw128(b0 + k * 32), 1);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
        release();
        pending = &empty2[s];
      }
    }
    wgmma_wait<0>();
    fence_acc(acc2);
    release();
    named_bar_sync(bar, kThreadsG);  // every product of the group is done: A and hidden free
    if constexpr (kCut >= kWhole) {
      store_tile<CW, L>(p, acc2, row0, cs * CN + w * CW, h_addr + w * kStageBytes, kStageBar + wg,
                        warp, lane);
    } else if (acc2[0] == 1234.5678f) {  // keep the products live, store nothing
      p.out[0] = __float2bfloat16(acc2[CW / 2 - 1]);
    }
  }
}

template <int CW, int L, int RH, int kCut>
cudaError_t launch(const Params& p, const void* w1, const void* w2, cudaStream_t stream) {
  using K = Cfg<CW, RH>;
  static SmemGrant grant;
  constexpr int CN = K::kWG * CW, R2 = w2_rows(CN);
  if (p.cs < 1 || p.cs > 2 || p.C != CN * p.cs || p.hidden <= 0 || p.hidden % K::kHN ||
      p.B <= 0 || p.M >= (1LL << 31) || p.stages1 < 2 || p.stages2 < 2 ||
      p.stages1 > kMaxStages || p.stages2 > kMaxStages)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p.C, RH, CN, K::kHN, p.stages1, p.stages2);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  CUtensorMap w1_map, w2_map;
  if (!make_map(&w1_map, w1, p.hidden, p.C, K::kHN) || !make_map(&w2_map, w2, p.C, p.hidden, R2))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = sm_count(&dev, &sms);
  if (err != cudaSuccess) return err;
  const void* kernel = (const void*)fused_kernel<CW, L, RH, kCut>;
  err = grant_smem(kernel, smem, grant, dev);
  if (err != cudaSuccess) return err;
  const long long items = (long long)ceil_div(p.M, RH * kTM) * p.cs;
  const int grid = items < sms ? (int)items : sms;
  fused_kernel<CW, L, RH, kCut><<<grid, kThreads, smem, stream>>>(w1_map, w2_map, p);
  return cudaGetLastError();
}

// C -> the row groups and the warpgroups' fc2 column block: two groups of two
// warpgroups at C <= 256, one of four above (C = 768: two column splits of 384)
template <int L, int kCut = kWhole>
cudaError_t dispatch(Params p, const void* w1, const void* w2, cudaStream_t stream) {
  if (p.M == 0) return cudaSuccess;
  if (p.M < 0 || p.cs < 1) return cudaErrorInvalidValue;
  switch (p.C / p.cs) {
    case 32: return launch<16, L, 2, kCut>(p, w1, w2, stream);
    case 64: return launch<32, L, 2, kCut>(p, w1, w2, stream);
    case 96: return launch<48, L, 2, kCut>(p, w1, w2, stream);
    case 128: return launch<64, L, 2, kCut>(p, w1, w2, stream);
    case 192: return launch<96, L, 2, kCut>(p, w1, w2, stream);
    case 256: return launch<128, L, 2, kCut>(p, w1, w2, stream);
    case 384: return launch<96, L, 1, kCut>(p, w1, w2, stream);
    case 512: return launch<128, L, 1, kCut>(p, w1, w2, stream);
    default: return cudaErrorInvalidValue;
  }
}

inline Params make_params(const void* x, const void* res, const void* ln_g, const void* ln_b,
                          const void* b1, const void* b2, const void* gamma, void* out,
                          long long M, int C, int hidden, int B, float eps, int cs, int stages1,
                          int stages2) {
  return Params{(const bf16*)x, (const bf16*)res, (const float*)ln_g, (const float*)ln_b,
                (const float*)b1, (const float*)b2, (const float*)gamma, (bf16*)out,
                M, C, hidden, B, eps, cs, stages1, stages2};
}

}  // namespace ln_mlp
