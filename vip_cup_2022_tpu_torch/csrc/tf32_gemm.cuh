// The fused blocks' f32 GEMMs on the tensor cores (sm_90a): 3xTF32 wgmma on
// the engine of hopper_gemm.cuh (TMA ring under mbarriers, persistent CTAs,
// two consumer pairs in ping-pong, setmaxnreg).
//
//   kind kGelu      LN(x) W1^T + b1, exact GELU             -> f32 (M, N) hidden
//                   (ln_fc1_gelu_f32)
//   kind kResidual  a W^T, (+ b) * gamma + residual          -> f32 or bf16 (M, N)
//                   (fc2_scale_residual_f32 / _mmf32 on the hidden; with K = N = C
//                   proj_scale_residual_f32 / _mmf32 on the attention output,
//                   the residual x f32 or bf16)
//   kind kQkv       LN(x) W_qkv^T + b, split by columns     -> S f32 (M, N / S)
//                   (ln_qkv_f32 / _mmf32: q, k, v, or k, v for a global query)
//
// A, the activations TMA loads (x for the LN kinds, the hidden or the
// attention output otherwise), is f32, or bf16 for the _mmf32 modes of
// ln_qkv and proj_scale_residual (VIPTPU_GCVIT_MM=f32 on bf16 activations).
//
// They replace the f32 mode of the dots of the TPU kernels
// fused_convnext_block and fused_ln_mlp_residual_batchlane
// (vip_cup_2022_tpu/ops/pallas/convnext_block.py) and of ln_dense /
// proj_res_ln_mlp / mono_window_transformer_block (ops/pallas/gcvit_block.py):
// with f32 operands every dot there is the f32 product. One TF32 pass (10
// bits of mantissa) is not that function; three are: each f32 operand v is
// split as hi = rna_tf32(v), lo = rna_tf32(v - hi), and
//
//   a w ~= a_lo w_hi + a_hi w_lo + a_hi w_hi
//
// sums the three products into one f32 accumulator, small terms first
// (a_lo w_lo, about 2^-22 of a w, is dropped). hi and lo are rounded
// explicitly (cvt.rna.tf32.f32 here, the same rounding in
// ops/kernels/tf32.py for the weights), so nothing depends on what the
// tensor core does with a value's low 13 bits. A bf16 value is exact in
// TF32 (8 bits of mantissa against 11), so a bf16 A without an LN has a_lo =
// 0 and two passes, a_hi w_lo + a_hi w_hi, give the same sum.
//
// What bounds them on this card: the products, 3 x 2 M N K TF32 operations
// at 495 TFLOP/s (165 TFLOP/s of f32 products) at s2-s4 and GCViT's L2-L4
// MLP and qkv; the bytes of A, the residual and the output at s1, L1 and
// for proj (K = C: 2 C products per 12 bytes an element in f32). What the
// design does about each:
//
// - Weights split once: W_hi and W_lo are f32 (N, K) tensors made by the
//   wrapper's caller (the blocks' weight cache, Int8Block.tf32_weight) and
//   loaded by TMA beside the A tile; a stage is A (128 rows x 32 K columns:
//   f32 under the 128-byte swizzle, or bf16 under the 64-byte one) + W_hi +
//   W_lo (BN rows x 32 f32 each, 128-byte swizzle).
// - Activations split in registers: wgmma takes TF32 A from registers. The
//   consumers read their rows of the raw tile that TMA brought, widen bf16
//   to f32, apply (x - mean) * rstd * g + b for the LN (row statistics
//   two-pass in f32, taken once per row tile by each warp for its own 16
//   rows, from device memory), split each value into hi and lo, and issue
//   the m64nBNk8 wgmmas. Nothing of A's split goes to shared or device
//   memory, and no LN'd row tile stays resident (at C = 768 a 128-row tile
//   in hi + lo would be 768 KB).
// - Fragment order: a thread of an m64nNk8 TF32 fragment holds rows r and
//   r + 8 at K columns t and t + 4 (t = lane % 4). W's K columns are
//   permuted within each 32-column tile (ops/kernels/tf32.py: tf32_weight),
//   so that the values a thread needs for two k8 steps are four consecutive
//   columns of its row: logical column 8 (2 p + e) + 4 h + t holds actual
//   column 16 p + 4 t + 2 h + e. A thread then reads its A fragment as one
//   16-byte load (f32) or one 8-byte load (bf16) a row per half tile
//   (bank-conflict free under the swizzle), and the product is unchanged
//   (the same permutation on both sides of every dot).
// - Pipelining: one commit group per k8 step (its wgmmas), waited one group
//   behind, so a step's split runs under the previous step's products; a
//   stage is released once its last group is done.
// - Epilogues in the accumulators' layout, staged through each warp's 2 KB
//   f32 tile so a lane holds 8 consecutive columns of a row: GELU (the
//   engine's two-polynomial erf, <= 1 ulp of f32 erf) after + b1, or + b
//   alone into the q, k or v output the column tile lies in (kQkv: the plan's
//   column tiles divide C), stored as 32 f32 bytes a lane; (acc + b) * gamma
//   + residual is the engine's residual_epilogue (f32 out, or bf16 rounded
//   once).
// - Work: items of 128 rows x BN columns, column chunk fastest, split into
//   contiguous ranges, one per persistent CTA (so a CTA's consecutive
//   items share a row tile: its rows stay in L2 and the LN statistics are
//   taken once per tile), taken in turns by the two pairs; each warpgroup
//   of a pair multiplies 64 rows.
//
// BN (32, 64, 96 or 128, dividing N; for kQkv dividing C) and the ring depth
// come from the caller's plan (ops/kernels/convnext_block.py: tf32_gemm_plan),
// checked here. K must be a multiple of 32 (the models' widths are), and at
// most 768 for the LN kinds (a warp holds a row in registers for its
// statistics).
//
// kCut makes phase-cut instantiations for timing (csrc/f32_mlp_cuts.cu):
// kLoads (the TMA ring and, for the LN kinds, the statistics' reads),
// kProducts (+ the A fragments, the split and the wgmmas), kWhole (+ the
// epilogue: the kernel itself), kNoStores (kWhole without its stores);
// kPasses = 1 issues a_hi w_hi alone (one TF32 pass: not the function, for
// timing).
#pragma once

#include "hopper_gemm.cuh"

namespace tf32_gemm {

using hopper_gemm::bf16;
using hopper_gemm::kAlign;
using hopper_gemm::kConsumers;
using hopper_gemm::kLoads;
using hopper_gemm::kNoStores;
using hopper_gemm::kProducts;
using hopper_gemm::kResEpilogueBytes;
using hopper_gemm::kThreads;
using hopper_gemm::kWarpgroup;
using hopper_gemm::kWhole;
using hopper_gemm::Ring;

constexpr int kBM = 128;                    // rows of a work item: 64 a warpgroup
constexpr int kBK = 32;                     // K columns a tile: one 128-byte swizzle row of f32
constexpr int kRowBytes = kBK * 4;          // a W tile's row (and an f32 A tile's)
constexpr int kMaxStages = 8;
constexpr int kMaxLnK = 768;                // the LN kinds' widest row (six float4 a lane)

enum Kind : int { kGelu = 0, kResidual = 1, kQkv = 2 };

struct Params {
  const void* x;       // the LN kinds: their input rows (M, K) in TA, read for the statistics
  const float* ln_g;   // (K,) LN weight and bias (kGelu, kQkv)
  const float* ln_b;
  const float* bias;   // (N,)
  const float* gamma;  // (N,) (kResidual)
  const void* res;     // (M, N) ResT residual (kResidual)
  void* out;           // (M, N): f32 (kGelu), OutT (kResidual); kQkv: the first (M, split) output
  int M, N, K, stages;
  float eps;
  void* out1;          // kQkv: the second and third (M, split) outputs (N = 2 or 3 split)
  void* out2;
  int split;           // kQkv: the width of one output (C)
};

// an A tile's row: 32 K columns of TA (128 bytes of f32, 64 of bf16)
__host__ __device__ constexpr int a_row_bytes(int a_bytes) { return kBK * a_bytes; }
__host__ __device__ constexpr int a_tile_bytes(int a_bytes) { return kBM * a_row_bytes(a_bytes); }

__host__ __device__ constexpr int stage_bytes(int bn, int a_bytes) {
  return a_tile_bytes(a_bytes) + 2 * bn * kRowBytes;
}

inline size_t smem_bytes(int bn, int stages, int a_bytes) {
  return hopper_gemm::kBarrierBytes(stages) + kAlign + kConsumers * 4 * kResEpilogueBytes +
         (size_t)stages * stage_bytes(bn, a_bytes);
}

// four consecutive values of TA from device memory, as f32
__device__ __forceinline__ float4 widen4(uint2 u) {  // bf16 x 4 -> f32 x 4 (exact)
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const bf16* p) {
  return widen4(__ldg(reinterpret_cast<const uint2*>(p)));
}

// a lane's four consecutive A values of half tile p (actual columns 16 p + 4 t
// ... + 3) in the row at byte `row` of a stage's A tile, as TMA swizzled it:
// f32 rows are 128 bytes under the 128-byte swizzle (16-byte chunk 4 p + t,
// XOR the row's r % 8), bf16 rows 64 bytes under the 64-byte swizzle (chunk
// 2 p + t / 2, XOR (r / 2) % 4, half 8 (t % 2)); `sw` is that XOR of the row
template <typename TA>
__device__ __forceinline__ float4 a_quad(const uint8_t* row, int p, int t, int sw) {
  if constexpr (sizeof(TA) == 4) {
    return *reinterpret_cast<const float4*>(row + (((4 * p + t) ^ sw) << 4));
  } else {
    return widen4(*reinterpret_cast<const uint2*>(row + (((2 * p + (t >> 1)) ^ sw) << 4) +
                                                  8 * (t & 1)));
  }
}

template <typename TA>
__device__ __forceinline__ int a_swizzle(int r) {
  return sizeof(TA) == 4 ? (r & 7) : ((r >> 1) & 3);
}

// m64nNk8 tf32 x tf32 -> f32: A from registers (a thread's rows lane / 4 and
// + 8 of its warp's 16, K columns lane % 4 and + 4), B K-major from shared
// memory through a 128-byte-swizzle descriptor (a k8 step is 32 bytes of a
// swizzle row, as a bf16 k16 step); the accumulators are laid out as
// hopper_gemm::Wgmma's. scale_d 0 overwrites the accumulators, 1 adds to them.
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// v -> TF32 (rounded to nearest, ties away from zero), in an f32 container
// whose low 13 bits are zero
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// hi = rna_tf32(v), lo = rna_tf32(v - hi) (v - hi is exact in f32)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ float4 ln4(const float4& v, float mean, float rstd, const float4& g,
                                      const float4& b) {
  return make_float4((v.x - mean) * rstd * g.x + b.x, (v.y - mean) * rstd * g.y + b.y,
                     (v.z - mean) * rstd * g.z + b.z, (v.w - mean) * rstd * g.w + b.w);
}

// Two-pass f32 statistics of the warp's 16 rows row0 ... row0 + 15 (K <=
// 32 x 4 CV), two rows in flight, each read once into registers; lane l
// keeps those of rows l / 4 (m0, s0) and l / 4 + 8 (m1, s1), the rows of its
// A fragment. Rows past M get mean 0 (their products are never stored).
template <int CV, int kCut, typename TA>
__device__ __forceinline__ void row_stats(const TA* __restrict__ x, long long row0, int M,
                                          int K, float eps, int lane, float& m0, float& s0,
                                          float& m1, float& s1) {
  const float inv_k = 1.0f / (float)K;
  for (int r = 0; r < 16; r += 2) {
    float4 v[2][CV];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + r + h;
#pragma unroll
      for (int j = 0; j < CV; ++j) {
        const int c = 4 * (lane + 32 * j);
        v[h][j] = row < M && c < K ? ldg4(x + row * K + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < CV; ++j) s += (v[h][j].x + v[h][j].y) + (v[h][j].z + v[h][j].w);
      float mean, rstd;
      if constexpr (kCut == kLoads) {  // the reads alone: keep them live
        mean = s;
        rstd = 1.f;
      } else {
        mean = hopper_gemm::warp_sum(s) * inv_k;
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < CV; ++j) {
          if (4 * (lane + 32 * j) < K) {
            const float a = v[h][j].x - mean, b = v[h][j].y - mean;
            const float c = v[h][j].z - mean, d = v[h][j].w - mean;
            q += (a * a + b * b) + (c * c + d * d);
          }
        }
        rstd = rsqrtf(hopper_gemm::warp_sum(q) * inv_k + eps);
      }
      const int rr = r + h;
      if ((lane >> 2) == (rr & 7)) {
        if (rr < 8) {
          m0 = mean;
          s0 = rstd;
        } else {
          m1 = mean;
          s1 = rstd;
        }
      }
    }
  }
}

// The consumer mainloop of one work item (q-th of the CTA, ring positions
// q KT ...): the warpgroup (`half` of pair `pair`) multiplies its 64 rows
// of each stage's A tile, transformed (the LN) and split in registers,
// against the stage's W_hi and W_lo. The order barrier, the ring's phases
// and the releases are hopper_gemm::mainloop's (see its note).
//
// The tensor cores add each k8 step into their f32 accumulator rounding
// toward zero, so over K the error of acc grows with K, one-signed (at K =
// 3072, 1.5e-5 of max|ref| on the card, past the f32 gate). With kPromote
// the wgmmas sum kPromoteTiles K tiles at a time into `tc` (the first of a
// chunk overwriting it), and each chunk is added to `acc` by FADD, rounded
// to nearest: the partial sums the tensor cores round stay small. That
// costs BN / 2 more registers (BN <= 64) and a drain of the warpgroup's
// wgmmas each chunk.
constexpr int kPromoteTiles = 2;

template <bool kFirst, typename T>
__device__ __forceinline__ T& pick(T& a, T& b) {
  if constexpr (kFirst) return a;
  else return b;
}

template <int BN, int kKind, int kCut, int kPasses, bool kPromote, typename TA>
__device__ __forceinline__ void mainloop(float (&acc)[BN / 2], const Ring& ring, int KT,
                                         long long q, int pair, int half, int warp, int lane,
                                         const float* __restrict__ ln_g,
                                         const float* __restrict__ ln_b, float m0, float s0,
                                         float m1, float s1) {
  using hopper_gemm::desc_sw128;
  using hopper_gemm::fence_acc;
  using hopper_gemm::mbar_arrive;
  using hopper_gemm::mbar_wait;
  static_assert(!kPromote || BN <= 64, "two accumulator tiles fit the registers up to BN = 64");
  // a bf16 A taken as it is (no LN) is exact in TF32: a_lo = 0, two passes
  constexpr bool kExactA = sizeof(TA) == 2 && kKind == kResidual;
  constexpr int kARow = a_row_bytes(sizeof(TA)), kATile = a_tile_bytes(sizeof(TA));
  float tc_tile[BN / 2];  // the wgmmas' tile with kPromote (unused, and dropped, without)
  float (&tc)[BN / 2] = pick<kPromote>(tc_tile, acc);
  if constexpr (kCut >= kProducts) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_acc(acc);
  }
  if (q > 0) mbar_wait(&ring.order[pair ^ 1], (int)(((q - 1) >> 1) & 1));
  const int t = lane & 3, r0 = 16 * warp + (lane >> 2);  // this lane's first row of the 64
  const int a_row = (half * 64 + r0) * kARow;
  const int sw = a_swizzle<TA>(r0);  // the swizzle's XOR for rows r0 and r0 + 8
  const long long g0 = q * KT;
  int prev = -1;
  for (int kt = 0; kt < KT; ++kt) {
    const unsigned g = (unsigned)(g0 + kt), n = (unsigned)ring.stages;
    const int s = (int)(g % n), parity = (int)((g / n) & 1u);
    mbar_wait(&ring.full[s], parity);
    if (kt == KT - 1 && lane == 0) mbar_arrive(&ring.order[pair]);
    if constexpr (kCut >= kProducts) {
      const uint8_t* stage = ring.base + (size_t)s * ring.stage_bytes;
      const uint32_t whi = hopper_gemm::smem_u32(stage) + kATile;
      const uint32_t wlo = whi + BN * kRowBytes;
      const bool chunk_start = kPromote && kt % kPromoteTiles == 0;
#pragma unroll
      for (int p = 0; p < 2; ++p) {  // half tiles: k8 steps 2p and 2p + 1
        float4 v0 = a_quad<TA>(stage + a_row, p, t, sw);
        float4 v1 = a_quad<TA>(stage + a_row + 8 * kARow, p, t, sw);
        if constexpr (kKind != kResidual) {  // the LN kinds
          const int col = kt * kBK + 16 * p + 4 * t;
          const float4 gv = __ldg(reinterpret_cast<const float4*>(ln_g + col));
          const float4 bv = __ldg(reinterpret_cast<const float4*>(ln_b + col));
          v0 = ln4(v0, m0, s0, gv, bv);
          v1 = ln4(v1, m1, s1, gv, bv);
        }
        const float x0[4] = {v0.x, v0.y, v0.z, v0.w}, x1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = 2 * p + e;
          uint32_t hi[4], lo[4];  // rows r0, r0 + 8 at logical columns t, then t + 4
          if constexpr (kExactA) {
            hi[0] = __float_as_uint(x0[e]);
            hi[1] = __float_as_uint(x1[e]);
            hi[2] = __float_as_uint(x0[2 + e]);
            hi[3] = __float_as_uint(x1[2 + e]);
          } else {
            split(x0[e], hi[0], lo[0]);
            split(x1[e], hi[1], lo[1]);
            split(x0[2 + e], hi[2], lo[2]);
            split(x1[2 + e], hi[3], lo[3]);
          }
          const uint64_t dh = desc_sw128(whi + kk * 32), dl = desc_sw128(wlo + kk * 32);
          const int first = chunk_start && kk == 0 ? 0 : 1;  // 0: the chunk's first overwrites
          hopper_gemm::wgmma_fence();
          if constexpr (kPasses == 3 && kExactA) {  // a_lo w_hi is exactly zero
            WgmmaTf32<BN>::mma(tc, hi, dl, first);
            WgmmaTf32<BN>::mma(tc, hi, dh, 1);
          } else if constexpr (kPasses == 3) {
            WgmmaTf32<BN>::mma(tc, lo, dh, first);
            WgmmaTf32<BN>::mma(tc, hi, dl, 1);
            WgmmaTf32<BN>::mma(tc, hi, dh, 1);
          } else {
            WgmmaTf32<BN>::mma(tc, hi, dh, first);
          }
          hopper_gemm::wgmma_commit();
          hopper_gemm::wgmma_wait<1>();  // the previous step's products are done
          if (kk == 0 && prev >= 0 && lane == 0) mbar_arrive(&ring.empty[prev]);
        }
      }
      if (kPromote && (kt % kPromoteTiles == kPromoteTiles - 1 || kt == KT - 1)) {
        hopper_gemm::wgmma_wait<0>();  // the chunk is summed: add it to acc, rounded to nearest
        fence_acc(tc);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += tc[i];
        if (lane == 0) mbar_arrive(&ring.empty[s]);
        prev = -1;
        continue;
      }
    } else if (lane == 0) {
      mbar_arrive(&ring.empty[s]);
    }
    prev = s;
  }
  if constexpr (kCut >= kProducts) {
    hopper_gemm::wgmma_wait<0>();
    fence_acc(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(&ring.empty[prev]);
  }
}

// The GELU epilogue of one warp's 16 rows of a (64, BN) tile: op(a, b, n)
// maps the f32 pair at columns n, n + 1 in the accumulators' layout; the
// results go, 32 columns at a time, through the warp's 2 KB f32 staging
// tile to lanes that each hold 8 consecutive columns of a row and store
// them as 32 bytes (hopper_gemm::residual_epilogue without a residual).
template <int BN, bool kStore, typename Op>
__device__ __forceinline__ void staged_epilogue(float (&acc)[BN / 2], long long row0, int col0,
                                                int M, int ncols, int warp, int lane,
                                                uint8_t* staging, float* out, long long ld, Op op) {
  using hopper_gemm::lds128;
  using hopper_gemm::stage32_offset;
  static_assert(BN % 32 == 0, "the epilogue writes 32-column pieces");
  const uint32_t st = hopper_gemm::smem_u32(staging);
#pragma unroll
  for (int q = 0; q < BN / 32; ++q) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c8 = 4 * q + c, col = 8 * c + 2 * (lane & 3);
        float a = acc[4 * c8 + 2 * h], b = acc[4 * c8 + 2 * h + 1];
        op(a, b, col0 + 32 * q + col);
        hopper_gemm::sts64(st + stage32_offset((lane >> 2) + 8 * h, col), a, b);
      }
    }
    hopper_gemm::warp_sync();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = 8 * half + (lane >> 2), c = lane & 3;
      const uint4 lo = lds128(st + stage32_offset(rl, 8 * c));
      const uint4 hi = lds128(st + stage32_offset(rl, 8 * c + 4));
      const long long row = row0 + warp * 16 + rl;
      const int n = col0 + 32 * q + 8 * c;
      const bool live = row < M && n < ncols;
      if constexpr (kStore) {
        hopper_gemm::stg128_if(live, out + row * ld + n, lo);
        hopper_gemm::stg128_if(live, out + row * ld + n + 4, hi);
      } else if (lo.x == 0x12345678u && hi.w == 0x12345678u) {  // keep the results live
        out[0] = 0.f;
      }
    }
    hopper_gemm::warp_sync();
  }
}

// OutT: the output of kResidual (f32, or bf16 for fc2_scale_residual_mmf32);
// kGelu and kQkv write f32. TA: A's type (f32, or bf16 for the _mmf32 modes
// of ln_qkv and proj_scale_residual); ResT: kResidual's residual (f32, or
// bf16 for proj_scale_residual_mmf32's x).
template <int BN, int kKind, int kCut, typename OutT, int kPasses, bool kPromote, typename TA,
          typename ResT>
__global__ void __launch_bounds__(kThreads, 1)
tf32_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap whi_map,
            const __grid_constant__ CUtensorMap wlo_map, const Params p) {
  static_assert(kKind == kResidual || sizeof(OutT) == 4, "the hidden and q, k, v are f32");
  constexpr int kStage = stage_bytes(BN, sizeof(TA)), kATile = a_tile_bytes(sizeof(TA));
  extern __shared__ __align__(1024) uint8_t smem[];
  const int KT = p.K / kBK, NC = p.N / BN;
  const long long items = (long long)hopper_gemm::ceil_div(p.M, kBM) * NC;
  // this CTA's items: a contiguous range, so that its consecutive items share a row tile
  const long long first = items * blockIdx.x / gridDim.x;
  const long long last = items * (blockIdx.x + 1) / gridDim.x;
  Ring ring;
  hopper_gemm::init_ring(ring, smem, p.stages);
  uint8_t* staging_base = hopper_gemm::aligned_base(smem, p.stages);  // each consumer warp's 2 KB
  ring.base = staging_base + kConsumers * 4 * kResEpilogueBytes;
  ring.stage_bytes = kStage;
  ring.b_offset = kATile;
  ring.stages = p.stages;
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  const int lane = threadIdx.x % 32;
  if (wg == kConsumers) {  // producer warpgroup: one thread issues every TMA load
    hopper_gemm::reg_dealloc<hopper_gemm::kProducerRegs>();
    if (threadIdx.x == kConsumers * kWarpgroup) {
      long long g = 0;
      for (long long i = first; i < last; ++i) {
        const int row0 = (int)(i / NC) * kBM, col0 = (int)(i % NC) * BN;
        for (int kt = 0; kt < KT; ++kt, ++g) {
          const int s = (int)(g % p.stages);
          hopper_gemm::mbar_wait(&ring.empty[s], (int)(((g / p.stages) & 1) ^ 1));
          hopper_gemm::mbar_expect_tx(&ring.full[s], kStage);
          uint8_t* stage = ring.base + (size_t)s * ring.stage_bytes;
          hopper_gemm::tma_load(stage, &a_map, &ring.full[s], kt * kBK, row0);
          hopper_gemm::tma_load(stage + kATile, &whi_map, &ring.full[s], kt * kBK, col0);
          hopper_gemm::tma_load(stage + kATile + BN * kRowBytes, &wlo_map, &ring.full[s],
                                kt * kBK, col0);
        }
      }
    }
  } else {  // consumer warpgroups: pair wg / 2 takes every other item, half wg % 2 its rows
    hopper_gemm::reg_alloc<hopper_gemm::kConsumerRegs>();
    const int warp = (threadIdx.x % kWarpgroup) / 32;
    const int pair = wg >> 1, half = wg & 1;
    uint8_t* staging = staging_base + (threadIdx.x / 32) * kResEpilogueBytes;
    const int cv = hopper_gemm::ceil_div(p.K, 128);
    float acc[BN / 2];
    float m0 = 0.f, s0 = 0.f, m1 = 0.f, s1 = 0.f;
    long long stats_tile = -1;
    for (long long i = first; i < last; ++i) {
      const long long q = i - first;
      if ((int)(q & 1) != pair) continue;
      const long long tile = i / NC;
      const int col0 = (int)(i % NC) * BN;
      const long long row0 = tile * kBM + half * 64;  // this warpgroup's rows
      if constexpr (kKind != kResidual) {  // the LN kinds
        if (tile != stats_tile) {  // the warp's 16 rows of the new row tile
          const TA* x = static_cast<const TA*>(p.x);
          switch (cv) {
#define STATS_CASE(V)                                                                    \
  case V:                                                                                \
    row_stats<V, kCut>(x, row0 + 16 * warp, p.M, p.K, p.eps, lane, m0, s0, m1, s1);     \
    break;
            STATS_CASE(1) STATS_CASE(2) STATS_CASE(3) STATS_CASE(4) STATS_CASE(5) STATS_CASE(6)
#undef STATS_CASE
            default: break;
          }
          stats_tile = tile;
        }
      }
      mainloop<BN, kKind, kCut, kPasses, kPromote, TA>(acc, ring, KT, q, pair, half, warp, lane,
                                                       p.ln_g, p.ln_b, m0, s0, m1, s1);
      if constexpr (kCut >= kWhole) {
        const int N = p.N, M = p.M;
        const float* bias = p.bias;
        if constexpr (kKind == kGelu) {
          staged_epilogue<BN, kCut != kNoStores>(
              acc, row0, col0, M, N, warp, lane, staging, static_cast<float*>(p.out), N,
              [&](float& a, float& b, int n) {
                const float2 bv = n < N ? hopper_gemm::load_pair(bias + n) : make_float2(0.f, 0.f);
                a = hopper_gemm::gelu_erf(a + bv.x);
                b = hopper_gemm::gelu_erf(b + bv.y);
              });
        } else if constexpr (kKind == kQkv) {  // the item's columns lie in one output
          const int S = p.split, part = col0 / S, lc = col0 - part * S;
          float* out = static_cast<float*>(part == 0 ? p.out : part == 1 ? p.out1 : p.out2);
          const float* b_part = bias + part * S;
          staged_epilogue<BN, kCut != kNoStores>(
              acc, row0, lc, M, S, warp, lane, staging, out, S,
              [&](float& a, float& b, int n) {
                const float2 bv = n < S ? hopper_gemm::load_pair(b_part + n) : make_float2(0.f, 0.f);
                a += bv.x;
                b += bv.y;
              });
        } else {
          const float* gamma = p.gamma;
          hopper_gemm::residual_epilogue<BN, kCut != kNoStores>(
              acc, row0, col0, M, N, warp, lane, staging, static_cast<const ResT*>(p.res),
              static_cast<OutT*>(p.out), N,
              [&](float& a, float& b, int n) {
                const float2 bv = n < N ? hopper_gemm::load_pair(bias + n) : make_float2(0.f, 0.f);
                const float2 gv = n < N ? hopper_gemm::load_pair(gamma + n) : make_float2(0.f, 0.f);
                a = (a + bv.x) * gv.x;
                b = (b + bv.y) * gv.y;
              });
        }
      } else if constexpr (kCut == kProducts) {  // keep the products live, write nothing
        if (acc[0] == 1234.5678f) static_cast<float*>(p.out)[0] = acc[BN / 2 - 1];
      }
    }
  }
}

// A's tensor map: f32 rows in boxes of 128 rows x 32 columns (128 bytes) under
// the 128-byte swizzle, bf16 rows in boxes of 128 x 32 (64 bytes) under the
// 64-byte one (the swizzle's span is a box row; a_quad reads both)
template <typename TA>
inline bool make_a_map(CUtensorMap* map, const void* a, int M, int K) {
  if constexpr (sizeof(TA) == 4) {
    return hopper_gemm::make_map(map, a, M, K, kBM, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4);
  } else {
    const hopper_gemm::EncodeTiledFn fn = hopper_gemm::encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
    const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)kBM};
    const cuuint32_t elem[2] = {1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(a), dims, strides, box,
              elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
}

template <int BN, int kKind, int kCut, typename OutT, int kPasses, bool kPromote, typename TA,
          typename ResT>
cudaError_t launch_bn(const Params& p, const void* a, const void* w_hi, const void* w_lo,
                      cudaStream_t stream) {
  static hopper_gemm::SmemGrant grant;
  if (p.K <= 0 || p.K % kBK || p.N <= 0 || p.N % BN || p.stages < 2 || p.stages > kMaxStages)
    return cudaErrorInvalidValue;
  if (kKind != kResidual && (p.K > kMaxLnK || !p.x || !p.ln_g || !p.ln_b))
    return cudaErrorInvalidValue;
  if (kKind == kResidual && (!p.gamma || !p.res)) return cudaErrorInvalidValue;
  if (kKind == kQkv) {  // S = 2 or 3 outputs of `split` columns, each a whole number of tiles
    const int S = p.split > 0 ? p.N / p.split : 0;
    if (p.split <= 0 || p.split % BN || S * p.split != p.N || S < 2 || S > 3 || !p.out ||
        !p.out1 || (S == 3 && !p.out2))
      return cudaErrorInvalidValue;
  }
  constexpr int kStage = stage_bytes(BN, sizeof(TA));
  if ((size_t)kStage > hopper_gemm::kMaxTxBytes) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(BN, p.stages, sizeof(TA));
  if (smem > hopper_gemm::kSmemLimit) return cudaErrorInvalidValue;
  CUtensorMap a_map, whi_map, wlo_map;
  constexpr CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!make_a_map<TA>(&a_map, a, p.M, p.K) ||
      !hopper_gemm::make_map(&whi_map, w_hi, p.N, p.K, BN, f32, 4) ||
      !hopper_gemm::make_map(&wlo_map, w_lo, p.N, p.K, BN, f32, 4))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = hopper_gemm::sm_count(&dev, &sms);
  if (err != cudaSuccess) return err;
  const void* kernel = (const void*)tf32_kernel<BN, kKind, kCut, OutT, kPasses, kPromote, TA, ResT>;
  err = hopper_gemm::grant_smem(kernel, smem, grant, dev);
  if (err != cudaSuccess) return err;
  const long long items = (long long)hopper_gemm::ceil_div(p.M, kBM) * (p.N / BN);
  const int grid = items < sms ? (int)items : sms;
  tf32_kernel<BN, kKind, kCut, OutT, kPasses, kPromote, TA, ResT>
      <<<grid, kThreads, smem, stream>>>(a_map, whi_map, wlo_map, p);
  return cudaGetLastError();
}

// a: x (the LN kinds), the hidden or the attention output (kResidual), TA (M,
// K); w_hi, w_lo: f32 (N, K), split and K-permuted (ops/kernels/tf32.py:
// tf32_weight); bn: 32, 64, 96 or 128, with `promote` (chunked sums, the
// plan's choice for K > 384) 32 or 64
template <int kKind, int kCut, typename OutT = float, int kPasses = 3, typename TA = float,
          typename ResT = float>
cudaError_t launch(const Params& p, const void* a, const void* w_hi, const void* w_lo, int bn,
                   int promote, cudaStream_t stream) {
  if (p.M == 0) return cudaSuccess;
  if (p.M < 0) return cudaErrorInvalidValue;
#define TF32_BN(B, PROMOTE) \
  launch_bn<B, kKind, kCut, OutT, kPasses, PROMOTE, TA, ResT>(p, a, w_hi, w_lo, stream)
  if (promote) {
    switch (bn) {
      case 32: return TF32_BN(32, true);
      case 64: return TF32_BN(64, true);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (bn) {
    case 32: return TF32_BN(32, false);
    case 64: return TF32_BN(64, false);
    case 96: return TF32_BN(96, false);
    case 128: return TF32_BN(128, false);
    default: return cudaErrorInvalidValue;
  }
#undef TF32_BN
}

}  // namespace tf32_gemm
