// The int8 site of post-training quantization (ptq_int8_conv) for Hopper
// (sm_90a), on hopper_gemm.cuh's wgmma + TMA engine, in two launches:
//
//   quantize_kernel<XT>   f32 or bf16 x -> int8 q = clamp(rint(x * inv), +-127)
//                         in x's layout (rows, or NHWC for a conv), once
//   ptq_gemm_kernel<BN, OutT, kSrc, kTall, kCut, ET, kScaled>
//                         int8 A @ int8 W (N, Kp)^T, s32 accumulation ->
//                         f32(acc) * colscale[n] (+ bias[n]) -> f32 or bf16
//                         (M, N). A is the rows of q (M, K) (a Dense site or a
//                         1x1 stride-1 conv; kRows) or the implicit-GEMM
//                         gather of NHWC q (kGather): row m = (b, oh, ow),
//                         column k = (kh, kw, c), zeros in the symmetric
//                         padding. A bf16 rows site whose output spans at
//                         most two column tiles skips the pass (kRowsQuant):
//                         its consumers quantize A themselves.
//
// They replace XLA's int8 conv_general_dilated and dot_general of the JAX
// package's PTQ pass (vip_cup_2022_tpu/quant/ptq.py: _int8_conv,
// _handle_dense), which the port first ran on K13's mma.sync template.
//
// The same GEMM runs the three bodies of K13's TPU kernel (`_call` of
// tools/int8_pallas_spike.py; int8_gemm.cu's entry points):
// `_int8_kernel` is the quantize pass (or kRowsQuant) and the GEMM with
// colscale[n] = sx and no bias; `_int8_direct_kernel` the GEMM with the s32
// sums stored as they are (kScaled false, OutT int); `_bf16_kernel` the GEMM
// on bf16 operands (ET bf16: wgmma m64nBNk16 bf16 -> f32, 64 bf16 a K tile,
// W packed (N, Kp) K-major as the int8 weights are, the f32 sums stored as
// f32 or rounded once to bf16).
//
// Numerics, bit for bit with the plain version: x * inv in f32 (the f32
// reciprocal of the site's scale) rounded half to even and clamped; exact
// s32 sums; the sum converted with round to nearest, multiplied by the f32
// column scale, then the f32 bias added (__fmul_rn, __fadd_rn: no FMA); one
// rounding to bf16 where the output is bf16.
//
// What bounds it on this card: at ResNetRS50's sites (K = 64 ... 4608, N =
// 64 ... 2048, M up to 640,000 rows at batch 256) the 1x1 sites by the bytes
// of x and the output, the 3x3 sites at c2/c3 by bytes and at c4/c5 by the
// int8 products. What the design does about it:
//
// - Products: wgmma m64nBNk32 s8 x s8 -> s32 (WgmmaS8), both operands
//   K-major from 128-byte-swizzled shared memory, a K tile being 128 int8 of
//   one 128-byte row. A work item is 128 rows x BN columns (BN = 64 for the
//   N = 64 sites, else 128), each warpgroup of a consumer pair 64 rows.
// - The engine's schedule: persistent CTAs of 640 threads, two consumer
//   pairs in ping-pong behind the order barrier (one pair's epilogue runs
//   while the other's products do), a producer warpgroup, an mbarrier ring
//   (hopper_gemm.cuh: Ring, mainloop, setmaxnreg).
// - W by TMA (UINT8 tensor map, boxes of BN rows x 128 bytes). Where all of
//   it fits beside three ring stages the producer loads it once per CTA
//   (ring.held) and the ring carries A alone. Where it streams (the wide
//   1x1 and the 3x3 sites: every 128-row item read all of its column slice
//   of W from L2, as many bytes as its A), items are 256 rows tall (kTall):
//   the two pairs multiply the two 128-row halves at once against each
//   stage's one W tile, half W's traffic, without the ping-pong.
// - x quantized once: a conv's 3x3 windows read each x element 9 times, so
//   quantizing on the way into every A tile would repeat the conversion 9
//   times (and, for N > BN, once more for every column tile); the separate
//   pass reads x once and writes a quarter (f32) or half (bf16) of its bytes.
//   Where a bf16 rows site's output spans one or two column tiles, the pass
//   would cost more bytes than quantizing in the GEMM: there (kRowsQuant)
//   TMA brings two swizzled boxes of 64 bf16 columns per stage and each
//   consumer warpgroup quantizes its 64 rows into the A tile before its
//   products (QuantRows: rint by the 1.5 * 2^23 add, no conversion-unit
//   instruction), the two pairs' ping-pong hiding one's quantizing behind
//   the other's products.
// - A of a rows site by TMA (boxes of 128 rows x 128 bytes, zeros past M
//   and K); of a gathered site by the producer warpgroup's 128 threads:
//   each row's window once per item into a small table (a pointer to its
//   top-left input pixel and a mask of the taps inside the image, so that a
//   stage's address is that pointer plus the tap's offset, and its bounds
//   check one bit), then per stage pieces of 16 bytes (16 channels of one
//   tap; 4 bytes where C is not a multiple of 16), two adjacent pieces of a
//   row a thread where C is a multiple of 32, the lanes of a warp along K
//   so that each row's 128 bytes are read whole, each a cp.async.ca
//   (neighbouring rows' 3x3 windows overlap in L1) with zero fill for the
//   padding, straight into the swizzled A tile. The stage's barrier is
//   completed by cp.async.mbarrier.arrive, and the consumers fence the async
//   proxy before their products read the tile. The gather is bound by the
//   producer's issue of addresses and copies more than by its bytes (the
//   loads cut of tools/exp_ptq_int8.py, PERF.md).
// - Epilogue: the accumulators, scaled in f32 in their own layout (an exact
//   integer-to-float by the bits of 1.5 * 2^23 where |acc| < 2^22), go 32
//   columns at a time through a 2 KB f32 staging tile per warp to lanes that
//   each hold 8 consecutive columns of a row, stored as 16 bytes (bf16) or
//   32 (f32): whole sectors. (Staging bf16 by stmatrix instead, as
//   hopper_gemm.cuh's epilogue does, was measured slower here.)
//
// kCut makes phase-cut instantiations for timing (csrc/ptq_int8_cuts.cu):
// hg::kLoads (the loads of A and W only), hg::kProducts (+ wgmma),
// hg::kWhole (+ the epilogue: the kernel itself), hg::kNoStores.
#pragma once

#include <type_traits>

#include "hopper_gemm.cuh"

namespace ptq_int8 {

namespace hg = hopper_gemm;
typedef hg::bf16 bf16;

constexpr int kBM = hg::kBM;              // rows of a work item: 64 a warpgroup of the pair
constexpr int kTileK = hg::kRowBytes;     // int8 of K per stage: one 128-byte swizzle row
constexpr int kATile = kBM * kTileK;      // bytes of a stage's A tile
constexpr int kStagingBytes = hg::kConsumers * 4 * hg::kResEpilogueBytes;  // 2 KB a consumer warp
constexpr int kTallBM = 2 * kBM;          // rows of a tall item: a pair's 128 each, one W tile
constexpr int kGeoBytes = 2 * kTallBM * 16;  // two tables of the gathered rows' windows (16 B each)
constexpr int kProducerBar = 2;           // named barrier of the producer warpgroup
constexpr int kConsumerBar0 = 3;          // + wg: named barrier of consumer warpgroup wg

// Where A comes from:
enum Source : int {
  kRows = 0,       // x quantized beforehand, (M, K) int8 rows by TMA
  kGather = 1,     // x quantized beforehand, NHWC int8, gathered by cp.async
  kRowsQuant = 2,  // bf16 (M, K) rows by TMA, quantized by the consumers into the A tile
};
// the gathering producer warpgroup keeps more registers than the one TMA thread needs
constexpr int kGatherProducerRegs = 32;
static_assert((hg::kConsumers * hg::kConsumerRegs + kGatherProducerRegs) * hg::kWarpgroup <=
                  hg::kEntryRegs * hg::kThreads,
              "setmaxnreg cannot hand out more registers than the launch granted");

struct Params {
  const int8_t* x;  // quantized A: rows (M, K), or NHWC (B, H, W, C) with kGather; with
                    // kRowsQuant the bf16 x (M, K) itself, quantized with inv; bf16 rows
                    // for the bf16 GEMM
  float inv;
  const float* colscale;  // unused where the sums are stored unscaled
  const float* bias;  // or nullptr
  void* out;          // OutT (M, N)
  int M, K, N, Kp;    // K = KH KW C; W is (N, Kp), K-major, zeros past K
  int H, W, C, KW, stride, pad, Ho, Wo;  // the conv's geometry (kGather)
  int stages, resident;
};

// The operands' element type: int8 (s8 wgmma, s32 sums) or bf16 (f32 sums).
// A K tile is one 128-byte swizzle row of either.
template <typename ET, int BN>
struct Operand;
template <int BN>
struct Operand<int8_t, BN> {
  typedef hg::WgmmaS8<BN> Mma;
  typedef int Acc;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};
template <int BN>
struct Operand<bf16, BN> {
  typedef hg::Wgmma<BN> Mma;
  typedef float Acc;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// bytes of W held in shared memory: a tile per (column tile, K tile); K in
// elements of `esize` bytes
inline size_t held_bytes(int bn, int N, int K, int esize = 1) {
  return (size_t)hg::ceil_div(N, bn) * hg::ceil_div((long long)K * esize, kTileK) * bn * kTileK;
}

// a stage: the int8 A tile (two of them for a tall item), W's tile unless it
// is held, and with kRowsQuant the two bf16 boxes (64 columns each) that A
// is quantized from
__host__ __device__ inline size_t stage_bytes(int bn, bool resident, int src, bool tall) {
  return kATile * (tall ? 2 : 1) + (resident ? 0 : bn * kTileK) +
         (src == kRowsQuant ? 2 * kATile : 0);
}

inline size_t gemm_smem_bytes(int bn, int stages, bool resident, int N, int K, int src,
                              bool tall, int esize = 1) {
  return hg::kBarrierBytes(stages) + hg::kAlign + kStagingBytes +
         (src == kGather ? kGeoBytes : 0) + (resident ? held_bytes(bn, N, K, esize) : 0) +
         (size_t)stages * stage_bytes(bn, resident, src, tall);
}

// ---------------------------------------------------------------------------
// the quantize pass
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t quantize(float v, float inv) {
  int q = __float2int_rn(__fmul_rn(v, inv));
  q = q > 127 ? 127 : (q < -127 ? -127 : q);
  return static_cast<uint32_t>(q) & 0xffu;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ uint32_t quantize4(const float4& v, float inv) {
  return quantize(v.x, inv) | (quantize(v.y, inv) << 8) | (quantize(v.z, inv) << 16) |
         (quantize(v.w, inv) << 24);
}

// groups of kPer (4 or 16) consecutive values, a thread a group per step:
// 16 values are 32 (bf16) or 64 (f32) bytes in flight and one 16-byte store
template <typename XT, int kPer>
__global__ void __launch_bounds__(256)
quantize_kernel(const XT* __restrict__ x, int8_t* __restrict__ q, long long groups, float inv) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < groups; i += step) {
    const XT* src = x + kPer * i;
    if constexpr (kPer == 16) {
      float4 v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = load4(src + 4 * e);
      *reinterpret_cast<uint4*>(q + 16 * i) = make_uint4(quantize4(v[0], inv), quantize4(v[1], inv),
                                                         quantize4(v[2], inv), quantize4(v[3], inv));
    } else {
      *reinterpret_cast<uint32_t*>(q + 4 * i) = quantize4(load4(src), inv);
    }
  }
}

template <typename XT>
cudaError_t launch_quantize(const void* x, void* q, long long n, float inv, cudaStream_t stream) {
  if (n % 4) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  const cudaError_t err = hg::sm_count(&dev, &sms);
  if (err != cudaSuccess) return err;
  const int per = n % 16 == 0 ? 16 : 4;
  const long long groups = n / per, blocks = (groups + 255) / 256, most = (long long)sms * 16;
  const int grid = (int)(blocks < most ? blocks : most);
  if (per == 16)
    quantize_kernel<XT, 16><<<grid, 256, 0, stream>>>(static_cast<const XT*>(x),
                                                      static_cast<int8_t*>(q), groups, inv);
  else
    quantize_kernel<XT, 4><<<grid, 256, 0, stream>>>(static_cast<const XT*>(x),
                                                     static_cast<int8_t*>(q), groups, inv);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the gather: cp.async with zero fill, completion tracked by an mbarrier
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
// the barrier counts one arrival when this thread's cp.asyncs so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(hg::smem_u32(bar))
               : "memory");
}

// Where a producer thread's pieces of a stage's K tile lie: tap (kh, kw)
// and channel c; `advance` moves them to the next K tile.
struct TapPos {
  int tap, kh, kw, c;

  __device__ __forceinline__ void advance(int bytes, int C, int KW) {
    c += bytes;
    while (c >= C) {
      c -= C;
      ++tap;
      if (++kw == KW) {
        kw = 0;
        ++kh;
      }
    }
  }
};

// A gathered row's window, computed once per item: a pointer to the input
// pixel at its top-left tap (outside x where the window starts in the
// padding; dereferenced only at taps inside) and a mask of the taps that
// fall inside the image (bit kh KW + kw; KW <= 8).
struct __align__(16) RowWindow {
  const int8_t* origin;
  unsigned long long taps;
};

__device__ __forceinline__ RowWindow row_window(const Params& p, long long m) {
  if (m >= p.M) return {p.x, 0ull};  // past M: every tap is padding
  const int r = (int)(m / p.Wo), ow = (int)(m - (long long)r * p.Wo);
  const int b = r / p.Ho, oh = r - b * p.Ho;
  const int ih0 = oh * p.stride - p.pad, iw0 = ow * p.stride - p.pad;
  unsigned long long taps = 0;
  for (int kh = 0, t = 0; kh < p.KW; ++kh)
    for (int kw = 0; kw < p.KW; ++kw, ++t)
      if ((unsigned)(ih0 + kh) < (unsigned)p.H && (unsigned)(iw0 + kw) < (unsigned)p.W)
        taps |= 1ull << t;
  return {p.x + ((long long)b * p.H * p.W + (long long)ih0 * p.W + iw0) * p.C, taps};
}

// the gather's pieces: kVec bytes a cp.async (16, or 4 where C is not a
// multiple of 16), kPieces of them a row per thread (2 where C is a multiple
// of 32: both in one tap), so kPerRow threads cover a row's 128 bytes of K
template <int kVec, int kPieces>
struct GatherShape {
  static constexpr int kPerRow = kTileK / (kVec * kPieces);
  static constexpr int kStep = hg::kWarpgroup / kPerRow;  // rows between a thread's rows
  static __device__ __forceinline__ int first_byte(int pt) { return (pt % kPerRow) * kVec * kPieces; }
};

// One producer thread's part of a stage's A tile: its pieces at byte
// first_byte(pt) of the K tile (tap and channel `pos`) in rows
// pt / kPerRow + kStep i of the item, whose windows are in `win`. Each piece
// is a cp.async into its swizzled place, zero-filled where the tap falls in
// the padding or past K. kRows: the item's rows (a tall item's 256 rows
// fill its two A tiles, which lie back to back).
template <int kVec, int kPieces, int kRows>
__device__ __forceinline__ void gather_stage(const Params& p, const RowWindow* win,
                                             uint32_t a_tile, const TapPos& pos, int pt) {
  typedef GatherShape<kVec, kPieces> Shape;
  const int kb = Shape::first_byte(pt);
  const bool k_ok = pos.tap < p.KW * p.KW;
  const int tap = k_ok ? pos.tap : 0;
  const long long off = ((long long)pos.kh * p.W + pos.kw) * p.C + pos.c;
#pragma unroll
  for (int i = 0; i < kRows / Shape::kStep; ++i) {
    const int r = pt / Shape::kPerRow + Shape::kStep * i;
    const RowWindow w = win[r];
    const bool ok = k_ok && ((w.taps >> tap) & 1ull);
    const int8_t* src = ok ? w.origin + off : p.x;
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      const int b = kb + j * kVec;
      const uint32_t dst = a_tile + r * kTileK + ((((b >> 4) ^ (r & 7))) << 4) + (b & 15);
      if constexpr (kVec == 16) cp_async16(dst, src + j * kVec, ok);
      else cp_async4(dst, src + j * kVec, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// kRowsQuant: the consumers quantize their rows of A
// ---------------------------------------------------------------------------
// four f32 -> four int8 clamp(rint(v * inv), +-127): clamped first (the
// bounds are integers, so the order does not matter), then rounded half to
// even by the add of 1.5 * 2^23, whose low byte is the int8: ALU work only,
// where __float2int_rn would wait on the conversion unit (a quarter rate)
__device__ __forceinline__ uint32_t quantize4_alu(float a, float b, float c, float d, float inv) {
  auto q = [inv](float v) {
    const float t = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
    return __float_as_uint(__fadd_rn(t, 12582912.f));
  };
  return __byte_perm(__byte_perm(q(a), q(b), 0x0040), __byte_perm(q(c), q(d), 0x0040), 0x5410);
}

// eight bf16 -> four int8 pairs, as two words
__device__ __forceinline__ uint2 quantize8_alu(const uint4& v, float inv) {
  auto lo = [](uint32_t w) { return __uint_as_float(w << 16); };
  auto hi = [](uint32_t w) { return __uint_as_float(w & 0xffff0000u); };
  return make_uint2(quantize4_alu(lo(v.x), hi(v.x), lo(v.y), hi(v.y), inv),
                    quantize4_alu(lo(v.z), hi(v.z), lo(v.w), hi(v.w), inv));
}

// Once a kRowsQuant stage has landed: each warp of the consumer warpgroup
// quantizes its 16 rows of the two swizzled bf16 boxes (K columns 0-63 and
// 64-127 of the tile) into the swizzled int8 A tile, lane l taking row l / 2
// and box l % 2 (16 bf16 -> one 16-byte chunk at a time, the two boxes'
// lanes a chunk apart so that they hit different banks), then publishes it
// to the warpgroup's wgmma (proxy fence, the warpgroup's named barrier).
struct QuantRows {
  uint32_t ring_base;
  int stage_bytes, raw_offset;
  float inv;
  int row0, lane, bar;  // the warp's first row in the tile

  __device__ __forceinline__ void operator()(int s) const {
    const uint32_t a_tile = ring_base + (uint32_t)s * stage_bytes;
    const int r = row0 + (lane >> 1), h = lane & 1, r7 = r & 7;
    const uint32_t raw = a_tile + raw_offset + h * kATile + r * kTileK;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = (jj + 2 * h) & 3;
      const uint2 lo = quantize8_alu(hg::lds128(raw + (((2 * j) ^ r7) << 4)), inv);
      const uint2 hi = quantize8_alu(hg::lds128(raw + (((2 * j + 1) ^ r7) << 4)), inv);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       a_tile + r * kTileK + (((4 * h + j) ^ r7) << 4)),
                   "r"(lo.x), "r"(lo.y), "r"(hi.x), "r"(hi.y)
                   : "memory");
    }
    hg::fence_proxy_async();
    hg::named_bar_sync(bar, hg::kWarpgroup);
  }
};

// ---------------------------------------------------------------------------
// the epilogue
// ---------------------------------------------------------------------------
__device__ __forceinline__ void stg64_if(bool pred, void* ptr, uint32_t a, uint32_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n@p st.global.v2.u32 [%1], {%2, %3};\n}\n" ::"r"(
          (int)pred),
      "l"(ptr), "r"(a), "r"(b));
}

// f32(acc) rounded to nearest. kSmall, where |acc| < 2^22 (127^2 K < 2^22:
// K <= 260), by the bits of 1.5 * 2^23 + acc, exact: an integer add and a
// float subtraction in place of the conversion unit's I2F, a quarter of
// whose rate the epilogue of a K = 64 site would otherwise wait on.
template <bool kSmall>
__device__ __forceinline__ float s32_to_f32(int a) {
  if constexpr (kSmall) return __int_as_float(a + 0x4B400000) - 12582912.0f;
  else return __int2float_rn(a);
}

// one warp's 16 rows of a (64, BN) accumulator tile (first row row0, first
// column col0): with kScaled, s32 sums as f32(acc) * colscale (+ bias);
// else f32 sums as they are, or s32 sums as their bits (OutT int). Each in
// the accumulators' layout, then 32 columns at a time through the warp's
// 2 KB staging tile to lanes holding 8 consecutive columns of a row, stored
// in whole sectors. N is a multiple of 4; a bf16 row is stored as 16 bytes
// where N is a multiple of 8, else as two 8-byte halves. Rows >= M, columns
// >= N are not stored.
template <int BN, bool kStore, bool kSmall, bool kScaled, typename AccT, typename OutT>
__device__ __forceinline__ void scale_epilogue(AccT (&acc)[BN / 2], long long row0, int col0,
                                               int M, int N, int warp, int lane,
                                               uint8_t* staging, const float* colscale,
                                               const float* bias, OutT* out) {
  static_assert(BN % 32 == 0, "the epilogue writes 32-column pieces");
  static_assert(kScaled == std::is_same<AccT, int>::value || std::is_same<OutT, int>::value,
                "s32 sums are scaled or stored as s32; f32 sums are stored as they are");
  const uint32_t st = hg::smem_u32(staging);
  const bool wide = N % 8 == 0;
#pragma unroll
  for (int q = 0; q < BN / 32; ++q) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int c8 = 4 * q + c, col = 8 * c + 2 * (lane & 3), n = col0 + 32 * q + col;
      float2 cs = make_float2(0.f, 0.f), bv = make_float2(0.f, 0.f);
      if constexpr (kScaled) {
        if (n < N) cs = hg::load_pair(colscale + n);
        if (n < N && bias != nullptr) bv = hg::load_pair(bias + n);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a, b;
        if constexpr (kScaled) {
          a = __fmul_rn(s32_to_f32<kSmall>(acc[4 * c8 + 2 * h]), cs.x);
          b = __fmul_rn(s32_to_f32<kSmall>(acc[4 * c8 + 2 * h + 1]), cs.y);
          if (bias != nullptr) {
            a = __fadd_rn(a, bv.x);
            b = __fadd_rn(b, bv.y);
          }
        } else if constexpr (std::is_same<AccT, int>::value) {  // s32 out: the sums' bits
          a = __int_as_float(acc[4 * c8 + 2 * h]);
          b = __int_as_float(acc[4 * c8 + 2 * h + 1]);
        } else {
          a = acc[4 * c8 + 2 * h];
          b = acc[4 * c8 + 2 * h + 1];
        }
        hg::sts64(st + hg::stage32_offset((lane >> 2) + 8 * h, col), a, b);
      }
    }
    hg::warp_sync();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = 8 * half + (lane >> 2), c = lane & 3;
      const uint4 lo = hg::lds128(st + hg::stage32_offset(rl, 8 * c));
      const uint4 hi = hg::lds128(st + hg::stage32_offset(rl, 8 * c + 4));
      const long long row = row0 + warp * 16 + rl;
      const int n = col0 + 32 * q + 8 * c;
      const bool live = row < M && n < N, all8 = live && n + 8 <= N;
      OutT* dst = out + row * N + n;
      if constexpr (sizeof(OutT) == 4) {
        if constexpr (kStore) {
          hg::stg128_if(live, dst, lo);
          hg::stg128_if(all8, dst + 4, hi);
        } else if (lo.x == 0x12345678u && hi.w == 0x12345678u) {  // keep the results live
          out[0] = OutT(0.f);
        }
      } else {
        const uint32_t w0 = hg::pack_bf16(__uint_as_float(lo.x), __uint_as_float(lo.y));
        const uint32_t w1 = hg::pack_bf16(__uint_as_float(lo.z), __uint_as_float(lo.w));
        const uint32_t w2 = hg::pack_bf16(__uint_as_float(hi.x), __uint_as_float(hi.y));
        const uint32_t w3 = hg::pack_bf16(__uint_as_float(hi.z), __uint_as_float(hi.w));
        if constexpr (kStore) {
          if (wide) {
            hg::stg128_if(live, dst, make_uint4(w0, w1, w2, w3));
          } else {
            stg64_if(live, dst, w0, w1);
            stg64_if(all8, dst + 4, w2, w3);
          }
        } else if (w0 == 0x12345678u && w3 == 0x12345678u) {  // keep the results live
          out[0] = __float2bfloat16(0.f);
        }
      }
    }
    hg::warp_sync();
  }
}

// ---------------------------------------------------------------------------
// the GEMM
// ---------------------------------------------------------------------------
// kTall: 256-row items whose two 128-row halves the two consumer pairs
// multiply at once against each stage's one W tile (no ping-pong): for the
// sites whose W streams through the ring, half its traffic from L2.
// ET: the operands' type (int8, or bf16 for the spike's bf16 body); kScaled:
// the colscale (+ bias) epilogue, else the sums stored as they are.
template <int BN, typename OutT, int kSrc, bool kTall, int kCut, typename ET = int8_t,
          bool kScaled = true>
__global__ void __launch_bounds__(hg::kThreads, 1)
ptq_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                const __grid_constant__ CUtensorMap w_map, const Params p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  typedef Operand<ET, BN> Op;
  constexpr bool kGat = kSrc == kGather, kQuant = kSrc == kRowsQuant;
  constexpr int kItemRows = kTall ? kTallBM : kBM, kATiles = kTall ? 2 : 1;
  constexpr int kTileElems = kTileK / sizeof(ET);  // K elements of a K tile
  static_assert(!(kTall && kQuant), "a tall item's A comes quantized");
  static_assert(sizeof(ET) == 1 || kSrc == kRows, "bf16 A comes as rows by TMA");
  const int KT = hg::ceil_div(p.K, kTileElems);
  const int n_cols = hg::ceil_div(p.N, BN);
  const long long items = (long long)hg::ceil_div(p.M, kItemRows) * n_cols;
  const uint32_t w_tile = BN * kTileK;
  hg::Ring ring;
  // a gathered stage is complete once the producer's expect_tx and each of
  // its 128 threads' cp.asyncs have arrived; a tall item's stage is released
  // by both pairs
  hg::init_ring(ring, smem, p.stages, kGat ? 1 + hg::kWarpgroup : 1,
                kTall ? 2 * hg::kPairWarps : hg::kPairWarps);
  uint8_t* staging_base = hg::aligned_base(smem, p.stages);
  RowWindow* win_base = reinterpret_cast<RowWindow*>(staging_base + kStagingBytes);
  uint8_t* held = staging_base + kStagingBytes + (kGat ? kGeoBytes : 0);
  ring.base = held + (p.resident ? (size_t)n_cols * KT * w_tile : 0);
  ring.stage_bytes = (int)stage_bytes(BN, p.resident, kSrc, kTall);
  ring.b_offset = kATiles * kATile;
  const int raw_offset = kATile + (p.resident ? 0 : w_tile);  // kQuant's bf16 boxes
  ring.stages = p.stages;
  __syncthreads();

  const int wg = threadIdx.x / hg::kWarpgroup;
  const int lane = threadIdx.x % 32;
  if (wg == hg::kConsumers) {  // producer warpgroup
    if constexpr (kGat) hg::reg_dealloc<kGatherProducerRegs>();
    else hg::reg_dealloc<hg::kProducerRegs>();
    const int pt = threadIdx.x - hg::kConsumers * hg::kWarpgroup;
    if (pt == 0 && p.resident) {
      hg::mbar_expect_tx(ring.held, n_cols * KT * w_tile);
      for (int i = 0; i < n_cols * KT; ++i)
        hg::tma_load(held + (size_t)i * w_tile, &w_map, ring.held, (i % KT) * kTileElems,
                     (i / KT) * BN);
    }
    if (!kGat && pt != 0) return;
    // a gathered A: the shape of the pieces, and where this thread's lie in the first K tile
    const int shape = p.C % 32 == 0 ? 2 : p.C % 16 == 0 ? 1 : 0;
    TapPos first{0, 0, 0, 0};
    if (kGat)
      first.advance(shape == 2   ? GatherShape<16, 2>::first_byte(pt)
                    : shape == 1 ? GatherShape<16, 1>::first_byte(pt)
                                 : GatherShape<4, 1>::first_byte(pt),
                    p.C, p.KW);
    long long g = 0;
    int lt = 0;
    for (long long t = blockIdx.x; t < items; t += gridDim.x, ++lt) {
      const long long row0 = (t / n_cols) * kItemRows;
      const int col0 = (int)(t % n_cols) * BN;
      RowWindow* win = win_base + (lt & 1) * kTallBM;
      if constexpr (kGat) {  // the item's rows: thread pt computes rows pt (and pt + 128)
#pragma unroll
        for (int h = 0; h < kATiles; ++h) win[pt + h * kBM] = row_window(p, row0 + pt + h * kBM);
        hg::named_bar_sync(kProducerBar, hg::kWarpgroup);
      }
      TapPos pos = first;
      for (int kt = 0; kt < KT; ++kt, ++g) {
        const int s = (int)(g % p.stages);
        hg::mbar_wait(&ring.empty[s], (int)(((g / p.stages) & 1) ^ 1));
        uint8_t* stage = ring.base + (size_t)s * ring.stage_bytes;
        if (pt == 0) {
          hg::mbar_expect_tx(&ring.full[s], (kGat ? 0 : kQuant ? 2 * kATile : kATiles * kATile) +
                                                (p.resident ? 0 : w_tile));
          if (kQuant) {  // two boxes of 64 bf16 columns
            hg::tma_load(stage + raw_offset, &a_map, &ring.full[s], kt * kTileK, (int)row0);
            hg::tma_load(stage + raw_offset + kATile, &a_map, &ring.full[s], kt * kTileK + 64,
                         (int)row0);
          } else if (!kGat) {
#pragma unroll
            for (int h = 0; h < kATiles; ++h)
              hg::tma_load(stage + h * kATile, &a_map, &ring.full[s], kt * kTileElems,
                           (int)row0 + h * kBM);
          }
          if (!p.resident)
            hg::tma_load(stage + ring.b_offset, &w_map, &ring.full[s], kt * kTileElems, col0);
        }
        if constexpr (kGat) {
          const uint32_t a_tile = hg::smem_u32(stage);
          if (shape == 2) gather_stage<16, 2, kItemRows>(p, win, a_tile, pos, pt);
          else if (shape == 1) gather_stage<16, 1, kItemRows>(p, win, a_tile, pos, pt);
          else gather_stage<4, 1, kItemRows>(p, win, a_tile, pos, pt);
          cp_async_arrive(&ring.full[s]);
          pos.advance(kTileK, p.C, p.KW);
        }
      }
    }
  } else {  // consumer warpgroups: pair wg / 2 takes every other item (kTall: every item,
            // its rows 128 pair ... 128 pair + 127), half wg % 2 64 of those rows
    hg::reg_alloc<hg::kConsumerRegs>();
    const int warp = (threadIdx.x % hg::kWarpgroup) / 32;
    const int pair = wg >> 1, half = wg & 1;
    uint8_t* staging = staging_base + (threadIdx.x / 32) * hg::kResEpilogueBytes;
    OutT* out = static_cast<OutT*>(p.out);
    if (p.resident) hg::mbar_wait(ring.held, 0);
    const bool small = (long long)p.K * 127 * 127 < (1LL << 22);
    typename Op::Acc acc[BN / 2];
    long long q = 0;
    for (long long t = blockIdx.x; t < items; t += gridDim.x, ++q) {
      if (!kTall && (int)(q & 1) != pair) continue;
      const int j = (int)(t % n_cols);
      const int a_half = (kTall ? pair * kATile : 0) + half * 64 * kTileK;
      const uint32_t b_addr = p.resident ? hg::smem_u32(held) + (uint32_t)(j * KT) * w_tile : 0u;
      if constexpr (kQuant) {
        const QuantRows quant{hg::smem_u32(ring.base), ring.stage_bytes, raw_offset, p.inv,
                              half * 64 + warp * 16, lane, kConsumerBar0 + wg};
        hg::mainloop<BN, kCut, typename Op::Mma, false>(acc, ring, KT, q, q * KT, false, 0, true,
                                                        0, 0, half * 64 * kTileK, b_addr, w_tile,
                                                        0, pair, lane, quant);
      } else {
        hg::mainloop<BN, kCut, typename Op::Mma, kGat, !kTall>(acc, ring, KT, q, q * KT, false,
                                                               0, true, 0, 0, a_half, b_addr,
                                                               w_tile, 0, pair, lane);
      }
      if constexpr (kCut >= hg::kWhole) {
        const long long r0 = (t / n_cols) * kItemRows + (kTall ? pair * kBM : 0) + half * 64;
        if (kScaled && small)
          scale_epilogue<BN, kCut != hg::kNoStores, true, kScaled>(
              acc, r0, j * BN, p.M, p.N, warp, lane, staging, p.colscale, p.bias, out);
        else
          scale_epilogue<BN, kCut != hg::kNoStores, false, kScaled>(
              acc, r0, j * BN, p.M, p.N, warp, lane, staging, p.colscale, p.bias, out);
      } else if constexpr (kCut == hg::kProducts) {  // keep the products live, write nothing
        if (acc[0] == 12345678) out[0] = OutT(0.f);
      }
    }
  }
}

template <int BN, typename OutT, int kSrc, bool kTall, int kCut, typename ET, bool kScaled>
cudaError_t launch_gemm_bn(const Params& p, const void* w, cudaStream_t stream) {
  static hg::SmemGrant grant;
  constexpr int esize = sizeof(ET);
  typedef Operand<ET, BN> Op;
  // TMA: 16-byte row strides, W's rows padded to Kp
  if (p.stages < 2 || p.stages > hg::kMaxStages || p.N % 4 || p.K > p.Kp ||
      (long long)p.Kp * esize % 16 ||
      (kSrc == kRows && (long long)p.K * esize % 16) || (kSrc == kRowsQuant && p.K % 8) ||
      (kSrc == kGather && (p.C % 4 || p.C <= 0 || p.KW <= 0 || p.KW > 8)))
    return cudaErrorInvalidValue;
  if (p.resident && held_bytes(BN, p.N, p.K, esize) > hg::kMaxTxBytes)
    return cudaErrorInvalidValue;
  const size_t smem = gemm_smem_bytes(BN, p.stages, p.resident, p.N, p.K, kSrc, kTall, esize);
  if (smem > hg::kSmemLimit) return cudaErrorInvalidValue;
  CUtensorMap a_map, w_map;
  if (!hg::make_map(&w_map, w, p.N, p.Kp, BN, Op::kMap, esize))
    return cudaErrorInvalidValue;
  if (kSrc == kGather) a_map = w_map;  // unused
  else if (kSrc == kRowsQuant ? !hg::make_map(&a_map, p.x, p.M, p.K, kBM)
                              : !hg::make_map(&a_map, p.x, p.M, p.K, kBM, Op::kMap, esize))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = hg::sm_count(&dev, &sms);
  if (err != cudaSuccess) return err;
  const void* kernel = (const void*)ptq_gemm_kernel<BN, OutT, kSrc, kTall, kCut, ET, kScaled>;
  err = hg::grant_smem(kernel, smem, grant, dev);
  if (err != cudaSuccess) return err;
  const long long items =
      (long long)hg::ceil_div(p.M, kTall ? kTallBM : kBM) * hg::ceil_div(p.N, BN);
  const int grid = items < sms ? (int)items : sms;
  ptq_gemm_kernel<BN, OutT, kSrc, kTall, kCut, ET, kScaled>
      <<<grid, hg::kThreads, smem, stream>>>(a_map, w_map, p);
  return cudaGetLastError();
}

// bn 64 or 128; tall items with bn 128 only (the sites whose W streams)
template <typename OutT, int kSrc, int kCut, typename ET, bool kScaled>
cudaError_t launch_gemm_src(const Params& p, const void* w, int bn, bool tall,
                            cudaStream_t stream) {
  if (bn == 64 && !tall)
    return launch_gemm_bn<64, OutT, kSrc, false, kCut, ET, kScaled>(p, w, stream);
  if (bn != 128) return cudaErrorInvalidValue;
  if constexpr (kSrc != kRowsQuant) {
    if (tall) return launch_gemm_bn<128, OutT, kSrc, true, kCut, ET, kScaled>(p, w, stream);
  }
  return tall ? cudaErrorInvalidValue
              : launch_gemm_bn<128, OutT, kSrc, false, kCut, ET, kScaled>(p, w, stream);
}

// src: a Source. int8 operands (ET int8_t): kRowsQuant takes bf16 x and a
// bf16 output only (the path's); with kScaled the s32 sums are scaled to an
// f32 or bf16 output, without it stored as s32 (OutT int). bf16 operands:
// rows only, the f32 sums to an f32 or bf16 output.
template <typename OutT, int kCut, typename ET = int8_t, bool kScaled = true>
cudaError_t launch_gemm(const Params& p, const void* w, int src, int bn, bool tall,
                        cudaStream_t stream) {
  if (p.M == 0) return cudaSuccess;
  if constexpr (sizeof(ET) == 2) {
    return src == kRows ? launch_gemm_src<OutT, kRows, kCut, ET, false>(p, w, bn, tall, stream)
                        : cudaErrorInvalidValue;
  } else {
    switch (src) {
      case kRows:
        return launch_gemm_src<OutT, kRows, kCut, ET, kScaled>(p, w, bn, tall, stream);
      case kGather:
        return launch_gemm_src<OutT, kGather, kCut, ET, kScaled>(p, w, bn, tall, stream);
      case kRowsQuant:
        if constexpr (sizeof(OutT) == 2 && kScaled)
          return launch_gemm_src<OutT, kRowsQuant, kCut, ET, kScaled>(p, w, bn, tall, stream);
        return cudaErrorInvalidValue;
      default: return cudaErrorInvalidValue;
    }
  }
}

}  // namespace ptq_int8
