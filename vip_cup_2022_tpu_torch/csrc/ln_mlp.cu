// LN -> MLP -> layer scale -> residual in one pass, for Hopper (sm_90a).
//
//   out = residual + gamma * (fc2(gelu(fc1(LN(x)) + b1)) + b2)
//
// on M rows of C channels, with the (M, hidden) hidden kept on chip. One
// kernel template, instantiated for three memory layouts of x, residual and
// out (bf16 all three):
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
// A CTA of 8 warps owns BM rows (64, or 32 for C > 384):
//   1. stage the bf16 x tile in shared memory; for the two strided layouts
//      the load runs along r, so a warp reads contiguous addresses, 16
//      bytes (8 rows of one channel) a thread where 8 rows are contiguous;
//   2. two-pass f32 LayerNorm (eps given), written back over the tile in
//      bf16;
//   3. for each chunk of HN = 8192 / BM hidden units: fc1 (BM, HN) = LN(x)
//      W1[chunk]^T with wmma bf16 and f32 accumulation, + b1, exact erff
//      GELU, rounded to bf16 into shared memory; then fc2 (BM, C) +=
//      hidden W2[:, chunk]^T, accumulated in f32 wmma fragments that live
//      in registers for the whole kernel;
//   4. (+ b2) * gamma + residual in f32 through a shared-memory tile,
//      rounded to bf16 and stored in the input's layout (along r, 8 rows a
//      thread where they are contiguous, for the strided layouts).
// W1 and W2 stream through a ring of (rows, 32) K slices by cp.async, one
// ring for both GEMMs (a slice is HN rows of W1 or C rows of W2).
//
// What bounds it on the card: 4 M C hidden bf16 tensor-core operations
// against 6 M C bytes of activations; at ConvNeXt's C = 96 that is ~100
// FLOP/byte (bytes bound), from C = 192 on operations. Its design removes
// the (M, hidden) round trip through device memory that the two-launch
// ln_fc1_gelu + fc2_scale_residual pair makes; it keeps that pair's
// warp-level wmma (not wgmma fed by TMA).
//
// Every launcher has a plain C interface for ctypes and returns
// cudaGetLastError() as an int, so a refused launch reaches the caller.

#include "block_gemm.cuh"

using namespace block_gemm;

namespace {

enum Layout { kRowsLayout = 0, kBatchLane = 1, kChanFirst = 2 };

constexpr int kWarps = kThreads / 32;  // 8

// shared memory of the main loop: the LN tile, the hidden tile, the weight
// ring and a 1 KB f32 fragment stage per warp
constexpr size_t loop_bytes(int bm, int c, int stages) {
  return (size_t)bm * (c + kPad) * 2 + (size_t)bm * (8192 / bm + kPad) * 2 +
         (size_t)stages * (8192 / bm > c ? 8192 / bm : c) * kLd * 2 + (size_t)kWarps * 256 * 4;
}

template <int BM, int C>
struct Cfg {
  static constexpr int MT = BM / 16;            // row blocks of 16
  static constexpr int HN = 8192 / BM;          // hidden chunk: 32 fc1 tiles, 4 a warp
  static constexpr int NT = BM * C / 2048;      // fc2 output tiles a warp owns
  static constexpr int WCOLS = kWarps / MT;     // warps sharing one row block
  static constexpr int LDA = C + kPad;          // x / LN tile (bf16)
  static constexpr int LDH = HN + kPad;         // hidden tile (bf16)
  static constexpr int LDO = C + 4;             // output tile (f32)
  static constexpr int SLICE = (HN > C ? HN : C) * kLd;  // bf16 of one ring slot
  static constexpr int STAGES = loop_bytes(BM, C, 3) <= kSmemLimit ? 3 : 2;
  static constexpr size_t epi_bytes = (size_t)BM * LDO * 4;
  static constexpr size_t smem =
      loop_bytes(BM, C, STAGES) > epi_bytes ? loop_bytes(BM, C, STAGES) : epi_bytes;
  static_assert(C % 32 == 0 && NT * 2048 == BM * C, "C must split into whole warp tiles");
  static_assert(loop_bytes(BM, C, STAGES) <= kSmemLimit, "tile does not fit in shared memory");
};

// global offset of element (r, c) of the activation in `layout`
template <int L>
__device__ __forceinline__ long long act_offset(long long r, int c, int C, long long M, int B) {
  if constexpr (L == kRowsLayout) return r * C + c;
  if constexpr (L == kBatchLane) return (r / B) * (long long)C * B + (long long)c * B + r % B;
  return (long long)c * M + r;
}

template <int BM, int C, int L>
__global__ void __launch_bounds__(kThreads)
ln_mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
              const float* __restrict__ ln_g, const float* __restrict__ ln_b,
              const bf16* __restrict__ w1, const float* __restrict__ b1,
              const bf16* __restrict__ w2, const float* __restrict__ b2,
              const float* __restrict__ gamma, bf16* __restrict__ out,
              long long M, int hidden, int B, float eps) {
  using K = Cfg<BM, C>;
  constexpr int S = K::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Hs = As + BM * K::LDA;
  bf16* ring = Hs + BM * K::LDH;
  float* stage = reinterpret_cast<float*>(ring + S * K::SLICE);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* wstage = stage + warp * 256;
  const long long r0 = (long long)blockIdx.x * BM;
  // the strided layouts move 8 rows of one channel per 16 bytes when every
  // aligned group of 8 rows is contiguous there (and M is a multiple of 8)
  const bool vec8 = L == kChanFirst ? M % 8 == 0 : B % 8 == 0;

  // ring steps: per hidden chunk, C/32 slices of W1 then HN/32 slices of W2
  constexpr int F1 = C / kBK, F2 = K::HN / kBK, SPC = F1 + F2;
  const int T = hidden / K::HN * SPC;
  auto load_slice = [&](int t) {
    bf16* dst = ring + (t % S) * K::SLICE;
    const int chunk = t / SPC, s = t % SPC;
    const bf16* src;
    int rows, ld;
    if (s < F1) {  // W1 (hidden, C): rows [chunk*HN, +HN), cols [s*32, +32)
      src = w1 + (long long)chunk * K::HN * C + s * kBK;
      rows = K::HN;
      ld = C;
    } else {  // W2 (C, hidden): rows [0, C), cols [chunk*HN + (s-F1)*32, +32)
      src = w2 + (long long)chunk * K::HN + (s - F1) * kBK;
      rows = C;
      ld = hidden;
    }
    for (int i = threadIdx.x; i < rows * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), v = i % (kBK / 8);
      cp_async16(dst + r * kLd + v * 8, src + (long long)r * ld + v * 8, true);
    }
  };
  for (int s = 0; s < S - 1; ++s) {  // start streaming weights before the LN
    if (s < T) load_slice(s);
    cp_async_commit();
  }

  // 1. the raw bf16 tile; rows past M read as zero and are never stored
  if constexpr (L == kRowsLayout) {
    for (int i = threadIdx.x; i < BM * (C / 8); i += kThreads) {
      const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r0 + r < M) v = *reinterpret_cast<const uint4*>(x + (r0 + r) * C + c8);
      *reinterpret_cast<uint4*>(As + r * K::LDA + c8) = v;
    }
  } else if (vec8) {  // 8 rows of one channel per 16-byte load, along r
    for (int i = threadIdx.x; i < BM / 8 * C; i += kThreads) {
      const int r = i % (BM / 8) * 8, c = i / (BM / 8);
      Pack8 v;
      v.u = make_uint4(0, 0, 0, 0);
      if (r0 + r < M) v.u = *reinterpret_cast<const uint4*>(x + act_offset<L>(r0 + r, c, C, M, B));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        As[(r + 2 * e) * K::LDA + c] = v.h[e].x;
        As[(r + 2 * e + 1) * K::LDA + c] = v.h[e].y;
      }
    }
  } else {  // one element at a time, along r
    for (int i = threadIdx.x; i < BM * C; i += kThreads) {
      const int r = i % BM, c = i / BM;
      const long long gr = r0 + r;
      As[r * K::LDA + c] = gr < M ? x[act_offset<L>(gr, c, C, M, B)] : __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  // 2. two-pass f32 LayerNorm of each row, written back over it in bf16
  const float inv_c = 1.0f / (float)C;
  for (int r = warp; r < BM; r += kWarps) {
    bf16* row = As + r * K::LDA;
    float mean = 0.f, var = 0.f;
    for (int c = lane; c < C; c += 32) mean += __bfloat162float(row[c]);
    mean = warp_sum(mean) * inv_c;
    for (int c = lane; c < C; c += 32) {
      const float d = __bfloat162float(row[c]) - mean;
      var += d * d;
    }
    const float rstd = rsqrtf(warp_sum(var) * inv_c + eps);
    for (int c = lane; c < C; c += 32)
      row[c] = __float2bfloat16((__bfloat162float(row[c]) - mean) * rstd * ln_g[c] + ln_b[c]);
  }

  // 3. the MLP. Warp w owns row block tm = w % MT; its fc1 tiles are column
  // blocks w / MT + WCOLS * i (i < 4) of the chunk, its fc2 tiles column
  // blocks w / MT + WCOLS * i (i < NT) of C.
  const int tm = warp % K::MT, tc = warp / K::MT;
  FragC o[K::NT], h[4];
#pragma unroll
  for (int i = 0; i < K::NT; ++i) wmma::fill_fragment(o[i], 0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) wmma::fill_fragment(h[i], 0.f);

  for (int t = 0; t < T; ++t) {
    if constexpr (S == 3) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();  // slice t landed; slot t-1 is free; As / Hs are written
    if (t + S - 1 < T) load_slice(t + S - 1);
    cp_async_commit();

    const bf16* sl = ring + (t % S) * K::SLICE;
    const int chunk = t / SPC, s = t % SPC;
    if (s < F1) {  // fc1 K slice s of the chunk
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, As + tm * 16 * K::LDA + s * kBK + kk, K::LDA);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          FragB fb;
          wmma::load_matrix_sync(fb, sl + (tc + K::WCOLS * i) * 16 * kLd + kk, kLd);
          wmma::mma_sync(h[i], fa, fb, h[i]);
        }
      }
      if (s == F1 - 1) {  // the chunk's fc1 is done: + b1, GELU, bf16 into Hs
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v[8], bv[8];
          stage_fragment(wstage, h[i], v);
          const int col = (tc + K::WCOLS * i) * 16 + (lane & 1) * 8;
          load8(b1 + chunk * K::HN + col, bv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = gelu_erf(v[e] + bv[e]);
          store8(Hs + (tm * 16 + (lane >> 1)) * K::LDH + col, v);
          wmma::fill_fragment(h[i], 0.f);
        }
      }
    } else {  // fc2 K slice s - F1 of the chunk
      const int k0 = (s - F1) * kBK;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        FragA fa;
        wmma::load_matrix_sync(fa, Hs + tm * 16 * K::LDH + k0 + kk, K::LDH);
#pragma unroll
        for (int i = 0; i < K::NT; ++i) {
          FragB fb;
          wmma::load_matrix_sync(fb, sl + (tc + K::WCOLS * i) * 16 * kLd + kk, kLd);
          wmma::mma_sync(o[i], fa, fb, o[i]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with As, Hs and the ring

  // 4. epilogue through an f32 (BM, C) tile over the loop's shared memory
  float* Os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < K::NT; ++i)
    wmma::store_matrix_sync(Os + tm * 16 * K::LDO + (tc + K::WCOLS * i) * 16, o[i], K::LDO,
                            wmma::mem_row_major);
  __syncthreads();
  if constexpr (L == kRowsLayout) {
    for (int i = threadIdx.x; i < BM * (C / 8); i += kThreads) {
      const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
      if (r0 + r >= M) continue;
      float v[8], bv[8], g[8], rv[8];
      load8(Os + r * K::LDO + c8, v);
      load8(b2 + c8, bv);
      load8(gamma + c8, g);
      load8(res + (r0 + r) * C + c8, rv);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = (v[e] + bv[e]) * g[e] + rv[e];
      store8(out + (r0 + r) * C + c8, v);
    }
  } else if (vec8) {
    for (int i = threadIdx.x; i < BM / 8 * C; i += kThreads) {
      const int r = i % (BM / 8) * 8, c = i / (BM / 8);
      if (r0 + r >= M) continue;
      const long long off = act_offset<L>(r0 + r, c, C, M, B);
      float v[8], rv[8];
      load8(res + off, rv);
      const float bc = b2[c], gc = gamma[c];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = (Os[(r + e) * K::LDO + c] + bc) * gc + rv[e];
      store8(out + off, v);
    }
  } else {
    for (int i = threadIdx.x; i < BM * C; i += kThreads) {
      const int r = i % BM, c = i / BM;
      const long long gr = r0 + r;
      if (gr >= M) continue;
      const long long off = act_offset<L>(gr, c, C, M, B);
      const float v = (Os[r * K::LDO + c] + b2[c]) * gamma[c] + __bfloat162float(res[off]);
      out[off] = __float2bfloat16(v);
    }
  }
}

template <int BM, int C, int L>
cudaError_t launch(const bf16* x, const bf16* res, const float* ln_g, const float* ln_b,
                   const bf16* w1, const float* b1, const bf16* w2, const float* b2,
                   const float* gamma, bf16* out, long long M, int hidden, int B, float eps,
                   cudaStream_t stream) {
  using K = Cfg<BM, C>;
  static SmemGrant grant;
  if (hidden % K::HN) return cudaErrorInvalidValue;
  const cudaError_t err = grant_smem((const void*)ln_mlp_kernel<BM, C, L>, K::smem, grant);
  if (err != cudaSuccess) return err;
  const long long blocks = (M + BM - 1) / BM;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ln_mlp_kernel<BM, C, L><<<(unsigned)blocks, kThreads, K::smem, stream>>>(
      x, res, ln_g, ln_b, w1, b1, w2, b2, gamma, out, M, hidden, B, eps);
  return cudaGetLastError();
}

// the channel widths with an instantiation: 64-row tiles up to C = 384,
// 32-row tiles above (the f32 fc2 accumulator of 64 x 768 would not fit a
// CTA's registers)
template <int L>
cudaError_t dispatch(const void* x, const void* res, const void* ln_g, const void* ln_b,
                     const void* w1, const void* b1, const void* w2, const void* b2,
                     const void* gamma, void* out, long long M, int C, int hidden, int B,
                     float eps, void* stream) {
  if (M == 0) return cudaSuccess;
  if (M < 0 || hidden <= 0 || B <= 0) return cudaErrorInvalidValue;
#define LN_MLP_ARGS                                                                      \
  (const bf16*)x, (const bf16*)res, (const float*)ln_g, (const float*)ln_b,              \
      (const bf16*)w1, (const float*)b1, (const bf16*)w2, (const float*)b2,              \
      (const float*)gamma, (bf16*)out, M, hidden, B, eps, (cudaStream_t)stream
  switch (C) {
    case 32: return launch<64, 32, L>(LN_MLP_ARGS);
    case 64: return launch<64, 64, L>(LN_MLP_ARGS);
    case 96: return launch<64, 96, L>(LN_MLP_ARGS);
    case 128: return launch<64, 128, L>(LN_MLP_ARGS);
    case 192: return launch<64, 192, L>(LN_MLP_ARGS);
    case 256: return launch<64, 256, L>(LN_MLP_ARGS);
    case 384: return launch<64, 384, L>(LN_MLP_ARGS);
    case 512: return launch<32, 512, L>(LN_MLP_ARGS);
    case 768: return launch<32, 768, L>(LN_MLP_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef LN_MLP_ARGS
}

}  // namespace

extern "C" {

// rows: x, res, out (M, C)
int ln_mlp_rows(const void* x, const void* res, const void* ln_g, const void* ln_b,
                const void* w1, const void* b1, const void* w2, const void* b2,
                const void* gamma, void* out, long long M, int C, int hidden, float eps,
                void* stream) {
  return (int)dispatch<kRowsLayout>(x, res, ln_g, ln_b, w1, b1, w2, b2, gamma, out, M, C,
                                    hidden, 1, eps, stream);
}

// batch-lane: x, res, out (P, C, B), M = P * B
int ln_mlp_batchlane(const void* x, const void* res, const void* ln_g, const void* ln_b,
                     const void* w1, const void* b1, const void* w2, const void* b2,
                     const void* gamma, void* out, long long M, int C, int hidden, int B,
                     float eps, void* stream) {
  return (int)dispatch<kBatchLane>(x, res, ln_g, ln_b, w1, b1, w2, b2, gamma, out, M, C,
                                   hidden, B, eps, stream);
}

// channel-first: x, res, out (C, M)
int ln_mlp_chanfirst(const void* x, const void* res, const void* ln_g, const void* ln_b,
                     const void* w1, const void* b1, const void* w2, const void* b2,
                     const void* gamma, void* out, long long M, int C, int hidden, float eps,
                     void* stream) {
  return (int)dispatch<kChanFirst>(x, res, ln_g, ln_b, w1, b1, w2, b2, gamma, out, M, C,
                                   hidden, 1, eps, stream);
}

}  // extern "C"
