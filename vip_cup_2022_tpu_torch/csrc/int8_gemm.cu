// The int8 and bf16 tensor-core GEMMs for Hopper (sm_90a):
//
//   int8_spike_bf16    bf16 x (M, K) @ bf16 w (K, N), f32 accumulation
//                      -> bf16 or f32 (M, N)
//   int8_spike_int8    f32 or bf16 x (M, K) quantized on load with a static
//                      scale (q = clamp(rint(x * inv_sx), +-127)) @ int8
//                      w (K, N), s32 accumulation -> f32(acc) * sx -> f32 or
//                      bf16 (M, N)
//   int8_spike_direct  int8 x (M, K) @ int8 w (K, N) -> s32 (M, N)
//
// on one mma.sync template (below), and the int8 site of post-training
// quantization on ptq_int8.cuh's wgmma + TMA kernels (its note says how):
//
//   ptq_int8_quantize  f32 or bf16 x -> int8 clamp(rint(x * inv_s), +-127)
//   ptq_int8_conv      that int8 x @ int8 per-output-channel weights
//                      (N, Kp), s32 accumulation -> f32(acc) * colscale[n]
//                      (+ bias[n]) -> f32 or bf16. A is either rows of an
//                      (M, K) matrix (a Dense site, a 1x1 stride-1 conv) or
//                      an implicit-GEMM gather from NHWC x (a k x k or
//                      strided conv): row m = (b, oh, ow), column
//                      k = (kh, kw, c), zeros in the symmetric padding.
//
// The spike bodies replace the TPU kernel `_call` of
// tools/int8_pallas_spike.py (its three bodies `_bf16_kernel`,
// `_int8_kernel`, `_int8_direct_kernel`, one pallas_call over row tiles of x
// against the whole of w in VMEM); the PTQ pair, XLA's int8
// conv_general_dilated / dot_general of vip_cup_2022_tpu/quant/ptq.py
// (`_int8_conv`, `_handle_dense`).
//
// Numerics, bit for bit with the JAX package: the activation is multiplied
// by the f32 reciprocal of its scale (the wrapper rounds the f64 1 / s once)
// and rounded half to even (__float2int_rn, as jnp.round), then clamped;
// the s32 sum is converted with round to nearest, multiplied by the f32
// scale (PTQ: then the f32 bias is added; no fused multiply-add).
//
// What bounds the spike bodies on this card: at the spike's shapes the
// int8 GEMM has 2 M K N operations against bytes of x, w and the output; at
// 1,979 int8 TOP/s and 3.35 TB/s the operations bound it once K N / (K + N)
// passes about 600 for a bf16 x. Their design is the simple one: 128 x 128
// output tiles per block of 8 warps (each 64 x 32), mma.sync m16n8k32 s8
// (m16n8k16 bf16, whose fragments have the same byte layout) fed from
// shared memory, K in 64-byte slices with two shared-memory buffers and the
// next slice's global loads in flight in registers while the current one is
// multiplied; two blocks per SM (registers capped at 128, a few bytes
// spilled in the f32-x instantiations) hide more of the loads' latency than
// one block of up to 198 registers did (PERF.md). The activation is
// converted (quantized) once, on its way into shared memory. Moving the
// three onto ptq_int8.cuh's wgmma + TMA kernel is later work.
//
// The launchers have a plain C interface for ctypes and return
// cudaGetLastError() as an int, so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "ptq_int8.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;    // 8 warps: 2 along M x 4 along N
constexpr int kMinBlocks = 2;    // CTAs per SM: registers capped at 128 a thread
constexpr int kBM = 128;         // output rows per block
constexpr int kBN = 128;         // output columns per block
constexpr int kBKB = 64;         // bytes of K per slice: 64 int8 or 32 bf16
constexpr int kLd = kBKB + 16;   // shared row stride in bytes: conflict-free fragment loads
constexpr int kGC = kBKB / 4;    // 4-byte A groups per row of a slice
constexpr int kAGroups = kBM * kGC / kThreads;  // A groups per thread per slice
static_assert(kBKB % 32 == 0 && kThreads % kGC == 0, "slice must split over the block");

enum Epilogue { kCast = 0, kScalar = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t quantize(float v, float inv) {
  int q = __float2int_rn(__fmul_rn(v, inv));
  q = q > 127 ? 127 : (q < -127 ? -127 : q);
  return static_cast<uint32_t>(q) & 0xffu;
}

// Raw A elements of one 4-byte group in registers: 4 f32, 4 or 2 bf16, or 4 int8.
template <typename XT, typename MT>
struct RawA {
  static constexpr int kElems = 4 / sizeof(MT);
  static constexpr int kBytes = kElems * sizeof(XT);
  static constexpr int kWords = kBytes / 4;
  uint32_t w[kWords];
};

template <typename XT, typename MT>
__device__ __forceinline__ void load_raw(RawA<XT, MT>& r, const XT* p, bool ok) {
  constexpr int kWords = RawA<XT, MT>::kWords;
  if (!ok) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) r.w[i] = 0u;
    return;
  }
  if constexpr (kWords == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    r.w[0] = v.x; r.w[1] = v.y; r.w[2] = v.z; r.w[3] = v.w;
  } else if constexpr (kWords == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    r.w[0] = v.x; r.w[1] = v.y;
  } else {
    r.w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// The 4 bytes of shared memory one group becomes: converted (quantized)
// when x is wider than the product type, copied as it is otherwise.
template <typename XT, typename MT>
__device__ __forceinline__ uint32_t convert(const RawA<XT, MT>& r, float inv) {
  if constexpr (sizeof(XT) == sizeof(MT)) {
    return r.w[0];
  } else {
    const XT* e = reinterpret_cast<const XT*>(r.w);
    return quantize(to_f32(e[0]), inv) | (quantize(to_f32(e[1]), inv) << 8) |
           (quantize(to_f32(e[2]), inv) << 16) | (quantize(to_f32(e[3]), inv) << 24);
  }
}

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2],
                                    int8_t) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2],
                                    bf16) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename OutT>
__device__ __forceinline__ void store2(OutT* p, float v0, float v1);
template <>
__device__ __forceinline__ void store2<float>(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float v0, float v1) {
  __nv_bfloat162 h;
  h.x = __float2bfloat16_rn(v0);
  h.y = __float2bfloat16_rn(v1);
  *reinterpret_cast<__nv_bfloat162*>(p) = h;
}

// B is w (K, N) row-major (the JAX layout), transposed into shared memory on
// the way.
template <typename MT>
struct BLoader {
  // int8: 4 x 4-byte blocks, bf16: 2 x 2-element blocks
  static constexpr int kGroups = (kBKB / 4) * (sizeof(MT) == 1 ? 32 : 64) / kThreads;
  uint32_t r[kGroups][4];

  __device__ __forceinline__ void load(const MT* __restrict__ w, int k0, int n0, int K, int N) {
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int g = threadIdx.x + j * kThreads;
      if constexpr (sizeof(MT) == 1) {
        const int n = n0 + (g % 32) * 4, k = k0 + (g / 32) * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[j][i] = (n < N && k + i < K)
                        ? *reinterpret_cast<const uint32_t*>(w + (long long)(k + i) * N + n)
                        : 0u;
      } else {
        const int n = n0 + (g % 64) * 2, k = k0 + (g / 64) * 2;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          r[j][i] = (n < N && k + i < K)
                        ? *reinterpret_cast<const uint32_t*>(w + (long long)(k + i) * N + n)
                        : 0u;
      }
    }
  }

  // Into Bs[n][k bytes], row stride kLd.
  __device__ __forceinline__ void store(unsigned char* __restrict__ bs) const {
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int g = threadIdx.x + j * kThreads;
      if constexpr (sizeof(MT) == 1) {
        // 4 k-rows x 4 columns of bytes -> 4 columns x 4 k bytes
        const uint32_t t0 = __byte_perm(r[j][0], r[j][1], 0x5140);
        const uint32_t t1 = __byte_perm(r[j][0], r[j][1], 0x7362);
        const uint32_t t2 = __byte_perm(r[j][2], r[j][3], 0x5140);
        const uint32_t t3 = __byte_perm(r[j][2], r[j][3], 0x7362);
        unsigned char* p = bs + ((g % 32) * 4) * kLd + (g / 32) * 4;
        *reinterpret_cast<uint32_t*>(p) = __byte_perm(t0, t2, 0x5410);
        *reinterpret_cast<uint32_t*>(p + kLd) = __byte_perm(t0, t2, 0x7632);
        *reinterpret_cast<uint32_t*>(p + 2 * kLd) = __byte_perm(t1, t3, 0x5410);
        *reinterpret_cast<uint32_t*>(p + 3 * kLd) = __byte_perm(t1, t3, 0x7632);
      } else {
        // 2 k-rows x 2 bf16 columns -> 2 columns x 2 k values
        unsigned char* p = bs + ((g % 64) * 2) * kLd + (g / 64) * 4;
        *reinterpret_cast<uint32_t*>(p) = __byte_perm(r[j][0], r[j][1], 0x5410);
        *reinterpret_cast<uint32_t*>(p + kLd) = __byte_perm(r[j][0], r[j][1], 0x7632);
      }
    }
  }
};

template <typename XT, typename MT, int kEpi, typename OutT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gemm_kernel(const XT* __restrict__ x, const MT* __restrict__ w, OutT* __restrict__ out,
            int M, int K, int N, float inv, float scale) {
  typedef typename std::conditional<sizeof(MT) == 1, int, float>::type AccT;
  constexpr int kElems = 4 / sizeof(MT);   // A elements per 4-byte group
  constexpr int kBK = kBKB / sizeof(MT);   // K elements per slice
  __shared__ __align__(16) unsigned char As[2][kBM * kLd];
  __shared__ __align__(16) unsigned char Bs[2][kBN * kLd];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;  // warp tile: rows wm*64.., columns wn*32..
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int gc = tid % kGC;  // this thread's A group column; rows tid / kGC + (kThreads / kGC) i

  RawA<XT, MT> ra[kAGroups];
  BLoader<MT> rb;

  auto load_a = [&](int k0) {
    const int k = k0 + gc * kElems;
#pragma unroll
    for (int i = 0; i < kAGroups; ++i) {
      const int m = m0 + tid / kGC + (kThreads / kGC) * i;
      load_raw(ra[i], x + (long long)m * K + k, m < M && k < K);
    }
  };
  auto store_a = [&](unsigned char* as) {
#pragma unroll
    for (int i = 0; i < kAGroups; ++i)
      *reinterpret_cast<uint32_t*>(as + (tid / kGC + (kThreads / kGC) * i) * kLd + gc * 4) =
          convert(ra[i], inv);
  };

  AccT acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = AccT(0);

  const int slices = (K + kBK - 1) / kBK;
  load_a(0);
  rb.load(w, 0, n0, K, N);
  store_a(As[0]);
  rb.store(Bs[0]);
  __syncthreads();

  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < slices;
    if (more) {  // next slice's global loads in flight during this slice's products
      load_a((s + 1) * kBK);
      rb.load(w, (s + 1) * kBK, n0, K, N);
    }
    const unsigned char* as = As[cur] + (wm * 64) * kLd;
    const unsigned char* bs = Bs[cur] + (wn * 32) * kLd;
#pragma unroll
    for (int kc = 0; kc < kBKB / 32; ++kc) {  // 32-byte K chunks of the slice
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned char* p = as + (i * 16 + g) * kLd + kc * 32 + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* p = bs + (j * 8 + g) * kLd + kc * 32 + t * 4;
        bfr[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bfr[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], af[i], bfr[j], MT());
    }
    if (more) {
      store_a(As[cur ^ 1]);
      rb.store(Bs[cur ^ 1]);
    }
    __syncthreads();
  }

  // epilogue: lane (g, t) holds rows g and g + 8, columns 2t and 2t + 1 of each 16 x 8 tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn * 32 + j * 8 + 2 * t;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + i * 16 + g + h * 8;
        if (m >= M) continue;
        const AccT a0 = acc[i][j][2 * h], a1 = acc[i][j][2 * h + 1];
        OutT* p = out + (long long)m * N + n;
        if constexpr (std::is_same<OutT, int>::value) {
          *reinterpret_cast<int2*>(p) = make_int2(a0, a1);
        } else if constexpr (kEpi == kCast) {
          store2<OutT>(p, static_cast<float>(a0), static_cast<float>(a1));
        } else {
          store2<OutT>(p, __fmul_rn(__int2float_rn(a0), scale), __fmul_rn(__int2float_rn(a1), scale));
        }
      }
    }
  }
}

template <typename XT, typename MT, int kEpi, typename OutT>
int launch(const void* x, const void* w, void* out, int M, int K, int N, float inv, float scale,
           void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<XT, MT, kEpi, OutT><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const XT*>(x), static_cast<const MT*>(w), static_cast<OutT*>(out), M, K, N, inv,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int int8_spike_bf16(const void* x, const void* w, void* out, int out_f32, int M, int K, int N,
                    void* stream) {
  return out_f32 ? launch<bf16, bf16, kCast, float>(x, w, out, M, K, N, 0.f, 0.f, stream)
                 : launch<bf16, bf16, kCast, bf16>(x, w, out, M, K, N, 0.f, 0.f, stream);
}

int int8_spike_int8(const void* x, int x_f32, const void* w, void* out, int out_f32, int M, int K,
                    int N, float inv_sx, float sx, void* stream) {
  if (x_f32)
    return out_f32 ? launch<float, int8_t, kScalar, float>(x, w, out, M, K, N, inv_sx, sx, stream)
                   : launch<float, int8_t, kScalar, bf16>(x, w, out, M, K, N, inv_sx, sx, stream);
  return out_f32 ? launch<bf16, int8_t, kScalar, float>(x, w, out, M, K, N, inv_sx, sx, stream)
                 : launch<bf16, int8_t, kScalar, bf16>(x, w, out, M, K, N, inv_sx, sx, stream);
}

int int8_spike_direct(const void* x, const void* w, void* out, int M, int K, int N, void* stream) {
  return launch<int8_t, int8_t, kCast, int>(x, w, out, M, K, N, 0.f, 0.f, stream);
}

// n values of f32 (x_f32) or bf16 x -> int8 q, n a multiple of 4
int ptq_int8_quantize(const void* x, int x_f32, void* q, long long n, float inv_s, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(x_f32 ? ptq_int8::launch_quantize<float>(x, q, n, inv_s, st)
                     : ptq_int8::launch_quantize<bf16>(x, q, n, inv_s, st));
}

// a: the quantized x (src 0: (M, K) rows; src 1: NHWC (B, H, W, C), the conv
// KH x KW at `stride` with symmetric `pad`, output (B, Ho, Wo, N) with M = B
// Ho Wo and K = KH KW C) or, with src 2, the bf16 x rows themselves,
// quantized in the GEMM with inv_s (bf16 output only); w (N, ldw) int8,
// K-major; the plan from ops/kernels/int8_gemm.py:
// ptq_plan (bn, stages, resident, tall)
int ptq_int8_conv(const void* a, const void* w, int ldw, const float* colscale,
                  const float* bias, void* out, int out_f32, int M, int K, int N, int src,
                  float inv_s, int H, int W, int C, int KW, int stride, int pad, int Ho, int Wo,
                  int bn, int stages, int resident, int tall, void* stream) {
  const ptq_int8::Params p{(const int8_t*)a, inv_s, colscale, bias, out, M, K, N, ldw, H, W,
                           C, KW, stride, pad, Ho, Wo, stages, resident};
  const cudaStream_t st = (cudaStream_t)stream;
  constexpr int kWhole = hopper_gemm::kWhole;
  return (int)(out_f32 ? ptq_int8::launch_gemm<float, kWhole>(p, w, src, bn, tall != 0, st)
                       : ptq_int8::launch_gemm<bf16, kWhole>(p, w, src, bn, tall != 0, st));
}

}  // extern "C"
