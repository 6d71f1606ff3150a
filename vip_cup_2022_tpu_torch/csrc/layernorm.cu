// LayerNorm over the last axis for Hopper (sm_90a), channels-last rows.
//
//   layer_norm_{bf16,f32}   x (M, C) bf16 or f32 -> two-pass f32 mean and
//                           variance of each row -> (x - mean) * rsqrt(var +
//                           eps) * g + b -> the same dtype as x
//
// Replaces the TPU kernel `_pallas_ln2` (body `_ln_kernel`) of
// vip_cup_2022_tpu/ops/pallas/norms.py, which `fused_layernorm` calls.
//
// What bounds it: it reads each row once and writes it once (a few f32
// operations per element), so device memory bandwidth. The design keeps a
// whole row in registers: a segment of LPR lanes owns one row, each lane
// holding up to MAXV 16-byte vectors (8 bf16 or 4 f32), so both statistics
// passes and the apply run from registers and x is read from device memory
// exactly once. LPR is the power of two covering C / vector width (up to a
// warp), so narrow rows share a warp: at C = 64 bf16 one warp normalises 4
// rows at once, with 8 lanes per row. Rows past M (the ragged last block)
// compute on zeros and store nothing.
//
// Any other width (C not a multiple of the vector, e.g. the 12 / 26 / 52
// channels of EfficientNetV2T_GC's gc_ln): the same kernel on scalar
// elements (layernorm_any_kernel), a lane holding up to MAXE of them, so the
// row is still read once and both passes run from registers.
//
// Every launcher has a plain C interface for ctypes and returns
// cudaGetLastError() as an int, so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Vec;

template <>
struct Vec<bf16> {  // eight bf16 = one 16-byte load or store
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const bf16* __restrict__ p, float v[N]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(bf16* __restrict__ p, const float v[N]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <>
struct Vec<float> {  // four f32 = one 16-byte load or store
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* __restrict__ p, float v[N]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  __device__ __forceinline__ static void store(float* __restrict__ p, const float v[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// sum over the aligned segment of LPR lanes that holds one row
template <int LPR>
__device__ __forceinline__ float segment_sum(float v) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int LPR, int MAXV>
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, T* __restrict__ out, long long M, int C,
                 float eps) {
  constexpr int VN = Vec<T>::N;
  constexpr int kRowsPerWarp = 32 / LPR;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sl = lane % LPR;  // this lane's place in its row's segment
  const long long row =
      ((long long)blockIdx.x * kWarps + warp) * kRowsPerWarp + lane / LPR;
  const bool valid = row < M;
  const int nvec = C / VN;
  const T* xr = x + (valid ? row : 0) * C;

  float v[MAXV][VN];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int j = sl + i * LPR;  // vector index within the row
    if (valid && j < nvec) {
      Vec<T>::load(xr + j * VN, v[i]);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) v[i][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) s += v[i][e];
  }
  const float inv_c = 1.0f / (float)C;
  const float mean = segment_sum<LPR>(s) * inv_c;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    if (sl + i * LPR < nvec) {
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        const float d = v[i][e] - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(segment_sum<LPR>(q) * inv_c + eps);
  if (!valid) return;  // after the last shuffle: every lane took part in both

  T* orow = out + row * C;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int j = sl + i * LPR;
    if (j < nvec) {
      float gv[VN], bv[VN], o[VN];
#pragma unroll
      for (int e = 0; e < VN; e += 4) {
        const float4 g4 = *reinterpret_cast<const float4*>(g + j * VN + e);
        const float4 b4 = *reinterpret_cast<const float4*>(b + j * VN + e);
        gv[e] = g4.x; gv[e + 1] = g4.y; gv[e + 2] = g4.z; gv[e + 3] = g4.w;
        bv[e] = b4.x; bv[e + 1] = b4.y; bv[e + 2] = b4.z; bv[e + 3] = b4.w;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) o[e] = (v[i][e] - mean) * rstd * gv[e] + bv[e];
      Vec<T>::store(orow + j * VN, o);
    }
  }
}

// One element of T as f32, and back (round to nearest even for bf16).
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void from_f32(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }

// Any C: a segment of LPR lanes owns a row, lane sl holding its elements
// sl + i LPR (i < MAXE) in registers; the same two-pass f32 statistics and
// apply as layernorm_kernel, one element a load and a store.
template <typename T, int LPR, int MAXE>
__global__ void __launch_bounds__(kThreads)
layernorm_any_kernel(const T* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ b, T* __restrict__ out, long long M, int C,
                     float eps) {
  constexpr int kRowsPerWarp = 32 / LPR;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sl = lane % LPR;
  const long long row =
      ((long long)blockIdx.x * kWarps + warp) * kRowsPerWarp + lane / LPR;
  const bool valid = row < M;
  const T* xr = x + (valid ? row : 0) * C;

  float v[MAXE];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < MAXE; ++i) {
    const int j = sl + i * LPR;
    v[i] = valid && j < C ? to_f32(xr[j]) : 0.f;
    s += v[i];
  }
  const float inv_c = 1.0f / (float)C;
  const float mean = segment_sum<LPR>(s) * inv_c;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < MAXE; ++i) {
    if (sl + i * LPR < C) {
      const float d = v[i] - mean;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(segment_sum<LPR>(q) * inv_c + eps);
  if (!valid) return;  // after the last shuffle: every lane took part in both

  T* orow = out + row * C;
#pragma unroll
  for (int i = 0; i < MAXE; ++i) {
    const int j = sl + i * LPR;
    if (j < C) from_f32(orow + j, (v[i] - mean) * rstd * g[j] + b[j]);
  }
}

template <typename T, int LPR, int MAXE>
void launch_any(const T* x, const float* g, const float* b, T* out, long long M, int C,
                float eps, cudaStream_t stream) {
  constexpr long long kRowsPerBlock = (long long)kWarps * (32 / LPR);
  const long long blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  layernorm_any_kernel<T, LPR, MAXE><<<(unsigned)blocks, kThreads, 0, stream>>>(x, g, b, out, M,
                                                                               C, eps);
}

// The segment and the elements a lane holds for a width that is not a
// multiple of the vector: up to 32 lanes x 64 elements.
template <typename T>
int launch_layernorm_any(const T* x, const float* g, const float* b, T* out, long long M, int C,
                         float eps, cudaStream_t stream) {
  int lpr = 1;
  while (lpr < C && lpr < 32) lpr *= 2;
  const int per_lane = (C + lpr - 1) / lpr;
  int maxe = 1;
  while (maxe < per_lane) maxe *= 2;
  switch (lpr * 128 + maxe) {
    case 1 * 128 + 1: launch_any<T, 1, 1>(x, g, b, out, M, C, eps, stream); break;
    case 2 * 128 + 1: launch_any<T, 2, 1>(x, g, b, out, M, C, eps, stream); break;
    case 4 * 128 + 1: launch_any<T, 4, 1>(x, g, b, out, M, C, eps, stream); break;
    case 8 * 128 + 1: launch_any<T, 8, 1>(x, g, b, out, M, C, eps, stream); break;
    case 16 * 128 + 1: launch_any<T, 16, 1>(x, g, b, out, M, C, eps, stream); break;
    case 32 * 128 + 1: launch_any<T, 32, 1>(x, g, b, out, M, C, eps, stream); break;
    case 32 * 128 + 2: launch_any<T, 32, 2>(x, g, b, out, M, C, eps, stream); break;
    case 32 * 128 + 4: launch_any<T, 32, 4>(x, g, b, out, M, C, eps, stream); break;
    case 32 * 128 + 8: launch_any<T, 32, 8>(x, g, b, out, M, C, eps, stream); break;
    case 32 * 128 + 16: launch_any<T, 32, 16>(x, g, b, out, M, C, eps, stream); break;
    case 32 * 128 + 32: launch_any<T, 32, 32>(x, g, b, out, M, C, eps, stream); break;
    case 32 * 128 + 64: launch_any<T, 32, 64>(x, g, b, out, M, C, eps, stream); break;
    default: return (int)cudaErrorInvalidValue;  // C above 32 * 64
  }
  return (int)cudaGetLastError();
}

template <typename T, int LPR, int MAXV>
void launch(const T* x, const float* g, const float* b, T* out, long long M, int C, float eps,
            cudaStream_t stream) {
  constexpr long long kRowsPerBlock = (long long)kWarps * (32 / LPR);
  const long long blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  layernorm_kernel<T, LPR, MAXV><<<(unsigned)blocks, kThreads, 0, stream>>>(x, g, b, out, M, C,
                                                                           eps);
}

// Pick the row segment (LPR lanes) and the vectors each lane holds (MAXV).
template <typename T>
int launch_layernorm(const T* x, const float* g, const float* b, T* out, long long M, int C,
                     float eps, cudaStream_t stream) {
  constexpr int VN = Vec<T>::N;
  if (M == 0) return 0;
  if (C <= 0) return (int)cudaErrorInvalidValue;
  if ((M + kWarps - 1) / kWarps > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (C % VN) return launch_layernorm_any<T>(x, g, b, out, M, C, eps, stream);
  const int nvec = C / VN;
  int lpr = 1;
  while (lpr < nvec && lpr < 32) lpr *= 2;
  const int per_lane = (nvec + lpr - 1) / lpr;
  int maxv = 1;
  while (maxv < per_lane) maxv *= 2;
  switch (lpr * 16 + maxv) {
    case 1 * 16 + 1: launch<T, 1, 1>(x, g, b, out, M, C, eps, stream); break;
    case 2 * 16 + 1: launch<T, 2, 1>(x, g, b, out, M, C, eps, stream); break;
    case 4 * 16 + 1: launch<T, 4, 1>(x, g, b, out, M, C, eps, stream); break;
    case 8 * 16 + 1: launch<T, 8, 1>(x, g, b, out, M, C, eps, stream); break;
    case 16 * 16 + 1: launch<T, 16, 1>(x, g, b, out, M, C, eps, stream); break;
    case 32 * 16 + 1: launch<T, 32, 1>(x, g, b, out, M, C, eps, stream); break;
    case 32 * 16 + 2: launch<T, 32, 2>(x, g, b, out, M, C, eps, stream); break;
    case 32 * 16 + 4: launch<T, 32, 4>(x, g, b, out, M, C, eps, stream); break;
    case 32 * 16 + 8: launch<T, 32, 8>(x, g, b, out, M, C, eps, stream); break;
    default: return (int)cudaErrorInvalidValue;  // C above 32 * 8 vectors
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int layer_norm_bf16(const void* x, const void* g, const void* b, void* out, long long M, int C,
                    float eps, void* stream) {
  return launch_layernorm<bf16>((const bf16*)x, (const float*)g, (const float*)b, (bf16*)out, M,
                                C, eps, (cudaStream_t)stream);
}

int layer_norm_f32(const void* x, const void* g, const void* b, void* out, long long M, int C,
                   float eps, void* stream) {
  return launch_layernorm<float>((const float*)x, (const float*)g, (const float*)b, (float*)out,
                                 M, C, eps, (cudaStream_t)stream);
}

}  // extern "C"
