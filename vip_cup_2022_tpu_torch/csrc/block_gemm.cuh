// Shared pieces of the block kernels for Hopper (sm_90a): cp.async staging,
// wmma bf16 fragments, and two GEMM kernel templates that both the ConvNeXt
// and the GCViT block sources instantiate.
//
//   ln_gemm_kernel<XT, kGelu>        (M, C) rows of XT (f32 or bf16) -> two-pass
//                                    f32 LN -> bf16 tile in shared memory ->
//                                    bf16 tensor-core GEMM against W (N, C)
//                                    -> + bias -> exact GELU into one (M, N)
//                                    output (kGelu), or no GELU and the N
//                                    columns split into N / ldo outputs of
//                                    width ldo (q / k / v)
//   gemm_scale_residual_kernel<ResT, OutT>
//                                    bf16 A (M, K) @ W (C, K)^T, f32
//                                    accumulation -> (+ bias) * gamma +
//                                    residual (ResT) -> OutT (M, C)
//
// Weights arrive in the nn.Linear layout (out, in), which is exactly the
// column-major B operand the tensor cores take. The GEMMs are written by
// hand with nvcuda::wmma 16x16x16 bf16 tiles (f32 accumulators) fed from
// shared memory by a three-stage cp.async ring; each warp writes its own
// accumulator tiles out through 1 KB of shared memory, with the epilogue
// applied in registers. No library GEMM is called.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>
#include <mutex>

namespace block_gemm {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps in every GEMM kernel below
constexpr int kBK = 32;        // GEMM K step staged in shared memory
constexpr int kPad = 8;        // bf16 row padding (16 bytes) against bank conflicts
constexpr int kLd = kBK + kPad;
constexpr int kStages = 3;     // shared-memory ring of K slices

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// cp.async: 16-byte global -> shared copies that run while the warps compute.
// With pred false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem_ptr, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem_ptr), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Queue the copy of rows [r0, r0+ROWS) x cols [k0, k0+kBK) of a row-major
// bf16 matrix (leading dimension ld) into shared memory (row stride kLd).
// Rows at or past `limit` are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_tile_async(bf16* __restrict__ dst,
                                                const bf16* __restrict__ src,
                                                long long r0, long long limit,
                                                long long ld, int k0) {
  constexpr int kVec = kBK / 8;  // 16-byte vectors per row
  static_assert((ROWS * kVec) % kThreads == 0, "tile must split evenly over the block");
#pragma unroll
  for (int j = 0; j < ROWS * kVec / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kVec, v = i % kVec;
    const bool ok = r0 + r < limit;
    const bf16* g = src + (ok ? r0 + r : 0) * ld + k0 + v * 8;
    cp_async16(dst + r * kLd + v * 8, g, ok);
  }
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

union Pack8 {  // eight bf16 = one 16-byte load or store
  uint4 u;
  __nv_bfloat162 h[4];
};

// A warp's 16x16 accumulator tile, staged through its own 1 KB of shared
// memory: lane l gets row l/2, columns (l%2)*8 ... +8.
__device__ __forceinline__ void stage_fragment(float* __restrict__ stage, const FragC& acc,
                                               float v[8]) {
  wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x % 32;
  const float4* src = reinterpret_cast<const float4*>(stage + (lane >> 1) * 16 + (lane & 1) * 8);
  const float4 a = src[0], b = src[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  __syncwarp();
}

__device__ __forceinline__ void load8(const float* __restrict__ p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* __restrict__ p, float v[8]) {
  Pack8 r;
  r.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(r.h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* __restrict__ p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(bf16* __restrict__ p, const float v[8]) {
  Pack8 o;
#pragma unroll
  for (int e = 0; e < 4; ++e) o.h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = o.u;
}

// ---------------------------------------------------------------------------
// LN + GEMM (+ GELU). A block owns kLnBM rows: it normalizes them once into a
// bf16 (kLnBM, C) shared tile, then walks the N output columns in chunks of
// kLnBN (the last chunk may be ragged: its missing weight rows are
// zero-filled and its columns never stored), while a kStages-deep cp.async
// ring streams W in (kLnBN, kBK) slices. Warps: 2 (m) x 4 (n), each a 32x32
// patch = 2x2 wmma tiles, written out by the warp itself at the end of each
// chunk. Without GELU, output column n goes to out[n / ldo] at column
// n % ldo; ldo is a multiple of 16, so no warp tile straddles two outputs.
// ---------------------------------------------------------------------------
constexpr int kLnBM = 64;
constexpr int kLnBN = 128;
constexpr int kLnRows = kLnBM / (kThreads / 32);  // rows each warp normalizes

inline size_t ln_gemm_smem_bytes(int C) {
  return (size_t)kLnBM * (C + kPad) * sizeof(bf16) +
         (size_t)kStages * kLnBN * kLd * sizeof(bf16) +
         (size_t)(kThreads / 32) * 256 * sizeof(float);
}

template <typename XT, bool kGelu>
__global__ void __launch_bounds__(kThreads, 3)  // 3 blocks/SM where shared memory allows
ln_gemm_kernel(const XT* __restrict__ x, const float* __restrict__ ln_g,
               const float* __restrict__ ln_b, const bf16* __restrict__ w,
               const float* __restrict__ bias, bf16* __restrict__ out0,
               bf16* __restrict__ out1, bf16* __restrict__ out2,
               int M, int C, int N, int ldo, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = C + kPad;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kLnBM * lda;
  float* stage = reinterpret_cast<float*>(Bs + kStages * kLnBN * kLd) + warp * 256;
  const long long m0 = (long long)blockIdx.x * kLnBM;
  const int KT = C / kBK;
  const int T = (N + kLnBN - 1) / kLnBN * KT;  // (chunk, K slice) steps

  // start streaming W before the LN prologue
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T) load_tile_async<kLnBN>(Bs + s * kLnBN * kLd, w, (s / KT) * kLnBN, N, C, (s % KT) * kBK);
    cp_async_commit();
  }

  // two-pass f32 LayerNorm; each warp normalizes its kLnRows rows together,
  // so a lane has kLnRows independent loads in flight per pass
  const float inv_c = 1.0f / (float)C;
  const long long r0 = m0 + warp * kLnRows;
  float mean[kLnRows], rstd[kLnRows];
#pragma unroll
  for (int i = 0; i < kLnRows; ++i) mean[i] = rstd[i] = 0.f;
  for (int c = lane; c < C; c += 32) {
#pragma unroll
    for (int i = 0; i < kLnRows; ++i) {
      if (r0 + i < M) mean[i] += to_f32(x[(r0 + i) * C + c]);
    }
  }
#pragma unroll
  for (int i = 0; i < kLnRows; ++i) mean[i] = warp_sum(mean[i]) * inv_c;
  for (int c = lane; c < C; c += 32) {
#pragma unroll
    for (int i = 0; i < kLnRows; ++i) {
      if (r0 + i < M) {
        const float d = to_f32(x[(r0 + i) * C + c]) - mean[i];
        rstd[i] += d * d;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kLnRows; ++i) rstd[i] = rsqrtf(warp_sum(rstd[i]) * inv_c + eps);
  for (int c = lane; c < C; c += 32) {
    const float g = ln_g[c], b = ln_b[c];
#pragma unroll
    for (int i = 0; i < kLnRows; ++i) {
      const float y = r0 + i < M ? (to_f32(x[(r0 + i) * C + c]) - mean[i]) * rstd[i] * g + b : 0.f;
      As[(warp * kLnRows + i) * lda + c] = __float2bfloat16(y);
    }
  }

  const int wm = warp / 4, wn = warp % 4;
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int t = 0; t < T; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice t landed for all; slice t-1's buffer is free; As is written
    const int tn = t + kStages - 1;
    if (tn < T) {
      load_tile_async<kLnBN>(Bs + (tn % kStages) * kLnBN * kLd, w, (tn / KT) * kLnBN, N, C,
                             (tn % KT) * kBK);
    }
    cp_async_commit();

    const int kt = t % KT, n0 = (t / KT) * kLnBN;
    const bf16* b = Bs + (t % kStages) * kLnBN * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA fa[2];
      FragB fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * lda + kt * kBK + kk, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b + (wn * 32 + j * 16) * kLd + kk, kLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }

    if (kt == KT - 1) {  // chunk done: + bias, (GELU), bf16 store, reset
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col0 = n0 + wn * 32 + j * 16;
          if (col0 < N) {
            float v[8], bv[8];
            stage_fragment(stage, acc[i][j], v);
            const long long m = m0 + wm * 32 + i * 16 + (lane >> 1);
            const int n = col0 + (lane & 1) * 8;
            if (m < M) {
              load8(bias + n, bv);
              if constexpr (kGelu) {  // one output, N wide
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] = gelu_erf(v[e] + bv[e]);
                store8(out0 + m * N + n, v);
              } else {  // split into N / ldo outputs
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] += bv[e];
                const int part = n / ldo;
                bf16* dst = part == 0 ? out0 : (part == 1 ? out1 : out2);
                store8(dst + m * ldo + (n - part * ldo), v);
              }
            }
          }
          wmma::fill_fragment(acc[i][j], 0.f);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// GEMM + layer scale + residual. A block owns a (kF2BM, kF2BN) output tile
// and streams K through a kStages-deep cp.async ring of (rows, kBK) slices
// of both operands. Warps: 2 (m) x 4 (n), each a 64x32 patch = 4x2 wmma
// tiles. Columns past C are zero-filled and never stored.
// ---------------------------------------------------------------------------
constexpr int kF2BM = 128;
constexpr int kF2BN = 128;

inline size_t gemm_residual_smem_bytes() {
  return (size_t)kStages * (kF2BM + kF2BN) * kLd * sizeof(bf16) +
         (size_t)(kThreads / 32) * 256 * sizeof(float);
}

template <typename ResT, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
gemm_scale_residual_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                           const float* __restrict__ bias, const float* __restrict__ gamma,
                           const ResT* __restrict__ res, OutT* __restrict__ out,
                           int M, int K, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kStages * kF2BM * kLd;
  float* stage = reinterpret_cast<float*>(Bs + kStages * kF2BN * kLd) + warp * 256;
  const int wm = warp / 4, wn = warp % 4;
  const long long m0 = (long long)blockIdx.x * kF2BM;
  const int n0 = blockIdx.y * kF2BN;
  const int T = K / kBK;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T) {
      load_tile_async<kF2BM>(As + s * kF2BM * kLd, a, m0, M, K, s * kBK);
      load_tile_async<kF2BN>(Bs + s * kF2BN * kLd, w, n0, C, K, s * kBK);
    }
    cp_async_commit();
  }

  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int t = 0; t < T; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int tn = t + kStages - 1;
    if (tn < T) {
      load_tile_async<kF2BM>(As + (tn % kStages) * kF2BM * kLd, a, m0, M, K, tn * kBK);
      load_tile_async<kF2BN>(Bs + (tn % kStages) * kF2BN * kLd, w, n0, C, K, tn * kBK);
    }
    cp_async_commit();

    const bf16* at = As + (t % kStages) * kF2BM * kLd;
    const bf16* bt = Bs + (t % kStages) * kF2BN * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA fa[4];
      FragB fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], at + (wm * 64 + i * 16) * kLd + kk, kLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bt + (wn * 32 + j * 16) * kLd + kk, kLd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col0 = n0 + wn * 32 + j * 16;
      if (col0 >= C) continue;  // the same for the whole warp
      float v[8], bv[8], g[8], r[8];
      stage_fragment(stage, acc[i][j], v);
      const long long m = m0 + wm * 64 + i * 16 + (lane >> 1);
      const int n = col0 + (lane & 1) * 8;
      if (m < M) {
        load8(bias + n, bv);
        load8(gamma + n, g);
        load8(res + m * C + n, r);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = (v[e] + bv[e]) * g[e] + r[e];
        store8(out + m * C + n, v);
      }
    }
  }
}

// A kernel's dynamic shared-memory limit persists in the device's context, so
// a launcher raises it only when a launch needs more than was granted there.
constexpr int kMaxDevices = 64;
struct SmemGrant {
  std::mutex mu;
  size_t bytes[kMaxDevices] = {};
};

inline cudaError_t grant_smem(const void* kernel, size_t bytes, SmemGrant& grant) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(grant.mu);
  if (bytes <= grant.bytes[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) grant.bytes[dev] = bytes;
  return err;
}

// Launch helpers: raise the shared-memory grant of the instantiation, then
// launch on `stream`; return cudaGetLastError() for the ctypes caller.
template <typename XT, bool kGelu>
cudaError_t launch_ln_gemm(const XT* x, const float* ln_g, const float* ln_b, const bf16* w,
                           const float* bias, bf16* out0, bf16* out1, bf16* out2,
                           int M, int C, int N, int ldo, float eps, cudaStream_t stream) {
  static SmemGrant grant;
  if (M == 0) return cudaSuccess;
  const size_t smem = ln_gemm_smem_bytes(C);
  const cudaError_t err = grant_smem((const void*)ln_gemm_kernel<XT, kGelu>, smem, grant);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((M + kLnBM - 1) / kLnBM);
  ln_gemm_kernel<XT, kGelu><<<blocks, kThreads, smem, stream>>>(
      x, ln_g, ln_b, w, bias, out0, out1, out2, M, C, N, ldo, eps);
  return cudaGetLastError();
}

template <typename ResT, typename OutT>
cudaError_t launch_gemm_scale_residual(const bf16* a, const bf16* w, const float* bias,
                                       const float* gamma, const ResT* res, OutT* out,
                                       int M, int K, int C, cudaStream_t stream) {
  static SmemGrant grant;
  if (M == 0) return cudaSuccess;
  const size_t smem = gemm_residual_smem_bytes();
  const cudaError_t err =
      grant_smem((const void*)gemm_scale_residual_kernel<ResT, OutT>, smem, grant);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((M + kF2BM - 1) / kF2BM), (unsigned)((C + kF2BN - 1) / kF2BN));
  gemm_scale_residual_kernel<ResT, OutT><<<grid, kThreads, smem, stream>>>(
      a, w, bias, gamma, res, out, M, K, C);
  return cudaGetLastError();
}

}  // namespace block_gemm
