// ConvNeXt block kernels for Hopper (sm_90a), channels-last.
//
// One ConvNeXt block is  x + gamma * fc2(gelu(fc1(LN(dw7x7(x) + dw_bias))))
// and runs here as three launches:
//
//   dwconv7x7_nhwc      bf16 NHWC x, f32 (7,7,C) taps, f32 bias -> f32 (M, C)
//   ln_fc1_gelu         f32 (M, C) -> two-pass f32 LN -> bf16 tile in shared
//                       memory -> bf16 tensor-core GEMM against fc1 (N, C)
//                       -> +b1, exact GELU (erff) -> bf16 hidden (M, N)
//   fc2_scale_residual  bf16 hidden (M, N) @ fc2 (C, N)^T, f32 accumulation
//                       -> (+b2) * gamma + residual -> bf16 (M, C)
//
// M = B*H*W rows; N = 4C. Weights arrive in the nn.Linear layout (out, in),
// which is exactly the column-major B operand the tensor cores take.
// The GEMMs are written by hand with nvcuda::wmma 16x16x16 bf16 tiles
// (f32 accumulators) fed from shared memory by a three-stage cp.async ring;
// each warp writes its own accumulator tiles out through 1 KB of shared
// memory, with the epilogue applied in registers. No library GEMM is called.
//
// Every launcher has a plain C interface for ctypes and returns
// cudaGetLastError() as an int, so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <mutex>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;  // 8 warps in every kernel below
constexpr int kBK = 32;        // GEMM K step staged in shared memory
constexpr int kPad = 8;        // bf16 row padding (16 bytes) against bank conflicts
constexpr int kLd = kBK + kPad;

// ---------------------------------------------------------------------------
// depthwise 7x7, stride 1, zero padding 3, + bias. Each thread owns two
// neighbouring channels and kTW neighbouring output columns, so one loaded
// input row segment of kTW+6 pixels feeds kTW*7 taps.
// ---------------------------------------------------------------------------
constexpr int kTW = 8;

__global__ void __launch_bounds__(kThreads)
dwconv7x7_nhwc_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int B, int H, int W, int C) {
  const int C2 = C / 2;
  const int WT = (W + kTW - 1) / kTW;
  const long long total = (long long)B * H * WT * C2;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int cp = (int)(idx % C2);
  long long t = idx / C2;
  const int wt = (int)(t % WT);
  t /= WT;
  const int h = (int)(t % H);
  const int b = (int)(t / H);
  const int c = cp * 2;
  const int w0 = wt * kTW;

  float acc0[kTW], acc1[kTW];
#pragma unroll
  for (int i = 0; i < kTW; ++i) {
    acc0[i] = 0.f;
    acc1[i] = 0.f;
  }
  for (int dy = 0; dy < 7; ++dy) {
    const int hh = h + dy - 3;
    if (hh < 0 || hh >= H) continue;
    const bf16* row = x + ((long long)b * H + hh) * W * C + c;
    float r0[kTW + 6], r1[kTW + 6];
#pragma unroll
    for (int j = 0; j < kTW + 6; ++j) {
      const int ww = w0 + j - 3;
      if (ww >= 0 && ww < W) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(row + (long long)ww * C));
        r0[j] = f.x;
        r1[j] = f.y;
      } else {
        r0[j] = 0.f;
        r1[j] = 0.f;
      }
    }
#pragma unroll
    for (int dx = 0; dx < 7; ++dx) {
      const float2 wv = *reinterpret_cast<const float2*>(w + (dy * 7 + dx) * C + c);
#pragma unroll
      for (int i = 0; i < kTW; ++i) {
        acc0[i] = fmaf(r0[i + dx], wv.x, acc0[i]);
        acc1[i] = fmaf(r1[i + dx], wv.y, acc1[i]);
      }
    }
  }
  const float b0 = bias[c], b1 = bias[c + 1];
  float* o = out + (((long long)b * H + h) * W + w0) * C + c;
#pragma unroll
  for (int i = 0; i < kTW; ++i) {
    if (w0 + i < W) {
      *reinterpret_cast<float2*>(o + (long long)i * C) =
          make_float2(acc0[i] + b0, acc1[i] + b1);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
}

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

constexpr int kStages = 3;  // shared-memory ring of K slices

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

// ---------------------------------------------------------------------------
// LN + fc1 + GELU. A block owns kLnBM rows: it normalizes them once into a
// bf16 (kLnBM, C) shared tile, then walks the N = 4C output columns in
// chunks of kLnBN, while a kStages-deep cp.async ring streams fc1 in
// (kLnBN, kBK) slices. Warps: 2 (m) x 4 (n), each a 32x32 patch = 2x2 wmma
// tiles, written out by the warp itself at the end of each chunk.
// ---------------------------------------------------------------------------
constexpr int kLnBM = 64;
constexpr int kLnBN = 128;
constexpr int kLnRows = kLnBM / (kThreads / 32);  // rows each warp normalizes

size_t ln_fc1_smem_bytes(int C) {
  return (size_t)kLnBM * (C + kPad) * sizeof(bf16) +
         (size_t)kStages * kLnBN * kLd * sizeof(bf16) +
         (size_t)(kThreads / 32) * 256 * sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 3)  // 3 blocks/SM where shared memory allows
ln_fc1_gelu_kernel(const float* __restrict__ x, const float* __restrict__ ln_g,
                   const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, bf16* __restrict__ hidden,
                   int M, int C, int N, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = C + kPad;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kLnBM * lda;
  float* stage = reinterpret_cast<float*>(Bs + kStages * kLnBN * kLd) + warp * 256;
  const long long m0 = (long long)blockIdx.x * kLnBM;
  const int KT = C / kBK;
  const int T = (N + kLnBN - 1) / kLnBN * KT;  // (chunk, K slice) steps

  // start streaming fc1 before the LN prologue
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T) load_tile_async<kLnBN>(Bs + s * kLnBN * kLd, w1, (s / KT) * kLnBN, N, C, (s % KT) * kBK);
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
      if (r0 + i < M) mean[i] += x[(r0 + i) * C + c];
    }
  }
#pragma unroll
  for (int i = 0; i < kLnRows; ++i) mean[i] = warp_sum(mean[i]) * inv_c;
  for (int c = lane; c < C; c += 32) {
#pragma unroll
    for (int i = 0; i < kLnRows; ++i) {
      if (r0 + i < M) {
        const float d = x[(r0 + i) * C + c] - mean[i];
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
      const float y = r0 + i < M ? (x[(r0 + i) * C + c] - mean[i]) * rstd[i] * g + b : 0.f;
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
      load_tile_async<kLnBN>(Bs + (tn % kStages) * kLnBN * kLd, w1, (tn / KT) * kLnBN, N, C,
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

    if (kt == KT - 1) {  // chunk done: + b1, GELU, bf16 store, reset
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col0 = n0 + wn * 32 + j * 16;
          if (col0 < N) {
            float v[8], bias[8];
            stage_fragment(stage, acc[i][j], v);
            const long long m = m0 + wm * 32 + i * 16 + (lane >> 1);
            const int n = col0 + (lane & 1) * 8;
            if (m < M) {
              load8(b1 + n, bias);
              Pack8 o;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                o.h[e] = __floats2bfloat162_rn(gelu_erf(v[2 * e] + bias[2 * e]),
                                               gelu_erf(v[2 * e + 1] + bias[2 * e + 1]));
              }
              *reinterpret_cast<uint4*>(hidden + m * N + n) = o.u;
            }
          }
          wmma::fill_fragment(acc[i][j], 0.f);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fc2 + layer scale + residual. A block owns a (kF2BM, kF2BN) output tile and
// streams K = 4C through a kStages-deep cp.async ring of (rows, kBK) slices
// of both operands. Warps: 2 (m) x 4 (n), each a 64x32 patch = 4x2 wmma
// tiles. Columns past C are zero-filled and never stored.
// ---------------------------------------------------------------------------
constexpr int kF2BM = 128;
constexpr int kF2BN = 128;

size_t fc2_smem_bytes() {
  return (size_t)kStages * (kF2BM + kF2BN) * kLd * sizeof(bf16) +
         (size_t)(kThreads / 32) * 256 * sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 2)
fc2_scale_residual_kernel(const bf16* __restrict__ hidden, const bf16* __restrict__ w2,
                          const float* __restrict__ b2, const float* __restrict__ gamma,
                          const bf16* __restrict__ res, bf16* __restrict__ out,
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
      load_tile_async<kF2BM>(As + s * kF2BM * kLd, hidden, m0, M, K, s * kBK);
      load_tile_async<kF2BN>(Bs + s * kF2BN * kLd, w2, n0, C, K, s * kBK);
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
      load_tile_async<kF2BM>(As + (tn % kStages) * kF2BM * kLd, hidden, m0, M, K, tn * kBK);
      load_tile_async<kF2BN>(Bs + (tn % kStages) * kF2BN * kLd, w2, n0, C, K, tn * kBK);
    }
    cp_async_commit();

    const bf16* a = As + (t % kStages) * kF2BM * kLd;
    const bf16* b = Bs + (t % kStages) * kF2BN * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA fa[4];
      FragB fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm * 64 + i * 16) * kLd + kk, kLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b + (wn * 32 + j * 16) * kLd + kk, kLd);
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
      float v[8], bias[8], g[8];
      stage_fragment(stage, acc[i][j], v);
      const long long m = m0 + wm * 64 + i * 16 + (lane >> 1);
      const int n = col0 + (lane & 1) * 8;
      if (m < M) {
        load8(b2 + n, bias);
        load8(gamma + n, g);
        Pack8 r, o;
        r.u = *reinterpret_cast<const uint4*>(res + m * C + n);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 rv = __bfloat1622float2(r.h[e]);
          o.h[e] = __floats2bfloat162_rn((v[2 * e] + bias[2 * e]) * g[2 * e] + rv.x,
                                         (v[2 * e + 1] + bias[2 * e + 1]) * g[2 * e + 1] + rv.y);
        }
        *reinterpret_cast<uint4*>(out + m * C + n) = o.u;
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

cudaError_t grant_smem(const void* kernel, size_t bytes, SmemGrant& grant) {
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

SmemGrant ln_fc1_grant, fc2_grant;

}  // namespace

extern "C" {

int dwconv7x7_nhwc(const void* x, const void* w, const void* bias, void* out,
                   int B, int H, int W, int C, void* stream) {
  const long long total = (long long)B * H * ((W + kTW - 1) / kTW) * (C / 2);
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  dwconv7x7_nhwc_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)w, (const float*)bias, (float*)out, B, H, W, C);
  return (int)cudaGetLastError();
}

int ln_fc1_gelu(const void* x, const void* ln_g, const void* ln_b, const void* w1,
                const void* b1, void* hidden, int M, int C, int N, float eps,
                void* stream) {
  if (M == 0) return 0;
  const size_t smem = ln_fc1_smem_bytes(C);
  const cudaError_t err = grant_smem((const void*)ln_fc1_gelu_kernel, smem, ln_fc1_grant);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((M + kLnBM - 1) / kLnBM);
  ln_fc1_gelu_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)ln_g, (const float*)ln_b, (const bf16*)w1,
      (const float*)b1, (bf16*)hidden, M, C, N, eps);
  return (int)cudaGetLastError();
}

int fc2_scale_residual(const void* hidden, const void* w2, const void* b2,
                       const void* gamma, const void* res, void* out, int M, int K,
                       int C, void* stream) {
  if (M == 0) return 0;
  const size_t smem = fc2_smem_bytes();
  const cudaError_t err =
      grant_smem((const void*)fc2_scale_residual_kernel, smem, fc2_grant);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + kF2BM - 1) / kF2BM), (unsigned)((C + kF2BN - 1) / kF2BN));
  fc2_scale_residual_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)hidden, (const bf16*)w2, (const float*)b2, (const float*)gamma,
      (const bf16*)res, (bf16*)out, M, K, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
