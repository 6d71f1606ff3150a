// The fused blocks' GEMMs in f32 for Hopper (sm_90a): f32 operands, f32
// products and f32 sums, on the CUDA cores.
//
//   kind kGelu      LN(x) W^T + b, exact GELU          -> f32 (M, N) hidden
//   kind kSplit     LN(x) W^T + b, split by columns     -> S f32 (M, N / S)
//   kind kResidual  a W^T, (+ b) * gamma + residual     -> (M, N)
//
// W (N, K) (the nn.Linear layout) is f32, row-major; x, a (M, K) are f32 or
// bf16 (TA), the residual f32 or bf16 (TR) and the output f32 or bf16 (TO),
// every value read widened to f32 and the output rounded once. The LN is
// two-pass f32 over K with weight and bias (K,). The bf16 types are the
// mixed mode of VIPTPU_GCVIT_MM=f32 on bf16 activations, where the TPU
// kernels cast their bf16 operands to f32 and store their outputs in the
// activations' dtype: ln_qkv_mmf32 (bf16 x -> f32 q, k, v, as the monoblock
// keeps them), proj_scale_residual_mmf32 (bf16 attention output and x -> f32
// r1) and fc2_scale_residual_mmf32 (f32 hidden and r1 -> bf16). These are the f32 mode
// of the TPU kernels fused_convnext_block / fused_ln_mlp_residual_batchlane
// (vip_cup_2022_tpu/ops/pallas/convnext_block.py, whose W1 and W2 take x's
// dtype) and ln_dense / proj_res_ln_mlp / mono_window_transformer_block
// (ops/pallas/gcvit_block.py, whose GEMM dtype follows x's): with f32
// activations every dot there takes f32 operands. The tensor cores take
// f32 only as TF32 (10 bits of mantissa), so a single TF32 or bf16 pass
// would not be the TPU kernel's function; these kernels run FFMA.
//
// What bounds them on this card: the products. 2 M N K FLOPs over 67 TFLOP/s
// at every main-path shape (K = C or 4C >= 64): the bytes, 4 (M K + M N)
// plus the weight, take a tenth of that or less. So the design keeps the
// FMA pipes fed from shared memory with few other instructions, in the
// classic register-blocked SGEMM shape:
//
// - A CTA of 256 threads owns a 128 x 128 output tile; a thread an 8 x 8
//   block of it, as two 4-row by two 4-column quarters (rows ty*4 and
//   64 + ty*4, columns tx*4 and 64 + tx*4), so its operands are four
//   16-byte shared-memory reads a k step for 64 FMAs, broadcast across the
//   warp's two row groups and contiguous across its 16 column groups.
// - K steps of 16: the next step's A and W tiles are read from device
//   memory into registers (two float4 each a thread) while this step's
//   FMAs run, then stored transposed ((k, row) order) into the other of two
//   shared buffers; one barrier a step.
// - The LN GEMMs normalise on the way in: the CTA first takes its 128 rows'
//   mean and 1 / sqrt(var + eps), two-pass (a warp two rows at once, each
//   row read once into registers up to K = 768, f32 sums, warp shuffles;
//   wider rows read twice), and each A value is (x - mean) * rstd * g + b
//   as it is stored to shared memory. A tile's rows are read twice (once
//   for the statistics, once for the product), the second time from L2:
//   the CTAs of one row tile are neighbours in the grid.
// - Tiles are numbered with the column tile fastest, so the CTAs that share
//   a row tile run together and x or the hidden crosses device memory about
//   once; W (at most 9.4 MB) stays in L2.
// - The epilogue adds the bias (and the GELU, or gamma and the residual)
//   in f32 and writes 16 bytes a store; rows past M and columns past N are
//   neither read nor written (K must be a multiple of 16: the models' widths
//   are multiples of 32).
//
// What it leaves on the table: a 3xTF32 wgmma design (hi*hi + hi*lo + lo*hi
// on the tensor cores, 23 bits kept) could pass the FFMA peak; at C = 96 a
// 128-wide column tile of fc2's 96 outputs, and of ln_qkv's 288, computes a
// quarter of zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace f32_gemm {

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kRowVec = 6;  // float4s of an LN row a lane holds: rows up to K = 768 in registers
constexpr int kPad = 4;  // shared rows of kBM + 4 floats: 16-byte aligned, fewer store conflicts

enum Kind : int { kGelu = 0, kSplit = 1, kResidual = 2 };

struct Params {
  const void* a;       // TA (M, K): x for the LN GEMMs, the hidden / attention output otherwise
  const float* w;      // (N, K)
  const float* bias;   // (N,)
  const float* ln_g;   // (K,) LN weight and bias (the LN GEMMs)
  const float* ln_b;
  const float* gamma;  // (N,) (kResidual)
  const void* res;     // TR (M, N) residual (kResidual)
  void* out[3];        // TO (M, N), or S outputs (M, split) for kSplit
  int M, N, K, split;  // split: the width of one kSplit output
  float eps;
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752440f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// four consecutive values as f32: 16 bytes of f32 or 8 of bf16
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// four consecutive outputs: 16 bytes of f32, or 8 of bf16 rounded to nearest even
__device__ __forceinline__ void st4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float4& v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

template <int kKind, typename TA = float, typename TR = float, typename TO = float>
__global__ void __launch_bounds__(kThreads, 2) kernel(const Params p) {
  constexpr bool kLn = kKind != kResidual;
  const TA* a_rows = static_cast<const TA*>(p.a);
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN + kPad];
  __shared__ float mean_s[kBM], rstd_s[kBM];

  const int tiles_n = (p.N + kBN - 1) / kBN;
  const long long tile = blockIdx.x;
  const int n0 = (int)(tile % tiles_n) * kBN;
  const long long m0 = (tile / tiles_n) * kBM;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  if constexpr (kLn) {  // the tile's rows' statistics, a warp a row
    if (p.K <= 128 * kRowVec) {  // two rows a warp at once, each read once into registers
      for (int r = warp; r < kBM; r += 2 * kWarps) {
        float4 v[2][kRowVec];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = m0 + r + h * kWarps;
          const TA* xr = a_rows + row * p.K;
#pragma unroll
          for (int j = 0; j < kRowVec; ++j)
            v[h][j] = row < p.M && lane + 32 * j < p.K / 4 ? ld4(xr + 4 * (lane + 32 * j))
                                                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < kRowVec; ++j) s += (v[h][j].x + v[h][j].y) + (v[h][j].z + v[h][j].w);
          const float mean = warp_sum(s) / (float)p.K;
          float q = 0.f;
#pragma unroll
          for (int j = 0; j < kRowVec; ++j) {
            if (lane + 32 * j < p.K / 4) {
              const float a = v[h][j].x - mean, b = v[h][j].y - mean, c = v[h][j].z - mean,
                          d = v[h][j].w - mean;
              q += (a * a + b * b) + (c * c + d * d);
            }
          }
          const float rstd = rsqrtf(warp_sum(q) / (float)p.K + p.eps);
          if (lane == 0) {
            mean_s[r + h * kWarps] = mean;
            rstd_s[r + h * kWarps] = rstd;
          }
        }
      }
    } else {  // wider rows: two passes over x
      for (int r = warp; r < kBM; r += kWarps) {
        const long long row = m0 + r;
        float mean = 0.f, rstd = 0.f;
        if (row < p.M) {
          const TA* xr = a_rows + row * p.K;
          float s = 0.f;
          for (int i = lane; i < p.K / 4; i += 32) {
            const float4 v = ld4(xr + 4 * i);
            s += (v.x + v.y) + (v.z + v.w);
          }
          mean = warp_sum(s) / (float)p.K;
          float q = 0.f;
          for (int i = lane; i < p.K / 4; i += 32) {
            const float4 v = ld4(xr + 4 * i);
            const float a = v.x - mean, b = v.y - mean, c = v.z - mean, d = v.w - mean;
            q += (a * a + b * b) + (c * c + d * d);
          }
          rstd = rsqrtf(warp_sum(q) / (float)p.K + p.eps);
        }
        if (lane == 0) {
          mean_s[r] = mean;
          rstd_s[r] = rstd;
        }
      }
    }
    __syncthreads();
  }

  // loads: thread t moves rows t/4 and 64 + t/4, columns (t%4)*4 .. +3 of a K step
  const int lr = t >> 2, lc = (t & 3) * 4;
  float4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lr + 64 * i;
      const long long row = m0 + r;
      ra[i] = row < p.M ? ld4(a_rows + row * p.K + k0 + lc) : make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kLn) {
        const float4 g = __ldg(reinterpret_cast<const float4*>(p.ln_g + k0 + lc));
        const float4 b = __ldg(reinterpret_cast<const float4*>(p.ln_b + k0 + lc));
        const float mu = mean_s[r], rs = rstd_s[r];
        ra[i].x = (ra[i].x - mu) * rs * g.x + b.x;
        ra[i].y = (ra[i].y - mu) * rs * g.y + b.y;
        ra[i].z = (ra[i].z - mu) * rs * g.z + b.z;
        ra[i].w = (ra[i].w - mu) * rs * g.w + b.w;
      }
      const int n = n0 + r;
      rb[i] = n < p.N ? __ldg(reinterpret_cast<const float4*>(p.w + (long long)n * p.K + k0 + lc))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lr + 64 * i;
      As[buf][lc][r] = ra[i].x;
      As[buf][lc + 1][r] = ra[i].y;
      As[buf][lc + 2][r] = ra[i].z;
      As[buf][lc + 3][r] = ra[i].w;
      Bs[buf][lc][r] = rb[i].x;
      Bs[buf][lc + 1][r] = rb[i].y;
      Bs[buf][lc + 2][r] = rb[i].z;
      Bs[buf][lc + 3][r] = rb[i].w;
    }
  };

  const int tx = t & 15, ty = t >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int steps = p.K / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load((s + 1) * kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      *reinterpret_cast<float4*>(a + 4) =
          *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      *reinterpret_cast<float4*>(b) = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      *reinterpret_cast<float4*>(b + 4) =
          *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (s + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= p.M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      if (col >= p.N) continue;
      const float4 bv = __ldg(reinterpret_cast<const float4*>(p.bias + col));
      float4 v = make_float4(acc[i][h * 4] + bv.x, acc[i][h * 4 + 1] + bv.y,
                             acc[i][h * 4 + 2] + bv.z, acc[i][h * 4 + 3] + bv.w);
      if constexpr (kKind == kGelu) {
        v = make_float4(gelu_erf(v.x), gelu_erf(v.y), gelu_erf(v.z), gelu_erf(v.w));
        st4(static_cast<TO*>(p.out[0]) + row * p.N + col, v);
      } else if constexpr (kKind == kSplit) {
        const int part = col / p.split, c = col - part * p.split;  // 4 columns in one part
        TO* dst = static_cast<TO*>(part == 0 ? p.out[0] : part == 1 ? p.out[1] : p.out[2]);
        st4(dst + row * p.split + c, v);
      } else {
        const float4 g = __ldg(reinterpret_cast<const float4*>(p.gamma + col));
        const float4 r = ld4(static_cast<const TR*>(p.res) + row * p.N + col);
        v = make_float4(v.x * g.x + r.x, v.y * g.y + r.y, v.z * g.z + r.z, v.w * g.w + r.w);
        st4(static_cast<TO*>(p.out[0]) + row * p.N + col, v);
      }
    }
  }
}

template <int kKind, typename TA = float, typename TR = float, typename TO = float>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.M == 0) return cudaSuccess;
  if (p.M < 0 || p.N <= 0 || p.K <= 0 || p.K % kBK || p.N % 4 ||
      (kKind == kSplit && (p.split <= 0 || p.split % 4 || p.N % p.split || p.N / p.split > 3)))
    return cudaErrorInvalidValue;
  const long long tiles = ((long long)p.M + kBM - 1) / kBM * ((p.N + kBN - 1) / kBN);
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  kernel<kKind, TA, TR, TO><<<(unsigned)tiles, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32_gemm
