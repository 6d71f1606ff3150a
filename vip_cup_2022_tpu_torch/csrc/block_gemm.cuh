// Helpers of the window-attention template (window_attention.cuh, with the
// window-attention and attention-parts kernels) for Hopper (sm_90a):
// 16-byte cp.async staging, 8-wide loads and stores, and (from
// smem_grant.cuh) the shared-memory grant. No GEMM is built from this file:
// every GEMM of both block families and the LN-MLP tool kernels runs on
// hopper_gemm.cuh's wgmma + TMA engine, and the int8 PTQ site and the int8
// spike's bodies on ptq_int8.cuh. No library GEMM is called.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "smem_grant.cuh"

namespace block_gemm {

typedef __nv_bfloat16 bf16;

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

union Pack8 {  // eight bf16 = one 16-byte load or store
  uint4 u;
  __nv_bfloat162 h[4];
};

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

using smem_grant::grant_smem;
using smem_grant::kMaxDevices;
using smem_grant::kSmemLimit;
using smem_grant::SmemGrant;

}  // namespace block_gemm
