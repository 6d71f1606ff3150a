// A block's shared-memory limit on Hopper (sm_90) and the launchers' grant of
// it, shared by the wgmma engine (hopper_gemm.cuh, ptq_int8.cuh), the
// window-attention template's helpers (block_gemm.cuh) and the tiled
// depthwise template (depthwise.cuh).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>

namespace smem_grant {

constexpr size_t kSmemLimit = 232448;  // a block's opt-in shared memory on sm_90

// A kernel's dynamic shared-memory limit persists in the device's context, so
// a launcher raises it only when a launch needs more than was granted there.
// The grant is a launcher's static, which the dynamic linker may share between
// two libraries that instantiate the same template (ptq_int8.cuh's, the
// window-attention or the depthwise template's kernels built into two
// sources, each library with its own copy of the kernel); so it remembers
// which kernel it granted.
constexpr int kMaxDevices = 64;
struct SmemGrant {
  std::mutex mu;
  const void* kernel[kMaxDevices] = {};
  size_t bytes[kMaxDevices] = {};
};

inline cudaError_t grant_smem(const void* kernel, size_t bytes, SmemGrant& grant, int dev) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(grant.mu);
  if (kernel == grant.kernel[dev] && bytes <= grant.bytes[dev]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) {
    grant.kernel[dev] = kernel;
    grant.bytes[dev] = bytes;
  }
  return err;
}

// the same on the current device
inline cudaError_t grant_smem(const void* kernel, size_t bytes, SmemGrant& grant) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : grant_smem(kernel, bytes, grant, dev);
}

}  // namespace smem_grant
