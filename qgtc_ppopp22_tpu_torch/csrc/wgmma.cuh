// wgmma helpers shared by the Hopper kernels that read K-major operands
// in the 128-byte swizzle from shared memory (fused_baseline_k5.cuh for
// K5, packmm_k4.cuh for K4).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qgtc {

// The wgmma descriptor of a K-major tile with the 128-byte swizzle at
// shared address `addr` (inside a 1024-byte-aligned atom of 8 rows of 128
// bytes): the stride between 8-row groups 1024 bytes (PTX ISA, "Matrix
// Descriptor Format"; the leading offset is unused for this layout).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

}  // namespace qgtc
