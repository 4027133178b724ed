// cp.async, ldmatrix and thread-block-cluster helpers shared by the
// Hopper kernels with a cp.async ring and split-K over a cluster
// (packmm_k2.cuh for K2, packmm_k4.cuh for K4, bitmm_k6.cuh for K6,
// fused_model_k1.cuh for K1 and probe_ring.cuh for the probes that run
// K1's loop).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qgtc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 16 bytes global -> shared address `dst`, bypassing L1.
__device__ __forceinline__ void cp_async16_u(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ldmatrix .x4: four 8 x 16-byte matrices; lane l gives the row address
// of matrix l / 8, row l % 8, and gets, of each matrix, row l / 4, bytes
// 4 (l % 4) .. + 3: the int8 mma.m16n8k32 fragments of k-contiguous rows.
__device__ __forceinline__ void ldsm4_u(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Rows x0..x3 of a 4 x 4 byte block -> its columns, 4 bytes each, at dst,
// dst + ld, ... (the block transposed).
__device__ __forceinline__ void transpose4(int8_t* dst, int ld, uint32_t x0, uint32_t x1,
                                           uint32_t x2, uint32_t x3) {
  const uint32_t lo01 = __byte_perm(x0, x1, 0x5140), hi01 = __byte_perm(x0, x1, 0x7362);
  const uint32_t lo23 = __byte_perm(x2, x3, 0x5140), hi23 = __byte_perm(x2, x3, 0x7362);
  *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
  *reinterpret_cast<uint32_t*>(dst + ld) = __byte_perm(lo01, lo23, 0x7632);
  *reinterpret_cast<uint32_t*>(dst + 2 * ld) = __byte_perm(hi01, hi23, 0x5410);
  *reinterpret_cast<uint32_t*>(dst + 3 * ld) = __byte_perm(hi01, hi23, 0x7632);
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared::cluster address of p in the CTA of cluster rank `rank`.
__device__ __forceinline__ uint32_t peer(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ uint32_t ld_peer(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ int2 ld_peer2(uint32_t addr) {
  int2 v;
  asm volatile("ld.shared::cluster.v2.s32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ int4 ld_peer4(uint32_t addr) {
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

}  // namespace qgtc
