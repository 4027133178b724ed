// K5, the bf16 baseline's whole model in one launch (csrc/fused_baseline.cu
// is its C entry and says what bounds it), redesigned for Hopper.
//
// Per batch and layer, h = relu(bf16(bf16(A @ h) @ W)) with f32 sums and
// the JAX kernel's rounding points (qgtc_ppopp22_tpu/ops/fused_model.py
// :1404-1414); no relu after the last layer, which stores f32 logits. The
// levers, each aimed at one cost of the first kernel:
//   1. The aggregation A @ h runs on wgmma.mma_async m64nNk16 (bf16, f32
//      sums): one consumer warpgroup per 64 rows, CTAs of 128 rows,
//      N = the pass's columns (16..128). B is read by the instruction from
//      shared memory, K-major with the 128-byte swizzle (the layout TMA
//      writes): the hidden planes (and X in bf16) are kept transposed,
//      h^T [w][pn]. A's int8 bytes become bf16 register fragments, four
//      bytes of a 16-byte shared load at a time (a byte permute that puts
//      0x43 above each byte, two masks and one bf16x2 fma: exact for every
//      int8 value, no per-byte loads). The fragment wants k pairs (2t,
//      2t + 1) and (2t + 8, 2t + 9), a four-byte load gives four
//      consecutive k: so the planes' columns are stored permuted inside
//      each 64 (perm_row), and a plain copy of 64 stored columns lands them
//      in the order the fragments take. The update against W (<= 128 x 128
//      bf16, staged once per layer) stays mma.sync from the rounded
//      accumulators, so the aggregated tile never leaves the SM.
//   2. A and h arrive by TMA (cp.async.bulk.tensor) into a ring of 3
//      slots, each tracked by a "full" and an "empty" mbarrier: a producer
//      warpgroup (one thread issuing, its registers given to the consumers
//      by setmaxnreg) keeps the copies in flight, the consumer warpgroups
//      wait only for their slot and free it when their wgmmas are done, so
//      no CTA-wide barrier falls on a step. A slot holds h^T's rows for kd
//      columns of the contraction and the rows' A bytes, each landed by
//      one TMA copy (a copy costs its issue whatever its size): 256
//      columns deep at the narrow layers, 128 at wider ones.
//   3. Few batches in flight: a persistent grid of `groups` groups of
//      `ctas` co-resident CTAs, each group one batch at a time (batches g,
//      g + groups, ...), so that only `groups` batches' A (6.55 MB each at
//      C1) are in flight, as many as the card holds groups; whether their
//      A then stays in the 50 MB L2 from the first layer to the last is
//      not shown (PERF.md §7). A group's CTAs meet at a barrier in
//      device memory (an arrival counter per group) between layers; the
//      launch is cooperative, so the card refuses it unless every CTA is
//      resident, and no CTA waits on one that is not scheduled.
//   4. X is read once: each CTA rounds its rows of f32 X to bf16 and writes
//      them transposed into the scratch (the producer warpgroup's idle
//      warps do it for the group's next batch during this batch's first
//      layer); every row tile's aggregation streams the bf16 copy: half
//      the bytes of f32 X, which each of a batch's row tiles reads again.
// PERF.md §6 records what each form of this design measured.
#pragma once

#include <cstdint>
#include <dlfcn.h>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

// K5_TRACE 1 (benchmarks/k5_trace.py builds it so, apart from the library)
// has each CTA add clock64 spans to k5_trace: the consumers' waits and
// steps, the producer's waits, the group barriers, the first batch's X.
#ifndef K5_TRACE
#define K5_TRACE 0
#endif

namespace qgtc {
namespace k5 {

using bf16 = __nv_bfloat16;

#if K5_TRACE
__device__ unsigned long long k5_trace[1024 * 8];
#define K5_T(i, v) atomicAdd(&k5_trace[blockIdx.x * 8 + (i)], (unsigned long long)(v))
#else
#define K5_T(i, v)
#endif

constexpr int MAX_LAYERS = 8;  // ops/fused_model.py BASELINE_MAX_LAYERS
constexpr int WG = 128;        // threads of a warpgroup (a consumer's: 64 rows)
constexpr int NC = 128;        // aggregation columns of a layer in one pass (wgmma N)
constexpr int KW = 64;         // columns of a pass in a layer wider than NC
constexpr int KB = 64;         // columns of one A box and of one h^T box
constexpr int ROWS = 128;      // rows of a CTA: two consumer warpgroups
constexpr int NCONS = ROWS / 64 * WG;  // consumer threads; the producer warpgroup follows
constexpr int STAGES = 3;      // ring slots
constexpr int SMEM_CTA = 227 * 1024;  // shared memory a block can use
constexpr int ALIGN = 1024;           // the 128-byte swizzle's atom

// The columns of a layer's passes: all of them up to NC, else KW at a time
// (passes of 128 kept 64 update sums live through the aggregation's steps
// and spilled: PERF.md §6).
__host__ __device__ inline int pass_width(int kin) { return kin <= NC ? kin : KW; }

// One ring slot: h^T's kn rows for kd columns as kd / 64 boxes of [kn][128
// bytes], then A's kd / 64 boxes of [ROWS][64 bytes].
__host__ __device__ inline int stage_bytes(int kd, int kn) { return kd * kn * 2 + ROWS * kd; }

// The shared memory of one launch (ops/fused_model.py _k5_layout takes the
// same sums): each layer's stage depth kd is 256 for a pass of <= 32
// columns and 128 for a wider one; STAGES slots of the largest stage, in
// 1024-byte multiples; then W^T of the widest layer's pass (<=
// 128 input columns, 64 in a layer wider than 128), the slots' full and empty mbarriers, and 1024 bytes to
// align the base.
struct Layout {
  int slot, off_w, off_bar, total;
  int kd[MAX_LAYERS];
};

inline Layout layout(const int* kp, const int* np, int n) {
  Layout L{};
  int slot = 0, wmax = 0;
  for (int l = 0; l < n; ++l) {
    const int kn = pass_width(kp[l]), kd = kn <= 32 ? 256 : 128;
    const int st = stage_bytes(kd, kn), w = np[l] * (kn + 8) * 2;
    L.kd[l] = kd;
    slot = slot > st ? slot : st;
    wmax = wmax > w ? wmax : w;
  }
  L.slot = (slot + ALIGN - 1) / ALIGN * ALIGN;
  L.off_w = STAGES * L.slot;
  L.off_bar = (L.off_w + wmax + 7) / 8 * 8;
  L.total = L.off_bar + 2 * STAGES * 8 + ALIGN;
  return L;
}

struct Params {
  // A [B * pn][pn] int8 seen as (64, B * pn, pn / 64): one box of (64,
  // ROWS, kd / 64) lands a step's [kd / 64][ROWS][64]; one map each for kd
  // = 128 and 256.
  CUtensorMap tm_a[2];
  // Layer l's plane h^T [B * w][pn] seen as (64, B * w, pn / 64): one box
  // of (64, kn, kd / 64), 128-byte swizzled, lands a step's [kd / 64][kn]
  // [64] (kn: pass_width); [MAX_LAYERS]: layer 0's last pass where it is
  // narrower.
  CUtensorMap tm_b[MAX_LAYERS + 1];
  float* out;           // [B][pn][cp]
  const int8_t* a;      // [B][pn][pn]
  const float* x;       // [B][pn][xp]
  const bf16* w;        // layer l at element w_off[l]: W_l^T [np[l]][kp[l]]
  bf16* h[3];           // the scratch's three planes, transposed, columns permuted (perm_row)
  unsigned* bar;        // [groups] arrival counters, zero at the launch
  int B, pn, xp, cp, kx, hw, n_layers, groups, ctas, slot, off_w, off_bar;
  int kp[MAX_LAYERS], np[MAX_LAYERS], w_off[MAX_LAYERS], kd[MAX_LAYERS];
};

// The stored column of node k in a plane h^T: inside each 64, k =
// 16 t + 4 j + i goes to 16 j + (i & 2 ? 8 : 0) + 2 t + (i & 1), the k
// position 2 t + (i & 1) (+ 8) of wgmma instruction j, where lane t's
// 16-byte load of A row bytes 16 t .. 16 t + 15 puts A[k] (lever 1).
__host__ __device__ inline int perm_row(int k) {
  return (k & ~63) | (((k >> 2) & 3) << 4) | ((k & 2) << 2) | (((k >> 4) & 3) << 1) | (k & 1);
}

// Two floats -> bf16x2, each rounded to nearest even; lo in the low half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __halves2bfloat162(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Four int8 -> two bf16x2, exact: lo holds bytes 0 and 1, hi bytes 2 and
// 3. A byte b with low bits l and sign bit s becomes the bf16 0x43:b, whose
// low 7 bits are l: as bf16 0x4300 | l is 128 + l, and 0x4300 | s << 7 is
// 128 (s = 0) or 256 (s = 1), so their difference is b; every value on
// the way is exact in bf16.
__device__ __forceinline__ void i8x4_bf16(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const uint32_t zl = __byte_perm(v, 0x43434343u, 0x4140), zh = __byte_perm(v, 0x43434343u, 0x4342);
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(lo)
      : "r"(zl & 0xFF80FF80u), "r"(0xBF80BF80u), "r"(zl & 0xFF7FFF7Fu));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(hi)
      : "r"(zh & 0xFF80FF80u), "r"(0xBF80BF80u), "r"(zh & 0xFF7FFF7Fu));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Keeps the compiler from moving an accumulator's uses across a wgmma
// wait.
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits until the phase of parity `parity` of the mbarrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
#pragma unroll 1
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA copy of a 3-D box at (c0, c1, c2) of the tensor map into shared
// memory, completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// wgmma.mma_async m64nNk16 f32 += bf16 x bf16: A (64 x 16) from registers
// (each warp's 16 rows as mma.m16n8k16's A fragment), B (16 x N) from
// shared memory, K-major (imm-trans-b 0); d as mma.m16n8's C fragments of
// the N / 8 n-tiles, in order.
template <int N>
__device__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc);

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<80>(float (&d)[40], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<112>(float (&d)[56], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// A group's barrier in device memory: every CTA of the group adds one to
// the group's counter and waits until it reaches `target` (the count of
// this barrier times the group's CTAs); the launch is cooperative, so all
// of them are resident. The planes written before it are read after it by
// TMA (the async proxy): each thread fences its writes to that proxy.
__device__ __forceinline__ void group_sync(unsigned* ctr, unsigned target) {
  asm volatile("fence.proxy.async;\n" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // this CTA's plane writes, before its arrival
    atomicAdd(ctr, 1u);
    unsigned v;
#pragma unroll 1
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(ctr) : "memory");
      if (v >= target) break;
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// The consumer threads' own barrier (named barrier 1).
__device__ __forceinline__ void consumer_sync(int nc) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nc) : "memory");
}

// The ring's position: `it` steps issued (or consumed) so far; slot and
// round of the next one.
struct Ring {
  uint32_t full0, empty0;  // the slots' mbarriers
  uint32_t it;
  __device__ __forceinline__ int slot() const { return (int)(it % (uint32_t)STAGES); }
  __device__ __forceinline__ uint32_t parity() const { return (it / (uint32_t)STAGES) & 1u; }
};

// The producer's copies of one pass (thread `issuer` issues them): for each
// step, once the consumers have freed its slot, the plane's rows c0 ..
// c0 + kn (h^T, features) at stored columns k0 .. k0 + kd, and
// A[m0:m0 + ROWS, k0:k0 + kd]: one TMA copy each (a copy costs its issue
// whatever its size: PERF.md §6).
__device__ __forceinline__ void produce_pass(const Params& p, unsigned char* base, Ring& ring, int l, int b,
                                             int m0, int c0, int kn, bool issuer) {
  const int kd = p.kd[l], nsteps = p.pn / kd, width = l == 0 ? p.kx : p.hw;
  const uint32_t bytes = (uint32_t)stage_bytes(kd, kn);
  const CUtensorMap* ma = &p.tm_a[kd == 128 ? 0 : 1];
  const CUtensorMap* mb = &p.tm_b[kn == pass_width(p.kp[l]) ? l : MAX_LAYERS];
#pragma unroll 1
  for (int s = 0; s < nsteps; ++s, ++ring.it) {
    if (!issuer) continue;
    const int slot = ring.slot();
    const uint32_t full = ring.full0 + 8 * slot, dst = smem_u32(base + slot * p.slot);
#if K5_TRACE
    const long long tw = clock64();
#endif
    mbar_wait(ring.empty0 + 8 * slot, ring.parity() ^ 1u);
    K5_T(2, clock64() - tw);
    mbar_expect_tx(full, bytes);
    tma_load3(dst, mb, 0, b * width + c0, s * kd / KB, full);
    tma_load3(dst + kd * kn * 2, ma, 0, b * p.pn + m0, s * kd / KB, full);
  }
}

// One pass of one row tile's aggregation in a consumer warpgroup: acc =
// A[m0:m0 + ROWS, :] @ h[:, c0:c0 + KN] through the ring, then the update
// of these KN columns: accu += bf16(acc) @ W^T[:, c0:c0 + KN] (Ws: those
// columns of W^T, [np][KN + 8] in shared memory). A step converts each 64
// columns' A fragments, issues their wgmmas and waits for them before the
// next 64 (a chunk's fragments kept live beside the next one's conversion
// left ptxas short of registers: it serialized the wgmmas, warning C7512,
// and spilled; PERF.md §6).
template <int KN, int NTU>
__device__ __forceinline__ void consume_pass(const Params& p, unsigned char* base, Ring& ring, int kd,
                                             const bf16* Ws, int ntu, float (&accu)[NTU][4]) {
  constexpr int ldw = KN + 8;
  constexpr int MC = KN <= 32 ? 4 : 2;  // a step's 64-column chunks: kd <= 256, or <= 128 wider
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3, row = (threadIdx.x >> 5) * 16 + g;
  const int nsteps = p.pn / kd, nch = kd / KB;
  float acc[KN / 2];
#pragma unroll
  for (int i = 0; i < KN / 2; ++i) acc[i] = 0.f;

#pragma unroll 1
  for (int s = 0; s < nsteps; ++s, ++ring.it) {
    const int slot = ring.slot();
#if K5_TRACE
    const long long tw = clock64();
#endif
    mbar_wait(ring.full0 + 8 * slot, ring.parity());
    if (threadIdx.x == 0) K5_T(0, clock64() - tw);
#if K5_TRACE
    const long long tc = clock64();
#endif
    const unsigned char* sl = base + slot * p.slot;
    const unsigned char* arow = sl + kd * KN * 2 + row * KB + 16 * t4;
    const uint32_t bbase = smem_u32(sl);
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) pin(acc[i]);
#pragma unroll
    for (int c = 0; c < MC; ++c) {
      if (c < nch) {
        const uint4 v0 = *reinterpret_cast<const uint4*>(arow + c * ROWS * KB);
        const uint4 v1 = *reinterpret_cast<const uint4*>(arow + c * ROWS * KB + 8 * KB);
        const uint32_t w0[4] = {v0.x, v0.y, v0.z, v0.w}, w1[4] = {v1.x, v1.y, v1.z, v1.w};
        uint32_t fr[4][4];  // [instruction][register]
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          i8x4_bf16(w0[j], fr[j][0], fr[j][2]);
          i8x4_bf16(w1[j], fr[j][1], fr[j][3]);
        }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) wgmma<KN>(acc, fr[j], desc_sw128(bbase + c * KN * 128 + j * 32));
        wgmma_commit();
        wgmma_wait0();
      }
    }
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) pin(acc[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty0 + 8 * slot);
    if (threadIdx.x == 0) K5_T(1, clock64() - tc);
  }

  // The update over this pass's columns: the accumulators of n-tiles 2j
  // and 2j + 1, rounded to bf16, are the A fragment of k-block j.
#pragma unroll
  for (int j = 0; j < KN / 16; ++j) {
    const uint32_t af[4] = {bf16x2(acc[8 * j], acc[8 * j + 1]), bf16x2(acc[8 * j + 2], acc[8 * j + 3]),
                            bf16x2(acc[8 * j + 4], acc[8 * j + 5]),
                            bf16x2(acc[8 * j + 6], acc[8 * j + 7])};
    const int k = 16 * j + t4 * 2;
#pragma unroll
    for (int u = 0; u < NTU; ++u) {
      if (u < ntu) {
        const bf16* pw = Ws + (u * 8 + g) * ldw + k;
        mma_bf16(accu[u], af, *reinterpret_cast<const uint32_t*>(pw),
                 *reinterpret_cast<const uint32_t*>(pw + 8));
      }
    }
  }
}

// W^T [np][kin] of layer l, columns c0 .. c0 + kn, into Ws [np][kn + 8], by
// the first `nthr` threads.
__device__ __forceinline__ void stage_w(const Params& p, bf16* Ws, int l, int c0, int kn, int nthr) {
  const int kin = p.kp[l], per = kn / 8, ldw = kn + 8;
  const bf16* wl = p.w + p.w_off[l] + c0;
  for (int i = threadIdx.x; i < p.np[l] * per; i += nthr) {
    const int r = i / per, c = (i - r * per) * 8;
    *reinterpret_cast<int4*>(Ws + r * ldw + c) =
        __ldg(reinterpret_cast<const int4*>(wl + (size_t)r * kin + c));
  }
}

// The pass of kn columns (a multiple of 16, at most 128; at most 64 unless
// WIDE, so that a multi-pass layer compiles no wider pass) at a run-time
// width.
template <int NTU, bool WIDE>
__device__ __forceinline__ void pass_of(int kn, const Params& p, unsigned char* base, Ring& ring, int kd,
                                        const bf16* Ws, int ntu, float (&accu)[NTU][4]) {
  if constexpr (WIDE) {
    if (kn > 64) {
      switch (kn >> 4) {
        case 5: consume_pass<80, NTU>(p, base, ring, kd, Ws, ntu, accu); return;
        case 6: consume_pass<96, NTU>(p, base, ring, kd, Ws, ntu, accu); return;
        case 7: consume_pass<112, NTU>(p, base, ring, kd, Ws, ntu, accu); return;
        default: consume_pass<128, NTU>(p, base, ring, kd, Ws, ntu, accu); return;
      }
    }
  }
  switch (kn >> 4) {
    case 1: consume_pass<16, NTU>(p, base, ring, kd, Ws, ntu, accu); break;
    case 2: consume_pass<32, NTU>(p, base, ring, kd, Ws, ntu, accu); break;
    case 3: consume_pass<48, NTU>(p, base, ring, kd, Ws, ntu, accu); break;
    default: consume_pass<64, NTU>(p, base, ring, kd, Ws, ntu, accu); break;
  }
}

// One row tile's output: relu and bf16 into the plane hout^T (at the stored
// columns), or the f32 logits of the last layer into outb.
template <int NTU>
__device__ __forceinline__ void store_tile(const Params& p, int l, int m0, bf16* hout, float* outb,
                                           const float (&accu)[NTU][4]) {
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t4 = lane & 3, ntu = p.np[l] / 8;
  const bool last = l == p.n_layers - 1;
#pragma unroll
  for (int u = 0; u < NTU; ++u) {
    if (u >= ntu) continue;
    const int col = u * 8 + t4 * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8
      const int r = m0 + (tid >> 5) * 16 + g + 8 * h;
      const float v0 = accu[u][2 * h], v1 = accu[u][2 * h + 1];
      if (last) {
        float* o = outb + (size_t)r * p.cp + col;
        if (col < p.cp) o[0] = v0;
        if (col + 1 < p.cp) o[1] = v1;
      } else {
        const int q = perm_row(r);
        hout[(size_t)col * p.pn + q] = __float2bfloat16_rn(fmaxf(v0, 0.f));
        hout[(size_t)(col + 1) * p.pn + q] = __float2bfloat16_rn(fmaxf(v1, 0.f));
      }
    }
  }
}

// One row tile of one layer in the consumer warpgroups: its passes
// (pass_width), then store_tile. A layer of one pass finds its W^T staged
// (k5_kernel) and keeps no update sums across a pass loop (their registers
// would be live through every step); a wider one stages each 64-column
// pass's W^T between two consumer barriers.
template <int NTU>
__device__ __forceinline__ void consume_tile(const Params& p, unsigned char* base, Ring& ring, int l,
                                             int m0, bf16* hout, float* outb) {
  bf16* Ws = reinterpret_cast<bf16*>(base + p.off_w);
  const int kin = p.kp[l], ntu = p.np[l] / 8, kd = p.kd[l];
  float accu[NTU][4];
#pragma unroll
  for (int u = 0; u < NTU; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) accu[u][i] = 0.f;
  if (kin <= NC) {
    pass_of<NTU, true>(kin, p, base, ring, kd, Ws, ntu, accu);
  } else {
#pragma unroll 1
    for (int c0 = 0; c0 < kin; c0 += KW) {
      const int kn = min(KW, kin - c0);
      consumer_sync(NCONS);  // the previous pass is done with Ws
      stage_w(p, Ws, l, c0, kn, NCONS);
      consumer_sync(NCONS);
      pass_of<NTU, false>(kn, p, base, ring, kd, Ws, ntu, accu);
    }
  }
  store_tile<NTU>(p, l, m0, hout, outb, accu);
}

// The node of stored column q (inverse of perm_row).
__host__ __device__ inline int unperm_row(int q) {
  const int j = (q >> 4) & 3, r = q & 15;
  return (q & ~63) | (((r & 7) >> 1) << 4) | (j << 2) | ((r >> 3) << 1) | (r & 1);
}

// X's rows [m0, m0 + ROWS) of one batch rounded to bf16 and written
// transposed into xt [kx][pn] at the stored columns, zero past xp, by
// `nthr` threads (`tid` this one's index): item (feature f, 8 stored
// columns) gathers its 8 values, consecutive threads taking consecutive
// features of one row (128-byte loads across a warp), two items at a time.
__device__ __forceinline__ void convert_x(const Params& p, const float* xb, bf16* xt, int m0, int tid,
                                          int nthr) {
  constexpr int U = 2;
  const int total = ROWS / 8 * p.kx;
#pragma unroll 1
  for (int i0 = tid; i0 < total; i0 += U * nthr) {
    float v[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * nthr, f = i % p.kx, q = i / p.kx * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[u][e] = i < total && f < p.xp ? __ldg(xb + (size_t)(m0 + unperm_row(q + e)) * p.xp + f) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * nthr, f = i % p.kx, q = i / p.kx * 8;
      if (i < total)
        *reinterpret_cast<uint4*>(xt + (size_t)f * p.pn + m0 + q) =
            make_uint4(bf16x2(v[u][0], v[u][1]), bf16x2(v[u][2], v[u][3]), bf16x2(v[u][4], v[u][5]),
                       bf16x2(v[u][6], v[u][7]));
    }
  }
}

// Whether a group barrier follows layer l of batch b: between layers, and
// after a one-layer batch when the group has another (the producer
// warpgroup writes the next batch's X^T during layer 0).
__device__ __forceinline__ bool sync_after(const Params& p, int b, int l) {
  return l < p.n_layers - 1 || (p.n_layers == 1 && b + p.groups < p.B);
}

// The consumer warpgroups' side of the kernel: X^T of the group's first
// batch, then every batch's layers and row tiles. The producer's side
// (produce_main) meets them at every CTA barrier, in the same order.
template <int NTU>
__device__ __forceinline__ void consume_main(const Params& p, unsigned char* base, Ring& ring) {
  const int grp = blockIdx.x / p.ctas, rank = blockIdx.x - grp * p.ctas, tiles = p.pn / ROWS;
  bf16* const Ws = reinterpret_cast<bf16*>(base + p.off_w);
  unsigned nbar = 0;
#if K5_TRACE
  long long t1 = clock64();
#endif
  if (grp < p.B)
#pragma unroll 1
    for (int t = rank; t < tiles; t += p.ctas)
      convert_x(p, p.x + (size_t)grp * p.pn * p.xp, p.h[0] + (size_t)grp * p.kx * p.pn, t * ROWS, threadIdx.x,
                NCONS);
  if (threadIdx.x == 0) K5_T(5, clock64() - t1);
  group_sync(p.bar + grp, ++nbar * p.ctas);
#pragma unroll 1
  for (int b = grp; b < p.B; b += p.groups) {
    float* const outb = p.out + (size_t)b * p.pn * p.cp;
#pragma unroll 1
    for (int l = 0; l < p.n_layers; ++l) {
      __syncthreads();  // the previous layer's readers of Ws are done
      if (p.kp[l] <= NC) stage_w(p, Ws, l, 0, p.kp[l], NCONS);
      __syncthreads();
      bf16* const hout = p.h[1 + (l & 1)] + (size_t)b * p.hw * p.pn;
#pragma unroll 1
      for (int t = rank; t < tiles; t += p.ctas) consume_tile<NTU>(p, base, ring, l, t * ROWS, hout, outb);
#if K5_TRACE
      t1 = clock64();
#endif
      if (sync_after(p, b, l)) group_sync(p.bar + grp, ++nbar * p.ctas);
      if (threadIdx.x == 0) K5_T(4, clock64() - t1);
    }
  }
}

// The producer warpgroup's side: its first thread issues every step's
// copies of the same batches, layers, tiles and passes; its warps 1-3
// write the next batch's X^T during layer 0.
__device__ __forceinline__ void produce_main(const Params& p, unsigned char* base, Ring& ring) {
  const int pt = (int)threadIdx.x - NCONS;
  const int grp = blockIdx.x / p.ctas, rank = blockIdx.x - grp * p.ctas, tiles = p.pn / ROWS;
  unsigned nbar = 0;
  group_sync(p.bar + grp, ++nbar * p.ctas);
#pragma unroll 1
  for (int b = grp; b < p.B; b += p.groups) {
#pragma unroll 1
    for (int l = 0; l < p.n_layers; ++l) {
      __syncthreads();
      __syncthreads();
      if (pt < 32) {
#pragma unroll 1
        for (int t = rank; t < tiles; t += p.ctas)
#pragma unroll 1
          for (int c0 = 0; c0 < p.kp[l]; c0 += pass_width(p.kp[l]))
            produce_pass(p, base, ring, l, b, t * ROWS, c0, min(pass_width(p.kp[l]), p.kp[l] - c0), pt == 0);
      } else if (l == 0 && b + p.groups < p.B) {
        const int nb = b + p.groups;
#pragma unroll 1
        for (int t = rank; t < tiles; t += p.ctas)
          convert_x(p, p.x + (size_t)nb * p.pn * p.xp, p.h[0] + (size_t)nb * p.kx * p.pn, t * ROWS, pt - 32,
                    WG - 32);
      }
      if (sync_after(p, b, l)) group_sync(p.bar + grp, ++nbar * p.ctas);
    }
  }
}

// NTU: n-tiles of the widest layer's update (8: up to 64 columns, 16: up
// to 128). Threads: two consumer warpgroups, then the producer
// warpgroup, whose first thread issues the copies; the producer gives its
// registers to the consumers (setmaxnreg).
template <int NTU>
__global__ void __launch_bounds__(NCONS + WG, 1) k5_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem[];
  unsigned char* const base = smem + ((ALIGN - (smem_u32(smem) & (ALIGN - 1))) & (ALIGN - 1));
#if K5_TRACE
  const long long t_start = clock64();
#endif
  Ring ring{smem_u32(base + p.off_bar), smem_u32(base + p.off_bar) + 8 * STAGES, 0};
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(ring.full0 + 8 * i, 1);
      mbar_init(ring.empty0 + 8 * i, ROWS / 16);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if ((int)threadIdx.x >= NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 64;\n");
    produce_main(p, base, ring);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
    consume_main<NTU>(p, base, ring);
    if (threadIdx.x == 0) K5_T(6, clock64() - t_start);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once in the libcuda the
// process has loaded (the library links only the CUDA runtime).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* drv = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (drv == nullptr) drv = dlopen("libcuda.so.1", RTLD_LAZY);
    if (drv != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(drv, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A tensor map over a row-major [rows][cols] array of `esz`-byte elements
// seen as (64, rows, cols / 64), boxes of (64, box_r, box_k).
inline int tensor_map(CUtensorMap* m, CUtensorMapDataType type, int esz, const void* base, uint64_t cols,
                      uint64_t rows, uint32_t box_r, uint32_t box_k, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)KB, rows, cols / KB}, strides[2] = {cols * esz, (cuuint64_t)KB * esz};
  const cuuint32_t box[3] = {(cuuint32_t)KB, box_r, box_k}, es[3] = {1, 1, 1};
  const CUresult r = fn(m, type, 3, const_cast<void*>(base), dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NTU>
int launch(Params& p, int smem, cudaStream_t s) {
  const int threads = NCONS + WG;
  int e = 0;
  for (int i = 0; i < 2 && !e; ++i)  // kd 128 and 256: 2 and 4 boxes of 64 columns
    e = tensor_map(&p.tm_a[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.a, p.pn, (uint64_t)p.B * p.pn, ROWS, 2 << i,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  for (int l = 0; l < p.n_layers && !e; ++l) {
    const int w = l == 0 ? p.kx : p.hw, kn = pass_width(p.kp[l]);
    bf16* const plane = l == 0 ? p.h[0] : p.h[1 + ((l - 1) & 1)];
    e = tensor_map(&p.tm_b[l], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, plane, p.pn, (uint64_t)p.B * w, kn,
                   p.kd[l] / KB, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (!e && p.kx > NC && p.kx % KW)
    e = tensor_map(&p.tm_b[MAX_LAYERS], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.h[0], p.pn, (uint64_t)p.B * p.kx,
                   p.kx % KW, p.kd[0] / KB, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e) return e;
  cudaError_t ce = cudaFuncSetAttribute(k5_kernel<NTU>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (ce != cudaSuccess) return (int)ce;
  int dev = 0, sms = 0, per_sm = 0;
  if ((ce = cudaGetDevice(&dev)) != cudaSuccess) return (int)ce;
  if ((ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)ce;
  if ((ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k5_kernel<NTU>, threads, smem)) != cudaSuccess)
    return (int)ce;
  if (p.groups * p.ctas > sms * per_sm) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.groups * p.ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  ce = cudaLaunchKernelEx(&cfg, k5_kernel<NTU>, p);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

#if K5_TRACE
inline int read_trace(void* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, k5_trace, sizeof(k5_trace));
  if (e == cudaSuccess && reset) {
    static unsigned long long zero[1024 * 8];
    e = cudaMemcpyToSymbol(k5_trace, zero, sizeof(k5_trace));
  }
  return (int)e;
}
#endif

}  // namespace k5
}  // namespace qgtc
