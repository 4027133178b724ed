// K1's ring loop (fused_model_k1.cuh's aggregation) as the redesigned
// kernel-study probes run it: P3b's kdot (grid_overhead.cu) and P1b's
// packed output (exp_packmm_packed.cu). The loading helpers (cp_async16_u,
// ldsm4_u, transpose4) are K1's own, from async_cluster.cuh.
#pragma once

#include "async_cluster.cuh"
#include "gemm_core.cuh"

// PROBE_TRACE 1 (benchmarks/probe_trace.py builds a probe's source so,
// apart from the library) has each thread sum clock64 spans of ring_loop
// in registers, and thread 0 of each CTA add its sums to probe_trace: the
// waits for a step's copies, the barriers, the issue, the steps' bodies,
// their preps and the whole loop.
#ifndef PROBE_TRACE
#define PROBE_TRACE 0
#endif

namespace qgtc {
namespace probe {

constexpr int TRACE_SPANS = 8;      // per CTA
constexpr int TRACE_CTAS = 8192;    // CTAs the trace holds (a larger grid's rest are not traced)

#if PROBE_TRACE
__device__ unsigned long long probe_trace[TRACE_CTAS * TRACE_SPANS];
// span i of the statement(s): summed in span_[i], which ring_loop declares
#define PROBE_SPAN(i, ...)                  \
  do {                                      \
    const long long t0_ = clock64();        \
    __VA_ARGS__;                            \
    span_[i] += clock64() - t0_;            \
  } while (0)
#else
#define PROBE_SPAN(i, ...) __VA_ARGS__
#endif

// K1's ring over `total` steps in `stages` (3 or 4) slots, one barrier a
// step: steps 0 .. stages - 3 in flight before the loop; then per step j
// from -1: wait for step j + 1's copies, one barrier, issue(step, slot) of
// step j + stages - 1 into the slot of step j - 1 (whose readers passed
// the barrier), body(j, slot, buf) of step j, then prep(slot, buf) of step
// j + 1 into buffer (j + 1) & 1 (beside the tail of step j's MMAs). A
// step reads its slot and buffer only in prep and body, so two buffers
// and stages - 2 steps ahead suffice.
template <class Issue, class Prep, class Body>
__device__ __forceinline__ void ring_loop(int total, int stages, Issue&& issue, Prep&& prep,
                                          Body&& body) {
  int issued = 0, islot = 0;
  auto next = [&]() {
    if (issued < total) {
      issue(issued++, islot);
      if (++islot == stages) islot = 0;
    }
    cp_commit();
  };
#if PROBE_TRACE
  long long span_[6] = {};
#endif
  PROBE_SPAN(5, {
    for (int i = 0; i < stages - 2; ++i) next();
    int cs = stages - 1;  // step j's slot
    for (int j = -1; j < total; ++j) {
      const int ns = cs + 1 == stages ? 0 : cs + 1;
      PROBE_SPAN(0, if (stages == 4) cp_wait<1>(); else cp_wait<0>());
      PROBE_SPAN(1, __syncthreads());
      PROBE_SPAN(2, next());
      if (j >= 0) PROBE_SPAN(3, body(j, cs, j & 1));
      if (j + 1 < total) PROBE_SPAN(4, prep(ns, (j + 1) & 1));
      cs = ns;
    }
    cp_wait<0>();
  });
#if PROBE_TRACE
  const unsigned cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (threadIdx.x == 0 && cta < TRACE_CTAS)
    for (int i = 0; i < 6; ++i) probe_trace[cta * TRACE_SPANS + i] += (unsigned long long)span_[i];
#endif
}

#if PROBE_TRACE
// The trace into host memory (TRACE_CTAS x TRACE_SPANS uint64), then, if
// reset, zeros on the device; a CUDA error code.
extern "C" int qgtc_probe_trace(void* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, probe_trace, sizeof(probe_trace));
  if (e == cudaSuccess && reset) {
    void* dev = nullptr;
    e = cudaGetSymbolAddress(&dev, probe_trace);
    if (e == cudaSuccess) e = cudaMemset(dev, 0, sizeof(probe_trace));
  }
  return (int)e;
}
#endif

}  // namespace probe
}  // namespace qgtc
