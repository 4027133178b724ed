// exp_bitcast_probe: where each byte of an int32 word lands on the card.
//
// Replaces the TPU probes benchmarks/exp_bitcast_probe.py::probe32to8
// (kernel :20, pallas_call :33) and probe8to32 (:46, :53), which asked
// which sublane each byte of a word lands on after pltpu.bitcast. Here:
//   bitcast32to8  int32 [m][n] -> int8 [4m][n], byte k of word (i, j) to
//                 row 4i + k (the TPU's row order, which is not a view of
//                 the card's memory: a word's bytes are adjacent there);
//   bitcast8to32  the inverse, word (i, j) = bytes (4i .. 4i + 3, j),
//                 little-endian;
//   fragment_probe the registers of the first int8 mma.sync.m16n8k32 of
//                 warp 0, through gemm_core.cuh's own code (the A tile
//                 staged by Int8Loader, B transposed to [n][k] by load_b,
//                 the fragments loaded by frag_a and frag_b, which K2's
//                 and K4's K loops call), so the caller can hold them to
//                 the PTX ISA's layout: a change to those loads changes
//                 this.
// Both bitcasts read or write a word as a char4, the access the packed
// loaders' byte order rests on.
// What bounds it on an H100: nothing measurable; a few KB, one launch.
// Design: one thread per word; one CTA of gemm_core's 128 threads for
// the fragments.
#include "gemm_core.cuh"

using namespace qgtc;

namespace {

__global__ void bitcast32to8_kernel(const int32_t* __restrict__ x, int8_t* __restrict__ out,
                                    int m, int n) {
  const int i = blockIdx.y, j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const char4 c = reinterpret_cast<const char4*>(x)[(size_t)i * n + j];
  out[(size_t)(4 * i) * n + j] = c.x;
  out[(size_t)(4 * i + 1) * n + j] = c.y;
  out[(size_t)(4 * i + 2) * n + j] = c.z;
  out[(size_t)(4 * i + 3) * n + j] = c.w;
}

__global__ void bitcast8to32_kernel(const int8_t* __restrict__ x, int32_t* __restrict__ out,
                                    int m, int n) {
  const int i = blockIdx.y, j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  char4 c;
  c.x = x[(size_t)(4 * i) * n + j];
  c.y = x[(size_t)(4 * i + 1) * n + j];
  c.z = x[(size_t)(4 * i + 2) * n + j];
  c.w = x[(size_t)(4 * i + 3) * n + j];
  reinterpret_cast<char4*>(out)[(size_t)i * n + j] = c;
}

// a: int8 [BM][BK] (rows x k), b: int8 [BK][BN] (k x n); a_regs
// [32][4], b_regs [32][2]: warp 0's fragments of m-tile 0, n-tile 0 and
// the first 32-deep slice, as frag_a and frag_b load them.
__global__ void __launch_bounds__(THREADS)
    fragment_probe_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                          uint32_t* __restrict__ a_regs, uint32_t* __restrict__ b_regs) {
  __shared__ __align__(16) int8_t As[1][BM][LDS];
  __shared__ __align__(16) int8_t Bs[1][BN][LDS];
  const int tid = threadIdx.x;
  const Int8Loader la{a, BM, BK};
  la.load<1, BM>(As, 0, 0, tid);
  load_b<1, THREADS>(Bs, b, BK, BN, 0, 0, tid);
  __syncthreads();
  if (tid >= 32) return;
  uint32_t af[4], bf[2];
  const int g = tid >> 2, t4 = tid & 3;
  frag_a(af, &As[0][g][t4 * 4]);
  frag_b(bf, &Bs[0][g][t4 * 4]);
#pragma unroll
  for (int r = 0; r < 4; ++r) a_regs[4 * tid + r] = af[r];
  b_regs[2 * tid] = bf[0];
  b_regs[2 * tid + 1] = bf[1];
}

}  // namespace

// m: word rows; n: columns.
extern "C" int qgtc_bitcast32to8(void* out, const void* x, int m, int n, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + 127) / 128, m);
  bitcast32to8_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int8_t*>(out), m, n);
  return (int)cudaGetLastError();
}

extern "C" int qgtc_bitcast8to32(void* out, const void* x, int m, int n, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + 127) / 128, m);
  bitcast8to32_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int32_t*>(out), m, n);
  return (int)cudaGetLastError();
}

extern "C" int qgtc_fragment_probe(void* a_regs, void* b_regs, const void* a, const void* b,
                                   void* stream) {
  fragment_probe_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<uint32_t*>(a_regs), static_cast<uint32_t*>(b_regs));
  return (int)cudaGetLastError();
}
