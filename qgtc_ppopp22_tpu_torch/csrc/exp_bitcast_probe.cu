// exp_bitcast_probe: where each byte of an int32 word lands on the card.
//
// Replaces the TPU probes benchmarks/exp_bitcast_probe.py::probe32to8
// (kernel :20, pallas_call :33) and probe8to32 (:46, :53), which asked
// which sublane each byte of a word lands on after pltpu.bitcast. Here:
//   bitcast32to8  int32 [m][n] -> int8 [4m][n], byte k of word (i, j) to
//                 row 4i + k (the TPU's row order, which is not a view of
//                 the card's memory: a word's bytes are adjacent there,
//                 so this is a transpose of each word's 4 bytes);
//   bitcast8to32  the inverse, word (i, j) = bytes (4i .. 4i + 3, j),
//                 little-endian;
//   fragment_probe the registers of the first int8 mma.sync.m16n8k32 of
//                 warp 0: the A tile staged by Int8Loader and B transposed
//                 to [n][k] by load_b (both below, the loaders of the
//                 retired single-stage GEMM loop), the fragments loaded by
//                 gemm_core.cuh's frag_a and frag_b, which K2's K loop
//                 calls (frag_b K3's too), so the caller can hold them to
//                 the PTX ISA's layout: a change to those loads changes this.
// What bounds it on an H100: bytes, each input read once and each output
// written once (2 x 4 m n bytes over 3.35 TB/s); at the probes' own few
// KB, one launch, whose floor is the device time of the smallest kernel
// PyTorch launches (chip_smoke.py times torch.zeros(1)'s fill beside it).
// Design: both bitcasts take four consecutive columns of one word row a
// thread, one grid row per word row, so no thread divides, and transpose
// the 4 x 4 bytes in registers by byte permutes (gemm_core.cuh bytes_at,
// the gather of exp_packmm's noextract). bitcast32to8: one 16-byte load,
// four 4-byte stores. bitcast8to32: four 4-byte loads (each warp's 128
// contiguous bytes of a byte row), one 16-byte store; on an H100 (700 W)
// it moved 128 MB at the card's copy rate, and two or four such groups a
// thread, all loads before the stores, ran 1-7% slower at 16 and 128 MB.
// Each has a tail path where n % 4 or the alignment rules the vector
// accesses out. One CTA of gemm_core's 128 threads for the fragments.
#include "gemm_core.cuh"

using namespace qgtc;

namespace {

// Word row blockIdx.y, four consecutive words a thread: one 16-byte load,
// then output row 4i + k's four bytes as one word, byte k of each
// (bytes_at). vec is 0 when n % 4 or the operands' alignment rules the
// vector accesses out: the tail path then reads the (up to) four words
// one by one and stores bytes.
__global__ void bitcast32to8_kernel(const int32_t* __restrict__ x, int8_t* __restrict__ out,
                                    int m, int n, int vec) {
  const int i = blockIdx.y, j0 = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (j0 >= n) return;
  const int32_t* const src = x + (size_t)i * n + j0;
  int8_t* const dst = out + (size_t)(4 * i) * n + j0;
  if (vec) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(src));
#pragma unroll
    for (int k = 0; k < 4; ++k) *reinterpret_cast<uint32_t*>(dst + (size_t)k * n) = bytes_at(v, k);
    return;
  }
  for (int j = 0; j < 4 && j0 + j < n; ++j) {
    const char4 b = reinterpret_cast<const char4*>(src)[j];
    dst[j] = b.x;
    dst[(size_t)n + j] = b.y;
    dst[(size_t)2 * n + j] = b.z;
    dst[(size_t)3 * n + j] = b.w;
  }
}

// Word row blockIdx.y, four consecutive columns a thread: one 4-byte load
// from each byte row 4i + k (byte j of load k = byte k of word j), then
// word j = byte j of each load (bytes_at) and one 16-byte store. vec is 0
// when n % 4 or the operands' alignment rules the vector accesses out:
// the tail path then builds the (up to) four words byte by byte.
__global__ void bitcast8to32_kernel(const int8_t* __restrict__ x, int32_t* __restrict__ out,
                                    int m, int n, int vec) {
  const int i = blockIdx.y, j0 = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (j0 >= n) return;
  const int8_t* const src = x + (size_t)(4 * i) * n + j0;
  int32_t* const dst = out + (size_t)i * n + j0;
  if (vec) {
    const int4 v = make_int4(__ldg(reinterpret_cast<const int*>(src)),
                             __ldg(reinterpret_cast<const int*>(src + n)),
                             __ldg(reinterpret_cast<const int*>(src + (size_t)2 * n)),
                             __ldg(reinterpret_cast<const int*>(src + (size_t)3 * n)));
    *reinterpret_cast<int4*>(dst) = make_int4(bytes_at(v, 0), bytes_at(v, 1), bytes_at(v, 2), bytes_at(v, 3));
    return;
  }
  for (int j = 0; j < 4 && j0 + j < n; ++j)
    dst[j] = (int32_t)((uint32_t)(uint8_t)src[j] | ((uint32_t)(uint8_t)src[(size_t)n + j] << 8) |
                       ((uint32_t)(uint8_t)src[(size_t)2 * n + j] << 16) |
                       ((uint32_t)(uint8_t)src[(size_t)3 * n + j] << 24));
}

// The fragment probe's A tile: plain int8 rows, [ND][mp][kp], 16-byte
// chunks into the [ND][ROWS][LDS] tile.
struct Int8Loader {
  const int8_t* __restrict__ a;
  int mp, kp;

  template <int ND, int ROWS>
  __device__ __forceinline__ void load(int8_t (*As)[ROWS][LDS], int m0, int k0,
                                       int tid) const {
    constexpr int CH = BK / 16;  // 16-byte chunks per row
    for (int c = tid; c < ROWS * CH; c += 2 * ROWS) {
      const int r = c / CH, kc = (c % CH) * 16;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(
            a + (size_t)d * mp * kp + (size_t)(m0 + r) * kp + k0 + kc));
        *reinterpret_cast<int4*>(&As[d][r][kc]) = v;
      }
    }
  }
};

// The fragment probe's B tile: int8 [ND_B][kp][np] rows, transposed to
// [ND_B][n][k] (the [n][k] tile that frag_b reads).
template <int ND_B, int NT = THREADS>
__device__ __forceinline__ void load_b(int8_t (*Bs)[BN][LDS],
                                       const int8_t* __restrict__ b, int kp,
                                       int np, int k0, int n0, int tid) {
  constexpr int CH = BN / 16;
  for (int c = tid; c < BK * CH; c += NT) {
    const int k = c / CH, nc = (c % CH) * 16;
#pragma unroll
    for (int e = 0; e < ND_B; ++e) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(
          b + (size_t)e * kp * np + (size_t)(k0 + k) * np + n0 + nc));
      const int8_t* bytes = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) Bs[e][nc + j][k] = bytes[j];
    }
  }
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

// m: word rows; n: columns. One thread per 4 words of a row: a row's
// ceil(n / 4) chunks over CTAs of up to 128 threads (whole warps), one
// grid row per word row, so no thread divides.
extern "C" int qgtc_bitcast32to8(void* out, const void* x, int m, int n, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int nc = (n + 3) / 4, threads = min(128, (nc + 31) / 32 * 32);
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const dim3 grid((nc + threads - 1) / threads, m);
  bitcast32to8_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int8_t*>(out), m, n, vec);
  return (int)cudaGetLastError();
}

// The same CTAs as qgtc_bitcast32to8's, four columns of a word row a
// thread.
extern "C" int qgtc_bitcast8to32(void* out, const void* x, int m, int n, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int nc = (n + 3) / 4, threads = min(128, (nc + 31) / 32 * 32);
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((nc + threads - 1) / threads, m);
  bitcast8to32_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int32_t*>(out), m, n, vec);
  return (int)cudaGetLastError();
}

extern "C" int qgtc_fragment_probe(void* a_regs, void* b_regs, const void* a, const void* b,
                                   void* stream) {
  fragment_probe_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<uint32_t*>(a_regs), static_cast<uint32_t*>(b_regs));
  return (int)cudaGetLastError();
}
