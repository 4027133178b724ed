// bitmm: BitTensor planes x BitTensor planes on the one-bit tensor cores.
//
// Replaces the TPU kernel qgtc_ppopp22_tpu/ops/bitgemm.py::_bitmm (kernel
// body _make_kernel.kernel, pallas_call at :345). The TPU's MXU has no
// one-bit product, so that kernel unpacks the planes into int8 digits in
// VMEM. Hopper still has one, and this kernel uses it, as the reference
// does (bmma_sync with bmmaBitOpAND):
//   C = sum_{i < a_bits, j < b_bits} popc(A_i AND B_j) << (i + j)
// with mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc, summed
// in unsigned 32-bit arithmetic so that a sum past 2^31 wraps as the JAX
// kernel's int32 does.
//
// What bounds it on an H100: at the slice's shapes (an aggregation is a
// 1-bit A[2560 x 2560] times 2-bit H[2560 x 256 padded], an update
// X[2560 x 256] x W[256 x 256]) the planes are 0.8-2.6 MB and the work is
// a few G one-bit operations, so the bytes (under a microsecond at
// 3.35 TB/s) and the launch bound it, not arithmetic. This first version
// is simple and right rather than fast: one shared-memory stage per
// 256-bit K step, no cp.async ring.
// What the design does about it: each CTA owns a 64 x 64 output tile and
// loops over the whole contraction (or over the K tiles its TileMap row
// lists), the plane pairs are summed in registers and the requantize +
// bit repack epilogue runs in the CTA, so no int32 sum reaches device
// memory.
//
// Layouts (ops/bitpack.py): planes int32[bits][rows / 32][cols], a word
// packing 32 consecutive rows of one column. For B (K x N) a word is 32
// consecutive k of one column: already the .col operand's register. For
// A (M x K) it is 32 consecutive m of one k, transposed relative to the
// .row operand, so each 32 x 32 bit block of A is transposed across a
// warp (5 shuffle rounds) as it is staged in shared memory.
#include <cstdint>
#include <cuda_runtime.h>

#include "gemm_core.cuh"

namespace qgtc {
namespace bitmm {

constexpr int BM = 64;          // output rows per CTA
constexpr int BN = 64;          // output columns per CTA
constexpr int KC = 256;         // contraction bits per stage (one mma k)
constexpr int KW = KC / 32;     // 32-bit words of K per row and stage
constexpr int AS = KW + 4;      // A row stride in words: 12 keeps the
                                // fragment loads (8 rows x 4 words) in 32
                                // distinct banks
constexpr int BS = BN + 8;      // B row stride in words: 72, likewise
constexpr int MAX_BITS = 8;
constexpr int THREADS = 128;    // 4 warps as 2 x 2, each a 32 x 32 tile

struct Args {
  void* out;             // f32 [mp][np], or int32 planes [out_bits][mp/32][np]
  const uint32_t* a;     // int32 planes [a_bits][mp/32][kp]
  const uint32_t* b;     // int32 planes [b_bits][kp/32][np]
  KMap map;              // the TileMap, or null pointers (dense)
  int a_bits, b_bits, mp, kp, np, out_bits;
};

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Lane L holds row L of a 32 x 32 bit matrix (bit c = column c); returns
// column L (bit r = row r). Each round swaps the off-diagonal halves of
// 2 x 2 blocks of side j between lanes L and L ^ j.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  uint32_t m = 0x0000FFFFu;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1, m ^= m << j) {
    const uint32_t p = __shfl_xor_sync(0xFFFFFFFFu, x, j);
    x = (lane & j) ? (((p >> j) & m) | (x & ~m)) : ((x & m) | ((p & m) << j));
  }
  return x;
}

__global__ void __launch_bounds__(THREADS) bitmm_kernel(Args p) {
  __shared__ __align__(16) uint32_t As[MAX_BITS][BM][AS];  // [row][k word]
  __shared__ __align__(16) uint32_t Bs[MAX_BITS][KW][BS];  // [k word][col]
  __shared__ uint8_t Rs[BM][BN + 4];                       // requantized tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // mma groupID / thread-in-group
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kwords = p.kp / 32;

  uint32_t acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  // The K tiles to visit: the whole contraction as one tile, or the
  // TileMap row of this CTA's rows (gemm_core.cuh KTiles).
  const KTiles kt(p.map, m0, p.kp);
  for (int t = 0; t < kt.n; ++t) {
    const int kb = kt.start(t);
    if (kb < 0) continue;  // outside the grid: nothing to read
    for (int k0 = kb; k0 < kb + kt.depth; k0 += KC) {
      // A: one 32 x 32 bit block (32 rows x 32 k) per warp step; lane L
      // reads the word of column k0 + 32c + L and keeps row 32r + L.
      const int nblk = p.a_bits * (BM / 32) * KW;
      for (int blk = warp; blk < nblk; blk += THREADS / 32) {
        const int i = blk / (2 * KW), r = (blk / KW) & 1, c = blk % KW;
        const uint32_t w = __ldg(p.a + ((size_t)i * (p.mp / 32) + m0 / 32 + r) * p.kp +
                                 k0 + 32 * c + lane);
        As[i][32 * r + lane][c] = transpose32(w, lane);
      }
      // B: KW word rows of BN columns per plane, 16-byte loads.
      const int nvec = p.b_bits * KW * (BN / 4);
      for (int v = tid; v < nvec; v += THREADS) {
        const int j = v / (KW * BN / 4), q = (v / (BN / 4)) % KW, c4 = (v % (BN / 4)) * 4;
        *reinterpret_cast<uint4*>(&Bs[j][q][c4]) = __ldg(reinterpret_cast<const uint4*>(
            p.b + ((size_t)j * kwords + k0 / 32 + q) * p.np + n0 + c4));
      }
      __syncthreads();
      for (int i = 0; i < p.a_bits; ++i) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t* r0 = &As[i][wm + 16 * mt + g][0];
          const uint32_t* r8 = r0 + 8 * AS;
          af[mt][0] = r0[t4];
          af[mt][1] = r8[t4];
          af[mt][2] = r0[t4 + 4];
          af[mt][3] = r8[t4 + 4];
        }
        for (int j = 0; j < p.b_bits; ++j) {
          uint32_t bf[4][2];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            bf[nt][0] = Bs[j][t4][wn + 8 * nt + g];
            bf[nt][1] = Bs[j][t4 + 4][wn + 8 * nt + g];
          }
          const int s = i + j;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              int d[4] = {0, 0, 0, 0};
              mma_b1(d, af[mt], bf[nt]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mt][nt][e] += (uint32_t)d[e] << s;
            }
        }
      }
      __syncthreads();
    }
  }

  if (p.out_bits == 0) {  // bitMM2Int: the raw sum as float32
    float* o = static_cast<float*>(p.out);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8
          const int row = m0 + wm + 16 * mt + g + 8 * h;
          const int col = n0 + wn + 8 * nt + 2 * t4;
          *reinterpret_cast<float2*>(o + (size_t)row * p.np + col) =
              make_float2((float)(int)acc[mt][nt][2 * h], (float)(int)acc[mt][nt][2 * h + 1]);
        }
    return;
  }
  // bitMM2Bit: requantize into the tile, then each thread builds whole
  // (plane, word row, column) words of 32 rows (the reverse transpose).
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Rs[wm + 16 * mt + g + 8 * (e >> 1)][wn + 8 * nt + 2 * t4 + (e & 1)] =
            (uint8_t)requant((int)acc[mt][nt][e], p.out_bits, 0);
  __syncthreads();
  uint32_t* o = static_cast<uint32_t*>(p.out);
  const int nwords = p.out_bits * (BM / 32) * BN;
  for (int v = tid; v < nwords; v += THREADS) {
    const int b = v / (2 * BN), r = (v / BN) & 1, n = v % BN;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) word |= (uint32_t)((Rs[32 * r + j][n] >> b) & 1) << j;
    o[((size_t)b * (p.mp / 32) + m0 / 32 + r) * p.np + n0 + n] = word;
  }
}

}  // namespace bitmm
}  // namespace qgtc

// out_bits 0 selects the float32 output. kidx / kcnt null: dense K.
extern "C" int qgtc_bitmm(void* out, const void* a, const void* b,
                          const void* kidx, const void* kcnt, int a_bits,
                          int b_bits, int mp, int kp, int np, int out_bits,
                          int tile_m, int tile_k, void* stream) {
  using namespace qgtc::bitmm;
  const qgtc::KMap map{static_cast<const int*>(kidx), static_cast<const int*>(kcnt),
                       tile_m, tile_k};
  if (out == nullptr || a == nullptr || b == nullptr) return (int)cudaErrorInvalidValue;
  if (a_bits < 1 || a_bits > MAX_BITS || b_bits < 1 || b_bits > MAX_BITS ||
      out_bits < 0 || out_bits > MAX_BITS)
    return (int)cudaErrorInvalidValue;
  if (mp <= 0 || kp <= 0 || np <= 0 || mp % BM || kp % KC || np % BN ||
      !qgtc::map_ok(map, mp, kp, BM, KC))
    return (int)cudaErrorInvalidValue;
  const Args args{out, static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
                  map, a_bits, b_bits, mp, kp, np, out_bits};
  const dim3 grid(np / BN, mp / BM);
  bitmm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(args);
  return (int)cudaGetLastError();
}
