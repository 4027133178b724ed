// K6's kernel: BitTensor planes x BitTensor planes on the one-bit tensor
// cores (csrc/bitmm.cu is its C entry; the source note there says what
// bounds it and what each lever does).
//
// A CTA owns 64 rows x BNT columns (BNT = 16, 32 or 64, the wrapper's
// choice from the real width N) and 1/S of the contraction. Its K loop,
// one 256-bit step a mma k:
//   * a ring of STAGES raw stages: cp.async.cg brings each step's A words
//     (the 2 word rows of the tile's 64 rows x 256 k, per plane) and B
//     words (8 word rows x BNT columns, per plane, as B lies in memory:
//     already the .col operand's registers) into shared memory ahead of
//     use; the MMAs read B straight from its ring slot;
//   * A's transpose: A is M-packed (a word holds 32 rows of one k), the
//     .row operand wants 32 k of one row, so each warp transposes 32 x 32
//     bit blocks from the raw slot, 4 or 8 at a time (5 shuffle rounds
//     each, interleaved; blocks all zero together are stored as they are) into
//     a swizzled [row][k word] tile that the fragment loads read without
//     bank conflicts;
//   * a double-buffered A tile, so a step has one barrier: the transpose of
//     step j + 1 and the MMAs of step j run between two barriers, and the
//     copies of step j + STAGES - 1 are issued after it into the slot that
//     step j - 1 freed.
// Plane pairs (i, j) add popc(A_i AND B_j) << (i + j) into uint32 sums,
// which wrap as the reference's int32 does. The plane counts are template
// parameters (0: read at run time, the general instantiation).
// Split-K: the S CTAs of a (1, 1, S) thread-block cluster share an output
// tile. Each takes a contiguous share of the K steps (with a TileMap,
// every S-th listed K tile of its row tile's map row); ranks z > 0 leave
// their sums in shared memory and rank 0 adds them through distributed
// shared memory (modulo 2^32, so the order does not matter), then runs
// the epilogue: the sums as float32, or requantized into a byte tile
// [column][row] from which each thread builds whole 32-row words, 4 rows
// a multiply. A 64-row CTA owns two whole word rows of the bits output.
// Every CTA passes a last cluster barrier before it exits. S = 1 launches
// without a cluster.
//
// Output: every element, padding included. The grid covers the column
// tiles that hold computed columns (below round_up(N, 8)); rank S - 1 of
// the last one also stores the columns past the grid: 0.0, or level 0 in
// every plane. That is exact because B's padded columns hold level 0 (their
// sums are 0 and requant(0) = 0).
#pragma once

#include <type_traits>

#include "async_cluster.cuh"
#include "gemm_core.cuh"

namespace qgtc {
namespace k6 {

constexpr int KC = 256;        // contraction bits per K step (one mma k)
constexpr int KW = KC / 32;    // words of K per row and step
constexpr int WR = BM / 32;    // A word rows of a 64-row CTA
constexpr int STAGES = 4;      // raw stages in the cp.async ring
constexpr int MAX_SPLIT = 4;   // CTAs that share one output tile
constexpr int MAX_BITS = 8;
constexpr int RS_LD = BM + 16;  // bytes a column of the requantized tile

struct Args {
  void* out;             // f32 [mp][np], or int32 planes [out_bits][mp/32][np]
  const uint32_t* a;     // int32 planes [a_bits][mp/32][kp]
  const uint32_t* b;     // int32 planes [b_bits][kp/32][np]
  KMap map;              // the TileMap, or null pointers (dense)
  int a_bits, b_bits, mp, kp, np, out_bits;
};

// Shared-memory layout (bytes) for ab A planes, bb B planes, BNT columns.
struct Layout {
  int a_raw;  // A's raw words of a step: [ab][WR][KC]
  int b_ld;   // B row stride in words: BNT + 8 keeps a fragment load in 32 banks
  int slot;   // one ring stage: A's raw words, then B's [bb][KW][b_ld]
  int as;     // the transposed A tile: [2][ab][BM][KW]
  int red;    // split-K partial sums [BM][BNT + 4]
  int smem;   // the A tile, then the ring or (after the loop) red + the byte tile
};

__host__ __device__ constexpr Layout layout(int ab, int bb, int bnt) {
  Layout l{};
  l.a_raw = ab * WR * KC * 4;
  l.b_ld = bnt + 8;
  l.slot = l.a_raw + bb * KW * l.b_ld * 4;
  l.as = 2 * ab * BM * KW * 4;
  l.red = BM * (bnt + 4) * 4;
  const int ring = STAGES * l.slot, epi = l.red + bnt * RS_LD;
  l.smem = l.as + (ring > epi ? ring : epi);
  return l;
}

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

// The A tile's swizzle: row r keeps its 8 k words at r * KW + (w ^
// swz((r >> 2) & 7)). A bijection of the 8 rows that share r % 4, so a
// transpose store (32 rows, one word) hits 32 banks; x and x + 1 differ in
// bit 2, so a fragment load (rows g, words t4 or t4 + 4) does too.
__device__ __forceinline__ int swz(int x) { return ((x & 1) << 2) | (x >> 1); }

// gridDim = (column tiles, mp / 64, S); cluster (1, 1, S). AB, BB: the
// plane counts, 0 for the run-time ones.
template <int AB, int BB, int BNT, bool MAPPED>
__global__ void __launch_bounds__(THREADS) k6_kernel(Args p) {
  constexpr int NT = BNT / 16;  // 8-column n-tiles per warp (2 x 2 warps)
  const int ab = AB ? AB : p.a_bits, bb = BB ? BB : p.b_bits;
  const Layout L = layout(ab, bb, BNT);

  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* const As = reinterpret_cast<uint32_t*>(smem);
  unsigned char* const tail = smem + L.as;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * (BNT / 2);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BNT;
  const int S = gridDim.z, z = blockIdx.z;
  const int mw = p.mp / 32;
  const size_t a_plane = (size_t)mw * p.kp, b_plane = (size_t)(p.kp / 32) * p.np;

  // This CTA's K steps: a contiguous share of the contraction, or every
  // S-th K tile its row tile's map row lists (an entry outside the grid
  // is read as zeros).
  int nst, kb_next, spt = 1, t_next = 0, s_next = 0;
  const KTiles kt(p.map, m0, p.kp);
  if (MAPPED) {
    spt = kt.depth / KC;
    const int cnt = kt.n > z ? (kt.n - z + S - 1) / S : 0;
    nst = cnt * spt;
    t_next = z;
    kb_next = cnt ? kt.start(z) : 0;
  } else {
    const int all = p.kp / KC, first = z * all / S;
    nst = (z + 1) * all / S - first;
    kb_next = first * KC;
  }

  // Each thread's copy of A, the same every step: one 16-byte chunk of a
  // word row (tid >> 6) per plane, columns 4 (tid & 63) onwards.
  const uint32_t* const a_src = p.a + (size_t)(m0 / 32 + (tid >> 6)) * p.kp + 4 * (tid & 63);
  const int a_dst = ((tid >> 6) * KC + 4 * (tid & 63)) * 4;
  auto issue = [&](int slot) {
    unsigned char* const raw = tail + slot * L.slot;
    const bool valid = kb_next >= 0;
    const int k0 = valid ? kb_next + s_next * KC : 0;
    for (int i = 0; i < ab; ++i)
      cp_async16(raw + i * (WR * KC * 4) + a_dst, a_src + i * a_plane + k0, valid);
    constexpr int PER_ROW = BNT / 4, PER_PLANE = KW * PER_ROW;
    for (int c = tid; c < bb * PER_PLANE; c += THREADS) {
      const int j = c / PER_PLANE, r = c - j * PER_PLANE;
      const int q = r / PER_ROW, nc = (r - q * PER_ROW) * 4;
      cp_async16(raw + L.a_raw + ((j * KW + q) * L.b_ld + nc) * 4,
                 p.b + j * b_plane + (size_t)(k0 / 32 + q) * p.np + n0 + nc, valid);
    }
    if (MAPPED) {
      if (++s_next == spt) {
        s_next = 0;
        t_next += S;
        if (t_next < kt.n) kb_next = kt.start(t_next);
      }
    } else {
      kb_next += KC;
    }
  };

  // Raw slot -> A tile `buf`: per plane i, warp w transposes the 4 blocks
  // (word row r, k word c = ((w - 2 i - r) & 3) + 4 h) for r, h in {0, 1}:
  // each warp holds one block of every k word below 4 and plane pair, so
  // the few non-zero low-k blocks of a narrow K spread over the warps. The
  // blocks of P = 1 or 2 planes go together, their shuffle chains
  // interleaved; blocks that are all zero together are stored as they are.
  // Lane L reads the word of column 32 c + L and keeps row 32 r + L's 32 k.
  const int sw_w = swz(lane >> 2);
  auto transpose_planes = [&](const uint32_t* raw, uint32_t* at, int i0, auto planes) {
    constexpr int NB = 4 * decltype(planes)::value;
    uint32_t w[NB];
    int c[NB];
    uint32_t any = 0;
#pragma unroll
    for (int v = 0; v < NB; ++v) {
      const int i = i0 + (v >> 2), r = (v >> 1) & 1;
      c[v] = ((warp - 2 * i - r) & 3) + 4 * (v & 1);
      w[v] = raw[(i * WR + r) * KC + 32 * c[v] + lane];
      any |= w[v];
    }
    if (__any_sync(0xFFFFFFFFu, any != 0)) {
#pragma unroll
      for (int v = 0; v < NB; ++v) w[v] = transpose32(w[v], lane);
    }
#pragma unroll
    for (int v = 0; v < NB; ++v)
      at[((i0 + (v >> 2)) * BM + 32 * ((v >> 1) & 1) + lane) * KW + (c[v] ^ sw_w)] = w[v];
  };
  auto transpose = [&](int slot, int buf) {
    const uint32_t* const raw = reinterpret_cast<const uint32_t*>(tail + slot * L.slot);
    uint32_t* const at = As + buf * ab * BM * KW;
    int i = 0;
    for (; i + 1 < ab; i += 2) transpose_planes(raw, at, i, std::integral_constant<int, 2>());
    if (i < ab) transpose_planes(raw, at, i, std::integral_constant<int, 1>());
  };

  uint32_t acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  // The fragment rows wm + 16 mt + 8 h + g and their swizzle.
  int sw_r[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) sw_r[mt][h] = swz((4 * mt + 2 * h + (g >> 2)) & 7);

  // Plane pair (i, j) of one step: popc(A_i AND B_j) << (i + j).
  auto pair = [&](const uint32_t (&af)[2][4], const uint32_t* bt, int i, int j) {
    uint32_t bf[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      bf[nt][0] = bt[(j * KW + t4) * L.b_ld + wn + 8 * nt + g];
      bf[nt][1] = bt[(j * KW + t4 + 4) * L.b_ld + wn + 8 * nt + g];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        int d[4] = {0, 0, 0, 0};
        mma_b1(d, af[mt], bf[nt]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += (uint32_t)d[e] << (i + j);
      }
  };
  auto plane = [&](const uint32_t* at, const uint32_t* bt, int i) {
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint32_t* r0 = at + (i * BM + wm + 16 * mt + g) * KW;
      const uint32_t* r8 = r0 + 8 * KW;
      af[mt][0] = r0[t4 ^ sw_r[mt][0]];
      af[mt][1] = r8[t4 ^ sw_r[mt][1]];
      af[mt][2] = r0[(t4 + 4) ^ sw_r[mt][0]];
      af[mt][3] = r8[(t4 + 4) ^ sw_r[mt][1]];
    }
    if constexpr (BB > 0 && BB * NT <= 8) {
#pragma unroll
      for (int j = 0; j < BB; ++j) pair(af, bt, i, j);
    } else if constexpr (BB > 0) {  // beyond, the unrolled pairs' registers spill
#pragma unroll 2
      for (int j = 0; j < BB; ++j) pair(af, bt, i, j);
    } else {
#pragma unroll 1
      for (int j = 0; j < bb; ++j) pair(af, bt, i, j);
    }
  };
  auto mma_step = [&](int slot, int buf) {
    const uint32_t* const at = As + buf * ab * BM * KW;
    const uint32_t* const bt = reinterpret_cast<const uint32_t*>(tail + slot * L.slot + L.a_raw);
    if constexpr (AB > 0 && AB * BB * NT <= 4) {  // beyond, the registers the unrolled pairs hold spill
#pragma unroll
      for (int i = 0; i < AB; ++i) plane(at, bt, i);
    } else {
#pragma unroll 1
      for (int i = 0; i < ab; ++i) plane(at, bt, i);
    }
  };

  // The ring: steps 0 .. STAGES - 2 in flight, step 0 transposed; then per
  // step j: wait for step j + 1, one barrier, issue step j + STAGES - 1
  // into the slot step j - 1 freed, transpose step j + 1, MMAs of step j.
  int issued = 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (issued < nst) issue(issued++ % STAGES);
    cp_commit();
  }
  cp_wait<STAGES - 2>();
  __syncthreads();
  if (nst > 0) transpose(0, 0);
  for (int j = 0; j < nst; ++j) {
    cp_wait<STAGES - 3>();
    __syncthreads();
    if (issued < nst) issue(issued++ % STAGES);
    cp_commit();
    if (j + 1 < nst) transpose((j + 1) % STAGES, (j + 1) & 1);
    mma_step(j % STAGES, j & 1);
  }
  cp_wait<0>();
  __syncthreads();  // the ring is read: its memory takes the epilogue's buffers

  if (S > 1) {
    if (cluster_rank() != (uint32_t)z) __trap();  // the launch's cluster shape
    // ranks z > 0 leave their sums in shared memory; rank 0 adds them
    uint32_t* const red = reinterpret_cast<uint32_t*>(tail);
    constexpr int RLD = BNT + 4;
    if (z != 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = wm + 16 * mt + g + 8 * h, col = wn + 8 * nt + 2 * t4;
            *reinterpret_cast<int2*>(&red[row * RLD + col]) =
                make_int2((int)acc[mt][nt][2 * h], (int)acc[mt][nt][2 * h + 1]);
          }
    }
    cluster_barrier();
    if (z == 0) {
      for (int zz = 1; zz < S; ++zz) {
        const uint32_t base = peer(red, zz);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = wm + 16 * mt + g + 8 * h, col = wn + 8 * nt + 2 * t4;
              const int2 v = ld_peer2(base + 4 * (row * RLD + col));
              acc[mt][nt][2 * h] += (uint32_t)v.x;
              acc[mt][nt][2 * h + 1] += (uint32_t)v.y;
            }
      }
    }
  }

  // The columns past the grid, from the CTAs of the last column tile:
  // rank S - 1 stores them (while rank 0 adds the sums, when S > 1).
  const int c0 = gridDim.x * BNT;  // first column past the grid
  unsigned char* const out = static_cast<unsigned char*>(p.out);
  if (blockIdx.x == gridDim.x - 1 && z == S - 1 && c0 < p.np) {
    if (p.out_bits == 0)
      fill_rows(out + (size_t)m0 * p.np * 4, (size_t)p.np * 4, BM, c0 * 4, (p.np - c0) * 4, 0u);
    for (int b = 0; b < p.out_bits; ++b)
      fill_rows(out + ((size_t)b * mw + m0 / 32) * p.np * 4, (size_t)p.np * 4, WR, c0 * 4,
                (p.np - c0) * 4, 0u);
  }

  if (z == 0) {
    if (p.out_bits == 0) {  // bitMM2Int: the raw sum as float32
      float* const o = static_cast<float*>(p.out);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + wm + 16 * mt + g + 8 * h, col = n0 + wn + 8 * nt + 2 * t4;
            *reinterpret_cast<float2*>(o + (size_t)row * p.np + col) =
                make_float2((float)(int)acc[mt][nt][2 * h], (float)(int)acc[mt][nt][2 * h + 1]);
          }
    } else {
      // bitMM2Bit: requantized levels [column][row] bytes, then each
      // thread builds the out_bits words of one (word row, column)
      uint8_t* const rs = reinterpret_cast<uint8_t*>(tail + L.red);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            rs[(wn + 8 * nt + 2 * t4 + (e & 1)) * RS_LD + wm + 16 * mt + g + 8 * (e >> 1)] =
                (uint8_t)requant((int)acc[mt][nt][e], p.out_bits, 0);
      __syncthreads();
      uint32_t* const o = static_cast<uint32_t*>(p.out);
      for (int t = tid; t < WR * BNT; t += THREADS) {
        const int n = t % BNT, r = t / BNT;
        const uint4* const src = reinterpret_cast<const uint4*>(rs + n * RS_LD + 32 * r);
        const uint4 lo = src[0], hi = src[1];
        const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        for (int b = 0; b < p.out_bits; ++b) {
          // bit b of rows 4q .. 4q + 3 (bytes 0..3 of v[q]) -> bits 4q .. 4q + 3
          uint32_t word = 0;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            word |= ((((v[q] >> b) & 0x01010101u) * 0x01020408u) >> 24) << (4 * q);
          o[((size_t)b * mw + m0 / 32 + r) * p.np + n0 + n] = word;
        }
      }
    }
  }
  if (S > 1) cluster_barrier();  // no peer still reads this CTA's shared memory
}

// One launch of k6_kernel on the (1, 1, S) cluster grid over `col_tiles`
// column tiles. A refused launch (too much shared memory, a cluster the
// card cannot place) is returned, not raised.
template <int AB, int BB, int BNT, bool MAPPED>
int launch_one(const Args& p, int col_tiles, int splits, cudaStream_t stream) {
  auto kern = k6_kernel<AB, BB, BNT, MAPPED>;
  const int smem = layout(AB ? AB : p.a_bits, BB ? BB : p.b_bits, BNT).smem;
  if (smem > 48 * 1024) {  // above the default, on the current device
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(col_tiles, p.mp / BM, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // S = 1: a plain launch
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Every instantiation of one plane pair: column tile 16, 32 or 64, dense
// or mapped.
template <int AB, int BB>
int launch_pair(const Args& p, int bnt, int col_tiles, int splits, cudaStream_t s) {
  const bool mapped = p.map.kcnt != nullptr;
  switch (bnt) {
    case 16:
      return mapped ? launch_one<AB, BB, 16, true>(p, col_tiles, splits, s)
                    : launch_one<AB, BB, 16, false>(p, col_tiles, splits, s);
    case 32:
      return mapped ? launch_one<AB, BB, 32, true>(p, col_tiles, splits, s)
                    : launch_one<AB, BB, 32, false>(p, col_tiles, splits, s);
    case 64:
      return mapped ? launch_one<AB, BB, 64, true>(p, col_tiles, splits, s)
                    : launch_one<AB, BB, 64, false>(p, col_tiles, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Defined in bitmm_a1.cu (a_bits 1 against b_bits 1, 2, 4 or 8: the
// aggregations) and bitmm_bb.cu (2 x 2, 4 x 4, 8 x 8: the updates), one
// translation unit each, built in parallel; they return
// cudaErrorInvalidValue for any other pair.
int launch_a1(const Args& p, int bnt, int col_tiles, int splits, cudaStream_t s);
int launch_bb(const Args& p, int bnt, int col_tiles, int splits, cudaStream_t s);

}  // namespace k6
}  // namespace qgtc
