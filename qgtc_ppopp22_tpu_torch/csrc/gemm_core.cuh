// Integer tile-GEMM core shared by the digitmm kernel, packmm's 8-bit
// signed-plane route and the packmm_signed kernel (packmm's 1/2/4-bit
// route is packmm_k2.cuh, which takes its fragment loads, mma and
// epilogue stores from here).
//
// C = sum_{d<ND_A, e<ND_B} dot(A_d, B_e) << 4*(d+e), exact in int32, plus
// an optional offset correction (CORR), followed by one fused epilogue:
// requantize to base-16 digit planes, to M-packed words or to the
// offset-signed byte plane, or store the raw sum as float32 / int32. The
// kernels differ only in how an A tile reaches shared memory (the ALoader
// template argument) and in the correction.
//
// Shape contract (checked by the C entry points and the Python wrappers):
//   A: rows mp, contraction kp; B: int8[ND_B][kp][np] digit planes;
//   mp % BM == 0, np % BN == 0, kp % BK == 0 (mp % 256 == 0 for packed
//   words out); every padded row and column of A and B holds level 0, so
//   the padded outputs come out as 0.
// Output (the kernel writes every element, padding included):
//   OUT_DIGITS  int8[nd_o][mp][np];
//   OUT_F32 / OUT_I32  [mp][ocp];
//   OUT_PACKED  int8[1][mp][ocp] of level - 128 for 5-8 bit out, else
//               int32 words [1][mp / (32 / f)][ocp] of f-bit fields
//               (f = 1, 2 or 4; layout below).
// ocp (a multiple of 8, at most np) is the stored width of the terminal
// forms; columns >= mask_n are stored as level 0 (sum 0).
//
// Zero-tile jumping (KMap, the TPU kernels' TileMap): with a map, a CTA
// loops over the K tiles that its row tile's map row lists instead of the
// whole contraction; the epilogue runs either way, so every output
// element is written, rows whose kcnt is 0 included.
//
// Design: a CTA owns ROWS x BN outputs, ROWS = 64 (4 warps) or, for packed
// words, one whole 256-row group (16 warps), and loops over the whole
// contraction (or its listed K tiles) itself (nothing carries across
// CTAs). Per BK step it stages
// the A and B tiles in shared memory, B transposed to [n][k] so that both
// mma.sync fragments are plain 32-bit loads, and runs int8
// mma.sync.m16n8k32 with one int32 accumulator set per digit shift
// 4*(d+e); each warp owns a 32 x 32 tile. This is the simple, single-stage
// form; cp.async/TMA rings and wgmma are later work.
//
// Packed words: within each 256-row group, row q*4*gw + 4*i + k of the
// output sits in bits [8k + f*q, 8k + f*(q+1)) of word row i, gw = 8 * f
// word rows per group. One word gathers rows from the whole group, so a
// CTA owns the group: it requantizes its accumulators into a byte tile in
// shared memory and then builds whole words from it.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qgtc {

constexpr int BM = 64;        // output rows per CTA (digits, f32, i32,
                              // signed byte plane)
constexpr int BN = 64;        // output columns per CTA
constexpr int BK = 64;        // contraction depth per shared-memory stage
constexpr int LDS = BK + 16;  // smem row stride in bytes (20 words: the
                              // 8 rows x 4 words of a fragment load fall
                              // in 32 distinct banks)
constexpr int THREADS = 128;  // 4 warps as 2 x 2, each a 32 x 32 tile
constexpr int GROUP = 256;    // rows per packing group (ops/packmm.py)

enum OutKind { OUT_DIGITS = 0, OUT_F32 = 1, OUT_I32 = 2, OUT_PACKED = 3 };

// The offset correction added to every sum.
enum Corr {
  CORR_NONE = 0,
  // A holds offset-signed bytes (level - 128): + 128 * colsum(B levels)
  // over the whole contraction (padded A columns hold level 0 and cancel
  // against it).
  CORR_COLSUM = 1,
  // A and B both offset-signed (a PreparedRHS plane): + 128 * rowsum(A)
  // + corr[n], corr = 128 * colsum(plane) + 128^2 * kp.
  CORR_PREPARED = 2,
};

struct Epilogue {
  void* out;
  int mp, np;
  int kind;         // OutKind
  int out_bits;     // OUT_DIGITS, OUT_PACKED
  int shift;        // OUT_DIGITS, OUT_PACKED: arithmetic >> before the clamp
  int ocp;          // stored columns of OUT_F32 / OUT_I32 / OUT_PACKED
  int mask_n;       // columns >= mask_n are stored as level 0
  const int* corr;  // CORR_PREPARED: int32 [np] (row 0 of corr[8][np])
};

// True when the output is M-packed words (one CTA per 256-row group).
__host__ __device__ inline bool group_out(int kind, int out_bits) {
  return kind == OUT_PACKED && out_bits <= 4;
}

// A zero-tile schedule over A's (tile_m x tile_k) tiles (ops/bitgemm.py
// TileMap): row tile i visits K tiles kidx[i][t] for t < kcnt[i]. Null
// pointers: the whole contraction.
struct KMap {
  const int* kidx;  // int32 [mp / tile_m][kp / tile_k]
  const int* kcnt;  // int32 [mp / tile_m]
  int tile_m, tile_k;
};

// The K ranges one CTA visits: the first min(kcnt[i], nk) entries of its
// row tile i's map row (the TPU kernel's sequential grid axis guarded by
// t < kcnt[i], as a loop), or the whole contraction as one range.
struct KTiles {
  const int* list;
  int n, nk, depth;

  __device__ __forceinline__ KTiles(const KMap& m, int m0, int kp)
      : list(nullptr), n(1), nk(1), depth(kp) {
    if (m.kcnt != nullptr) {
      const int i = m0 / m.tile_m;
      nk = kp / m.tile_k;
      n = min(__ldg(m.kcnt + i), nk);
      list = m.kidx + (size_t)i * nk;
      depth = m.tile_k;
    }
  }
  // The first column of range t, or -1 for an entry outside the grid
  // (nothing to read; the TPU kernel leaves it undefined).
  __device__ __forceinline__ int start(int t) const {
    const int kt = list != nullptr ? __ldg(list + t) : 0;
    return kt < 0 || kt >= nk ? -1 : kt * depth;
  }
};

// A map the kernels can index: both pointers or neither; tiles that
// divide the padded extents, tile_m a multiple of the CTA's rows and
// tile_k of the K step.
inline bool map_ok(const KMap& m, int mp, int kp, int rows, int k_step) {
  if (m.kidx == nullptr && m.kcnt == nullptr) return true;
  return m.kidx != nullptr && m.kcnt != nullptr && m.tile_m > 0 && m.tile_k > 0 &&
         m.tile_m % rows == 0 && m.tile_k % k_step == 0 && mp % m.tile_m == 0 &&
         kp % m.tile_k == 0;
}

// Plain int8 rows, [ND][mp][kp]: digit planes, or the one offset-signed
// byte plane of a 5-8 bit packed A.
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

// M-packed A (ops/packmm.py layout, above): decodes int32 words
// [mp / (32 / F)][kp] of F-bit fields into the int8 A tile, each row's
// word address and shift computed every step (K2's loader before
// packmm_k2.cuh; the kernel-study probe's k2loader row runs it).
template <int F>
struct PackedLoader {
  const int32_t* __restrict__ w;
  int kp;

  template <int ND, int ROWS>
  __device__ __forceinline__ void load(int8_t (*As)[ROWS][LDS], int m0, int k0,
                                       int tid) const {
    static_assert(ND == 1, "packed A holds one digit plane");
    constexpr int GW = 8 * F;  // word rows per 256-row group
    constexpr uint32_t MASK = (1u << F) - 1;
    constexpr int CH = BK / 4;  // chunks of 4 columns (one int4 of words)
    for (int c = tid; c < ROWS * CH; c += 2 * ROWS) {
      const int r = c / CH, kc = (c % CH) * 4;
      const int m = m0 + r;
      const int rr = m & 255;
      const int q = rr / (4 * GW), rem = rr % (4 * GW);
      const int wrow = (m >> 8) * GW + (rem >> 2);
      const int sh = 8 * (rem & 3) + F * q;
      const int4 v =
          __ldg(reinterpret_cast<const int4*>(w + (size_t)wrow * kp + k0 + kc));
      const uint32_t packed = (((uint32_t)v.x >> sh) & MASK) |
                              ((((uint32_t)v.y >> sh) & MASK) << 8) |
                              ((((uint32_t)v.z >> sh) & MASK) << 16) |
                              ((((uint32_t)v.w >> sh) & MASK) << 24);
      *reinterpret_cast<uint32_t*>(&As[0][r][kc]) = packed;
    }
  }
};

// The F-bit fields at bit sh of four consecutive columns' words, as the
// four bytes of one register (column j in byte j): an M-packed A's
// unpack (packmm_k2.cuh, the kernel-study probes).
template <int F>
__device__ __forceinline__ uint32_t fields(const int4& v, int sh) {
  constexpr uint32_t M = (1u << F) - 1;
  return (((uint32_t)v.x >> sh) & M) | ((((uint32_t)v.y >> sh) & M) << 8) |
         ((((uint32_t)v.z >> sh) & M) << 16) | ((((uint32_t)v.w >> sh) & M) << 24);
}

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

// The A and B fragments of one int8 mma.sync.m16n8k32 (PTX ISA, "Matrix
// Fragments for mma.m16n8k32", .s8), as 32-bit shared-memory loads: lane
// (g, t4) = (lane / 4, lane % 4) takes A rows g and g + 8 at k = 4 t4 ..
// 4 t4 + 3 and 16 + 4 t4 .. 16 + 4 t4 + 3, and B column g at the same k.
// p points at the lane's first byte: (row g, k 4 t4) of the 16-row m-tile
// of an A tile with rows LDS bytes apart, or (column g, k 4 t4) of the
// 8-column n-tile of B transposed to [n][k] (any column stride).
// gemm_kernel's K loop and the kernel-study probes load their fragments
// here; exp_bitcast_probe.cu's fragment_probe pins on the card what these
// loads put in each register.
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], const int8_t* p) {
  f[0] = *reinterpret_cast<const uint32_t*>(p);
  f[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
  f[2] = *reinterpret_cast<const uint32_t*>(p + 16);
  f[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
}

__device__ __forceinline__ void frag_b(uint32_t (&f)[2], const int8_t* p) {
  f[0] = *reinterpret_cast<const uint32_t*>(p);
  f[1] = *reinterpret_cast<const uint32_t*>(p + 16);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Reference requantizer (qgtc_ppopp22_tpu/ops/quantize.py): after >>shift,
// acc > 2^b -> 2^b - 1, acc < 0 -> 1, else unchanged; then keep the low b
// bits, so acc == 2^b wraps to 0.
__device__ __forceinline__ int requant(int acc, int out_bits, int shift) {
  const int ub = 1 << out_bits;
  const int v = acc >> shift;  // arithmetic, like int32 >> in JAX
  const int r = v > ub ? ub - 1 : (v < 0 ? 1 : v);
  return r & (ub - 1);
}

// `rows` rows of a row-major buffer from base, bytes [byte0, byte0 +
// nbytes) of each, set to a 4-byte pattern; every extent a multiple of 8
// (the columns past the grid of K2's and K6's epilogues).
__device__ __forceinline__ void fill_rows(unsigned char* base, size_t stride, int rows,
                                          int byte0, int nbytes, uint32_t pattern) {
  const int per = nbytes / 8;
  for (int i = threadIdx.x; i < rows * per; i += THREADS) {
    const int r = i / per, c = i - r * per;
    *reinterpret_cast<uint2*>(base + r * stride + byte0 + 8 * c) = make_uint2(pattern, pattern);
  }
}

// Requantize two adjacent sums and store them at element idx of each of
// the nd_o = ceil(out_bits / 4) base-16 digit planes o[d * plane]. A
// caller that knows nd_o at compile time passes it as a constant, so the
// loop unrolls (a runtime count cost the fused kernel 40 registers).
__device__ __forceinline__ void store_digits(int8_t* o, size_t plane,
                                             size_t idx, int nd_o,
                                             int out_bits, int shift, int v0,
                                             int v1) {
  const int r0 = requant(v0, out_bits, shift);
  const int r1 = requant(v1, out_bits, shift);
  for (int d = 0; d < nd_o; ++d) {
    const int width = min(4, out_bits - 4 * d);
    const int mask = (1 << width) - 1;
    char2 c;
    c.x = (char)((r0 >> (4 * d)) & mask);
    c.y = (char)((r1 >> (4 * d)) & mask);
    *reinterpret_cast<char2*>(o + d * plane + idx) = c;
  }
}

// Store two adjacent (masked) sums at (row, col): every kind but packed
// words. col is even and ocp a multiple of 8, so a pair is stored whole or
// not at all.
__device__ __forceinline__ void store_pair(const Epilogue& ep, int row,
                                           int col, int v0, int v1) {
  if (ep.kind == OUT_DIGITS) {
    store_digits(static_cast<int8_t*>(ep.out), (size_t)ep.mp * ep.np,
                 (size_t)row * ep.np + col, (ep.out_bits + 3) / 4,
                 ep.out_bits, ep.shift, v0, v1);
    return;
  }
  if (col >= ep.ocp) return;
  const size_t idx = (size_t)row * ep.ocp + col;
  if (ep.kind == OUT_F32) {
    *reinterpret_cast<float2*>(static_cast<float*>(ep.out) + idx) =
        make_float2((float)v0, (float)v1);
  } else if (ep.kind == OUT_I32) {
    *reinterpret_cast<int2*>(static_cast<int*>(ep.out) + idx) =
        make_int2(v0, v1);
  } else {  // OUT_PACKED, 5-8 bits: the offset-signed byte plane
    char2 c;
    c.x = (char)(requant(v0, ep.out_bits, ep.shift) - 128);
    c.y = (char)(requant(v1, ep.out_bits, ep.shift) - 128);
    *reinterpret_cast<char2*>(static_cast<int8_t*>(ep.out) + idx) = c;
  }
}

// PACK: the CTA owns one 256-row group and writes packed words; otherwise
// a 64-row tile stored pair by pair.
template <int ND_A, int ND_B, int CORR, bool PACK, bool MAPPED, class ALoader>
__global__ void __launch_bounds__(PACK ? 2 * GROUP : THREADS)
    gemm_kernel(ALoader la, const int8_t* __restrict__ b, int kp,
                Epilogue ep, KMap km) {
  constexpr int ROWS = PACK ? GROUP : BM;
  constexpr int NT = 2 * ROWS;  // 4 warps per 64 rows
  __shared__ __align__(16) int8_t As[ND_A][ROWS][LDS];
  __shared__ __align__(16) int8_t Bs[ND_B][BN][LDS];  // [n][k]
  __shared__ int colsum[CORR == CORR_COLSUM ? BN : 1];
  __shared__ int rowsum[CORR == CORR_PREPARED ? ROWS : 1];

  constexpr int NS = ND_A + ND_B - 1;  // distinct digit shifts
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // mma groupID / thread-in-group
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * ROWS, n0 = blockIdx.x * BN;

  int acc[NS][2][4][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[s][mt][nt][i] = 0;
  // CORR_COLSUM: column tid's B sum over the visited K tiles only (a
  // skipped tile drops its dot and its correction together, as on the
  // TPU); CORR_PREPARED: row tid's A sum
  int cs = 0;

  // The K ranges this CTA visits. Dense (MAPPED false): the whole
  // contraction as one range, so the loop is the plain k0 loop. MAPPED:
  // the K tiles its row tile's map row lists (KTiles), BK steps each.
  const KTiles kt(km, m0, kp);
  const int nr = MAPPED ? kt.n : 1;
  for (int t = 0; t < nr; ++t) {
    const int kb = MAPPED ? kt.start(t) : 0;
    if (kb < 0) continue;  // outside the grid: nothing to read
    const int ke = MAPPED ? kb + kt.depth : kp;
    for (int k0 = kb; k0 < ke; k0 += BK) {
      la.template load<ND_A, ROWS>(As, m0, k0, tid);
      load_b<ND_B, NT>(Bs, b, kp, ep.np, k0, n0, tid);
      __syncthreads();
      if (CORR == CORR_COLSUM && tid < BN) {
#pragma unroll
        for (int e = 0; e < ND_B; ++e)
          for (int k = 0; k < BK; ++k) cs += (int)Bs[e][tid][k] << (4 * e);
      }
      if (CORR == CORR_PREPARED && tid < ROWS) {
        const int* row = reinterpret_cast<const int*>(&As[0][tid][0]);
#pragma unroll
        for (int w = 0; w < BK / 4; ++w) cs = __dp4a(row[w], 0x01010101, cs);
      }
#pragma unroll
      for (int ks = 0; ks < BK; ks += 32) {
        uint32_t af[ND_A][2][4];
        uint32_t bf[ND_B][4][2];
#pragma unroll
        for (int d = 0; d < ND_A; ++d)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            frag_a(af[d][mt], &As[d][wm + mt * 16 + g][ks + t4 * 4]);
#pragma unroll
        for (int e = 0; e < ND_B; ++e)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            frag_b(bf[e][nt], &Bs[e][wn + nt * 8 + g][ks + t4 * 4]);
#pragma unroll
        for (int d = 0; d < ND_A; ++d)
#pragma unroll
          for (int e = 0; e < ND_B; ++e)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_s8(acc[d + e][mt][nt], af[d][mt], bf[e][nt]);
      }
      __syncthreads();
    }
  }
  if (CORR == CORR_COLSUM) {
    if (tid < BN) colsum[tid] = cs;
    __syncthreads();
  }
  if (CORR == CORR_PREPARED) {
    if (tid < ROWS) rowsum[tid] = cs;
    __syncthreads();
  }

  // PACK: requantized levels [ROWS][BN], in the A tile's shared memory
  // (free after the last __syncthreads of the K loop)
  uint8_t* stage = reinterpret_cast<uint8_t*>(&As[0][0][0]);
  static_assert(!PACK || sizeof(As) >= GROUP * BN, "stage fits in As");
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8
        const int row = wm + mt * 16 + g + 8 * h;
        const int col = wn + nt * 8 + t4 * 2;
        int v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t s = 0;  // unsigned: the shifted sum wraps like int32
#pragma unroll
          for (int si = 0; si < NS; ++si)
            s += (uint32_t)acc[si][mt][nt][2 * h + j] << (4 * si);
          if (CORR == CORR_COLSUM) s += (uint32_t)colsum[col + j] << 7;
          if (CORR == CORR_PREPARED)
            s += ((uint32_t)rowsum[row] << 7) + (uint32_t)ep.corr[n0 + col + j];
          v[j] = n0 + col + j < ep.mask_n ? (int)s : 0;
        }
        if (PACK) {
          stage[row * BN + col] = (uint8_t)requant(v[0], ep.out_bits, ep.shift);
          stage[row * BN + col + 1] =
              (uint8_t)requant(v[1], ep.out_bits, ep.shift);
        } else {
          store_pair(ep, m0 + row, n0 + col, v[0], v[1]);
        }
      }
  if (PACK) {
    __syncthreads();
    // f-bit fields: whole words of the group, padding rows included
    const int f = ep.out_bits <= 2 ? ep.out_bits : 4;
    const int gw = 8 * f, P = 8 / f;
    int32_t* out = static_cast<int32_t*>(ep.out);
    for (int w = tid; w < gw * BN; w += NT) {
      const int i = w / BN, n = w % BN;
      if (n0 + n >= ep.ocp) continue;
      uint32_t word = 0;
      for (int q = 0; q < P; ++q)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          word |= (uint32_t)stage[(q * 4 * gw + 4 * i + k) * BN + n]
                  << (8 * k + f * q);
      out[(size_t)(blockIdx.y * gw + i) * ep.ocp + n0 + n] = (int32_t)word;
    }
  }
}

// One kernel instantiation: PACK chooses the 256-row CTA. Digit planes
// keep their padding, so they take every column tile; the terminal kinds
// take only the tiles that hold stored columns (< ocp): a tile past them
// would stream all of A through the K loop for sums nobody stores. A map
// (km) whose row tiles split a CTA's rows is refused; null pointers launch
// the dense instantiation (MAPPED false), whose K loop carries no map.
template <int ND_A, int ND_B, int CORR, bool PACK, class ALoader>
int launch_tiles(const ALoader& la, const void* b, int mp, int kp, int np,
                 const Epilogue& ep, const KMap& km, cudaStream_t stream) {
  constexpr int ROWS = PACK ? GROUP : BM;
  if (!map_ok(km, mp, kp, ROWS, BK)) return (int)cudaErrorInvalidValue;
  const int col_tiles = ep.kind == OUT_DIGITS ? np / BN : (ep.ocp + BN - 1) / BN;
  const dim3 grid(col_tiles, mp / ROWS);
  const int8_t* bp = static_cast<const int8_t*>(b);
  if constexpr (CORR == CORR_PREPARED) {
    // a PreparedRHS takes no map (the TPU kernel refuses one)
    if (km.kcnt != nullptr) return (int)cudaErrorInvalidValue;
  } else if (km.kcnt != nullptr) {
    gemm_kernel<ND_A, ND_B, CORR, PACK, true, ALoader>
        <<<grid, 2 * ROWS, 0, stream>>>(la, bp, kp, ep, km);
    return (int)cudaGetLastError();
  }
  gemm_kernel<ND_A, ND_B, CORR, PACK, false, ALoader>
      <<<grid, 2 * ROWS, 0, stream>>>(la, bp, kp, ep, km);
  return (int)cudaGetLastError();
}

// Every output kind, packed words included.
template <int ND_A, int ND_B, int CORR, class ALoader>
int launch(const ALoader& la, const void* b, int mp, int kp, int np,
           const Epilogue& ep, const KMap& km, cudaStream_t stream) {
  if (group_out(ep.kind, ep.out_bits))
    return launch_tiles<ND_A, ND_B, CORR, true>(la, b, mp, kp, np, ep, km, stream);
  return launch_tiles<ND_A, ND_B, CORR, false>(la, b, mp, kp, np, ep, km, stream);
}

inline bool shapes_ok(int mp, int kp, int np, int kind, int out_bits,
                      int shift, int ocp) {
  if (mp <= 0 || kp <= 0 || np <= 0) return false;
  if (mp % BM || kp % BK || np % BN) return false;
  if (kind < OUT_DIGITS || kind > OUT_PACKED) return false;
  if ((kind == OUT_DIGITS || kind == OUT_PACKED) &&
      (out_bits < 1 || out_bits > 8 || shift < 0 || shift > 31))
    return false;
  if (ocp <= 0 || ocp > np || ocp % 8) return false;
  if (kind == OUT_DIGITS && ocp != np) return false;
  if (group_out(kind, out_bits) && mp % GROUP) return false;
  return true;
}

}  // namespace qgtc
