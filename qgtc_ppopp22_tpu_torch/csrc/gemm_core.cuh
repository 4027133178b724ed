// Integer tile-GEMM pieces shared by the kernels that run int8
// mma.sync.m16n8k32: K2 (packmm_k2.cuh, an M-packed 1/2/4-bit A), K3
// (digitmm_k3.cuh), K4 (packmm_k4.cuh, the offset-signed 8-bit A plane:
// packmm_signed and packmm's 8-bit route) and the kernel-study probes:
// the tile constants, the output kinds and their epilogue stores, the
// offset corrections, the TileMap K skip, the fragment loads and the mma.
//
// C = sum_{d<ND_A, e<ND_B} dot(A_d, B_e) << 4*(d+e), exact in int32, plus
// an optional offset correction (CORR), followed by one fused epilogue:
// requantize to base-16 digit planes, to M-packed words or to the
// offset-signed byte plane, or store the raw sum as float32 / int32.
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
// Packed words: within each 256-row group, row q*4*gw + 4*i + k of the
// output sits in bits [8k + f*q, 8k + f*(q+1)) of word row i, gw = 8 * f
// word rows per group. One word gathers rows from the whole group, so the
// four 64-row CTAs of a group form a thread-block cluster and build its
// words from each other's requantized levels (K2, K4).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qgtc {

constexpr int BM = 64;        // output rows per CTA
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

// The F-bit fields at bit sh of four consecutive columns' words, as the
// four bytes of one register (column j in byte j): an M-packed A's
// unpack (packmm_k2.cuh, the kernel-study probes).
template <int F>
__device__ __forceinline__ uint32_t fields(const int4& v, int sh) {
  constexpr uint32_t M = (1u << F) - 1;
  return (((uint32_t)v.x >> sh) & M) | ((((uint32_t)v.y >> sh) & M) << 8) |
         ((((uint32_t)v.z >> sh) & M) << 16) | ((((uint32_t)v.w >> sh) & M) << 24);
}

// Byte k of four consecutive columns' words, by byte permutes only: the
// bytes of one register (column j in byte j). The kernel-study probes'
// byte gathers (exp_packmm.cuh's noextract, exp_bitcast_probe.cu).
__device__ __forceinline__ uint32_t bytes_at(const int4& v, int k) {
  const uint32_t sel = (uint32_t)k | ((uint32_t)(k + 4) << 4);
  const uint32_t lo = __byte_perm((uint32_t)v.x, (uint32_t)v.y, sel);
  const uint32_t hi = __byte_perm((uint32_t)v.z, (uint32_t)v.w, sel);
  return __byte_perm(lo, hi, 0x5410);
}

// The A and B fragments of one int8 mma.sync.m16n8k32 (PTX ISA, "Matrix
// Fragments for mma.m16n8k32", .s8), as 32-bit shared-memory loads: lane
// (g, t4) = (lane / 4, lane % 4) takes A rows g and g + 8 at k = 4 t4 ..
// 4 t4 + 3 and 16 + 4 t4 .. 16 + 4 t4 + 3, and B column g at the same k.
// p points at the lane's first byte: (row g, k 4 t4) of the 16-row m-tile
// of an A tile with rows LDS bytes apart, or (column g, k 4 t4) of the
// 8-column n-tile of B transposed to [n][k] (any column stride).
// K2 loads its fragments here (K3 its B fragments);
// exp_bitcast_probe.cu's fragment_probe pins on the card what these loads
// put in each register.
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
