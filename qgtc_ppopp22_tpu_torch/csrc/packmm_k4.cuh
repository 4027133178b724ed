// K4's kernel: an offset-signed 8-bit A plane (the PackedTensor of 5-8-bit
// levels) times int8 B rows, with the offset correction folded into the
// sums. It runs two products (packmm_signed.cu and packmm.cu are the C
// entries; their source notes say what bounds each and what the design
// does about it):
//   * CORR_PREPARED, K4 itself: B is a PreparedRHS plane (one plane,
//     level - 128, ones lane np - 1), given transposed ([n][k], made once
//     by prepare_rhs), and every sum gains 128 * rowsum(A_s) + corr[n];
//   * CORR_COLSUM, K2's 8-bit plane: B is 1 or 2 base-16 digit planes,
//     and every sum gains 128 * colsum(B levels) over the K tiles visited
//     (a TileMap's listed tiles, MAPPED, or the whole contraction).
//
// A CTA (two warpgroups) owns 128 rows x BNT columns (BNT = 16, 32 or 64,
// the wrapper's choice from the columns it computes) and 1/S of the
// contraction, in steps of KS = 128. Its K loop:
//   * a ring of STAGES slots: cp.async.cg brings each step's A rows (128
//     x 128 bytes, each row one line, in the 128-byte swizzle wgmma reads)
//     and B's into shared memory: a transposed B's rows [n][k] as A's, B
//     as it lies ([k][n]) with its rows padded so that the transpose's
//     loads spread over the banks; copies past the end of a range (a
//     contraction that is not a multiple of KS, a map's 64-deep tiles) are
//     zero-filled, A and B alike, so they add nothing;
//   * B as it lies is transposed by 4 x 4 byte blocks into a
//     double-buffered K-major [n][k] tile in the same swizzle (a lane's
//     stores start at a row that turns with its column group, so that they
//     spread over the banks), one step ahead of its wgmmas;
//   * wgmma.mma_async m64nNk32 s8 reads both operands from shared memory:
//     each warpgroup 4 instructions a step and B plane on its 64 rows,
//     against the one transposed B, issued after the step's one barrier;
//     the next step's copies and B's transpose run while they do.
// The correction costs no pass of its own. CORR_PREPARED: B's tile has 8
// or 16 more rows of ones (N = BNT + 8 or + 16), so the wgmmas also sum
// each A row (every column of that tile holds rowsum(A_s) over the CTA's
// steps).
// CORR_COLSUM: the transposing threads sum each B column they move
// (dp4a; a thread's column group is the same every step), and add their
// sums into shared memory once at the end.
// Each CTA adds its partial correction (128 * its rows' or columns' sums)
// to its partial sums, so the split-K reduction carries it; corr[n] is
// added once, by the CTA that stores the element.
// Split-K: the S CTAs of a (1, R, S) cluster share an output tile, each
// with a contiguous share of the K steps (with a TileMap every S-th listed
// K tile), and stage their int32 sums in shared memory. For a per-tile
// output they then share the epilogue: CTA z adds every split's sums of
// its 128 / S rows through distributed shared memory and stores them row
// by row, 4 columns a thread (the stores of a warp are contiguous). For
// packed words, as K2 (packmm_k2.cuh): rank z = 0 adds the other split's
// sums and requantizes, and the two 128-row CTAs of a 256-row group (R =
// 2) build the group's words from both's levels.
//
// Output: every element, padding included (gemm_core.cuh's contract).
// The grid covers the column tiles below round_up(n, 8) (n: the columns
// not stored as level 0, mask_n for K4 and B's real columns for K2) and
// the stored width; the last tile's CTAs store the columns past the grid
// as level 0 (their sums are 0, or masked to 0).
#pragma once

#include "async_cluster.cuh"
#include "gemm_core.cuh"
#include "wgmma.cuh"

namespace qgtc {
namespace k4 {

constexpr int KS = 128;       // contraction depth of a ring step: one swizzled 128-byte row
constexpr int ROWS = 128;     // output rows of a CTA: two warpgroups of 64
constexpr int NTH = 2 * ROWS;  // its threads
constexpr int MAX_SPLIT = 4;  // CTAs that share one output tile
constexpr int PACK_ROWS = GROUP / ROWS;  // CTAs of a 256-row group

// Shared-memory layout of one instantiation (bytes, from a 1024-byte
// aligned base): for B as it lies ([k][n], CORR_COLSUM) B transposed (two
// buffers of ND_B planes of NW rows); then the ring, whose bytes the
// epilogue reuses for the staged sums and the packed-out levels; then the
// colsum correction's column sums. A ring slot holds A's rows and B's,
// transposed already (CORR_PREPARED: NW rows, the last ones) or as they
// lie.
template <int ND_B, int BNT, int CORR>
struct Layout {
  static constexpr bool BT_IN = CORR == CORR_PREPARED;  // B arrives K-major ([n][k])
  // ring slots: step j's A and B; B as it lies also holds step j + 1's for
  // its transpose; the rest in flight
  static constexpr int STAGES = BT_IN ? 4 : 3;
  // wgmma N: B's columns and, for the rowsum, rows of ones (an integer
  // wgmma takes N = 8, 16, 24 or a multiple of 16)
  static constexpr int NW = BNT + (CORR == CORR_PREPARED ? (BNT == 16 ? 8 : 16) : 0);
  static constexpr int BLD = BNT == 16 ? 16 : BNT + 16;  // a staged B row as it lies
  static constexpr int A_ST = ROWS * KS;
  static constexpr int BT_PLANE = NW * KS;
  static constexpr int B_RAW = BT_IN ? BT_PLANE : ND_B * KS * BLD;
  static constexpr int SLOT = (A_ST + B_RAW + 1023) / 1024 * 1024;
  static constexpr int BT = BT_IN ? 0 : 2 * ND_B * BT_PLANE;
  static constexpr int RING = STAGES * SLOT;
  static constexpr int RLD = BNT + 4;  // the staged sums [ROWS][RLD] int32
  static constexpr int RED = ROWS * RLD * 4;
  static constexpr int SLD = ROWS + 4;  // packed out: levels [BNT][SLD] bytes
  static constexpr int STG = BNT * SLD;
  static constexpr int TAIL = RING > RED + STG ? RING : RED + STG;
  static constexpr int SUMS = BNT * 4;
  static constexpr int SMEM = 1024 + BT + TAIL + SUMS;  // 1024: the base's alignment
  static_assert(BT_PLANE % 1024 == 0 && RED % 16 == 0, "swizzle atoms, 16-byte rows");
};

// A plan the C entries take for CTAs of `rows` rows (K2: 64, K4: ROWS):
// the column tile, gx = ceil(ncomp / bnt) column tiles with ncomp =
// min(round_up(n, 8), the stored width), gy = mp / rows row tiles, gz = cz
// = the split (1-4; 1-2 for packed words), cx = 1 and cy = 256 / rows for
// packed words (a 256-row group), else 1 (ops/packmm.py packmm_plan and
// packmm_signed_plan choose it).
inline bool plan_ok(int rows, int n, int bnt, int gx, int gy, int gz, int cx, int cy, int cz,
                    int mp, int np, int kind, int out_bits, int ocp) {
  const bool pack = group_out(kind, out_bits);
  if (n <= 0 || (bnt != 16 && bnt != 32 && bnt != 64)) return false;
  const int width = kind == OUT_DIGITS ? np : ocp;
  const int ncomp = (n + 7) / 8 * 8 < width ? (n + 7) / 8 * 8 : width;
  return gx == (ncomp + bnt - 1) / bnt && gy == mp / rows && gz >= 1 &&
         gz <= (pack ? 2 : MAX_SPLIT) && cx == 1 && cy == (pack ? GROUP / rows : 1) && cz == gz;
}

// The byte of (row, k) in a K-major tile of 128-byte rows with the
// 128-byte swizzle: the 16-byte chunk k / 16 of row r sits at chunk
// (k / 16) ^ (r % 8) (what TMA's SWIZZLE_128B writes and wgmma reads).
__device__ __forceinline__ int swz(int row, int k) {
  return row * KS + ((((k >> 4) ^ row) & 7) << 4) + (k & 15);
}

// Shared-memory writes of the generic proxy (stores, cp.async), made
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma.mma_async m64nNk32 s32 += s8 x s8, both operands K-major from
// shared memory; d holds, per 8-column chunk c, mma.m16n8's C fragment of
// the warp's 16 rows: d[4c + i] at row 16 (warp % 4) + g + 8 (i / 2) of
// the warpgroup's 64, column 8c + 2 t4 + i % 2.
template <int N>
__device__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<24>(int (&d)[12], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<48>(int (&d)[24], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<80>(int (&d)[40], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39"
      "}, %40, %41, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(da), "l"(db), "r"(1));
}

// gridDim = (column tiles, mp / ROWS, S); cluster (1, PACK ? 2 : 1, S).
// a: int8[mp][kp]; b: int8[ND_B][kp][np], or (CORR_PREPARED) the plane
// transposed, int8[np][kp].
template <int ND_B, int CORR, int BNT, bool MAPPED, bool PACK>
__global__ void __launch_bounds__(NTH)
    k4_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, int kp, Epilogue ep,
              KMap km) {
  static_assert(CORR == CORR_COLSUM || (CORR == CORR_PREPARED && ND_B == 1 && !MAPPED),
                "a PreparedRHS is one plane and takes no map");
  using L = Layout<ND_B, BNT, CORR>;
  constexpr int STAGES = L::STAGES, NW = L::NW;
  constexpr int A_PER = ROWS * (KS / 16) / NTH;  // 16-byte A copies a thread
  constexpr int B_CH = ND_B * KS * BNT / 16;       // 16-byte B copies a step
  constexpr int NQB = BNT / 4, NQW = NQB < 8 ? NQB : 8;  // 4-column groups: a tile's, a warp's
  constexpr int B_BLK = ND_B * (KS / 4) * NQB;     // 4 x 4 transpose blocks a step
  constexpr int TU = (B_BLK + NTH - 1) / NTH;      // ... a thread (whole warps idle past B_BLK)
  static_assert(ROWS * (KS / 16) % NTH == 0 && B_BLK % 32 == 0, "whole shares per thread and warp");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw + (-(int)smem_u32(smem_raw) & 1023);
  unsigned char* const bt = smem;  // [2][ND_B][NW][KS], swizzled (B as it lies)
  unsigned char* const tail = smem + L::BT;
  int* const sums = reinterpret_cast<int*>(tail + L::TAIL);  // [BNT] column sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * ROWS, n0 = blockIdx.x * BNT;
  const int S = gridDim.z, z = blockIdx.z;
  const int h = blockIdx.y & (PACK_ROWS - 1);  // row tile within its 256-row group
  const int wg = warp >> 2;                    // warpgroup: rows 64 wg .. 64 wg + 63
  const int np = ep.np;
  const int8_t* const abase = a + (size_t)m0 * kp;
  const size_t bplane = (size_t)kp * np;

  if constexpr (CORR == CORR_PREPARED) {  // the rows of ones past B's columns, every slot
    constexpr int ONES = (NW - BNT) * KS / 16;
    for (int i = tid; i < STAGES * ONES; i += NTH) {
      const int slot = i / ONES, c = i - slot * ONES;
      *reinterpret_cast<int4*>(tail + slot * L::SLOT + L::A_ST + BNT * KS + 16 * c) =
          make_int4(0x01010101, 0x01010101, 0x01010101, 0x01010101);
    }
  }
  if (CORR == CORR_COLSUM) {
    for (int i = tid; i < BNT; i += NTH) sums[i] = 0;
  }

  // This CTA's K steps: a contiguous share of the contraction, or every
  // S-th K tile its row tile's map row lists, each cut into steps of KS
  // (an entry outside the grid is read as zeros).
  int nst, kb_next, spt = 1, t_next = 0, s_next = 0;
  const KTiles kt(km, m0, kp);
  if (MAPPED) {
    spt = (kt.depth + KS - 1) / KS;
    const int cnt = kt.n > z ? (kt.n - z + S - 1) / S : 0;
    nst = cnt * spt;
    t_next = z;
    kb_next = cnt ? kt.start(z) : 0;
  } else {
    const int all = (kp + KS - 1) / KS, share = (all + S - 1) / S;
    const int first = min(z * share, all);
    nst = min(all - first, share);
    kb_next = first * KS;
  }

  // Issue the next step's copies into ring slot `slot`, then advance.
  auto issue = [&](int slot) {
    unsigned char* const st = tail + slot * L::SLOT;
    const bool in_grid = kb_next >= 0;
    const int k0 = in_grid ? kb_next + s_next * KS : 0;
    const int ke = !in_grid ? 0 : MAPPED ? min(kb_next + kt.depth, k0 + KS) : min(kp, k0 + KS);
#pragma unroll
    for (int u = 0; u < A_PER; ++u) {
      const int c = tid + u * NTH, r = c >> 3, kc = (c & 7) * 16;
      const bool valid = k0 + kc < ke;
      cp_async16(st + swz(r, kc), abase + (valid ? (size_t)r * kp + k0 + kc : 0), valid);
    }
    if constexpr (L::BT_IN) {  // B's rows [n][k] of the tile's columns, as A's
      for (int c = tid; c < BNT * (KS / 16); c += NTH) {
        const int r = c >> 3, kc = (c & 7) * 16;
        const bool valid = k0 + kc < ke;
        cp_async16(st + L::A_ST + swz(r, kc), b + (valid ? (size_t)(n0 + r) * kp + k0 + kc : 0), valid);
      }
    } else {
      for (int c = tid; c < B_CH; c += NTH) {
        constexpr int PER_K = BNT / 16, PER_E = KS * PER_K;
        const int e = c / PER_E, r = c - e * PER_E;
        const int k = r / PER_K, nc = (r - k * PER_K) * 16;
        const bool valid = k0 + k < ke;
        cp_async16(st + L::A_ST + (e * KS + k) * L::BLD + nc,
                   b + (valid ? e * bplane + (size_t)(k0 + k) * np + n0 + nc : 0), valid);
      }
    }
    if (MAPPED) {
      if (++s_next == spt) {
        s_next = 0;
        t_next += S;
        if (t_next < kt.n) kb_next = kt.start(t_next);
      }
    } else {
      kb_next += KS;
    }
  };

  // B of ring slot `slot` -> the transposed tile `buf`, by 4 x 4 byte
  // blocks: a warp takes NQW column groups x 32 / NQW row groups; a
  // thread's column group nq is the same every step and block (NTH and
  // the blocks of a plane are multiples of 2 x 32 x NQW / NQB), and
  // CORR_COLSUM sums its four columns.
  int cs[4] = {0, 0, 0, 0};
  auto transpose = [&](int slot, int buf) {
    const unsigned char* const rb = tail + slot * L::SLOT + L::A_ST;
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      constexpr int PER_E = (KS / 4) * NQB, HI_N = NQB / NQW;
      const int blk = tid + u * NTH, e = blk / PER_E, r = blk - e * PER_E, lo = r & 31, hi = r >> 5;
      if (B_BLK % NTH != 0 && blk >= B_BLK) break;
      const int nq = lo % NQW + NQW * (hi % HI_N), kq = lo / NQW + (32 / NQW) * (hi / HI_N);
      const unsigned char* p = rb + (e * KS + 4 * kq) * L::BLD + 4 * nq;
      const uint32_t x0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t x1 = *reinterpret_cast<const uint32_t*>(p + L::BLD);
      const uint32_t x2 = *reinterpret_cast<const uint32_t*>(p + 2 * L::BLD);
      const uint32_t x3 = *reinterpret_cast<const uint32_t*>(p + 3 * L::BLD);
      const uint32_t lo01 = __byte_perm(x0, x1, 0x5140), hi01 = __byte_perm(x0, x1, 0x7362);
      const uint32_t lo23 = __byte_perm(x2, x3, 0x5140), hi23 = __byte_perm(x2, x3, 0x7362);
      const uint32_t o[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                             __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
      unsigned char* const plane = bt + (buf * ND_B + e) * L::BT_PLANE;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = (i + nq) & 3, n = 4 * nq + j;
        const uint32_t v = j == 0 ? o[0] : j == 1 ? o[1] : j == 2 ? o[2] : o[3];
        *reinterpret_cast<uint32_t*>(plane + swz(n, 4 * kq)) = v;
      }
      if (CORR == CORR_COLSUM) {
#pragma unroll
        for (int j = 0; j < 4; ++j) cs[j] += __dp4a((int)o[j], 0x01010101, 0) << (4 * e);
      }
    }
  };

  int acc[ND_B][NW / 2];
#pragma unroll
  for (int e = 0; e < ND_B; ++e)
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[e][i] = 0;

  // The step's wgmmas (asynchronous): A from ring slot `slot`, B from
  // that slot (B_IN) or the transposed tile `buf`, 32 columns of K each.
  auto mma_step = [&](int slot, int buf) {
    const uint32_t sa = smem_u32(tail + slot * L::SLOT) + wg * 64 * KS;  // this warpgroup's rows
    const uint32_t sb = L::BT_IN ? smem_u32(tail + slot * L::SLOT + L::A_ST)
                                 : smem_u32(bt + buf * ND_B * L::BT_PLANE);
    wgmma_fence();
#pragma unroll
    for (int e = 0; e < ND_B; ++e)
#pragma unroll
      for (int kk = 0; kk < KS; kk += 32)
        wgmma_s8<NW>(acc[e], desc_sw128(sa + kk), desc_sw128(sb + e * L::BT_PLANE + kk));
    wgmma_commit();
  };

  // The ring: steps 0 .. STAGES - 2 in flight. B transposed already: per
  // step j, wait for step j, one barrier, step j's wgmmas, issue step j +
  // STAGES - 1 into the slot step j - 1 used, wait for the wgmmas. B as it
  // lies: step 0's B transposed first; per step j, wait for step j + 1, one
  // barrier, step j's wgmmas, issue step j + STAGES - 1, transpose step j
  // + 1's B, wait for the wgmmas.
  int issued = 0;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (issued < nst) issue(issued++ % STAGES);
    cp_commit();
  }
  if constexpr (L::BT_IN) {
#pragma unroll 1
    for (int j = 0; j < nst; ++j) {
      cp_wait<STAGES - 2>();
      fence_async_smem();
      __syncthreads();
      mma_step(j % STAGES, 0);
      if (issued < nst) issue(issued++ % STAGES);
      cp_commit();
      wgmma_wait0();
    }
  } else {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (nst > 0) transpose(0, 0);
#pragma unroll 1
    for (int j = 0; j < nst; ++j) {
      cp_wait<STAGES - 3>();
      fence_async_smem();
      __syncthreads();
      mma_step(j % STAGES, j & 1);
      if (issued < nst) issue(issued++ % STAGES);
      cp_commit();
      if (j + 1 < nst) transpose((j + 1) % STAGES, (j + 1) & 1);
      wgmma_wait0();
    }
  }
  cp_wait<0>();
  // the sums are read only after the last wait
#pragma unroll
  for (int e = 0; e < ND_B; ++e)
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) asm volatile("" : "+r"(acc[e][i])::"memory");
  if (CORR == CORR_COLSUM) {
    constexpr int HI_N = NQB / NQW;
    const int nq = (tid & 31) % NQW + NQW * ((tid >> 5) % HI_N);
#pragma unroll
    for (int j = 0; j < 4; ++j) atomicAdd(&sums[4 * nq + j], cs[j]);
  }
  __syncthreads();  // the column sums are whole; every wgmma is done with the ring

  // The sum over digit shifts and this CTA's share of the correction,
  // wrapping like int32, staged in shared memory for the epilogue.
  int* const red = reinterpret_cast<int*>(tail);
#pragma unroll
  for (int c = 0; c < BNT / 8; ++c)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * warp + g + 8 * hh, col = 8 * c + 2 * t4;
      uint32_t v[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t s = 0;
#pragma unroll
        for (int e = 0; e < ND_B; ++e) s += (uint32_t)acc[e][4 * c + 2 * hh + i] << (4 * e);
        // CORR_PREPARED: the ones rows' sums, rowsum(A_s) of this row
        if (CORR == CORR_PREPARED) s += (uint32_t)acc[0][4 * (BNT / 8) + 2 * hh] << 7;
        if (CORR == CORR_COLSUM) s += (uint32_t)sums[col + i] << 7;
        v[i] = s;
      }
      *reinterpret_cast<int2*>(&red[row * L::RLD + col]) = make_int2((int)v[0], (int)v[1]);
    }

  // Cluster rank of the CTA at (row tile y, split z) of this cluster.
  auto rank_of = [&](int y, int zz) { return (uint32_t)(PACK ? y + PACK_ROWS * zz : zz); };
  if (S > 1 || PACK) {
    if (cluster_rank() != rank_of(h, z)) __trap();  // the launch's cluster shape
    cluster_barrier();  // every CTA's sums are staged
  } else {
    __syncthreads();
  }
  // Every split's sums of 4 columns of a row, with corr[n] (CORR_PREPARED)
  // and the columns >= mask_n as 0.
  auto whole = [&](int row, int col) {
    int* const own = &red[row * L::RLD + col];
    int4 v = *reinterpret_cast<const int4*>(own);
    for (int zz = 0; zz < S; ++zz) {
      if (zz == z) continue;
      const int4 w = ld_peer4(peer(own, rank_of(h, zz)));
      v.x = (int)((uint32_t)v.x + (uint32_t)w.x);
      v.y = (int)((uint32_t)v.y + (uint32_t)w.y);
      v.z = (int)((uint32_t)v.z + (uint32_t)w.z);
      v.w = (int)((uint32_t)v.w + (uint32_t)w.w);
    }
    if (CORR == CORR_PREPARED) {
      const int4 cr = __ldg(reinterpret_cast<const int4*>(ep.corr + n0 + col));
      v.x = (int)((uint32_t)v.x + (uint32_t)cr.x);
      v.y = (int)((uint32_t)v.y + (uint32_t)cr.y);
      v.z = (int)((uint32_t)v.z + (uint32_t)cr.z);
      v.w = (int)((uint32_t)v.w + (uint32_t)cr.w);
    }
    const int n = n0 + col;
    return make_int4(n < ep.mask_n ? v.x : 0, n + 1 < ep.mask_n ? v.y : 0, n + 2 < ep.mask_n ? v.z : 0,
                     n + 3 < ep.mask_n ? v.w : 0);
  };
  constexpr int CPR = BNT / 4;  // 4-column chunks of a row
  const bool last_tile = blockIdx.x == gridDim.x - 1;
  const int c0 = gridDim.x * BNT;  // first column past the grid
  if (PACK) {
    // rank z = 0 requantizes the whole tile into levels [BNT][SLD] bytes,
    // rows 4i .. 4i + 3 of a column in one word
    uint8_t* const stage = reinterpret_cast<uint8_t*>(tail + L::RED);
    if (z == 0) {
      for (int c = tid; c < ROWS * CPR; c += NTH) {
        const int row = c / CPR, col = (c % CPR) * 4;
        const int4 v = whole(row, col);
        stage[col * L::SLD + row] = (uint8_t)requant(v.x, ep.out_bits, ep.shift);
        stage[(col + 1) * L::SLD + row] = (uint8_t)requant(v.y, ep.out_bits, ep.shift);
        stage[(col + 2) * L::SLD + row] = (uint8_t)requant(v.z, ep.out_bits, ep.shift);
        stage[(col + 3) * L::SLD + row] = (uint8_t)requant(v.w, ep.out_bits, ep.shift);
      }
    }
    cluster_barrier();
    if (z == 0) {
      // this CTA's quarter of the group's gw = 8 f word rows: word (i, n)
      // ORs rows q * 4 gw + 4 i .. + 3 of column n, field q at bit f q
      const int f = ep.out_bits <= 2 ? ep.out_bits : 4;
      const int gw = 8 * f, nw = gw / PACK_ROWS, P = 8 / f;
      const size_t wrow0 = (size_t)(m0 >> 8) * gw + h * nw;
      int32_t* const out = static_cast<int32_t*>(ep.out);
      for (int w = tid; w < nw * BNT; w += NTH) {
        const int il = w / BNT, n = w - il * BNT;
        if (n0 + n >= ep.ocp) continue;
        const int i = h * nw + il;
        uint32_t word = 0;
        for (int fq = 0; fq < P; ++fq) {
          const int r = fq * 4 * gw + 4 * i;  // group row of field fq, byte 0
          word |= ld_peer(peer(stage + n * L::SLD + (r & (ROWS - 1)), rank_of(r / ROWS, 0)))
                  << (f * fq);
        }
        out[(wrow0 + il) * ep.ocp + n0 + n] = (int32_t)word;
      }
      if (last_tile && c0 < ep.ocp && tid < THREADS)  // fill_rows strides by THREADS
        fill_rows(static_cast<unsigned char*>(ep.out) + wrow0 * ep.ocp * 4, (size_t)ep.ocp * 4, nw,
                  c0 * 4, (ep.ocp - c0) * 4, 0u);
    }
  } else {
    // the S CTAs of a tile share its epilogue: CTA z stores rows [r0, r1)
    const int per = (ROWS + S - 1) / S, r0 = min(z * per, ROWS), r1 = min(r0 + per, ROWS);
    for (int c = tid; c < (r1 - r0) * CPR; c += NTH) {
      const int row = r0 + c / CPR, col = (c % CPR) * 4;
      const int4 v = whole(row, col);
      store_pair(ep, m0 + row, n0 + col, v.x, v.y);
      store_pair(ep, m0 + row, n0 + col + 2, v.z, v.w);
    }
    if (last_tile && z == 0 && tid < THREADS) {  // the columns past the grid: level 0
      unsigned char* const out = static_cast<unsigned char*>(ep.out);
      if (ep.kind == OUT_DIGITS) {
        for (int d = 0; d < (ep.out_bits + 3) / 4; ++d)
          fill_rows(out + ((size_t)d * ep.mp + m0) * np, np, ROWS, c0, np - c0, 0u);
      } else if (c0 < ep.ocp) {
        const int es = ep.kind == OUT_PACKED ? 1 : 4;  // the signed plane: level 0 is -128
        fill_rows(out + (size_t)m0 * ep.ocp * es, (size_t)ep.ocp * es, ROWS, c0 * es,
                  (ep.ocp - c0) * es, ep.kind == OUT_PACKED ? 0x80808080u : 0u);
      }
    }
  }
  if (S > 1 || PACK) cluster_barrier();  // no peer still reads this CTA's shared memory
}

// One launch of k4_kernel on the (1, PACK ? 4 : 1, S) cluster grid over
// `col_tiles` column tiles. A refused launch (too much shared memory, a
// cluster the card cannot place) is returned, not raised.
template <int ND_B, int CORR, int BNT, bool MAPPED, bool PACK>
int launch_one(const int8_t* a, const int8_t* b, int kp, const Epilogue& ep, const KMap& km,
               int col_tiles, int splits, cudaStream_t stream) {
  auto kern = k4_kernel<ND_B, CORR, BNT, MAPPED, PACK>;
  constexpr int smem = Layout<ND_B, BNT, CORR>::SMEM;
  if (smem > 48 * 1024) {  // above the default, on the current device
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(col_tiles, ep.mp / ROWS, splits);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = PACK ? PACK_ROWS : 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a, b, kp, ep, km);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int ND_B, int CORR, int BNT>
int launch_forms(const int8_t* a, const int8_t* b, int kp, const Epilogue& ep, const KMap& km,
                 int col_tiles, int splits, cudaStream_t s) {
  const bool pack = group_out(ep.kind, ep.out_bits);
  if constexpr (CORR == CORR_PREPARED) {
    if (km.kcnt != nullptr) return (int)cudaErrorInvalidValue;  // as the TPU kernel: no map
    return pack ? launch_one<ND_B, CORR, BNT, false, true>(a, b, kp, ep, km, col_tiles, splits, s)
                : launch_one<ND_B, CORR, BNT, false, false>(a, b, kp, ep, km, col_tiles, splits, s);
  } else {
    const bool mapped = km.kcnt != nullptr;
    if (pack)
      return mapped ? launch_one<ND_B, CORR, BNT, true, true>(a, b, kp, ep, km, col_tiles, splits, s)
                    : launch_one<ND_B, CORR, BNT, false, true>(a, b, kp, ep, km, col_tiles, splits, s);
    return mapped ? launch_one<ND_B, CORR, BNT, true, false>(a, b, kp, ep, km, col_tiles, splits, s)
                  : launch_one<ND_B, CORR, BNT, false, false>(a, b, kp, ep, km, col_tiles, splits, s);
  }
}

// Every instantiation of one B plane count and correction: column tile
// 16, 32 or 64, (for CORR_COLSUM) dense or mapped, per-tile or packed
// words out.
template <int ND_B, int CORR>
int launch_bnt(const int8_t* a, const int8_t* b, int kp, const Epilogue& ep, const KMap& km,
               int bnt, int col_tiles, int splits, cudaStream_t s) {
  switch (bnt) {
    case 16: return launch_forms<ND_B, CORR, 16>(a, b, kp, ep, km, col_tiles, splits, s);
    case 32: return launch_forms<ND_B, CORR, 32>(a, b, kp, ep, km, col_tiles, splits, s);
    case 64: return launch_forms<ND_B, CORR, 64>(a, b, kp, ep, km, col_tiles, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K2's 8-bit plane (CORR_COLSUM, B with 1 or 2 digit planes); defined in
// packmm_f8.cu, a translation unit of its own built in parallel.
int launch_colsum(const int8_t* a, const int8_t* b, int nd_b, int kp, const Epilogue& ep,
                  const KMap& km, int bnt, int col_tiles, int splits, cudaStream_t s);

}  // namespace k4
}  // namespace qgtc
