// K2's kernel for an M-packed 1-, 2- or 4-bit A (csrc/packmm.cu is its C
// entry; the source note there says what bounds it and what each lever
// does).
//
// A CTA owns 64 rows x BNT columns (BNT = 16, 32 or 64, the wrapper's
// choice from the real width N) and 1/S of the contraction. Its K loop:
//   * a ring of STAGES raw stages: cp.async.cg brings each 64-deep step's
//     packed words (the 8 or 16 word rows that hold the tile's rows) and
//     its B tile ([k][n], as B lies in memory) into shared memory
//     STAGES - 1 steps ahead of use;
//   * the unpack: each thread takes the same 16 bytes of words every
//     step (the rows they hold and the bit offsets are fixed per CTA and
//     computed before the loop) and writes their fields into the int8 A
//     tile that frag_a reads; B is transposed by 4 x 4 byte blocks into
//     the [n][k] tile that frag_b reads;
//   * double-buffered A and B tiles, so a step has one barrier: the unpack
//     of step j + 1 and the MMAs of step j run between two barriers.
// Split-K: the S CTAs of a (1, R, S) thread-block cluster share an output
// tile. Each takes a contiguous share of the K steps (with a TileMap,
// every S-th listed K tile) and leaves its int32 sums in its shared
// memory; rank z = 0 adds the others' through distributed shared memory
// (the sums wrap modulo 2^32, so the order does not matter) and runs the
// epilogue. Packed words: the four 64-row CTAs of a 256-row group form the
// cluster's R = 4 dimension; each stores its requantized levels column by
// column in shared memory and, after a cluster barrier, builds a quarter
// of the group's words from all four over distributed shared memory. Every
// CTA passes a last cluster barrier before it exits, so no peer reads
// shared memory that is gone.
//
// Output: every element, padding included (gemm_core.cuh's contract).
// The grid covers the column tiles that hold computed columns (below
// round_up(N, 8), or the stored ones for the terminal forms); the CTAs of
// the last of them also store the columns past the grid as level 0, which
// is exact because B's padded columns hold level 0 (their sums are 0 and
// requant(0) = 0).
#pragma once

#include "async_cluster.cuh"
#include "gemm_core.cuh"

namespace qgtc {
namespace k2 {

constexpr int STAGES = 4;     // raw stages in the cp.async ring
constexpr int MAX_SPLIT = 4;  // CTAs that share one output tile
constexpr int PACK_ROWS = GROUP / BM;  // 64-row CTAs of a 256-row group

// Shared-memory layout of one instantiation (bytes).
template <int F, int ND_B, int BNT>
struct Layout {
  static constexpr int WR = F == 1 ? 8 : 16;  // word rows holding 64 rows
  static constexpr int A_RAW = WR * BK * 4;
  static constexpr int B_RAW = ND_B * BK * BNT;
  static constexpr int SLOT = A_RAW + B_RAW;
  static constexpr int AS = 2 * BM * LDS;
  static constexpr int BS = 2 * ND_B * BNT * LDS;
  static constexpr int RING = STAGES * SLOT;
  static constexpr int RLD = BNT + 4;  // split-K partial sums [BM][RLD] int32
  static constexpr int RED = BM * RLD * 4;
  static constexpr int SLD = BM + 4;  // packed out: levels [BNT][SLD] bytes
  static constexpr int STG = BNT * SLD;
  static constexpr int TAIL = RING > RED + STG ? RING : RED + STG;
  static constexpr int SMEM = AS + BS + TAIL;
  static_assert(A_RAW % 16 == 0 && B_RAW % 16 == 0 && RED % 16 == 0, "16-byte slots");
};

// gridDim = (column tiles, mp / 64, S); cluster (1, PACK ? 4 : 1, S).
template <int F, int ND_B, int BNT, bool MAPPED, bool PACK>
__global__ void __launch_bounds__(THREADS)
    k2_kernel(const int32_t* __restrict__ a, const int8_t* __restrict__ b, int kp,
              Epilogue ep, KMap km) {
  using L = Layout<F, ND_B, BNT>;
  constexpr int NT = BNT / 16;  // 8-column n-tiles per warp (2 x 2 warps)
  constexpr int GW = 8 * F;     // word rows per 256-row group
  constexpr int QR = 4 * GW;    // rows per field
  constexpr int NQ = F == 1 ? 2 : 1;  // fields a 64-row tile spans
  constexpr int A_PER = L::WR * 16 / THREADS;  // 16-byte word chunks a thread
  constexpr int B_CH = ND_B * BK * BNT / 16;   // 16-byte B chunks a step
  constexpr int B_BLK = ND_B * 16 * (BNT / 4);  // 4 x 4 transpose blocks a step
  static_assert(L::WR * 16 % THREADS == 0, "whole word chunks per thread");

  extern __shared__ __align__(16) unsigned char smem[];
  int8_t(*As)[BM][LDS] = reinterpret_cast<int8_t(*)[BM][LDS]>(smem);
  int8_t(*Bs)[ND_B][BNT][LDS] = reinterpret_cast<int8_t(*)[ND_B][BNT][LDS]>(smem + L::AS);
  unsigned char* const tail = smem + L::AS + L::BS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * (BNT / 2);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BNT;
  const int S = gridDim.z, z = blockIdx.z;
  const int h = blockIdx.y & (PACK_ROWS - 1);  // 64-row tile within its group
  const int np = ep.np;

  // The word rows that hold this tile's rows, and the fields it takes:
  // tile row qq * QR + 4 * wr + kb sits in bits 8 kb + F (q0 + qq) of
  // staged word row wr (ops/packmm.py layout).
  const int q0 = F == 1 ? 2 * h : (F == 2 ? h : h >> 1);
  const int i0 = F == 4 ? 16 * (h & 1) : 0;
  const int32_t* const wbase = a + (size_t)((m0 >> 8) * GW + i0) * kp;
  const size_t bplane = (size_t)kp * np;

  // This CTA's K steps: a contiguous share of the contraction, or every
  // S-th K tile its row tile's map row lists (an entry outside the grid
  // is read as zeros).
  int nst, kb_next, spt = 1, t_next = 0, s_next = 0;
  const KTiles kt(km, m0, kp);
  if (MAPPED) {
    spt = kt.depth / BK;
    const int cnt = kt.n > z ? (kt.n - z + S - 1) / S : 0;
    nst = cnt * spt;
    t_next = z;
    kb_next = cnt ? kt.start(z) : 0;
  } else {
    const int all = kp / BK, share = (all + S - 1) / S;
    const int first = min(z * share, all);
    nst = min(all - first, share);
    kb_next = first * BK;
  }

  // Issue the next step's copies into ring slot `slot`, then advance.
  auto issue = [&](int slot) {
    unsigned char* const raw = tail + slot * L::SLOT;
    const bool valid = kb_next >= 0;
    const int k0 = valid ? kb_next + s_next * BK : 0;
#pragma unroll
    for (int u = 0; u < A_PER; ++u) {
      const int c = tid + u * THREADS, wr = c >> 4, kc = (c & 15) * 4;
      cp_async16(raw + (wr * BK + kc) * 4, wbase + (size_t)wr * kp + k0 + kc, valid);
    }
    for (int c = tid; c < B_CH; c += THREADS) {
      constexpr int PER_K = BNT / 16, PER_E = BK * PER_K;
      const int e = c / PER_E, r = c - e * PER_E;
      const int k = r / PER_K, nc = (r - k * PER_K) * 16;
      cp_async16(raw + L::A_RAW + (e * BK + k) * BNT + nc,
                 b + e * bplane + (size_t)(k0 + k) * np + n0 + nc, valid);
    }
    if (MAPPED) {
      if (++s_next == spt) {
        s_next = 0;
        t_next += S;
        if (t_next < kt.n) kb_next = kt.start(t_next);
      }
    } else {
      kb_next += BK;
    }
  };

  // Raw slot -> A tile and transposed B tile `buf`.
  auto unpack = [&](int slot, int buf) {
    const unsigned char* const raw = tail + slot * L::SLOT;
#pragma unroll
    for (int u = 0; u < A_PER; ++u) {
      const int c = tid + u * THREADS, wr = c >> 4, kc = (c & 15) * 4;
      const int4 v = *reinterpret_cast<const int4*>(raw + (wr * BK + kc) * 4);
#pragma unroll
      for (int qq = 0; qq < NQ; ++qq)
#pragma unroll
        for (int kb = 0; kb < 4; ++kb)
          *reinterpret_cast<uint32_t*>(&As[buf][qq * QR + 4 * wr + kb][kc]) =
              fields<F>(v, 8 * kb + F * (q0 + qq));
    }
    const unsigned char* const rb = raw + L::A_RAW;
    for (int blk = tid; blk < B_BLK; blk += THREADS) {
      constexpr int NQB = BNT / 4, PER_E = 16 * NQB;
      const int e = blk / PER_E, r = blk - e * PER_E;
      const int kq = r / NQB, nq = r - kq * NQB;
      const unsigned char* p = rb + (e * BK + 4 * kq) * BNT + 4 * nq;
      const uint32_t x0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t x1 = *reinterpret_cast<const uint32_t*>(p + BNT);
      const uint32_t x2 = *reinterpret_cast<const uint32_t*>(p + 2 * BNT);
      const uint32_t x3 = *reinterpret_cast<const uint32_t*>(p + 3 * BNT);
      const uint32_t lo01 = __byte_perm(x0, x1, 0x5140), hi01 = __byte_perm(x0, x1, 0x7362);
      const uint32_t lo23 = __byte_perm(x2, x3, 0x5140), hi23 = __byte_perm(x2, x3, 0x7362);
      int8_t(*bt)[LDS] = Bs[buf][e];
      *reinterpret_cast<uint32_t*>(&bt[4 * nq][4 * kq]) = __byte_perm(lo01, lo23, 0x5410);
      *reinterpret_cast<uint32_t*>(&bt[4 * nq + 1][4 * kq]) = __byte_perm(lo01, lo23, 0x7632);
      *reinterpret_cast<uint32_t*>(&bt[4 * nq + 2][4 * kq]) = __byte_perm(hi01, hi23, 0x5410);
      *reinterpret_cast<uint32_t*>(&bt[4 * nq + 3][4 * kq]) = __byte_perm(hi01, hi23, 0x7632);
    }
  };

  int acc[ND_B][2][NT][4];
#pragma unroll
  for (int e = 0; e < ND_B; ++e)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[e][mt][nt][i] = 0;

  auto mma_step = [&](int buf) {
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4], bf[ND_B][NT][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) frag_a(af[mt], &As[buf][wm + mt * 16 + g][ks + t4 * 4]);
#pragma unroll
      for (int e = 0; e < ND_B; ++e)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          frag_b(bf[e][nt], &Bs[buf][e][wn + nt * 8 + g][ks + t4 * 4]);
#pragma unroll
      for (int e = 0; e < ND_B; ++e)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_s8(acc[e][mt][nt], af[mt], bf[e][nt]);
    }
  };

  // The ring: steps 0 .. STAGES - 2 in flight, step 0 unpacked; then per
  // step j: issue step j + STAGES - 1, wait for step j + 1, one barrier,
  // unpack step j + 1, MMAs of step j.
  int issued = 0;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (issued < nst) issue(issued++ % STAGES);
    cp_commit();
  }
  cp_wait<STAGES - 2>();
  __syncthreads();
  if (nst > 0) unpack(0, 0);
  for (int j = 0; j < nst; ++j) {
    if (issued < nst) issue(issued++ % STAGES);
    cp_commit();
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (j + 1 < nst) unpack((j + 1) % STAGES, (j + 1) & 1);
    mma_step(j & 1);
  }
  cp_wait<0>();

  // The sum over digit shifts, wrapping like int32.
  uint32_t tot[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t s = 0;
#pragma unroll
        for (int e = 0; e < ND_B; ++e) s += (uint32_t)acc[e][mt][nt][i] << (4 * e);
        tot[mt][nt][i] = s;
      }

  // Cluster rank of the CTA at (row tile y, split z) of this cluster.
  auto rank_of = [&](int y, int zz) { return (uint32_t)(PACK ? y + PACK_ROWS * zz : zz); };
  if (S > 1 || PACK) {
    if (cluster_rank() != rank_of(h, z)) __trap();  // the launch's cluster shape
  }
  int* const red = reinterpret_cast<int*>(tail);
  if (S > 1) {
    // every partial into shared memory; rank z = 0 adds the others'
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = wm + mt * 16 + g + 8 * hh, col = wn + nt * 8 + 2 * t4;
          *reinterpret_cast<int2*>(&red[row * L::RLD + col]) =
              make_int2((int)tot[mt][nt][2 * hh], (int)tot[mt][nt][2 * hh + 1]);
        }
    cluster_barrier();
    if (z == 0) {
      for (int zz = 1; zz < S; ++zz) {
        const uint32_t base = peer(red, rank_of(h, zz));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int row = wm + mt * 16 + g + 8 * hh, col = wn + nt * 8 + 2 * t4;
              const int2 v = ld_peer2(base + 4 * (row * L::RLD + col));
              tot[mt][nt][2 * hh] += (uint32_t)v.x;
              tot[mt][nt][2 * hh + 1] += (uint32_t)v.y;
            }
      }
    }
  }

  const bool last_tile = blockIdx.x == gridDim.x - 1;
  const int c0 = gridDim.x * BNT;  // first column past the grid
  if (PACK) {
    // levels [BNT][SLD] bytes, rows 4i .. 4i + 3 of a column in one word
    uint8_t* const stage = reinterpret_cast<uint8_t*>(tail + L::RED);
    if (z == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = wm + mt * 16 + g + 8 * (i >> 1), col = wn + nt * 8 + 2 * t4 + (i & 1);
            const int v = n0 + col < ep.mask_n ? (int)tot[mt][nt][i] : 0;
            stage[col * L::SLD + row] = (uint8_t)requant(v, ep.out_bits, ep.shift);
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
      for (int w = tid; w < nw * BNT; w += THREADS) {
        const int il = w / BNT, n = w - il * BNT;
        if (n0 + n >= ep.ocp) continue;
        const int i = h * nw + il;
        uint32_t word = 0;
        for (int q = 0; q < P; ++q) {
          const int r = q * 4 * gw + 4 * i;  // group row of field q, byte 0
          word |= ld_peer(peer(stage + n * L::SLD + (r & (BM - 1)), rank_of(r / BM, 0)))
                  << (f * q);
        }
        out[(wrow0 + il) * ep.ocp + n0 + n] = (int32_t)word;
      }
      if (last_tile && c0 < ep.ocp)
        fill_rows(static_cast<unsigned char*>(ep.out) + wrow0 * ep.ocp * 4, (size_t)ep.ocp * 4, nw,
                  c0 * 4, (ep.ocp - c0) * 4, 0u);
    }
  } else if (z == 0) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = wm + mt * 16 + g + 8 * hh, col = wn + nt * 8 + 2 * t4;
          const int v0 = n0 + col < ep.mask_n ? (int)tot[mt][nt][2 * hh] : 0;
          const int v1 = n0 + col + 1 < ep.mask_n ? (int)tot[mt][nt][2 * hh + 1] : 0;
          store_pair(ep, m0 + row, n0 + col, v0, v1);
        }
    if (last_tile) {  // the columns past the grid: level 0
      unsigned char* const out = static_cast<unsigned char*>(ep.out);
      if (ep.kind == OUT_DIGITS) {
        for (int d = 0; d < (ep.out_bits + 3) / 4; ++d)
          fill_rows(out + ((size_t)d * ep.mp + m0) * np, np, BM, c0, np - c0, 0u);
      } else if (c0 < ep.ocp) {
        const int es = ep.kind == OUT_PACKED ? 1 : 4;  // the signed plane: level 0 is -128
        fill_rows(out + (size_t)m0 * ep.ocp * es, (size_t)ep.ocp * es, BM, c0 * es,
                  (ep.ocp - c0) * es, ep.kind == OUT_PACKED ? 0x80808080u : 0u);
      }
    }
  }
  if (S > 1 || PACK) cluster_barrier();  // no peer still reads this CTA's shared memory
}

// One launch of k2_kernel on the (1, PACK ? 4 : 1, S) cluster grid over
// `col_tiles` column tiles. A refused launch (too much shared memory, a
// cluster the card cannot place) is returned, not raised.
template <int F, int ND_B, int BNT, bool MAPPED, bool PACK>
int launch_one(const int32_t* a, const int8_t* b, int kp, const Epilogue& ep, const KMap& km,
               int col_tiles, int splits, cudaStream_t stream) {
  auto kern = k2_kernel<F, ND_B, BNT, MAPPED, PACK>;
  constexpr int smem = Layout<F, ND_B, BNT>::SMEM;
  if (smem > 48 * 1024) {  // above the default, on the current device
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(col_tiles, ep.mp / BM, splits);
  cfg.blockDim = dim3(THREADS);
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

template <int F, int ND_B, int BNT>
int launch_forms(const int32_t* a, const int8_t* b, int kp, const Epilogue& ep, const KMap& km,
                 int col_tiles, int splits, cudaStream_t s) {
  const bool pack = group_out(ep.kind, ep.out_bits), mapped = km.kcnt != nullptr;
  if (pack)
    return mapped ? launch_one<F, ND_B, BNT, true, true>(a, b, kp, ep, km, col_tiles, splits, s)
                  : launch_one<F, ND_B, BNT, false, true>(a, b, kp, ep, km, col_tiles, splits, s);
  return mapped ? launch_one<F, ND_B, BNT, true, false>(a, b, kp, ep, km, col_tiles, splits, s)
                : launch_one<F, ND_B, BNT, false, false>(a, b, kp, ep, km, col_tiles, splits, s);
}

// Every instantiation for field width F: B with 1 or 2 digit planes,
// column tile 16, 32 or 64, dense or mapped, per-tile or packed-words out.
template <int F>
int launch_field(const int32_t* a, const int8_t* b, int nd_b, int kp, const Epilogue& ep,
                 const KMap& km, int bnt, int col_tiles, int splits, cudaStream_t s) {
#define QGTC_K2_BNT(ND)                                                              \
  switch (bnt) {                                                                     \
    case 16: return launch_forms<F, ND, 16>(a, b, kp, ep, km, col_tiles, splits, s); \
    case 32: return launch_forms<F, ND, 32>(a, b, kp, ep, km, col_tiles, splits, s); \
    case 64: return launch_forms<F, ND, 64>(a, b, kp, ep, km, col_tiles, splits, s); \
    default: return (int)cudaErrorInvalidValue;                                      \
  }
  if (nd_b == 1) QGTC_K2_BNT(1)
  if (nd_b == 2) QGTC_K2_BNT(2)
#undef QGTC_K2_BNT
  return (int)cudaErrorInvalidValue;
}

// Defined in packmm_f1.cu, packmm_f2.cu and packmm_f4.cu (one translation
// unit per field width, built in parallel).
int launch_f1(const int32_t* a, const int8_t* b, int nd_b, int kp, const Epilogue& ep,
              const KMap& km, int bnt, int col_tiles, int splits, cudaStream_t s);
int launch_f2(const int32_t* a, const int8_t* b, int nd_b, int kp, const Epilogue& ep,
              const KMap& km, int bnt, int col_tiles, int splits, cudaStream_t s);
int launch_f4(const int32_t* a, const int8_t* b, int nd_b, int kp, const Epilogue& ep,
              const KMap& km, int bnt, int col_tiles, int splits, cudaStream_t s);

}  // namespace k2
}  // namespace qgtc
