// P1a, the packed-A GEMM probe: one ring loop and the ways an M-packed A
// can reach the tensor cores (benchmarks/exp_packmm.py packmm_exp).
//
// Replaces the TPU experiment benchmarks/exp_packmm.py::make_packmm
// (:146, pallas_call at :236): A arrives as int32 words [mp / rpw][kp] of
// f-bit fields (rpw = 32 / f rows per word), permuted within each layout
// tile of tm rows so that row q*4*ms + 4*i + k of a tile sits in bits
// [8k + f*q, 8k + f*(q+1)) of the tile's word row i (ms = tm / rpw word
// rows per tile). B is int8 [kp][np]. out = A.B exactly in int32, stored
// as float32 [mp][np]. The packed output (make_packmm_packedout) has a
// kernel of its own, exp_packmm_packed.cu, whose loop and row map this
// kernel shares.
//
// The loop (K2's and K1's mechanics, as P1b runs them): probe_ring.cuh's
// ring of 3 or 4 cp.async.cg slots, stages - 2 steps ahead, one barrier a
// step, K steps of 64, 128 or 256 columns, every per-thread offset fixed
// before the loop; B's [k][n] rows transposed by 4 x 4 byte blocks into
// [n][k] (two buffers) and loaded with ldmatrix; int8 mma.sync.m16n8k32 on
// four warps of 16 rows, each warp all BNT (16, 32 or 64) columns.
// Rows: a CTA owns 64 rows. In every variant but int8 and rowrange it
// owns WR = 2 f whole word rows of one layout tile (exp_packmm.
// word_row_ctas): local row q*4*WR + 4*w + k is field q of byte k of its
// word row w, logical row t*tm + q*4*ms + 4*(i0 + w) + k; each word is
// read once and each f32 row stored at its logical place. Split-K: the S
// CTAs of a (1, 1, S) cluster take contiguous shares of the K steps and
// rank 0 adds the others' int32 sums through distributed shared memory
// (exp_packmm.exp_packmm_plan sizes the tile, the split, the ring and the
// step). Each warp unpacks the rows it multiplies: 16 rows, from NWW
// staged word rows and NQW = 4 / NWW fields of them.
//
// Variants (the same product, but noextract), differing only in how A
// reaches the MMAs:
//   concat      prep unpacks the slot's words into an int8 A tile (two
//               buffers, shifts and masks) beside the previous step's
//               MMAs; body loads the fragments with ldmatrix;
//   slabs       the fragments built from the slot's words in registers,
//               as P1b builds them: no A tile;
//   noextract   concat with byte permutes in place of the shifts and
//               masks: byte k of each word, as a signed int8, for every
//               field q (an ablation: wrong by design, deterministic,
//               checked against its own plain version);
//   bres        B's K share of the column tile held whole in shared
//               memory, loaded once; only the words ride the ring, and
//               body unpacks a step's words just before its MMAs;
//   bres_chunk  bres with step j + 1's unpack in prep, beside step j's
//               MMAs: the pair isolates that overlap;
//   int8        an int8 A [mp][kp] (8 / f times the bytes), 64 consecutive
//               rows a CTA, staged through the same ring; ldmatrix reads
//               the slot;
//   rowrange    concat on K2's rows: 64 consecutive logical rows a CTA,
//               staging the 8 (1-bit) or 16 word rows that hold them, of
//               which it uses 2 of 8 fields (1-bit), 1 of 4 (2-bit) or 1 of
//               2 (4-bit), offsets fixed before the loop as
//               packmm_k2.cuh:6-15 fixes them; tm = 256 (K2's layout).
//               Timed beside concat it reads what K2's row ranges cost.
// What bounds it on an H100: at C1's shape, 1-bit A[2560^2] (tm 256) x
// B[2560 x 16] to f32, the words, B and the f32 out are 1.02 MB (0.31 us
// at 3.35 TB/s); its 0.21 G operations take 0.1 us at the int8 peak. Its
// 40 row CTAs are a third of the 132 SMs, so the split (5 at C1 by
// default) fills the card, and a CTA's few deep steps leave the launch,
// the ring's fill and the reduction.
// Measured (one H100 80GB HBM3 at 700 W, benchmarks/gemm_times.py
// --probes-only, parent and change in turns in one call): concat at C1
// 32.22, 32.25 us on the old single-stage loop -> 7.51, 7.52 (K2's
// packmm_to_f32 11.12-11.29 in the same call); benchmarks/probe_trace.py:
// of a 256-deep step's 3239 cycles, prep (the unpack beside B's
// transpose) takes 1675, the MMAs 611.
#pragma once

#include "probe_ring.cuh"

namespace qgtc {
namespace probe {

enum Variant {
  V_CONCAT = 0,
  V_SLABS = 1,
  V_NOEXTRACT = 2,
  V_BRES = 3,
  V_BRES_CHUNK = 4,
  V_INT8 = 5,
  V_ROWRANGE = 6,
};

constexpr int EXP_ROWS = 64;      // logical rows a CTA owns
constexpr int EXP_THREADS = 128;  // 4 warps of 16 rows
constexpr int EXP_MAX_SPLIT = 8;  // a portable cluster

struct ExpArgs {
  const void* a;    // int32 words [mp / rpw][kp]; V_INT8: int8 [mp][kp]
  const int8_t* b;  // int8 [kp][np]
  float* out;       // [mp][np]
  int kp, np, tm, stages, depth;
};

template <int V>
__host__ __device__ constexpr bool has_a_tile() {
  return V != V_SLABS && V != V_INT8;
}

template <int V>
__host__ __device__ constexpr bool b_resident() {
  return V == V_BRES || V == V_BRES_CHUNK;
}

// Rows of A a CTA stages a step: its word rows, K2's 8 or 16, or 64 int8 rows.
template <int V, int F>
__host__ __device__ constexpr int staged_rows() {
  return V == V_INT8 ? EXP_ROWS : (V == V_ROWRANGE ? (F == 1 ? 8 : 16) : 2 * F);
}

// Shared memory (bytes) at a K step of `depth` columns and a K share of
// `share` steps: two A tiles [64][depth + 16] (the unpacking variants),
// B's tiles (two [BNT][depth + 16], or the resident share [BNT][share *
// depth + 16]), then the ring, whose room the split's int32 sums take
// after the loop. A slot holds the staged rows, a_ld bytes apart (words:
// 4 depth + 64, so a warp's rows land in distinct banks; int8: depth +
// 16, ldmatrix's stride), then, unless B is resident, B's [depth][BNT]
// rows. exp_packmm.exp_packmm_smem takes the same sums.
template <int V, int F, int BNT>
struct ExpLayout {
  static constexpr int WS = staged_rows<V, F>();
  static constexpr int RLD = BNT + 4;  // partial sums [64][RLD] int32
  static constexpr int RED = EXP_ROWS * RLD * 4;
  int ald, at, a_ld, a_raw, slot, bld, bt, tiles, ring;
  __host__ __device__ ExpLayout(int depth, int stages, int share) {
    ald = depth + 16;
    at = has_a_tile<V>() ? EXP_ROWS * ald : 0;
    a_ld = V == V_INT8 ? depth + 16 : 4 * depth + 64;
    a_raw = WS * a_ld;
    slot = a_raw + (b_resident<V>() ? 0 : depth * BNT);
    bld = b_resident<V>() ? share * depth + 16 : depth + 16;
    bt = BNT * bld;
    tiles = 2 * at + (b_resident<V>() ? 1 : 2) * bt;
    ring = stages * slot;
  }
  __host__ __device__ int bytes() const { return tiles + (ring > RED ? ring : RED); }
  static_assert(RED % 16 == 0, "16-byte parts");
};

// gridDim = (np / BNT, mp / 64, S); cluster (1, 1, S).
template <int V, int F, int BNT>
__global__ void __launch_bounds__(EXP_THREADS) exp_packmm_kernel(const ExpArgs p) {
  constexpr int NT = BNT / 8;
  constexpr bool TILE = has_a_tile<V>(), RES = b_resident<V>();
  constexpr int WS = staged_rows<V, F>();
  constexpr int ES = V == V_INT8 ? 1 : 4;  // bytes an element of A
  // a warp's 16 rows: NQW fields of NWW staged word rows (K2's rows: one field)
  constexpr int NWW = F == 1 && V != V_ROWRANGE ? 2 : 4, NQW = 4 / NWW;
  constexpr int AN = WS * 256 * ES / 16 / EXP_THREADS;  // 16-byte A chunks a thread, deepest step
  constexpr int UN = NWW * 256 / 4 / 32;                 // 4-column word chunks a lane unpacks, likewise
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * BNT, y = blockIdx.y;
  const int S = gridDim.z, z = blockIdx.z, d = p.depth;
  const int all = p.kp / d, share = (all + S - 1) / S;
  const int first = min(z * share, all), nst = min(all - first, share);
  const ExpLayout<V, F, BNT> L(d, p.stages, share);
  int8_t* const at = reinterpret_cast<int8_t*>(smem);          // [2][64][ald]
  int8_t* const bt = reinterpret_cast<int8_t*>(smem + 2 * L.at);  // [2][BNT][bld], or the resident share
  unsigned char* const ring = smem + L.tiles;
  const uint32_t ring_u = smem_u32(ring), at_u = smem_u32(at), bt_u = smem_u32(bt);

  // The rows this CTA stages and their fields. Word rows: y*WR .. of the
  // layout, in tile t from its word row i0. K2's rows: the 64 rows from
  // m0 = 64 y, in 256-row group y / 4 as its quarter h, in the fields q0 ..
  // of staged rows from i0 (packmm_k2.cuh). int8: rows m0 ...
  const int h4 = y & 3;
  const int q0 = V == V_ROWRANGE ? (F == 1 ? 2 * h4 : (F == 2 ? h4 : h4 >> 1)) : 0;
  const int row0 = V == V_INT8 ? EXP_ROWS * y
                   : (V == V_ROWRANGE ? (y >> 2) * 8 * F + (F == 4 ? 16 * (h4 & 1) : 0) : y * WS);
  const unsigned char* const abase =
      static_cast<const unsigned char*>(p.a) + ((size_t)row0 * p.kp + (size_t)first * d) * ES;
  const int8_t* const bbase = p.b + (size_t)first * d * p.np + n0;

  // this thread's 16-byte chunks of a step's staged rows (-1: none)
  int a_dst[AN], a_src[AN];
  {
    const int per = d * ES / 16;
#pragma unroll
    for (int u = 0; u < AN; ++u) {
      const int c = tid + u * EXP_THREADS, r = c / per, cc = c - r * per;
      a_dst[u] = c < WS * per ? r * L.a_ld + 16 * cc : -1;
      a_src[u] = r * p.kp * ES + 16 * cc;
    }
  }

  auto issue = [&](int i, int slot_i) {
    const uint32_t slot = ring_u + slot_i * L.slot;
    const int k0 = i * d;
#pragma unroll
    for (int u = 0; u < AN; ++u)
      if (a_dst[u] >= 0) cp_async16_u(slot + a_dst[u], abase + a_src[u] + (size_t)k0 * ES);
    if (!RES) {
      constexpr int CH = BNT / 16;
      for (int c = tid; c < d * CH; c += EXP_THREADS) {
        const int k = c / CH, nc = (c % CH) * 16;
        cp_async16_u(slot + L.a_raw + k * BNT + nc, bbase + (size_t)(k0 + k) * p.np + nc);
      }
    }
  };
  // B's [k][n] rows in slot_i -> transposed tile buf, [n][k]
  auto transpose = [&](int slot_i, int buf) {
    const unsigned char* const rb = ring + slot_i * L.slot + L.a_raw;
    constexpr int NQ = BNT / 4;
    for (int blk = tid; blk < (d / 4) * NQ; blk += EXP_THREADS) {
      const int kq = blk / NQ, nq = blk - kq * NQ;
      const unsigned char* src = rb + 4 * kq * BNT + 4 * nq;
      transpose4(bt + buf * L.bt + 4 * nq * L.bld + 4 * kq, L.bld, *reinterpret_cast<const uint32_t*>(src),
                 *reinterpret_cast<const uint32_t*>(src + BNT),
                 *reinterpret_cast<const uint32_t*>(src + 2 * BNT),
                 *reinterpret_cast<const uint32_t*>(src + 3 * BNT));
    }
  };
  if (RES) {  // the CTA's K share of B's columns, once (ring_loop's first barrier orders it)
    constexpr int NQ = BNT / 4;
    for (int blk = tid; blk < nst * (d / 4) * NQ; blk += EXP_THREADS) {
      const int kq = blk / NQ, nq = blk - kq * NQ;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(bbase + (size_t)4 * kq * p.np + 4 * nq);
      const int w = p.np / 4;
      transpose4(bt + 4 * nq * L.bld + 4 * kq, L.bld, __ldg(src), __ldg(src + w), __ldg(src + 2 * w),
                 __ldg(src + 3 * w));
    }
  }

  // The unpack: this warp's rows 16 warp + a*4*NWW + 4*b + k hold field
  // q(a) of byte k of staged row sw(b); a lane takes 4-column chunks of
  // the NWW rows, fixed for the loop.
  int u_src[UN], u_dst[UN], qsh[NQW];
  if (TILE) {
    const int per = d / 4;
#pragma unroll
    for (int i = 0; i < UN; ++i) {
      const int u = lane + 32 * i, b = u / per, c = u - b * per;
      const int sw = V == V_ROWRANGE ? (F == 1 ? 4 * (warp & 1) + b : 4 * warp + b)
                                     : (F == 4 ? 4 * (warp & 1) + b : b);
      u_src[i] = u < NWW * per ? sw * L.a_ld + 16 * c : -1;
      u_dst[i] = (16 * warp + 4 * b) * L.ald + 4 * c;
    }
#pragma unroll
    for (int a = 0; a < NQW; ++a)
      qsh[a] = F * (V == V_ROWRANGE ? q0 + (F == 1 ? warp >> 1 : 0)
                                    : (F == 1 ? 2 * warp + a : (F == 2 ? warp : warp >> 1)));
  }
  auto unpack = [&](int slot_i, int buf) {
    const unsigned char* const w = ring + slot_i * L.slot;
    int8_t* const t = at + buf * L.at;
#pragma unroll
    for (int i = 0; i < UN; ++i) {
      if (u_src[i] < 0) continue;
      const int4 v = *reinterpret_cast<const int4*>(w + u_src[i]);
#pragma unroll
      for (int a = 0; a < NQW; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          *reinterpret_cast<uint32_t*>(t + u_dst[i] + (a * 4 * NWW + k) * L.ald) =
              V == V_NOEXTRACT ? bytes_at(v, k) : fields<F>(v, 8 * k + qsh[a]);
    }
  };

  // slabs: lane (g, t4)'s rows 16 warp + g and + 8 (fragment rows g, g +
  // 8): local row r = q*4*WR + 4*w + k is field q of byte k of word row w
  int aoff[2], fsh[2];
  uint32_t sel[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h, q = r / (4 * WS), rem = r % (4 * WS), kb = rem & 3;
    aoff[h] = (rem >> 2) * L.a_ld + 16 * t4;
    fsh[h] = F * q;
    sel[h] = (uint32_t)kb | ((uint32_t)(kb + 4) << 4);
  }
  constexpr uint32_t MREP = F >= 8 ? 0xFFFFFFFFu : ((1u << (F & 7)) - 1) * 0x01010101u;
  auto frag = [&](const unsigned char* w, int h) {
    const int4 v = *reinterpret_cast<const int4*>(w + aoff[h]);
    const uint32_t lo = __byte_perm((uint32_t)v.x, (uint32_t)v.y, sel[h]);
    const uint32_t hi = __byte_perm((uint32_t)v.z, (uint32_t)v.w, sel[h]);
    return (__byte_perm(lo, hi, 0x5410) >> fsh[h]) & MREP;
  };

  int acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
  // ldmatrix lanes: A rows (lane & 7) + 8 ((lane >> 3) & 1) at k 16 (lane >>
  // 4) give af[0..3]; B columns (lane & 7) + 8 (lane >> 4) at k 16 ((lane
  // >> 3) & 1) give two n-tiles' fragments
  const int a_lane = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1), a_k = 16 * (lane >> 4);
  const int bn = (lane & 7) + (lane >> 4) * 8, bk = ((lane >> 3) & 1) * 16;
  auto body = [&](int j, int slot_i, int buf) {
    const unsigned char* const raw = ring + slot_i * L.slot;
    if (V == V_BRES) {  // this warp's rows only: a warp barrier orders them
      __syncwarp();
      unpack(slot_i, buf);
      __syncwarp();
    }
    const uint32_t a_u = V == V_INT8 ? ring_u + slot_i * L.slot + a_lane * L.a_ld + a_k
                                     : at_u + buf * L.at + a_lane * L.ald + a_k;
    const uint32_t b_u = RES ? bt_u + bn * L.bld + bk + j * d : bt_u + buf * L.bt + bn * L.bld + bk;
#pragma unroll 2
    for (int ks = 0; ks < d; ks += 32) {
      uint32_t af[4];
      if (V == V_SLABS) {  // rows g, g + 8 at k 4 t4 ..; then at k 16 + 4 t4 ..
        af[0] = frag(raw + 4 * ks, 0);
        af[1] = frag(raw + 4 * ks, 1);
        af[2] = frag(raw + 4 * ks + 64, 0);
        af[3] = frag(raw + 4 * ks + 64, 1);
      } else {
        ldsm4_u(af, a_u + ks);
      }
#pragma unroll
      for (int pr = 0; pr < NT / 2; ++pr) {
        uint32_t bf[4];
        ldsm4_u(bf, b_u + 16 * pr * L.bld + ks);
        const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
        mma_s8(acc[2 * pr], af, b0);
        mma_s8(acc[2 * pr + 1], af, b1);
      }
    }
  };
  auto prep = [&](int slot_i, int buf) {
    if (TILE && V != V_BRES) unpack(slot_i, buf);
    if (!RES) transpose(slot_i, buf);
  };
  ring_loop(nst, p.stages, issue, prep, body);
  __syncthreads();  // the last step's readers are done with the ring

  if (S > 1 && cluster_rank() != (uint32_t)z) __trap();  // the launch's cluster shape
  constexpr int RLD = ExpLayout<V, F, BNT>::RLD;
  int* const red = reinterpret_cast<int*>(ring);
  if (S > 1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(&red[(16 * warp + g + 8 * h) * RLD + nt * 8 + 2 * t4]) =
            make_int2(acc[nt][2 * h], acc[nt][2 * h + 1]);
    cluster_barrier();
    if (z == 0)
      for (int zz = 1; zz < S; ++zz) {
        const uint32_t base = peer(red, (uint32_t)zz);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int2 v = ld_peer2(base + 4 * ((16 * warp + g + 8 * h) * RLD + nt * 8 + 2 * t4));
            acc[nt][2 * h] = (int)((uint32_t)acc[nt][2 * h] + (uint32_t)v.x);
            acc[nt][2 * h + 1] = (int)((uint32_t)acc[nt][2 * h + 1] + (uint32_t)v.y);
          }
      }
  }
  if (z == 0) {
    // local row r -> its logical row: word rows' r = q*4*WR + 4*w + k is
    // row t*tm + q*4*ms + 4*(i0 + w) + k; the others' is m0 + r
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
      int row = EXP_ROWS * y + r;
      if (V != V_INT8 && V != V_ROWRANGE) {
        const int ms = p.tm * F / 32, t = y * WS / ms, i0 = y * WS - t * ms;
        const int q = r / (4 * WS), rem = r % (4 * WS);
        row = t * p.tm + q * 4 * ms + 4 * (i0 + (rem >> 2)) + (rem & 3);
      }
      float* const o = p.out + (size_t)row * p.np + n0 + 2 * t4;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(o + nt * 8) = make_float2((float)acc[nt][2 * h], (float)acc[nt][2 * h + 1]);
    }
  }
  if (S > 1) cluster_barrier();  // no peer still reads this CTA's shared memory
}

template <int V, int F, int BNT>
int launch_exp(const ExpArgs& p, int mp, int splits, cudaStream_t s) {
  auto kern = exp_packmm_kernel<V, F, BNT>;
  const int share = (p.kp / p.depth + splits - 1) / splits;
  const int smem = ExpLayout<V, F, BNT>(p.depth, p.stages, share).bytes();
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.np / BNT, mp / EXP_ROWS, splits);
  cfg.blockDim = dim3(EXP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int V, int F>
int launch_tile(const ExpArgs& p, int mp, int bnt, int splits, cudaStream_t s) {
  switch (bnt) {
    case 16: return launch_exp<V, F, 16>(p, mp, splits, s);
    case 32: return launch_exp<V, F, 32>(p, mp, splits, s);
    case 64: return launch_exp<V, F, 64>(p, mp, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One variant at field width f (V_INT8: any) on column tile bnt.
template <int V>
int launch_fields(const ExpArgs& p, int mp, int f, int bnt, int splits, cudaStream_t s) {
  if constexpr (V == V_INT8) {
    return launch_tile<V, 8>(p, mp, bnt, splits, s);
  } else {
    switch (f) {
      case 1: return launch_tile<V, 1>(p, mp, bnt, splits, s);
      case 2: return launch_tile<V, 2>(p, mp, bnt, splits, s);
      case 4: return launch_tile<V, 4>(p, mp, bnt, splits, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

// Defined in exp_packmm_var.cu (a second translation unit, built in
// parallel): noextract, bres, bres_chunk and rowrange.
int launch_var(const ExpArgs& p, int variant, int mp, int f, int bnt, int splits, cudaStream_t s);

}  // namespace probe
}  // namespace qgtc
