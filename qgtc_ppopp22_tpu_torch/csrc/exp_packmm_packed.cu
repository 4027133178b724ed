// P1b, the packed-A GEMM probe's packed output, from CTAs that own whole
// word rows (benchmarks/exp_packmm.py packmm_exp_packedout).
//
// Replaces the TPU experiment benchmarks/exp_packmm.py::
// make_packmm_packedout (:60, pallas_call at :135): A arrives as int32
// words [mp / rpw][kp] of f-bit fields (rpw = 32 / f rows per word) in the
// layout of tile g (exp_packmm.cuh: row q*4*ms + 4*i + k of a tile sits in
// bits [8k + f*q, 8k + f*(q+1)) of the tile's word row i, ms = g / rpw);
// B is int8 [kp][np]. The output is the product requantized (gemm_core.cuh
// requant, shift 0) to out_bits and repacked in the same layout: int32
// words [mp / rpw][np], every word written once.
//
// A CTA owns WR = 64 / rpw = 2 f consecutive word rows of one layout tile
// (2, 4 or 8 at 1, 2 or 4 bits; ms is a multiple of WR for any g that is
// a multiple of 64): the 64 logical rows t*g + q*4*ms + 4*(i0 + w) + k,
// q < 8 / f, w < WR, k < 4, whose fields those words hold, in the local
// order q*4*WR + 4*w + k (exp_packmm.word_row_ctas mirrors the map). So
// the CTA reads each of its words once, and its output words hold only its
// own rows: it packs them itself, with no cluster across row tiles and no
// atomics. K2 (packmm_k2.cuh) instead gives a 64-row CTA a row range of a
// 256-row group: it copies the 8 or 16 word rows that hold its rows, of
// which it uses 2 of 8 fields (1-bit), 1 of 4 (2-bit) or 1 of 2 (4-bit),
// and the group's four CTAs assemble each output word across a cluster;
// timing the two at the same shapes reads what that choice costs.
//
// The design (K2's and K1's mechanics):
//   * a cp.async.cg ring of 3 or 4 slots (probe_ring.cuh) brings each K
//     step's WR word rows and B's [k][n] tile, stages - 2 steps ahead, one
//     barrier a step, every word chunk's offsets fixed before the loop; a
//     step is 64, 128 or 256 columns deep (K1's stage depths), since a
//     step's barrier and the latency of its chain of loads, byte permutes
//     and MMAs cost more than its few MMAs;
//   * A's fragments are built from the words in the slot, as K1 builds
//     its adjacency's (fused_model_k1.cuh): four warps of 16 rows; lane
//     (g, t4) loads 4 columns' words of its rows g and g + 8, gathers byte
//     k of each (byte permutes) and shifts field q down. Each fragment
//     register is used by one warp only (each warp owns all BNT columns),
//     so this extracts each field once, as an unpack into an int8 tile
//     would, without the tile's stores, its ldmatrix loads and its second
//     buffer. The rows' word-row offsets, bytes and fields are computed
//     once, before the loop;
//   * B is transposed by 4 x 4 byte blocks into [n][k] (two buffers) and
//     its fragments loaded with ldmatrix; int8 mma.sync.m16n8k32;
//   * the column tile BNT (16, 32 or 64) fits N; split-K: the S CTAs of a
//     (1, 1, S) cluster take contiguous shares of the K steps, and rank 0
//     adds the others' sums through distributed shared memory (they wrap
//     modulo 2^32, so the order does not matter), then requantizes the
//     64 x BNT levels into shared memory and stores its WR x BNT words
//     whole (exp_packmm.packedout_plan sizes BNT and S).
// What bounds it on an H100: the words and B read once and the words
// written once (2.17 MB at 1-bit A[4096^2] x B[4096 x 16]: 0.65 us at the
// memory rate; its 0.54 G operations take 0.27 us at the int8 peak). With
// 64 row CTAs there, the split fills the SMs; a CTA's steps are a few
// MMAs each, so a step's fixed latency and the launch are what is left.
// Measured (one H100 80GB HBM3 at 700 W, benchmarks/gemm_times.py
// --probes-only): 10.9-11.0 us at that row (256-column steps, S 4),
// against 22.1-22.8 for K2's packed route at the same shape.
#include "probe_ring.cuh"

using namespace qgtc;
using namespace qgtc::probe;

namespace {

constexpr int ROWS = 64;      // logical rows a CTA owns
constexpr int NTHR = 128;     // 4 warps of 16 rows
constexpr int MAX_SPLIT = 8;  // a portable cluster

struct Args {
  const int32_t* a;  // words [mp / rpw][kp], layout tile g
  const int8_t* b;   // [kp][np]
  int32_t* out;      // words [mp / rpw][np]
  int kp, np, out_bits, stages, depth;
};

// Shared memory (bytes) at a K step of `depth` (64, 128 or 256) columns:
// two transposed B tiles [BNT][depth + 16], then the ring, whose room the
// split-K partial sums and the levels take after the loop. A slot holds
// the step's WR word rows, 4 depth + 64 bytes apart (a warp's two word
// rows land in distinct banks), then B's [depth][BNT] rows.
// exp_packmm.packedout_smem takes the same sums.
template <int F, int BNT>
struct Layout {
  static constexpr int WR = 2 * F;  // word rows that hold 64 rows
  static constexpr int RLD = BNT + 4;  // partial sums [ROWS][RLD] int32
  static constexpr int RED = ROWS * RLD * 4;
  static constexpr int SLD = ROWS + 4;  // levels [BNT][SLD] bytes
  static constexpr int STG = BNT * SLD;
  int a_ld, a_raw, slot, bld, bt;
  __host__ __device__ explicit Layout(int depth)
      : a_ld(4 * depth + 64), a_raw(WR * a_ld), slot(a_raw + depth * BNT), bld(depth + 16),
        bt(BNT * bld) {}
  __host__ __device__ int bytes(int stages) const {
    return 2 * bt + (stages * slot > RED + STG ? stages * slot : RED + STG);
  }
  static_assert(RED % 16 == 0, "16-byte parts");
};

// gridDim = (np / BNT, mp / 64, S); cluster (1, 1, S).
template <int F, int BNT>
__global__ void __launch_bounds__(NTHR) packedout_kernel(const Args p) {
  const Layout<F, BNT> L(p.depth);
  constexpr int WR = Layout<F, BNT>::WR, NT = BNT / 8, P = 8 / F;
  constexpr int RLD = Layout<F, BNT>::RLD, RED = Layout<F, BNT>::RED, SLD = Layout<F, BNT>::SLD;
  constexpr uint32_t MREP = ((1u << F) - 1) * 0x01010101u;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* const bt = reinterpret_cast<int8_t*>(smem);  // [2][BNT][bld]
  unsigned char* const ring = smem + 2 * L.bt;
  const uint32_t ring_u = smem_u32(ring), bt_u = smem_u32(bt);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * BNT, wrow0 = blockIdx.y * WR;
  const int S = gridDim.z, z = blockIdx.z, d = p.depth;
  const int all = p.kp / d, share = (all + S - 1) / S;
  const int first = min(z * share, all), nst = min(all - first, share);
  const int32_t* const abase = p.a + (size_t)wrow0 * p.kp + (size_t)first * d;
  const int8_t* const bbase = p.b + (size_t)first * d * p.np + n0;

  // this lane's rows 16 warp + g and + 8 (fragment rows g, g + 8): local
  // row r = q*4*WR + 4*w + k is field q of byte k of word row w
  int aoff[2], qsh[2];
  uint32_t sel[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h, q = r / (4 * WR), rem = r % (4 * WR), kb = rem & 3;
    aoff[h] = (rem >> 2) * L.a_ld + 16 * t4;
    qsh[h] = F * q;
    sel[h] = (uint32_t)kb | ((uint32_t)(kb + 4) << 4);
  }

  // this thread's 16-byte chunks of the step's words (word row wr,
  // columns kc ..), fixed for the loop (-1: none), so the step loop
  // divides nothing
  constexpr int AN = 2 * F * (256 / 4) / NTHR;  // the most a thread takes (256-column steps)
  int a_dst[AN], a_src[AN];
#pragma unroll
  for (int u = 0; u < AN; ++u) {
    const int c = tid + u * NTHR, wr = c / (d / 4), kc = (c - wr * (d / 4)) * 4;
    a_dst[u] = c < WR * (d / 4) ? wr * L.a_ld + 4 * kc : -1;
    a_src[u] = wr * p.kp + kc;
  }

  auto issue = [&](int i, int slot_i) {
    const uint32_t slot = ring_u + slot_i * L.slot;
    const int k0 = i * d;
#pragma unroll
    for (int u = 0; u < AN; ++u)
      if (a_dst[u] >= 0) cp_async16_u(slot + a_dst[u], abase + a_src[u] + k0);
    constexpr int CH = BNT / 16;
    for (int c = tid; c < d * CH; c += NTHR) {
      const int k = c / CH, nc = (c % CH) * 16;
      cp_async16_u(slot + L.a_raw + k * BNT + nc, bbase + (size_t)(k0 + k) * p.np + nc);
    }
  };
  // B's [k][n] rows in slot_i -> transposed tile buf, [n][k]
  auto transpose = [&](int slot_i, int buf) {
    const unsigned char* const rb = ring + slot_i * L.slot + L.a_raw;
    constexpr int NQ = BNT / 4;
    for (int blk = tid; blk < (d / 4) * NQ; blk += NTHR) {
      const int kq = blk / NQ, nq = blk - kq * NQ;
      const unsigned char* src = rb + 4 * kq * BNT + 4 * nq;
      transpose4(bt + buf * L.bt + 4 * nq * L.bld + 4 * kq, L.bld, *reinterpret_cast<const uint32_t*>(src),
                 *reinterpret_cast<const uint32_t*>(src + BNT),
                 *reinterpret_cast<const uint32_t*>(src + 2 * BNT),
                 *reinterpret_cast<const uint32_t*>(src + 3 * BNT));
    }
  };

  int acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
  // 4 columns' words -> the 4 fields of row h, one byte a column
  auto frag = [&](const unsigned char* w, int h) {
    const int4 v = *reinterpret_cast<const int4*>(w + aoff[h]);
    const uint32_t lo = __byte_perm((uint32_t)v.x, (uint32_t)v.y, sel[h]);
    const uint32_t hi = __byte_perm((uint32_t)v.z, (uint32_t)v.w, sel[h]);
    return (__byte_perm(lo, hi, 0x5410) >> qsh[h]) & MREP;
  };
  const int bn = (lane & 7) + (lane >> 4) * 8, bk = ((lane >> 3) & 1) * 16;
  auto body = [&](int, int slot_i, int buf) {
    const unsigned char* const raw = ring + slot_i * L.slot;
    const uint32_t b_u = bt_u + buf * L.bt + bn * L.bld + bk;
#pragma unroll 2
    for (int ks = 0; ks < d; ks += 32) {
      uint32_t af[4];  // rows g, g + 8 at k 4 t4 ..; then at k 16 + 4 t4 ..
      af[0] = frag(raw + 4 * ks, 0);
      af[1] = frag(raw + 4 * ks, 1);
      af[2] = frag(raw + 4 * ks + 64, 0);
      af[3] = frag(raw + 4 * ks + 64, 1);
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
  ring_loop(nst, p.stages, issue, transpose, body);
  __syncthreads();  // the last step's readers are done with the ring

  if (S > 1 && cluster_rank() != (uint32_t)z) __trap();  // the launch's cluster shape
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
    // levels [BNT][SLD]: rows 4 w .. 4 w + 3 of field q, one word's bytes
    uint8_t* const stage = reinterpret_cast<uint8_t*>(ring + RED);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        stage[(nt * 8 + 2 * t4 + (i & 1)) * SLD + 16 * warp + g + 8 * (i >> 1)] =
            (uint8_t)requant(acc[nt][i], p.out_bits, 0);
    __syncthreads();
    for (int w = tid; w < WR * BNT; w += NTHR) {
      const int wl = w / BNT, n = w - wl * BNT;
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < P; ++q)
        word |= *reinterpret_cast<const uint32_t*>(stage + n * SLD + q * 4 * WR + 4 * wl) << (F * q);
      p.out[(size_t)(wrow0 + wl) * p.np + n0 + n] = (int32_t)word;
    }
  }
  if (S > 1) cluster_barrier();  // no peer still reads this CTA's shared memory
}

template <int F, int BNT>
int launch(const Args& p, int mp, int splits, cudaStream_t s) {
  auto kern = packedout_kernel<F, BNT>;
  const int smem = Layout<F, BNT>(p.depth).bytes(p.stages);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.np / BNT, mp / ROWS, splits);
  cfg.blockDim = dim3(NTHR);
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

template <int F>
int launch_tile(const Args& p, int mp, int bnt, int splits, cudaStream_t s) {
  switch (bnt) {
    case 16: return launch<F, 16>(p, mp, splits, s);
    case 32: return launch<F, 32>(p, mp, splits, s);
    case 64: return launch<F, 64>(p, mp, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a: int32 words [mp / (32 / field_bits)][kp] in the layout of tile g; b:
// int8 [kp][np]; out: int32 words [mp / (32 / field_bits)][np], written
// whole; out_bits 1-4 packed into fields of field_bits (1, 2 or 4);
// exp_packmm.packedout_plan's column tile bnt, split, ring depth and K
// step. Refused: what the plan refuses (mp % g, g % 256, kp % depth or np
// % bnt not 0; a step other than 64, 128 or 256 columns; a split beyond 8
// or the K steps; a ring other than 3 or 4 slots; more than 227 KB of
// shared memory).
extern "C" int qgtc_exp_packedout(void* out, const void* a, const void* b, int field_bits,
                                  int out_bits, int mp, int kp, int np, int g, int bnt, int splits,
                                  int stages, int depth, void* stream) {
  const int f = field_bits;
  if ((f != 1 && f != 2 && f != 4) || out_bits < 1 || out_bits > 4 ||
      (out_bits <= 2 ? out_bits : 4) != f)
    return (int)cudaErrorInvalidValue;
  if (mp <= 0 || g <= 0 || g % 256 || mp % g || (depth != 64 && depth != 128 && depth != 256) ||
      kp <= 0 || kp % depth || np <= 0 || (bnt != 16 && bnt != 32 && bnt != 64) || np % bnt ||
      splits < 1 || splits > MAX_SPLIT || splits > kp / depth || (stages != 3 && stages != 4))
    return (int)cudaErrorInvalidValue;
  const Args p{static_cast<const int32_t*>(a), static_cast<const int8_t*>(b), static_cast<int32_t*>(out),
               kp, np, out_bits, stages, depth};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (f) {
    case 1: return launch_tile<1>(p, mp, bnt, splits, s);
    case 2: return launch_tile<2>(p, mp, bnt, splits, s);
    default: return launch_tile<4>(p, mp, bnt, splits, s);
  }
}
