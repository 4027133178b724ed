// The packed-A GEMM probe: one kernel template, one K loop, and the ways
// an M-packed A can reach the tensor cores (benchmarks/exp_packmm.py).
//
// Replaces the TPU experiment benchmarks/exp_packmm.py::make_packmm
// (pallas_call at :236) and make_packmm_packedout (:135): A arrives as
// int32 words [mp / rpw][kp] of f-bit fields (rpw = 32 / f rows per
// word), permuted within each layout tile of tm rows so that row
// q*4*ms + 4*i + k of a tile sits in bits [8k + f*q, 8k + f*(q+1)) of the
// tile's word row i (ms = tm / rpw word rows per tile; 4*ms rows form one
// "slab", the rows of one field q). B is int8 [kp][np]. out = A.B exactly
// in int32, stored as float32 [mp][np]; or (packed out) requantized, as
// gemm_core.cuh's requant with shift 0, and repacked in A's layout into
// int32 words [mp / rpw][np].
//
// Variants (the same product, but noextract):
//   concat      unpack each 64 x 64 A tile into a shared-memory int8 tile,
//               then the MMAs: gemm_core.cuh's PackedLoader, for any tm;
//   slabs       unpack straight into the mma.sync A fragments in registers,
//               no shared A tile: each warp's 32 rows are one field slab,
//               and lane (g, t4) takes bytes 0-3 of word row g as its four
//               rows, so one 16-byte load gives two fragment registers;
//   noextract   concat's loads and stores with byte permutes in place of
//               the shifts and masks: byte k of each word, as a signed
//               int8, for every field q (an ablation: wrong by design,
//               deterministic, checked against its own plain version);
//   int8        an int8 A [mp][kp] of the same logical shape, staged by
//               gemm_core.cuh's Int8Loader (8 / f times the bytes);
//   bres        concat with B held whole in shared memory (kp x BN bytes,
//               loaded once per CTA), not streamed per K step;
//   bres_chunk  bres with the unpack of step k+1 overlapped with the MMAs
//               of step k: the next words are loaded into registers before
//               the MMAs and stored into the other of two A tiles after
//               them (one barrier a step). On the TPU this variant
//               interleaved extract and dot over four sub-K chunks;
//   k2loader    concat with A staged by gemm_core.cuh's PackedLoader itself,
//               which computes each row's word address and shift every K
//               step (concat computes them once): the port's tm = 256
//               layout only. The card's row, not the TPU's: it isolates
//               the address math between concat and K2.
//
// What bounds it on an H100: at M = K = 2560, N = 16 (1-bit) the product
// is 0.2 G operations against 0.9 MB of words: 0.1 us at the int8 peak,
// 0.27 us at the memory rate. The 64-row CTAs make one wave (40 CTAs),
// so each CTA's 40 single-stage K steps, each a load, unpack, barrier and
// 2-16 MMAs a warp, are the time: the probe splits that step.
// Design: 64 x BN tiles (BN = 16 or 64: 4 warps as 2 x 2, each 32 x BN/2),
// BK = 64, int8 mma.sync.m16n8k32 as in gemm_core.cuh; packed output
// ORs each 4-row quad's fields into its word with atomicOr (the words
// start at zero), exact in any CTA order for any tm, since a word gathers
// rows from P slabs that different CTAs own.
#pragma once

#include "gemm_core.cuh"

namespace qgtc {
namespace probe {

enum Variant {
  V_CONCAT = 0,
  V_SLABS = 1,
  V_NOEXTRACT = 2,
  V_BRES = 3,
  V_BRES_CHUNK = 4,
  V_INT8 = 5,
  V_K2LOADER = 6,
};

struct ExpArgs {
  const void* a;    // int32 words [mp / rpw][kp]; V_INT8: int8 [mp][kp]
  const int8_t* b;  // int8 [kp][np]
  void* out;        // float [mp][np]; packed: int32 [mp / rpw][np], zeroed
  int mp, kp, np;
  int tm;        // layout tile (rows)
  int out_bits;  // > 0: requantize to out_bits and repack (V_CONCAT only)
};

// Word row and bit offset of packed row m (F-bit fields, layout tile tm).
template <int F>
__device__ __forceinline__ void row_slot(int m, int tm, int& wrow, int& sh) {
  constexpr int RPW = 32 / F;
  const int ms = tm / RPW, slab = 4 * ms;
  const int t = m / tm, rr = m - t * tm;
  const int q = rr / slab, rem = rr - q * slab;
  wrow = t * ms + (rem >> 2);
  sh = 8 * (rem & 3) + F * q;
}

// Byte k of four consecutive columns' words, by byte permutes only.
__device__ __forceinline__ uint32_t bytes_at(const int4& v, int k) {
  const uint32_t sel = (uint32_t)k | ((uint32_t)(k + 4) << 4);
  const uint32_t lo = __byte_perm((uint32_t)v.x, (uint32_t)v.y, sel);
  const uint32_t hi = __byte_perm((uint32_t)v.z, (uint32_t)v.w, sel);
  return __byte_perm(lo, hi, 0x5410);
}

// concat / noextract: each thread stages 4 columns of rows r0 + 8j,
// j < 8, of the 64-row A tile; the rows' word rows and shifts are fixed
// for the whole K loop, so they are computed once.
template <int F, bool EXTRACT>
struct StagedA {
  static constexpr int NR = BM * (BK / 4) / THREADS;  // 8 rows a thread
  const int32_t* w;
  int kp, r0, kc;
  int wrow[NR], sh[NR];

  // tm = 0: a variant that stages no packed tile (nothing to compute)
  __device__ __forceinline__ StagedA(const int32_t* w_, int kp_, int m0,
                                     int tm, int tid)
      : w(w_), kp(kp_), r0(tid / (BK / 4)), kc((tid % (BK / 4)) * 4) {
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      wrow[j] = sh[j] = 0;
      if (tm > 0) row_slot<F>(m0 + r0 + 8 * j, tm, wrow[j], sh[j]);
    }
  }
  __device__ __forceinline__ void fetch(int4 (&v)[NR], int k0) const {
#pragma unroll
    for (int j = 0; j < NR; ++j)
      v[j] = __ldg(reinterpret_cast<const int4*>(w + (size_t)wrow[j] * kp + k0 + kc));
  }
  __device__ __forceinline__ void store(int8_t (*As)[LDS], const int4 (&v)[NR]) const {
#pragma unroll
    for (int j = 0; j < NR; ++j)
      *reinterpret_cast<uint32_t*>(&As[r0 + 8 * j][kc]) =
          EXTRACT ? fields<F>(v[j], sh[j]) : bytes_at(v[j], sh[j] >> 3);
  }
};

// BK rows of B's columns [n0, n0 + BNT), transposed into Bs[n * ldb + kd + k].
template <int BNT>
__device__ __forceinline__ void load_b_cols(int8_t* Bs, int ldb, int kd,
                                            const int8_t* __restrict__ b,
                                            int np, int k0, int n0, int tid) {
  constexpr int CH = BNT / 16;
  for (int c = tid; c < BK * CH; c += THREADS) {
    const int k = c / CH, nc = (c % CH) * 16;
    const int4 v = __ldg(reinterpret_cast<const int4*>(b + (size_t)(k0 + k) * np + n0 + nc));
    const int8_t* bytes = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int j = 0; j < 16; ++j) Bs[(nc + j) * ldb + kd + k] = bytes[j];
  }
}

template <int V, bool PIPE>
__host__ __device__ constexpr int a_tiles() {
  return V == V_SLABS ? 0 : (PIPE ? 2 : 1);
}

// Dynamic shared memory of one CTA: the A tile(s), then B.
template <int V, int NT>
inline size_t smem_bytes(int kp) {
  constexpr bool RES = V == V_BRES || V == V_BRES_CHUNK;
  constexpr int A = a_tiles<V, V == V_BRES_CHUNK>() * BM * LDS;
  const size_t b = (size_t)16 * NT * (RES ? kp + 16 : LDS);
  const size_t stage = (size_t)BM * 16 * NT;  // packed out's levels
  return (size_t)A + b > stage ? (size_t)A + b : stage;
}

template <int V, int F, int NT, bool PACK>
__global__ void __launch_bounds__(THREADS) exp_packmm_kernel(const ExpArgs p) {
  constexpr int BNT = 16 * NT;
  constexpr bool RES = V == V_BRES || V == V_BRES_CHUNK;
  constexpr bool PIPE = V == V_BRES_CHUNK;
  constexpr bool SLABS = V == V_SLABS;
  static_assert(!PACK || V == V_CONCAT, "packed out runs the concat path");
  extern __shared__ __align__(16) int8_t smem[];
  int8_t(*As)[BM][LDS] = reinterpret_cast<int8_t(*)[BM][LDS]>(smem);
  int8_t* const Bs = smem + a_tiles<V, PIPE>() * BM * LDS;
  const int ldb = RES ? p.kp + 16 : LDS;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * (BNT / 2);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BNT;

  int acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  if (RES) {  // the CTA's columns of all of B, once
    for (int k0 = 0; k0 < p.kp; k0 += BK)
      load_b_cols<BNT>(Bs, ldb, k0, p.b, p.np, k0, n0, tid);
    __syncthreads();
  }

  // slabs: this lane's word row (rows 4g .. 4g + 3 of the warp) and field
  int s_wrow = 0, s_sh = 0;
  if (SLABS) row_slot<F>(m0 + wm + 4 * g, p.tm, s_wrow, s_sh);
  const int32_t* const words = static_cast<const int32_t*>(p.a);
  const StagedA<F, V != V_NOEXTRACT> sa(
      words, p.kp, m0, SLABS || V == V_INT8 || V == V_K2LOADER ? 0 : p.tm, tid);

  // the MMAs of one BK step from A tile At (or, for slabs, the words)
  // and B columns at kb
  auto mma_step = [&](int8_t(*At)[LDS], int k0, int kb) {
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4], bf[NT][2];
      if (SLABS) {
        const int32_t* wp = words + (size_t)s_wrow * p.kp + k0 + ks + t4 * 4;
        const int4 lo = __ldg(reinterpret_cast<const int4*>(wp));
        const int4 hi = __ldg(reinterpret_cast<const int4*>(wp + 16));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {  // fragment row g + 8h: byte 2mt + h
          af[mt][0] = fields<F>(lo, 8 * (2 * mt) + s_sh);
          af[mt][1] = fields<F>(lo, 8 * (2 * mt + 1) + s_sh);
          af[mt][2] = fields<F>(hi, 8 * (2 * mt) + s_sh);
          af[mt][3] = fields<F>(hi, 8 * (2 * mt + 1) + s_sh);
        }
      } else {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) frag_a(af[mt], &At[wm + mt * 16 + g][ks + t4 * 4]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) frag_b(bf[nt], Bs + (wn + nt * 8 + g) * ldb + kb + ks + t4 * 4);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
  };

  if (PIPE) {
    int4 v[StagedA<F, true>::NR];
    sa.fetch(v, 0);
    sa.store(As[0], v);
    __syncthreads();
    const int steps = p.kp / BK;
    for (int s = 0; s < steps; ++s) {
      const bool more = s + 1 < steps;
      if (more) sa.fetch(v, (s + 1) * BK);  // in flight during the MMAs
      mma_step(As[s & 1], s * BK, s * BK);
      if (more) sa.store(As[(s + 1) & 1], v);
      __syncthreads();
    }
  } else {
    for (int k0 = 0; k0 < p.kp; k0 += BK) {
      if constexpr (V == V_INT8) {
        const Int8Loader la{static_cast<const int8_t*>(p.a), p.mp, p.kp};
        la.template load<1, BM>(As, m0, k0, tid);
      } else if constexpr (V == V_K2LOADER) {
        const PackedLoader<F> la{words, p.kp};
        la.template load<1, BM>(As, m0, k0, tid);
      } else if (!SLABS) {
        int4 v[StagedA<F, true>::NR];
        sa.fetch(v, k0);
        sa.store(As[0], v);
      }
      if (!RES) load_b_cols<BNT>(Bs, ldb, 0, p.b, p.np, k0, n0, tid);
      __syncthreads();
      mma_step(As[0], k0, RES ? k0 : 0);
      __syncthreads();
    }
  }

  // acc[mt][nt][2h + j]: fragment row g + 8h of m-tile mt, column
  // wn + nt*8 + 2*t4 + j; slabs put the warp's row 4g + 2mt + h there
  auto row_of = [&](int mt, int h) {
    return SLABS ? wm + 4 * g + 2 * mt + h : wm + mt * 16 + g + 8 * h;
  };
  if (!PACK) {
    float* const out = static_cast<float*>(p.out);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + row_of(mt, h), col = n0 + wn + nt * 8 + 2 * t4;
          *reinterpret_cast<float2*>(out + (size_t)row * p.np + col) =
              make_float2((float)acc[mt][nt][2 * h], (float)acc[mt][nt][2 * h + 1]);
        }
    return;
  }
  // packed out: levels [BM][BNT] in shared memory (free after the loop's
  // last barrier), then each quad of rows 4i .. 4i + 3 (one word row,
  // bytes 0-3, one field) ORed into its words
  uint8_t* const stage = reinterpret_cast<uint8_t*>(smem);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          stage[row_of(mt, h) * BNT + wn + nt * 8 + 2 * t4 + j] =
              (uint8_t)requant(acc[mt][nt][2 * h + j], p.out_bits, 0);
  __syncthreads();
  int32_t* const out = static_cast<int32_t*>(p.out);
  for (int it = tid; it < (BM / 4) * BNT; it += THREADS) {
    const int quad = it / BNT, n = it % BNT;
    int wrow, sh;
    row_slot<F>(m0 + 4 * quad, p.tm, wrow, sh);
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) word |= (uint32_t)stage[(4 * quad + k) * BNT + n] << (8 * k + sh);
    atomicOr(reinterpret_cast<unsigned int*>(out + (size_t)wrow * p.np + n0 + n), word);
  }
}

template <int V, int F, int NT, bool PACK>
int launch_exp(const ExpArgs& p, cudaStream_t s) {
  auto kern = exp_packmm_kernel<V, F, NT, PACK>;
  const size_t smem = smem_bytes<V, NT>(p.kp);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.np / (16 * NT), p.mp / BM);
  kern<<<grid, THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// One variant at field width f (V_INT8: any) and column tile 16 * nt.
template <int V, bool PACK = false>
int launch_fields(const ExpArgs& p, int f, int nt, cudaStream_t s) {
  if (nt != 1 && nt != 4) return (int)cudaErrorInvalidValue;
  if constexpr (V == V_INT8) {
    return nt == 1 ? launch_exp<V, 8, 1, PACK>(p, s) : launch_exp<V, 8, 4, PACK>(p, s);
  } else {
    switch (f) {
      case 1: return nt == 1 ? launch_exp<V, 1, 1, PACK>(p, s) : launch_exp<V, 1, 4, PACK>(p, s);
      case 2: return nt == 1 ? launch_exp<V, 2, 1, PACK>(p, s) : launch_exp<V, 2, 4, PACK>(p, s);
      case 4: return nt == 1 ? launch_exp<V, 4, 1, PACK>(p, s) : launch_exp<V, 4, 4, PACK>(p, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

// Defined in exp_packmm_var.cu (a second translation unit, built in
// parallel): slabs, bres, bres_chunk and k2loader.
int launch_var(const ExpArgs& p, int variant, int f, int nt, cudaStream_t s);

}  // namespace probe
}  // namespace qgtc
