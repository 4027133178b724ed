// grid_overhead: the fixed costs of fused_model's (K1's) launch geometry.
//
// Replaces the TPU ladder kernels of benchmarks/grid_overhead_study.py:
// zero_body (kernel :83, pallas_call :85) and kdot (:109, :123), which
// split the mega kernel's per-grid-step cost on the TPU. Both run K1's
// geometry (ops/fused_model.py fused_model_plan's default rule, restated
// by the port's benchmarks/grid_overhead_study.py kdot_plan): one
// thread-block cluster of cl CTAs per batch (per G batches for zero_body),
// CTAs of RT = 128 rows (64 where 128 do not divide pn) and RT / 16 warps
// of 16 rows, CTA r owning the row tiles r, r + cl, ... of its batch.
//   zero_body  reads each of its tiles of X (int8 [B][pn][xp]) into shared
//              memory, with volatile stores so that the reads stay, and
//              writes zeros to the tile's rows of out (float [B][pn][oc]);
//   kdot       out[b] = (sum over k < K of S . roll(x[b], k))[:, :oc] as
//              float, with S int8 [pn][pn] and roll along the 128 columns
//              as jnp.roll (column j of x[b] moves to column (j + k) mod 128).
//
// kdot is K1's aggregation loop (fused_model_k1.cuh) with S for the
// adjacency and x[b] for the hidden plane:
//   * one stream of 64-deep K steps over all of a CTA's row tiles through
//     a cp.async.cg ring of 3 or 4 slots (probe_ring.cuh: issued stages - 2
//     steps ahead, one barrier a step); a slot holds S's [RT][64] tile and
//     x[b]'s 64 K rows [64][128], the rows 144 bytes apart so that the
//     transpose's 4-row reads spread over the banks; every per-thread
//     offset is fixed before the loop, which divides nothing (as K1's);
//   * a step stages and transposes only the columns some pass reads: the
//     window of 4-column blocks that the C entry computes (window(), which
//     grid_overhead_study.xt_window mirrors: the output's columns and the
//     K - 1 before them; at K 0 those of one pass, so that the fixed cost
//     of a step is the same at every K); its 16-column chunks of x's rows are copied, and the
//     window is transposed once a step into Xt [128][k] by 4 x 4 byte
//     blocks (two buffers: step j + 1's transpose runs after step j's
//     MMAs, beside their tail);
//   * the K passes share the staged tiles: a step's A fragments (ldmatrix
//     of S's tile) are loaded once and every pass runs its MMAs on them, so
//     a step costs t_fixed + K t_dot, the ladder the study reads; the TPU's
//     K dots reused their VMEM-resident operands the same way;
//   * the roll is an address: pass k reads output column j's B fragment
//     from Xt row (j - k) mod 128, each lane's ldmatrix row address
//     (grid_overhead_study.roll_column); no rolled copy is made. Rows
//     consecutive mod 128 keep ldmatrix's 8 rows in distinct banks;
//   * round_up(oc, 16) columns are computed (NP pairs of 8-column n-tiles,
//     a template parameter, so that a pass's loads and MMAs unroll whole),
//     int8 mma.sync.m16n8k32 as in K1 (2 MMAs per ldmatrix of B), every
//     pass into the same sums; the A fragments of a step load once.
// What bounds it on an H100: 2 B K pn^2 oc operations (40.3 G at the
// study's pn 2048, B 50, K 2, oc 48: 20.35 us at 1979 TOP/s, 41.6 us at
// the 966-970 TOP/s torch._int_mm reaches on the card). Beyond that, every
// row tile reads S's rows and x[b]'s window from L2 again: B pn^2 (1 +
// 128 / RT) bytes when the window is all 128 columns, 419 MB at that row,
// 315 MB at oc 48 (the HBM bound counts 4.2 MB of S and 26 MB of x once),
// and every 16-row warp loads each B fragment for 2 MMAs, as K1's does.
// Measured (one H100 80GB HBM3 at 700 W; benchmarks/gemm_times.py
// --probes-only [--plans], benchmarks/probe_trace.py): a step's fixed cost
// is that L2 traffic at ~3.4-3.5 TB/s (K 0: 92 us at oc 48, 67 at oc 8),
// and a pass 26-37 us for 20 G operations.
// zero_body moves B pn (xp + 4 oc) bytes (35.7 MB at pn 2048, 50 batches,
// oc 48: 11 us at the memory rate).
#include "probe_ring.cuh"

using namespace qgtc;
using namespace qgtc::probe;

namespace {

constexpr int MAX_CLUSTER = 8;  // fused_model_k1.cuh MAX_CLUSTER
constexpr int XCOLS = 128;      // kdot's x width (the roll's period)
constexpr int KD = 64;          // kdot's K step
constexpr int TLD = KD + 16;    // row stride of S's tile and of Xt (ldmatrix rows in distinct banks)
constexpr int XLD = XCOLS + 16;  // row stride of x's rows in a slot (the transpose's reads of 4
                                 // rows spread over the banks)

struct ZeroArgs {
  const int8_t* x;  // [B][pn][xp]
  float* out;       // [B][pn][oc]
  int pn, xp, oc, G, cl;
};

struct KdotArgs {
  const int8_t* x;  // [B][pn][128]
  const int8_t* s;  // [pn][pn]
  float* out;       // [B][pn][oc]
  int pn, oc, K, cl, stages;
  int blk0, nblk;  // Xt's window (window()): 4-column blocks blk0, blk0 + 1, ... mod 32
};

// kdot's shared memory: the ring's slots (S's tile, then x's rows), then
// the two Xt buffers; grid_overhead_study.kdot_smem takes the same sums.
template <int RT>
struct KdotLayout {
  static constexpr int S_BYTES = RT * TLD;
  static constexpr int SLOT = S_BYTES + KD * XLD;
  static constexpr int XT = XCOLS * TLD;
  static constexpr int bytes(int stages) { return stages * SLOT + 2 * XT; }
};

// Rows [r0, r0 + RT) of one batch's X into shared memory; the volatile
// stores keep the loads.
template <int RT>
__device__ __forceinline__ void read_x_tile(int8_t* xs, const int8_t* __restrict__ x, int xp,
                                            int tid) {
  const int4* src = reinterpret_cast<const int4*>(x);
  for (int i = tid; i < RT * xp / 16; i += 2 * RT) {
    const int4 v = __ldg(src + i);
    const unsigned addr = (unsigned)__cvta_generic_to_shared(xs + 16 * i);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x),
                 "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
  }
}

template <int RT>
__global__ void __launch_bounds__(2 * RT) zero_body_kernel(const ZeroArgs p) {
  __shared__ __align__(16) int8_t xs[RT * XCOLS];
  const int c = blockIdx.x / p.cl, r = blockIdx.x % p.cl, tid = threadIdx.x;
  const int tiles = p.pn / RT;
  for (int b = c * p.G; b < (c + 1) * p.G; ++b)
    for (int t = r; t < tiles; t += p.cl) {
      const size_t row0 = (size_t)b * p.pn + (size_t)t * RT;
      read_x_tile<RT>(xs, p.x + row0 * p.xp, p.xp, tid);
      float4* dst = reinterpret_cast<float4*>(p.out + row0 * p.oc);
      for (int i = tid; i < RT * p.oc / 4; i += 2 * RT) dst[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// NP: pairs of 8-column n-tiles computed (16 NP >= round_up(oc, 8)), so
// a pass's ldmatrix loads and MMAs unroll whole and issue together.
template <int RT, int NP>
__global__ void __launch_bounds__(2 * RT, 2) kdot_kernel(const KdotArgs p) {
  using L = KdotLayout<RT>;
  constexpr int NTHR = 2 * RT, SN = RT * (KD / 16) / NTHR;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t ring_u = smem_u32(smem);
  unsigned char* const xt = smem + p.stages * L::SLOT;
  const uint32_t xt_u = smem_u32(xt);
  const int b = blockIdx.x / p.cl, rank = blockIdx.x % p.cl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int8_t* const xb = p.x + (size_t)b * p.pn * XCOLS;
  const int spt = p.pn / KD;  // steps a row tile
  const int total = (p.pn / RT - rank + p.cl - 1) / p.cl * spt;

  // Every per-thread offset is fixed for the whole loop, so the step loop
  // divides nothing: this thread's 16-byte chunks of S's tile (row r,
  // bytes kc ..), of x's K rows (the 16-column chunks c0, c0 + 1, ... mod
  // 8 that hold the window), and its 4 x 4 blocks of the window to
  // transpose (x's rows 4 kq .., columns 4 nq ..; -1: none).
  constexpr int XN = KD * XCOLS / 16 / NTHR;  // the most chunks, or blocks, a thread takes
  int s_dst[SN], x_dst[XN], x_src[XN], t_src[XN], t_dst[XN];
  size_t s_src[SN];
#pragma unroll
  for (int u = 0; u < SN; ++u) {
    const int c = tid + u * NTHR, r = c >> 2, kc = (c & 3) * 16;
    s_dst[u] = r * TLD + kc;
    s_src[u] = (size_t)r * p.pn + kc;
  }
  const int c0 = p.blk0 / 4, nch = min(XCOLS / 16, (p.blk0 + p.nblk - 1) / 4 - c0 + 1);
#pragma unroll
  for (int u = 0; u < XN; ++u) {
    const int c = tid + u * NTHR, r = c / nch, kq = c / max(p.nblk, 1);
    const int cc = 16 * ((c0 + c - r * nch) & (XCOLS / 16 - 1));
    x_dst[u] = c < KD * nch ? r * XLD + cc : -1;
    x_src[u] = r * XCOLS + cc;
    const int nq = (p.blk0 + c - kq * p.nblk) & (XCOLS / 4 - 1);
    t_src[u] = c < (KD / 4) * p.nblk ? 4 * kq * XLD + 4 * nq : -1;
    t_dst[u] = 4 * nq * TLD + 4 * kq;
  }

  // step i's copies: S's rows of the tile im0, x's K rows ik0 ..
  int im0 = rank * RT, ik0 = 0;
  auto issue = [&](int, int slot_i) {
    const uint32_t slot = ring_u + slot_i * L::SLOT;
    const int8_t* const sg = p.s + (size_t)im0 * p.pn + ik0;
#pragma unroll
    for (int u = 0; u < SN; ++u) cp_async16_u(slot + s_dst[u], sg + s_src[u]);
    const int8_t* const xr = xb + (size_t)ik0 * XCOLS;
#pragma unroll
    for (int u = 0; u < XN; ++u)
      if (x_dst[u] >= 0) cp_async16_u(slot + L::S_BYTES + x_dst[u], xr + x_src[u]);
    if ((ik0 += KD) == p.pn) {
      ik0 = 0;
      im0 += p.cl * RT;
    }
  };
  // the window's columns of x's rows in slot_i -> Xt buffer buf, [n][k]
  auto transpose = [&](int slot_i, int buf) {
    const unsigned char* const xr = smem + slot_i * L::SLOT + L::S_BYTES;
    int8_t* const dst = reinterpret_cast<int8_t*>(xt + buf * L::XT);
#pragma unroll
    for (int u = 0; u < XN; ++u)
      if (t_src[u] >= 0) {
        const unsigned char* src = xr + t_src[u];
        transpose4(dst + t_dst[u], TLD, *reinterpret_cast<const uint32_t*>(src),
                   *reinterpret_cast<const uint32_t*>(src + XLD),
                   *reinterpret_cast<const uint32_t*>(src + 2 * XLD),
                   *reinterpret_cast<const uint32_t*>(src + 3 * XLD));
      }
  };

  int acc[2 * NP][4];
  auto zero = [&]() {
#pragma unroll
    for (int nt = 0; nt < 2 * NP; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0;
  };
  zero();
  // ldmatrix row addresses: A (this warp's 16 rows of S's tile) and B
  // (Xt rows n, before the roll)
  const int wrow = 16 * warp;
  const int a_off = (wrow + (lane & 7) + ((lane >> 3) & 1) * 8) * TLD + (lane >> 4) * 16;
  const int bn = (lane & 7) + (lane >> 4) * 8, bk = ((lane >> 3) & 1) * 16;
  const bool even = (p.oc & 1) == 0;
  int om0 = rank * RT, ostep = 0;  // the tile whose sums are in acc, its steps so far
  auto body = [&](int, int slot_i, int buf) {
    const uint32_t s_u = ring_u + slot_i * L::SLOT + a_off, x_u = xt_u + buf * L::XT + bk;
    uint32_t af[2][4];  // the step's A fragments, for every pass
    ldsm4_u(af[0], s_u);
    ldsm4_u(af[1], s_u + 32);
#pragma unroll 2
    for (int k = 0; k < p.K; ++k)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t bf[NP][4];
#pragma unroll
        for (int pr = 0; pr < NP; ++pr) ldsm4_u(bf[pr], x_u + ((16 * pr + bn - k) & (XCOLS - 1)) * TLD + 32 * ks);
#pragma unroll
        for (int pr = 0; pr < NP; ++pr) {
          const uint32_t b0[2] = {bf[pr][0], bf[pr][1]}, b1[2] = {bf[pr][2], bf[pr][3]};
          mma_s8(acc[2 * pr], af[ks], b0);
          mma_s8(acc[2 * pr + 1], af[ks], b1);
        }
      }
    if (++ostep == spt) {  // the tile's last step: its rows out
      float* const o = p.out + ((size_t)b * p.pn + om0 + wrow + g) * p.oc;
#pragma unroll
      for (int nt = 0; nt < 2 * NP; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = nt * 8 + 2 * t4;
          float* const d = o + h * 8 * p.oc + col;
          if (even && col < p.oc) {
            *reinterpret_cast<float2*>(d) = make_float2((float)acc[nt][2 * h], (float)acc[nt][2 * h + 1]);
          } else if (!even) {
            if (col < p.oc) d[0] = (float)acc[nt][2 * h];
            if (col + 1 < p.oc) d[1] = (float)acc[nt][2 * h + 1];
          }
        }
      zero();
      ostep = 0;
      om0 += p.cl * RT;
    }
  };
  ring_loop(total, p.stages, issue, transpose, body);
}

int launch_clusters(const void* kern, void** args, int ctas, int threads, int smem, int cl,
                    cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelExC(&cfg, kern, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The geometry kdot_plan takes: rows 64 or 128 dividing pn, 1 .. 8 CTAs a
// cluster, no more than the row tiles.
bool geometry_ok(int pn, int rows, int cl) {
  if (pn <= 0 || (rows != 64 && rows != 128) || pn % rows) return false;
  const int tiles = pn / rows;
  return cl >= 1 && cl <= MAX_CLUSTER && cl <= tiles;
}

// The window of x's 4-column blocks a step stages and transposes: output
// columns [0, round_up(oc, 8)) of pass k < max(K, 1) read source columns
// j - k mod 128 (grid_overhead_study.xt_window).
void window(int oc, int K, int& blk0, int& nblk) {
  const int lo = K > 1 ? -(K - 1) : 0, hi = (oc + 7) / 8 * 8 - 1;
  const int b_lo = lo >= 0 ? lo / 4 : -((-lo + 3) / 4);
  nblk = hi / 4 - b_lo + 1;
  if (nblk >= XCOLS / 4) {
    blk0 = 0;
    nblk = XCOLS / 4;
  } else {
    blk0 = b_lo & (XCOLS / 4 - 1);
  }
}

// kdot's instantiation for RT rows a CTA and np pairs of n-tiles.
template <int RT>
const void* kdot_rows(int np) {
  switch (np) {
    case 1: return reinterpret_cast<const void*>(kdot_kernel<RT, 1>);
    case 2: return reinterpret_cast<const void*>(kdot_kernel<RT, 2>);
    case 3: return reinterpret_cast<const void*>(kdot_kernel<RT, 3>);
    case 4: return reinterpret_cast<const void*>(kdot_kernel<RT, 4>);
    case 5: return reinterpret_cast<const void*>(kdot_kernel<RT, 5>);
    case 6: return reinterpret_cast<const void*>(kdot_kernel<RT, 6>);
    case 7: return reinterpret_cast<const void*>(kdot_kernel<RT, 7>);
    default: return reinterpret_cast<const void*>(kdot_kernel<RT, 8>);
  }
}

}  // namespace

// x: int8 [B][pn][xp]; out: float [B][pn][oc]; one cluster of cl CTAs of
// `rows` rows per G batches (grid_overhead_study.kdot_plan's geometry).
extern "C" int qgtc_zero_body(void* out, const void* x, int B, int pn, int xp, int oc, int G,
                              int rows, int cl, void* stream) {
  if (B <= 0 || G <= 0 || B % G || !geometry_ok(pn, rows, cl) || xp <= 0 || xp % 16 ||
      xp > XCOLS || oc <= 0)
    return (int)cudaErrorInvalidValue;
  ZeroArgs p{static_cast<const int8_t*>(x), static_cast<float*>(out), pn, xp, oc, G, cl};
  void* args[] = {&p};
  const void* kern = rows == 128 ? reinterpret_cast<const void*>(zero_body_kernel<128>)
                                 : reinterpret_cast<const void*>(zero_body_kernel<64>);
  return launch_clusters(kern, args, B / G * cl, 2 * rows, 0, cl, static_cast<cudaStream_t>(stream));
}

// x: int8 [B][pn][128]; s: int8 [pn][pn]; out: float [B][pn][oc]; one
// cluster of cl CTAs of `rows` rows per batch, a ring of `stages` slots.
// Refused: what grid_overhead_study.kdot_plan refuses.
extern "C" int qgtc_kdot(void* out, const void* x, const void* s, int B, int pn, int oc, int K,
                         int rows, int cl, int stages, void* stream) {
  if (B <= 0 || !geometry_ok(pn, rows, cl) || oc <= 0 || oc > XCOLS || K < 0 ||
      (stages != 3 && stages != 4))
    return (int)cudaErrorInvalidValue;
  const int smem = rows == 128 ? KdotLayout<128>::bytes(stages) : KdotLayout<64>::bytes(stages);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const void* kern = rows == 128 ? kdot_rows<128>((oc + 15) / 16) : kdot_rows<64>((oc + 15) / 16);
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  KdotArgs p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(s), static_cast<float*>(out),
             pn, oc, K, cl, stages, 0, 0};
  window(oc, K, p.blk0, p.nblk);
  void* args[] = {&p};
  return launch_clusters(kern, args, B * cl, 2 * rows, smem, cl, static_cast<cudaStream_t>(stream));
}
