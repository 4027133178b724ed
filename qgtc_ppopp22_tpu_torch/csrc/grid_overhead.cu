// grid_overhead: the fixed costs of fused_model's launch geometry.
//
// Replaces the TPU ladder kernels of benchmarks/grid_overhead_study.py:
// zero_body (kernel :83, pallas_call :85) and kdot (:109, :123), which
// split the mega kernel's per-grid-step cost on the TPU. Here both run
// with fused_model's geometry: one thread-block cluster of
// cl = min(pn / 64, 8) CTAs of 128 threads per batch (per G batches for
// zero_body), CTA r owning the 64-row tiles r, r + cl, ... of its rows.
//   zero_body  reads each of its tiles of X (int8 [B][pn][xp]) into shared
//              memory, with volatile stores so that the reads stay, and
//              writes zeros to the tile's rows of out (float [B][pn][oc]);
//   kdot       the same read of X, then out[b] = (sum over k < K of
//              S . roll(x[b], k))[:, :oc] as float, with S int8 [pn][pn]
//              and roll along the 128 columns as jnp.roll (column j of
//              x[b] moves to column (j + k) mod 128): per k, a pass of a
//              single-stage int8 mma.sync loop (gemm_core.cuh's loader and
//              fragment loads) over the whole contraction, both 64-column
//              tiles, as fused_model's aggregations ran (the TPU study's K
//              dummy MXU dots).
// What bounds it on an H100: zero_body moves B pn (xp + 4 oc) bytes
// (35.7 MB at pn 2048, 50 batches, oc 48: 11 us at the memory rate);
// kdot at K passes does 2 B K pn^2 oc operations (K = 2: 2.6 T at
// oc 120) over the same bytes plus S. What the probe measures is the
// rest: per-CTA, per-cluster and per-pass fixed costs.
#include "gemm_core.cuh"

using namespace qgtc;

namespace {

constexpr int MAX_CLUSTER = 8;  // fused_model_k1.cuh MAX_CLUSTER
constexpr int XCOLS = 128;      // kdot's x width (the roll's period)

struct StudyArgs {
  const int8_t* x;  // [B][pn][xp]
  const int8_t* s;  // kdot: [pn][pn]
  float* out;       // [B][pn][oc]
  int B, pn, xp, oc, G, K, cl;
};

// Rows [r0, r0 + 64) of one batch's X into shared memory; the volatile
// stores keep the loads.
__device__ __forceinline__ void read_x_tile(int8_t* xs, const int8_t* __restrict__ x,
                                            int xp, int tid) {
  const int4* src = reinterpret_cast<const int4*>(x);
  for (int i = tid; i < BM * xp / 16; i += THREADS) {
    const int4 v = __ldg(src + i);
    const unsigned addr = (unsigned)__cvta_generic_to_shared(xs + 16 * i);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x),
                 "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
  }
}

__global__ void __launch_bounds__(THREADS) zero_body_kernel(const StudyArgs p) {
  __shared__ __align__(16) int8_t xs[BM * XCOLS];
  const int c = blockIdx.x / p.cl, r = blockIdx.x % p.cl, tid = threadIdx.x;
  const int tiles = p.pn / BM;
  for (int b = c * p.G; b < (c + 1) * p.G; ++b)
    for (int t = r; t < tiles; t += p.cl) {
      const size_t row0 = (size_t)b * p.pn + (size_t)t * BM;
      read_x_tile(xs, p.x + row0 * p.xp, p.xp, tid);
      float4* dst = reinterpret_cast<float4*>(p.out + row0 * p.oc);
      for (int i = tid; i < BM * p.oc / 4; i += THREADS) dst[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// BK rows of roll(x[b], k)'s columns [c0, c0 + BN), transposed into Bs[n][k].
__device__ __forceinline__ void load_rolled(int8_t (*Bs)[BN][LDS], const int8_t* __restrict__ xb,
                                            int k0, int c0, int shift, int tid) {
  constexpr int CH = XCOLS / 16;
  for (int c = tid; c < BK * CH; c += THREADS) {
    const int kk = c / CH, sc = (c % CH) * 16;
    const int4 v = __ldg(reinterpret_cast<const int4*>(xb + (size_t)(k0 + kk) * XCOLS + sc));
    const int8_t* bytes = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = ((sc + j + shift) & (XCOLS - 1)) - c0;
      if (n >= 0 && n < BN) Bs[0][n][kk] = bytes[j];
    }
  }
}

__global__ void __launch_bounds__(THREADS) kdot_kernel(const StudyArgs p) {
  __shared__ __align__(16) int8_t As[1][BM][LDS];
  __shared__ __align__(16) int8_t Bs[1][BN][LDS];
  __shared__ __align__(16) int8_t xs[BM * XCOLS];
  const int b = blockIdx.x / p.cl, r = blockIdx.x % p.cl, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int8_t* const xb = p.x + (size_t)b * p.pn * XCOLS;
  const Int8Loader la{p.s, p.pn, p.pn};
  for (int t = r; t < p.pn / BM; t += p.cl) {
    read_x_tile(xs, xb + (size_t)t * BM * XCOLS, XCOLS, tid);
    for (int c0 = 0; c0 < XCOLS; c0 += BN) {
      int acc[2][4][4] = {};
      for (int k = 0; k < p.K; ++k)
        for (int k0 = 0; k0 < p.pn; k0 += BK) {
          la.load<1, BM>(As, t * BM, k0, tid);
          load_rolled(Bs, xb, k0, c0, k, tid);
          __syncthreads();
#pragma unroll
          for (int ks = 0; ks < BK; ks += 32) {
            uint32_t af[2][4], bf[4][2];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) frag_a(af[mt], &As[0][wm + mt * 16 + g][ks + t4 * 4]);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) frag_b(bf[nt], &Bs[0][wn + nt * 8 + g][ks + t4 * 4]);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
          }
          __syncthreads();
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = t * BM + wm + mt * 16 + g + 8 * (i >> 1);
            const int col = c0 + wn + nt * 8 + 2 * t4 + (i & 1);
            if (col < p.oc) p.out[((size_t)b * p.pn + row) * p.oc + col] = (float)acc[mt][nt][i];
          }
    }
  }
}

int launch_clusters(void (*kern)(StudyArgs), const StudyArgs& p, int clusters, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * p.cl);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int cluster_of(int pn) { return pn / BM < MAX_CLUSTER ? pn / BM : MAX_CLUSTER; }

}  // namespace

// x: int8 [B][pn][xp]; out: float [B][pn][oc]; one cluster per G batches.
extern "C" int qgtc_zero_body(void* out, const void* x, int B, int pn, int xp, int oc, int G,
                              void* stream) {
  if (B <= 0 || G <= 0 || B % G || pn <= 0 || pn % BM || xp <= 0 || xp % 16 ||
      xp > XCOLS || oc <= 0)
    return (int)cudaErrorInvalidValue;
  const StudyArgs p{static_cast<const int8_t*>(x), nullptr, static_cast<float*>(out),
                    B, pn, xp, oc, G, 0, cluster_of(pn)};
  return launch_clusters(zero_body_kernel, p, B / G, static_cast<cudaStream_t>(stream));
}

// x: int8 [B][pn][128]; s: int8 [pn][pn]; out: float [B][pn][oc]; one
// cluster per batch.
extern "C" int qgtc_kdot(void* out, const void* x, const void* s, int B, int pn, int oc, int K,
                         void* stream) {
  if (B <= 0 || pn <= 0 || pn % BM || oc <= 0 || oc > XCOLS || K < 0)
    return (int)cudaErrorInvalidValue;
  const StudyArgs p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(s),
                    static_cast<float*>(out), B, pn, XCOLS, oc, 1, K, cluster_of(pn)};
  return launch_clusters(kdot_kernel, p, B, static_cast<cudaStream_t>(stream));
}
