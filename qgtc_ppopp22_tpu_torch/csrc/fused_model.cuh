// The whole-model kernel of fused_model.cu, shared by its two
// translation units (X with 1 digit plane there, 2 in fused_model_x2.cu)
// so that nvcc builds them in parallel.
#pragma once

#include "gemm_core.cuh"

namespace qgtc {
namespace mega {

constexpr int MAX_LAYERS = 8;  // ops/fused_model.py MAX_LAYERS
constexpr int MAX_CLUSTER = 8;  // portable cluster size

struct Params {
  float* out;             // [B][pn][oc]
  const int32_t* a;       // [B][pn / 32][pn] M-packed 1-bit adjacency
  const int8_t* x;        // [B][nd_x][pn][xp] feature digits
  const int8_t* w;        // weight digits, layer l at byte w_off[l]:
                          // [nd_w][kp[l]][np[l]]
  const int* sched;       // [B][pn / chunk][nj + 1] or null (dense)
  int8_t* scratch;        // [B][3][nd_h][pn][hw]: P0, P1, Q
  int B, pn, xp, out_bits, oc, chunk, nj, hw, n_layers, gin, cl;
  int kp[MAX_LAYERS], np[MAX_LAYERS], nw[MAX_LAYERS], w_off[MAX_LAYERS];
  int shift[2 * MAX_LAYERS];
};

// Row-major int8 digit planes [ND][rows][ld] as the A operand.
template <int ND>
struct RowsA {
  const int8_t* p;
  size_t plane;
  int ld;

  __device__ __forceinline__ void load(int8_t (*As)[BM][LDS], int m0, int k0,
                                       int kk, int tid) const {
    const int ch = kk / 16;
    for (int c = tid; c < BM * ch; c += THREADS) {
      const int r = c / ch, kc = (c % ch) * 16;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<int4*>(&As[d][r][kc]) =
            __ldcg(reinterpret_cast<const int4*>(
                p + d * plane + (size_t)(m0 + r) * ld + k0 + kc));
    }
  }
};

// The packed adjacency as the A operand (kk is always BK here).
struct PackedA {
  PackedLoader<1> l;

  __device__ __forceinline__ void load(int8_t (*As)[BM][LDS], int m0, int k0,
                                       int, int tid) const {
    l.template load<1>(As, m0, k0, tid);
  }
};

// Row-major int8 digit planes [ND][k][ld] as the B operand, stored
// transposed ([n][k]) in shared memory like gemm_core's load_b.
template <int ND>
struct RowsB {
  const int8_t* p;
  size_t plane;
  int ld;

  __device__ __forceinline__ void load(int8_t (*Bs)[BN][LDS], int n0, int nc,
                                       int k0, int kk, int tid) const {
    const int ch = nc / 16;
    for (int c = tid; c < kk * ch; c += THREADS) {
      const int k = c / ch, cc = (c % ch) * 16;
#pragma unroll
      for (int e = 0; e < ND; ++e) {
        const int4 v = __ldcg(reinterpret_cast<const int4*>(
            p + e * plane + (size_t)(k0 + k) * ld + n0 + cc));
        const int8_t* bytes = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int j = 0; j < 16; ++j) Bs[e][cc + j][k] = bytes[j];
      }
    }
  }
};

// Requantized digit planes [ND][pn][ld] into the scratch.
template <int ND>
struct DigitsOut {
  int8_t* p;
  size_t plane;
  int ld, out_bits, shift;

  __device__ __forceinline__ void operator()(int row, int col, int v0,
                                             int v1) const {
    store_digits(p, plane, (size_t)row * ld + col, ND, out_bits, shift, v0,
                 v1);
  }
};

// float32 logits [pn][oc]; columns at or past oc are not stored.
struct F32Out {
  float* p;
  int oc;

  __device__ __forceinline__ void operator()(int row, int col, int v0,
                                             int v1) const {
    if (col < oc)
      *reinterpret_cast<float2*>(p + (size_t)row * oc + col) =
          make_float2((float)v0, (float)v1);
  }
};

__device__ __forceinline__ void cluster_sync() {
  __threadfence();  // scratch writes reach L2 before the barrier
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One BK-deep stage of a 64 x (NT*8) tile: 4 warps, 16 rows each.
template <int ND_A, int ND_B, int NT, class AL, class BL>
__device__ __forceinline__ void stage(int (&acc)[ND_A + ND_B - 1][NT][4],
                                      int8_t (*As)[BM][LDS],
                                      int8_t (*Bs)[BN][LDS], const AL& la,
                                      const BL& lb, int m0, int n0, int k0,
                                      int kk) {
  const int tid = threadIdx.x, lane = tid & 31, wm = (tid >> 5) * 16;
  const int g = lane >> 2, t4 = lane & 3;
  __syncthreads();  // the previous stage's (or tile's) readers are done
  la.load(As, m0, k0, kk, tid);
  lb.load(Bs, n0, NT * 8, k0, kk, tid);
  __syncthreads();
  for (int ks = 0; ks < kk; ks += 32) {
    uint32_t af[ND_A][4];
    uint32_t bf[ND_B][NT][2];
#pragma unroll
    for (int d = 0; d < ND_A; ++d) {
      const int8_t* p = &As[d][wm + g][ks + t4 * 4];
      af[d][0] = *reinterpret_cast<const uint32_t*>(p);
      af[d][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
      af[d][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      af[d][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
    }
#pragma unroll
    for (int e = 0; e < ND_B; ++e)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* p = &Bs[e][nt * 8 + g][ks + t4 * 4];
        bf[e][nt][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[e][nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
    for (int d = 0; d < ND_A; ++d)
#pragma unroll
      for (int e = 0; e < ND_B; ++e)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_s8(acc[d + e][nt], af[d], bf[e][nt]);
  }
}

// C[m0:m0+64, n0:n0+NT*8] = sum over the contraction, then epi(). The
// contraction is [0, K) when srow is null, else the column blocks that
// the schedule row srow = [count, j_0, ...] lists (width cb each).
template <int ND_A, int ND_B, int NT, class AL, class BL, class Epi>
__device__ __forceinline__ void tile_gemm(int8_t (*As)[BM][LDS],
                                          int8_t (*Bs)[BN][LDS], const AL& la,
                                          const BL& lb, int m0, int n0, int K,
                                          const int* srow, int nj, int cb,
                                          const Epi& epi) {
  constexpr int NS = ND_A + ND_B - 1;
  int acc[NS][NT][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[s][nt][i] = 0;
  if (srow) {
    const int cnt = min(max(__ldg(srow), 0), nj);
    for (int t = 0; t < cnt; ++t) {
      const int j = __ldg(srow + 1 + t);
      if (j < 0 || j >= nj) continue;  // memory safety only
      for (int k0 = j * cb; k0 < (j + 1) * cb; k0 += BK)
        stage<ND_A, ND_B, NT>(acc, As, Bs, la, lb, m0, n0, k0, BK);
    }
  } else {
    for (int k0 = 0; k0 < K; k0 += BK)
      stage<ND_A, ND_B, NT>(acc, As, Bs, la, lb, m0, n0, k0, min(BK, K - k0));
  }
  const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8
      uint32_t v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t s = 0;  // unsigned: the shifted sum wraps like int32
#pragma unroll
        for (int si = 0; si < NS; ++si)
          s += (uint32_t)acc[si][nt][2 * h + j] << (4 * si);
        v[j] = s;
      }
      epi(m0 + wm + g + 8 * h, n0 + nt * 8 + t4 * 2, (int)v[0], (int)v[1]);
    }
  __threadfence();  // scratch rows visible through L2 to every reader
}

// Every tile this CTA owns of C[pn, width] = A_op x B_op, in column
// chunks of 64 (or 32 for the last of an odd multiple of 32).
template <int ND_A, int ND_B, class AL, class BL, class Epi>
__device__ __forceinline__ void gemm_rows(int8_t (*As)[BM][LDS],
                                          int8_t (*Bs)[BN][LDS],
                                          const Params& p, const AL& la,
                                          const BL& lb, int K, int width,
                                          const int* sched, const Epi& epi) {
  const int rank = blockIdx.x % p.cl;
  const int cb = p.nj ? p.pn / p.nj : 0;
  for (int t = rank; t < p.pn / BM; t += p.cl) {
    const int m0 = t * BM;
    const int* srow = sched ? sched + (m0 / p.chunk) * (p.nj + 1) : nullptr;
    for (int n0 = 0; n0 < width; n0 += 64) {
      if (width - n0 >= 64)
        tile_gemm<ND_A, ND_B, 8>(As, Bs, la, lb, m0, n0, K, srow, p.nj, cb, epi);
      else
        tile_gemm<ND_A, ND_B, 4>(As, Bs, la, lb, m0, n0, K, srow, p.nj, cb, epi);
    }
  }
}

template <int ND_X, int ND_W, int ND_H>
__global__ void __launch_bounds__(THREADS) fused_model_kernel(const Params p) {
  __shared__ __align__(16) int8_t As[2][BM][LDS];
  __shared__ __align__(16) int8_t Bs[2][BN][LDS];  // [n][k]

  const int b = blockIdx.x / p.cl;
  const size_t hplane = (size_t)p.pn * p.hw;
  int8_t* const base = p.scratch + (size_t)b * 3 * ND_H * hplane;
  int8_t* const P[2] = {base, base + ND_H * hplane};
  int8_t* const Q = base + 2 * ND_H * hplane;
  const PackedA adj{{p.a + (size_t)b * (p.pn / 32) * p.pn, p.pn}};
  const int8_t* const xb = p.x + (size_t)b * ND_X * p.pn * p.xp;
  const int* const sched =
      p.sched ? p.sched + (size_t)b * (p.pn / p.chunk) * (p.nj + 1) : nullptr;
  float* const out = p.out + (size_t)b * p.pn * p.oc;
  const int n = p.n_layers;

  auto weight = [&](int l) {
    return RowsB<ND_W>{p.w + p.w_off[l], (size_t)p.kp[l] * p.np[l], p.np[l]};
  };
  auto hidden_out = [&](int8_t* dst, int ld, int shift) {
    return DigitsOut<ND_H>{dst, hplane, ld, p.out_bits, shift};
  };

  if (!p.gin) {
    // upd 0: X W1, row-local
    gemm_rows<ND_X, ND_W>(As, Bs, p, RowsA<ND_X>{xb, (size_t)p.pn * p.xp, p.xp},
                          weight(0), p.xp, p.nw[0], nullptr,
                          hidden_out(P[0], p.nw[0], p.shift[0]));
    cluster_sync();
    for (int l = 1; l < n; ++l) {
      const int w_in = p.nw[l - 1];
      int8_t* const h = P[(l - 1) & 1];
      gemm_rows<1, ND_H>(As, Bs, p, adj, RowsB<ND_H>{h, hplane, w_in}, p.pn,
                         w_in, sched, hidden_out(Q, w_in, p.shift[2 * l - 1]));
      gemm_rows<ND_H, ND_W>(As, Bs, p, RowsA<ND_H>{Q, hplane, w_in}, weight(l),
                            w_in, p.nw[l], nullptr,
                            hidden_out(P[l & 1], p.nw[l], p.shift[2 * l]));
      cluster_sync();
    }
    gemm_rows<1, ND_H>(As, Bs, p, adj,
                       RowsB<ND_H>{P[(n - 1) & 1], hplane, p.nw[n - 1]}, p.pn,
                       p.nw[n - 1], sched, F32Out{out, p.oc});
  } else {
    for (int l = 0; l < n; ++l) {
      const int w_in = l ? p.nw[l - 1] : p.xp;
      if (l == 0)
        gemm_rows<1, ND_X>(As, Bs, p, adj,
                           RowsB<ND_X>{xb, (size_t)p.pn * p.xp, p.xp}, p.pn,
                           p.xp, sched, hidden_out(Q, p.xp, p.shift[0]));
      else
        gemm_rows<1, ND_H>(As, Bs, p, adj,
                           RowsB<ND_H>{P[(l - 1) & 1], hplane, w_in}, p.pn,
                           w_in, sched, hidden_out(Q, w_in, p.shift[2 * l]));
      const RowsA<ND_H> q{Q, hplane, w_in};
      if (l < n - 1) {
        gemm_rows<ND_H, ND_W>(As, Bs, p, q, weight(l), w_in, p.nw[l], nullptr,
                              hidden_out(P[l & 1], p.nw[l], p.shift[2 * l + 1]));
        cluster_sync();
      } else {
        gemm_rows<ND_H, ND_W>(As, Bs, p, q, weight(l), w_in, p.nw[l], nullptr,
                              F32Out{out, p.oc});
      }
    }
  }
}

template <int ND_X, int ND_W, int ND_H>
int launch_fused(const Params& p, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.cl);
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
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, fused_model_kernel<ND_X, ND_W, ND_H>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int ND_X, int ND_W>
int launch_h(const Params& p, int nd_h, cudaStream_t s) {
  if (nd_h == 1) return launch_fused<ND_X, ND_W, 1>(p, s);
  if (nd_h == 2) return launch_fused<ND_X, ND_W, 2>(p, s);
  return (int)cudaErrorInvalidValue;
}

// Launches for X with 2 digit planes (fused_model_x2.cu).
int launch_x2(const Params& p, int nd_w, int nd_h, cudaStream_t s);

template <int ND_X>
int launch_x(const Params& p, int nd_w, int nd_h, cudaStream_t s) {
  if (nd_w == 1) return launch_h<ND_X, 1>(p, nd_h, s);
  if (nd_w == 2) return launch_h<ND_X, 2>(p, nd_h, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mega
}  // namespace qgtc

