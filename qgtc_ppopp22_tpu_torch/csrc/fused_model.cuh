// The whole-model kernel of fused_model.cu, shared by its translation
// units so that nvcc builds them in parallel: X as 1 digit plane
// (fused_model.cu) or 2 (fused_model_x2.cu), and X as one plane of 5-8-bit
// byte levels, split into 2 digit planes on load (fused_model_split.cu)
// or run as the offset-signed single-plane chain (fused_model_signed.cu).
#pragma once

#include "gemm_core.cuh"

namespace qgtc {
namespace mega {

constexpr int MAX_LAYERS = 8;  // ops/fused_model.py MAX_LAYERS
constexpr int MAX_CLUSTER = 8;  // portable cluster size

// How X arrives and which chain runs (ops/fused_model.py MegaPlan.form).
enum XForm {
  X_DIGITS = 0,  // [nd_x][pn][xp] base-16 digit planes; the digit chain
  X_SPLIT = 1,   // [1][pn][xp] 5-8-bit byte levels, split into 2 digit
                 // planes as they are loaded; the digit chain
  X_SIGNED = 2,  // [1][pn][xp] byte levels, loaded as level - 128; every
                 // operand one offset-signed plane (below)
};

// The offset-signed chain (X_SIGNED): X, every weight and every hidden
// layer is one int8 plane of level - 128, so each GEMM is one int8 pass,
// and a rank-1 correction restores the unsigned product exactly
// (sums in uint32, which wraps like the int32 algebra):
//   update  H W = Hs Ws + 128 rowsum(Hs) + corr[n],
//           corr = 128 colsum(Ws) + 128^2 K over the K rows contracted;
//   aggr.   A H = A Hs + 128 deg,
//           deg = the row's ones in the A blocks visited (a block a
//           schedule leaves out drops its product and its degree).
// Both row sums are those of the A operand's staged tile, taken from the
// mma fragments with __dp4a. Weight rows past a layer's input are level
// 0 (Ws = -128), so whatever the hidden plane holds there cancels.

struct Params {
  float* out;             // [B][pn][oc]
  const int32_t* a;       // [B][pn / 32][pn] M-packed 1-bit adjacency
  const int8_t* x;        // [B][nd_x][pn][xp] feature digits (X_DIGITS),
                          // else [B][1][pn][xp] byte levels
  const int8_t* w;        // weight digits, layer l at byte w_off[l]:
                          // [nd_w][kp[l]][np[l]] (X_SIGNED: one plane of
                          // level - 128)
  const int* corr;        // X_SIGNED: layer l's corr[np[l]] at c_off[l]
  const int* sched;       // [B][pn / chunk][nj + 1] or null (dense)
  int8_t* scratch;        // [B][3][nd_h][pn][hw]: P0, P1, Q
  int B, pn, xp, out_bits, oc, chunk, nj, hw, n_layers, gin, cl;
  uint32_t x_hi;          // X_SPLIT: each byte's mask of its high digit
  int kp[MAX_LAYERS], np[MAX_LAYERS], nw[MAX_LAYERS], w_off[MAX_LAYERS];
  int c_off[MAX_LAYERS];
  int shift[2 * MAX_LAYERS];
};

// Each 32-bit word of v, shifted right by sh (logically), then masked.
__device__ __forceinline__ int4 bits4(int4 v, int sh, uint32_t m) {
  return make_int4((int)(((uint32_t)v.x >> sh) & m), (int)(((uint32_t)v.y >> sh) & m),
                   (int)(((uint32_t)v.z >> sh) & m), (int)(((uint32_t)v.w >> sh) & m));
}

// Byte levels -> level - 128 as signed bytes (the top bit flipped).
__device__ __forceinline__ int4 offset4(int4 v) {
  constexpr uint32_t F = 0x80808080u;
  return make_int4((int)((uint32_t)v.x ^ F), (int)((uint32_t)v.y ^ F),
                   (int)((uint32_t)v.z ^ F), (int)((uint32_t)v.w ^ F));
}

// The ND planes that 16 bytes read at plane 0 give under form XF:
// X_DIGITS reads ND planes (plane bytes apart), X_SPLIT splits one plane
// of levels into its 2 digits (the high one masked by hi), X_SIGNED
// offsets one plane.
template <int ND, int XF>
__device__ __forceinline__ void load16(int4 (&v)[ND], const int8_t* src,
                                       size_t plane, uint32_t hi) {
  if constexpr (XF == X_DIGITS) {
#pragma unroll
    for (int d = 0; d < ND; ++d)
      v[d] = __ldcg(reinterpret_cast<const int4*>(src + d * plane));
  } else {
    const int4 raw = __ldcg(reinterpret_cast<const int4*>(src));
    if constexpr (XF == X_SIGNED) {
      static_assert(ND == 1, "the signed chain has one plane");
      v[0] = offset4(raw);
    } else {
      static_assert(ND == 2, "5-8-bit levels split into 2 digits");
      v[0] = bits4(raw, 0, 0x0F0F0F0Fu);  // each byte's low nibble
      v[1] = bits4(raw, 4, hi);           // its high digit
    }
  }
}

// Row-major int8 planes [ND][rows][ld] as the A operand (XF: how X's
// bytes become them; hidden layers are X_DIGITS).
template <int ND, int XF = X_DIGITS>
struct RowsA {
  const int8_t* p;
  size_t plane;
  int ld;
  uint32_t hi = 0;

  __device__ __forceinline__ void load(int8_t (*As)[BM][LDS], int m0, int k0,
                                       int kk, int tid) const {
    const int ch = kk / 16;
    for (int c = tid; c < BM * ch; c += THREADS) {
      const int r = c / ch, kc = (c % ch) * 16;
      int4 v[ND];
      load16<ND, XF>(v, p + (size_t)(m0 + r) * ld + k0 + kc, plane, hi);
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<int4*>(&As[d][r][kc]) = v[d];
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

// Row-major int8 planes [ND][k][ld] as the B operand, stored transposed
// ([n][k]) in shared memory like gemm_core's load_b.
template <int ND, int XF = X_DIGITS>
struct RowsB {
  const int8_t* p;
  size_t plane;
  int ld;
  uint32_t hi = 0;

  __device__ __forceinline__ void load(int8_t (*Bs)[BN][LDS], int n0, int nc,
                                       int k0, int kk, int tid) const {
    const int ch = nc / 16;
    for (int c = tid; c < kk * ch; c += THREADS) {
      const int k = c / ch, cc = (c % ch) * 16;
      int4 v[ND];
      load16<ND, XF>(v, p + (size_t)(k0 + k) * ld + n0 + cc, plane, hi);
#pragma unroll
      for (int e = 0; e < ND; ++e) {
        const int8_t* bytes = reinterpret_cast<const int8_t*>(&v[e]);
#pragma unroll
        for (int j = 0; j < 16; ++j) Bs[e][cc + j][k] = bytes[j];
      }
    }
  }
};

// Requantized hidden rows into the scratch: ND digit planes [ND][pn][ld],
// or (SG) the one offset-signed plane of level - 128.
template <int ND, bool SG>
struct HiddenOut {
  int8_t* p;
  size_t plane;
  int ld, out_bits, shift;

  __device__ __forceinline__ void operator()(int row, int col, int v0,
                                             int v1) const {
    if constexpr (SG) {
      char2 c;
      c.x = (char)(requant(v0, out_bits, shift) - 128);
      c.y = (char)(requant(v1, out_bits, shift) - 128);
      *reinterpret_cast<char2*>(p + (size_t)row * ld + col) = c;
    } else {
      store_digits(p, plane, (size_t)row * ld + col, ND, out_bits, shift, v0,
                   v1);
    }
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

// One BK-deep stage of a 64 x (NT*8) tile: 4 warps, 16 rows each. SG:
// also sums this lane's bytes of A rows g and g + 8 into rs.
template <int ND_A, int ND_B, int NT, bool SG, class AL, class BL>
__device__ __forceinline__ void stage(int (&acc)[ND_A + ND_B - 1][NT][4],
                                      int (&rs)[2], int8_t (*As)[BM][LDS],
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
    if constexpr (SG) {  // fragments 0, 2: row g; 1, 3: row g + 8
      rs[0] = __dp4a((int)af[0][0], 0x01010101, rs[0]);
      rs[0] = __dp4a((int)af[0][2], 0x01010101, rs[0]);
      rs[1] = __dp4a((int)af[0][1], 0x01010101, rs[1]);
      rs[1] = __dp4a((int)af[0][3], 0x01010101, rs[1]);
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
// the schedule row srow = [count, j_0, ...] lists (width cb each). SG:
// the signed chain's corrections, + 128 rowsum(A tile) and corr[n] when
// corr is not null.
template <int ND_A, int ND_B, int NT, bool SG, class AL, class BL, class Epi>
__device__ __forceinline__ void tile_gemm(int8_t (*As)[BM][LDS],
                                          int8_t (*Bs)[BN][LDS], const AL& la,
                                          const BL& lb, int m0, int n0, int K,
                                          const int* srow, int nj, int cb,
                                          const int* corr, const Epi& epi) {
  constexpr int NS = ND_A + ND_B - 1;
  int acc[NS][NT][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[s][nt][i] = 0;
  int rs[2] = {0, 0};
  if (srow) {
    const int cnt = min(max(__ldg(srow), 0), nj);
    for (int t = 0; t < cnt; ++t) {
      const int j = __ldg(srow + 1 + t);
      if (j < 0 || j >= nj) continue;  // memory safety only
      for (int k0 = j * cb; k0 < (j + 1) * cb; k0 += BK)
        stage<ND_A, ND_B, NT, SG>(acc, rs, As, Bs, la, lb, m0, n0, k0, BK);
    }
  } else {
    for (int k0 = 0; k0 < K; k0 += BK)
      stage<ND_A, ND_B, NT, SG>(acc, rs, As, Bs, la, lb, m0, n0, k0,
                                min(BK, K - k0));
  }
  const int lane = threadIdx.x & 31, wm = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t4 = lane & 3;
  if constexpr (SG) {  // the 4 lanes of a row group hold its 4 column slices
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8
      const int col = n0 + nt * 8 + t4 * 2;
      uint32_t v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t s = 0;  // unsigned: the shifted sum wraps like int32
#pragma unroll
        for (int si = 0; si < NS; ++si)
          s += (uint32_t)acc[si][nt][2 * h + j] << (4 * si);
        if constexpr (SG) {
          s += (uint32_t)rs[h] << 7;
          if (corr) s += (uint32_t)__ldg(corr + col + j);
        }
        v[j] = s;
      }
      epi(m0 + wm + g + 8 * h, col, (int)v[0], (int)v[1]);
    }
  __threadfence();  // scratch rows visible through L2 to every reader
}

// Every tile this CTA owns of C[pn, width] = A_op x B_op, in column
// chunks of 64 (or 32 for the last of an odd multiple of 32).
template <int ND_A, int ND_B, bool SG, class AL, class BL, class Epi>
__device__ __forceinline__ void gemm_rows(int8_t (*As)[BM][LDS],
                                          int8_t (*Bs)[BN][LDS],
                                          const Params& p, const AL& la,
                                          const BL& lb, int K, int width,
                                          const int* sched, const int* corr,
                                          const Epi& epi) {
  const int rank = blockIdx.x % p.cl;
  const int cb = p.nj ? p.pn / p.nj : 0;
  for (int t = rank; t < p.pn / BM; t += p.cl) {
    const int m0 = t * BM;
    const int* srow = sched ? sched + (m0 / p.chunk) * (p.nj + 1) : nullptr;
    for (int n0 = 0; n0 < width; n0 += 64) {
      if (width - n0 >= 64)
        tile_gemm<ND_A, ND_B, 8, SG>(As, Bs, la, lb, m0, n0, K, srow, p.nj,
                                     cb, corr, epi);
      else
        tile_gemm<ND_A, ND_B, 4, SG>(As, Bs, la, lb, m0, n0, K, srow, p.nj,
                                     cb, corr, epi);
    }
  }
}

template <int XF, int ND_X, int ND_W, int ND_H>
__global__ void __launch_bounds__(THREADS) fused_model_kernel(const Params p) {
  constexpr bool SG = XF == X_SIGNED;
  static_assert(!SG || (ND_X == 1 && ND_W == 1 && ND_H == 1),
                "the signed chain has one plane per operand");
  __shared__ __align__(16) int8_t As[2][BM][LDS];
  __shared__ __align__(16) int8_t Bs[2][BN][LDS];  // [n][k]

  const int b = blockIdx.x / p.cl;
  const size_t hplane = (size_t)p.pn * p.hw;
  int8_t* const base = p.scratch + (size_t)b * 3 * ND_H * hplane;
  int8_t* const P[2] = {base, base + ND_H * hplane};
  int8_t* const Q = base + 2 * ND_H * hplane;
  const PackedA adj{{p.a + (size_t)b * (p.pn / 32) * p.pn, p.pn}};
  const size_t xplane = (size_t)p.pn * p.xp;
  const int8_t* const xb = p.x + (size_t)b * (XF == X_DIGITS ? ND_X : 1) * xplane;
  const int* const sched =
      p.sched ? p.sched + (size_t)b * (p.pn / p.chunk) * (p.nj + 1) : nullptr;
  float* const out = p.out + (size_t)b * p.pn * p.oc;
  const int n = p.n_layers;

  auto weight = [&](int l) {
    return RowsB<ND_W>{p.w + p.w_off[l], (size_t)p.kp[l] * p.np[l], p.np[l]};
  };
  auto corr = [&](int l) -> const int* {  // an update's weight correction
    return SG ? p.corr + p.c_off[l] : nullptr;
  };
  auto hidden_out = [&](int8_t* dst, int ld, int shift) {
    return HiddenOut<ND_H, SG>{dst, hplane, ld, p.out_bits, shift};
  };

  if (!p.gin) {
    // upd 0: X W1, row-local
    gemm_rows<ND_X, ND_W, SG>(
        As, Bs, p, RowsA<ND_X, XF>{xb, xplane, p.xp, p.x_hi},
        weight(0), p.xp, p.nw[0], nullptr, corr(0),
        hidden_out(P[0], p.nw[0], p.shift[0]));
    cluster_sync();
    for (int l = 1; l < n; ++l) {
      const int w_in = p.nw[l - 1];
      int8_t* const h = P[(l - 1) & 1];
      gemm_rows<1, ND_H, SG>(As, Bs, p, adj, RowsB<ND_H>{h, hplane, w_in},
                             p.pn, w_in, sched, nullptr,
                             hidden_out(Q, w_in, p.shift[2 * l - 1]));
      gemm_rows<ND_H, ND_W, SG>(As, Bs, p, RowsA<ND_H>{Q, hplane, w_in},
                                weight(l), w_in, p.nw[l], nullptr, corr(l),
                                hidden_out(P[l & 1], p.nw[l], p.shift[2 * l]));
      cluster_sync();
    }
    gemm_rows<1, ND_H, SG>(As, Bs, p, adj,
                           RowsB<ND_H>{P[(n - 1) & 1], hplane, p.nw[n - 1]},
                           p.pn, p.nw[n - 1], sched, nullptr, F32Out{out, p.oc});
  } else {
    for (int l = 0; l < n; ++l) {
      const int w_in = l ? p.nw[l - 1] : p.xp;
      if (l == 0)
        gemm_rows<1, ND_X, SG>(
            As, Bs, p, adj, RowsB<ND_X, XF>{xb, xplane, p.xp, p.x_hi},
            p.pn, p.xp, sched, nullptr, hidden_out(Q, p.xp, p.shift[0]));
      else
        gemm_rows<1, ND_H, SG>(As, Bs, p, adj,
                               RowsB<ND_H>{P[(l - 1) & 1], hplane, w_in}, p.pn,
                               w_in, sched, nullptr,
                               hidden_out(Q, w_in, p.shift[2 * l]));
      const RowsA<ND_H> q{Q, hplane, w_in};
      if (l < n - 1) {
        gemm_rows<ND_H, ND_W, SG>(
            As, Bs, p, q, weight(l), w_in, p.nw[l], nullptr, corr(l),
            hidden_out(P[l & 1], p.nw[l], p.shift[2 * l + 1]));
        cluster_sync();
      } else {
        gemm_rows<ND_H, ND_W, SG>(As, Bs, p, q, weight(l), w_in, p.nw[l],
                                  nullptr, corr(l), F32Out{out, p.oc});
      }
    }
  }
}

template <int XF, int ND_X, int ND_W, int ND_H>
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
      cudaLaunchKernelEx(&cfg, fused_model_kernel<XF, ND_X, ND_W, ND_H>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int XF, int ND_X, int ND_W>
int launch_h(const Params& p, int nd_h, cudaStream_t s) {
  if (nd_h == 1) return launch_fused<XF, ND_X, ND_W, 1>(p, s);
  if (nd_h == 2) return launch_fused<XF, ND_X, ND_W, 2>(p, s);
  return (int)cudaErrorInvalidValue;
}

// The digit chain's launches for X of form XF (X_DIGITS or X_SPLIT) with
// ND_X digit planes.
template <int XF, int ND_X>
int launch_x(const Params& p, int nd_w, int nd_h, cudaStream_t s) {
  if (nd_w == 1) return launch_h<XF, ND_X, 1>(p, nd_h, s);
  if (nd_w == 2) return launch_h<XF, ND_X, 2>(p, nd_h, s);
  return (int)cudaErrorInvalidValue;
}

// Defined in the other translation units.
int launch_x2(const Params& p, int nd_w, int nd_h, cudaStream_t s);
int launch_split(const Params& p, int nd_w, int nd_h, cudaStream_t s);
int launch_signed(const Params& p, cudaStream_t s);

}  // namespace mega
}  // namespace qgtc
