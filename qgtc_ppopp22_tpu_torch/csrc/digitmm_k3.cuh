// K3, the digit-plane GEMM (csrc/digitmm.cu is its C entry and says what
// bounds it), redesigned for Hopper: sized to the operands' real extents.
//
// Digit tensors are padded to 128 in both dimensions (the TPU's lane
// width). The step engine's updates are X[2560 x 128] x W[128 x 16] and
// H[2560 x 16] x W[16 x 16 | 40]: a kernel over the padded extent computes
// 128 columns where 16 or 40 are real and, for H x W, reads 8x the real
// contraction of A. This one takes the real K and N from the wrapper
// (ops/digitmm.py digitmm_plan: K rounded up to the int8 MMA's depth of
// 32, N to its 8 columns) and:
//   * computes only those: its column tile (BNT = 16 or 32) is sized
//     to N, and its K steps stop at K; the padded columns past the last
//     column tile are stored as level 0, without being computed, by a
//     column of CTAs of their own beside the computing ones;
//   * takes 16, 32 or 64 rows a CTA (one warp per 16 rows), so that the
//     updates' 2560 rows spread over more CTAs than the card has SMs;
//   * brings A and B in by cp.async.cg into a ring of 3 slots of `ks`
//     (<= 128) columns, issued 2 steps ahead: at C1's
//     updates (K <= 128) the whole contraction is one step, in flight at
//     once; a long contraction (the K-skip form's A[2560²] digit plane)
//     streams through the ring;
//   * lands B row-major as it lies in memory and transposes it once a
//     step, by 4 x 4 byte blocks (8 byte permutes), into [n][k] rows, so
//     that both mma.sync fragments are plain 32-bit shared loads.
// The all-digit-pairs fusion (one int32 accumulator set per digit shift
// 4 (d + e)), the requantize epilogue (gemm_core.cuh store_pair) and the
// TileMap K skip (a compile-time MAPPED flag: a run-time general K loop
// cost the dense kernels 13-20%) are gemm_core.cuh's, which K4 and K2's
// 8-bit plane still run unchanged.
#pragma once

#include "async_cluster.cuh"
#include "gemm_core.cuh"

namespace qgtc {
namespace k3 {

constexpr int STAGES = 3;    // ring slots
constexpr int KS_MAX = 128;  // the deepest ring stage, in columns of A

// The shared memory of one launch (ops/digitmm.py _k3_smem takes the same
// sums): STAGES slots, each A's rows [nd_a][rows][ks + 16] and B's rows
// as they lie in memory [nd_b][ks][bnt]; then B transposed,
// [nd_b][bnt][ks + 16]. A row stride of ks + 16 bytes puts the 8 rows x 4
// words of a fragment load in 32 distinct banks (ks a multiple of 32).
struct Layout {
  int ld, slot, off_b, off_bt, total;
};

inline Layout layout(int nd_a, int nd_b, int rows, int bnt, int ks) {
  Layout L{};
  L.ld = ks + 16;
  L.off_b = nd_a * rows * L.ld;
  L.slot = (L.off_b + nd_b * ks * bnt + 127) / 128 * 128;
  L.off_bt = STAGES * L.slot;
  L.total = L.off_bt + nd_b * bnt * L.ld;
  return L;
}

struct Args {
  Epilogue ep;
  const int8_t* a;  // [nd_a][mp][kp]
  const int8_t* b;  // [nd_b][kp][np]
  KMap km;
  int mp, kp, np, kr, rows, ks, col_tiles;
  int ld, slot, off_b, off_bt;
};

// The K steps of one CTA, in order: [0, kr) in steps of ks (dense), or
// each listed K tile of its row tile cut into steps of ks (MAPPED; an
// entry outside the grid is skipped); no step starts at or past kr, and
// the last one of a range is cut to what is left of it.
template <bool MAPPED>
struct Cursor {
  const int* list;
  int cnt, nk, tk, ks, kr;
  int t, j;

  __device__ __forceinline__ Cursor(const Args& p, int m0) : list(nullptr), cnt(1), nk(1), tk(p.kr),
                                                             ks(p.ks), kr(p.kr), t(0), j(0) {
    if (MAPPED) {
      const int i = m0 / p.km.tile_m;
      nk = p.kp / p.km.tile_k;
      tk = p.km.tile_k;
      cnt = min(__ldg(p.km.kcnt + i), nk);
      list = p.km.kidx + (size_t)i * nk;
    }
    settle();
  }
  __device__ __forceinline__ int base() const { return MAPPED ? __ldg(list + t) * tk : 0; }
  __device__ __forceinline__ void settle() {
#pragma unroll 1
    while (t < cnt) {
      if (MAPPED) {
        const int kt = __ldg(list + t);
        if (kt < 0 || kt >= nk) {
          ++t;
          continue;
        }
      }
      if (j * ks < tk && base() + j * ks < kr) return;
      ++t;
      j = 0;
    }
  }
  __device__ __forceinline__ bool done() const { return t >= cnt; }
  // the current step's first column and depth; then advance
  __device__ __forceinline__ void next(int& k0, int& kk) {
    const int b0 = base();
    k0 = b0 + j * ks;
    kk = min(ks, min(b0 + tk, kr) - k0);
    ++j;
    settle();
  }
};

// A 4 x 4 byte block, rows r[0..3], transposed: o[j] holds byte j of each
// row, row i in byte i.
__device__ __forceinline__ void transpose4(uint32_t (&o)[4], const uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362), t3 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// The output's columns past the last column tile, rows m0 .. m0 + rows:
// level 0 (a zero sum), every plane of a digit output.
__device__ __forceinline__ void fill_padding(const Args& p, int bnt, int m0) {
  const bool digits = p.ep.kind == OUT_DIGITS;
  const int width = digits ? p.np : p.ep.ocp, esz = digits ? 1 : 4;
  const int c0 = min(p.col_tiles * bnt, width);
  const int per = ((width - c0) * esz) >> 4;
  const int planes = digits ? (p.ep.out_bits + 3) / 4 : 1;
  unsigned char* const out = static_cast<unsigned char*>(p.ep.out);
  for (int i = threadIdx.x; i < planes * p.rows * per; i += blockDim.x) {
    const int d = i / (p.rows * per), rem = i - d * p.rows * per, r = rem / per, c = rem - r * per;
    *reinterpret_cast<int4*>(out + ((size_t)d * p.mp + m0 + r) * width * esz + c0 * esz + 16 * c) =
        make_int4(0, 0, 0, 0);
  }
}

// One step's copies into slot `s`, one commit group (empty past the end):
// A's rows [nd_a][rows][kk] and B's rows [nd_b][kk][BNT] of the step `ld`
// takes next. Returns the step's depth kk, 0 past the end.
template <int ND_A, int ND_B, int BNT, bool MAPPED>
__device__ __forceinline__ int issue_step(const Args& p, Cursor<MAPPED>& ld, unsigned char* s, int m0, int n0) {
  constexpr int BCH = BNT / 16;  // 16-byte chunks of a B row
  const int tid = threadIdx.x, nthr = blockDim.x;
  int kk = 0;
  if (!ld.done()) {
    int k0;
    ld.next(k0, kk);
    const int cpr = kk >> 4, per_a = p.rows * cpr;
    for (int c = tid; c < ND_A * per_a; c += nthr) {
      const int d = c / per_a, rem = c - d * per_a, r = rem / cpr, kc = (rem - r * cpr) << 4;
      cp_async16(s + (d * p.rows + r) * p.ld + kc, p.a + ((size_t)d * p.mp + m0 + r) * p.kp + k0 + kc, true);
    }
    const int per_b = kk * BCH;
    for (int c = tid; c < ND_B * per_b; c += nthr) {
      const int e = c / per_b, rem = c - e * per_b, k = rem / BCH, nc = (rem % BCH) << 4;
      cp_async16(s + p.off_b + (e * p.ks + k) * BNT + nc, p.b + ((size_t)e * p.kp + k0 + k) * p.np + n0 + nc, true);
    }
  }
  cp_commit();
  return kk;
}

// One block an SM asked of the launch bounds: with none, ptxas spilled 12
// bytes in one mapped instantiation at 64 registers (PERF.md §6).
template <int ND_A, int ND_B, int BNT, bool MAPPED>
__global__ void __launch_bounds__(128, 1) k3_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NS = ND_A + ND_B - 1;  // distinct digit shifts
  constexpr int NT8 = BNT / 8;         // n-tiles of a warp
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * p.rows, n0 = blockIdx.x * BNT;
  int8_t* const bt = reinterpret_cast<int8_t*>(smem + p.off_bt);
  if ((int)blockIdx.x >= p.col_tiles) {
    fill_padding(p, BNT, m0);
    return;
  }

  int acc[NS][NT8][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int u = 0; u < NT8; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[s][u][i] = 0;

  // depth[i]: the depth of step s + i, in flight (0: no such step); the
  // loader's cursor alone walks the steps
  Cursor<MAPPED> ld(p, m0);
  int depth[STAGES];
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) depth[i] = issue_step<ND_A, ND_B, BNT>(p, ld, smem + i * p.slot, m0, n0);
#pragma unroll 1
  for (int s = 0; depth[0] > 0; ++s) {
    const int kk = depth[0];
    cp_wait<STAGES - 2>();
    __syncthreads();  // step s landed; step s - 1's MMAs are done with its slot and bt
    depth[STAGES - 1] = issue_step<ND_A, ND_B, BNT>(p, ld, smem + (s + STAGES - 1) % STAGES * p.slot, m0, n0);
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) depth[i] = depth[i + 1];
    const unsigned char* sl = smem + (s % STAGES) * p.slot;
    // B, [nd_b][kk][BNT] as it landed -> bt [nd_b][BNT][ld], by 4 x 4 blocks
    const int blocks = (kk >> 2) * (BNT / 4);
    for (int c = tid; c < ND_B * blocks; c += nthr) {
      const int e = c / blocks, rem = c - e * blocks, kb = (rem / (BNT / 4)) << 2,
                nb = (rem % (BNT / 4)) << 2;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(sl + p.off_b + (e * p.ks + kb) * BNT + nb);
      const uint32_t r[4] = {src[0], src[BNT / 4], src[BNT / 2], src[3 * BNT / 4]};
      uint32_t o[4];
      transpose4(o, r);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(bt + (e * BNT + nb + j) * p.ld + kb) = o[j];
    }
    __syncthreads();
    const int8_t* as = reinterpret_cast<const int8_t*>(sl) + (warp * 16 + g) * p.ld + t4 * 4;
#pragma unroll 1
    for (int kq = 0; kq < kk; kq += 32) {
      uint32_t af[ND_A][4], bf[ND_B][NT8][2];
#pragma unroll
      for (int d = 0; d < ND_A; ++d) {
        const int8_t* pa = as + d * p.rows * p.ld + kq;
        af[d][0] = *reinterpret_cast<const uint32_t*>(pa);
        af[d][1] = *reinterpret_cast<const uint32_t*>(pa + 8 * p.ld);
        af[d][2] = *reinterpret_cast<const uint32_t*>(pa + 16);
        af[d][3] = *reinterpret_cast<const uint32_t*>(pa + 8 * p.ld + 16);
      }
#pragma unroll
      for (int e = 0; e < ND_B; ++e)
#pragma unroll
        for (int u = 0; u < NT8; ++u)
          frag_b(bf[e][u], bt + (e * BNT + u * 8 + g) * p.ld + kq + t4 * 4);
#pragma unroll
      for (int d = 0; d < ND_A; ++d)
#pragma unroll
        for (int e = 0; e < ND_B; ++e)
#pragma unroll
          for (int u = 0; u < NT8; ++u) mma_s8(acc[d + e][u], af[d], bf[e][u]);
    }
  }

#pragma unroll
  for (int u = 0; u < NT8; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8
      int v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t s = 0;  // unsigned: the shifted sum wraps like int32
#pragma unroll
        for (int si = 0; si < NS; ++si) s += (uint32_t)acc[si][u][2 * h + j] << (4 * si);
        v[j] = (int)s;
      }
      store_pair(p.ep, m0 + warp * 16 + g + 8 * h, n0 + u * 8 + t4 * 2, v[0], v[1]);
    }
}

template <int ND_A, int ND_B, int BNT>
int launch_bnt(const Args& p, int smem, cudaStream_t s) {
  const bool mapped = p.km.kcnt != nullptr;
  auto kern = mapped ? k3_kernel<ND_A, ND_B, BNT, true> : k3_kernel<ND_A, ND_B, BNT, false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int width = p.ep.kind == OUT_DIGITS ? p.np : p.ep.ocp;
  const int fill = p.col_tiles * BNT < width;  // a column of CTAs that only store the padding
  kern<<<dim3(p.col_tiles + fill, p.mp / p.rows), 2 * p.rows, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int ND_A, int ND_B>
int launch_pair(const Args& p, int bnt, int smem, cudaStream_t s) {
  return bnt == 16 ? launch_bnt<ND_A, ND_B, 16>(p, smem, s) : launch_bnt<ND_A, ND_B, 32>(p, smem, s);
}

}  // namespace k3
}  // namespace qgtc
