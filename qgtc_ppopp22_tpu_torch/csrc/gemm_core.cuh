// Integer tile-GEMM core shared by the digitmm and packmm kernels.
//
// C = sum_{d<ND_A, e<ND_B} dot(A_d, B_e) << 4*(d+e), exact in int32,
// followed by one fused epilogue: requantize to base-16 digit planes, or
// store the raw sum as float32 / int32. The two kernels differ only in
// how an A tile reaches shared memory (the ALoader template argument).
//
// Shape contract (checked by the C entry points and the Python wrappers):
//   A: rows mp, contraction kp; B: int8[ND_B][kp][np] digit planes;
//   mp % BM == 0, np % BN == 0, kp % BK == 0; every padded row and column
//   of A and B holds level 0, so the padded outputs come out as 0.
// Output: digits int8[nd_o][mp][np], or f32 / i32 [mp][np]. The kernel
// writes every element, padding included.
//
// Design: a CTA of 4 warps owns one BM x BN output tile and loops over
// the whole contraction itself (nothing carries across CTAs). Per BK
// step it stages the A and B tiles in shared memory, B transposed to
// [n][k] so that both mma.sync fragments are plain 32-bit loads, and
// runs int8 mma.sync.m16n8k32 with one int32 accumulator set per digit
// shift 4*(d+e). This is the simple, single-stage form; cp.async/TMA
// rings and wgmma are later work.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qgtc {

constexpr int BM = 64;        // output rows per CTA
constexpr int BN = 64;        // output columns per CTA
constexpr int BK = 64;        // contraction depth per shared-memory stage
constexpr int LDS = BK + 16;  // smem row stride in bytes (20 words: the
                              // 8 rows x 4 words of a fragment load fall
                              // in 32 distinct banks)
constexpr int THREADS = 128;  // 4 warps as 2 x 2, each a 32 x 32 tile

enum OutKind { OUT_DIGITS = 0, OUT_F32 = 1, OUT_I32 = 2 };

struct Epilogue {
  void* out;
  int mp, np;
  int kind;      // OutKind
  int out_bits;  // OUT_DIGITS only
  int shift;     // OUT_DIGITS only: arithmetic >> before the clamp
};

// Plain int8 rows, [ND][mp][kp]: digit planes, or the one offset-signed
// byte plane of a 5-8 bit packed A.
struct Int8Loader {
  const int8_t* __restrict__ a;
  int mp, kp;

  template <int ND>
  __device__ __forceinline__ void load(int8_t (*As)[BM][LDS], int m0, int k0,
                                       int tid) const {
    constexpr int CH = BK / 16;  // 16-byte chunks per row
    for (int c = tid; c < BM * CH; c += THREADS) {
      const int r = c / CH, kc = (c % CH) * 16;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(
            a + (size_t)d * mp * kp + (size_t)(m0 + r) * kp + k0 + kc));
        *reinterpret_cast<int4*>(&As[d][r][kc]) = v;
      }
    }
  }
};

template <int ND_B>
__device__ __forceinline__ void load_b(int8_t (*Bs)[BN][LDS],
                                       const int8_t* __restrict__ b, int kp,
                                       int np, int k0, int n0, int tid) {
  constexpr int CH = BN / 16;
  for (int c = tid; c < BK * CH; c += THREADS) {
    const int k = c / CH, nc = (c % CH) * 16;
#pragma unroll
    for (int e = 0; e < ND_B; ++e) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(
          b + (size_t)e * kp * np + (size_t)(k0 + k) * np + n0 + nc));
      const int8_t* bytes = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) Bs[e][nc + j][k] = bytes[j];
    }
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Reference requantizer (qgtc_ppopp22_tpu/ops/quantize.py): after >>shift,
// acc > 2^b -> 2^b - 1, acc < 0 -> 1, else unchanged; then keep the low b
// bits, so acc == 2^b wraps to 0.
__device__ __forceinline__ int requant(int acc, int out_bits, int shift) {
  const int ub = 1 << out_bits;
  const int v = acc >> shift;  // arithmetic, like int32 >> in JAX
  const int r = v > ub ? ub - 1 : (v < 0 ? 1 : v);
  return r & (ub - 1);
}

__device__ __forceinline__ void store_pair(const Epilogue& ep, int row,
                                           int col, int v0, int v1) {
  const size_t idx = (size_t)row * ep.np + col;
  if (ep.kind == OUT_F32) {
    *reinterpret_cast<float2*>(static_cast<float*>(ep.out) + idx) =
        make_float2((float)v0, (float)v1);
  } else if (ep.kind == OUT_I32) {
    *reinterpret_cast<int2*>(static_cast<int*>(ep.out) + idx) =
        make_int2(v0, v1);
  } else {
    const int r0 = requant(v0, ep.out_bits, ep.shift);
    const int r1 = requant(v1, ep.out_bits, ep.shift);
    int8_t* o = static_cast<int8_t*>(ep.out);
    const size_t plane = (size_t)ep.mp * ep.np;
    const int nd_o = (ep.out_bits + 3) / 4;
    for (int d = 0; d < nd_o; ++d) {
      const int width = min(4, ep.out_bits - 4 * d);
      const int mask = (1 << width) - 1;
      char2 c;
      c.x = (char)((r0 >> (4 * d)) & mask);
      c.y = (char)((r1 >> (4 * d)) & mask);
      *reinterpret_cast<char2*>(o + d * plane + idx) = c;
    }
  }
}

// A_SIGNED: A holds offset-signed bytes (level - 128); the epilogue adds
// the exact rank-1 correction 128 * colsum(B levels) over the whole
// contraction (padded A columns hold level 0 and cancel against it).
template <int ND_A, int ND_B, bool A_SIGNED, class ALoader>
__global__ void __launch_bounds__(THREADS)
    gemm_kernel(ALoader la, const int8_t* __restrict__ b, int kp,
                Epilogue ep) {
  __shared__ __align__(16) int8_t As[ND_A][BM][LDS];
  __shared__ __align__(16) int8_t Bs[ND_B][BN][LDS];  // [n][k]
  __shared__ int colsum[BN];

  constexpr int NS = ND_A + ND_B - 1;  // distinct digit shifts
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // mma groupID / thread-in-group
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[NS][2][4][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[s][mt][nt][i] = 0;
  int cs = 0;

  for (int k0 = 0; k0 < kp; k0 += BK) {
    la.template load<ND_A>(As, m0, k0, tid);
    load_b<ND_B>(Bs, b, kp, ep.np, k0, n0, tid);
    __syncthreads();
    if (A_SIGNED && tid < BN) {
#pragma unroll
      for (int e = 0; e < ND_B; ++e)
        for (int k = 0; k < BK; ++k) cs += (int)Bs[e][tid][k] << (4 * e);
    }
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[ND_A][2][4];
      uint32_t bf[ND_B][4][2];
#pragma unroll
      for (int d = 0; d < ND_A; ++d)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int8_t* p = &As[d][wm + mt * 16 + g][ks + t4 * 4];
          af[d][mt][0] = *reinterpret_cast<const uint32_t*>(p);
          af[d][mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
          af[d][mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
          af[d][mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
        }
#pragma unroll
      for (int e = 0; e < ND_B; ++e)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int8_t* p = &Bs[e][wn + nt * 8 + g][ks + t4 * 4];
          bf[e][nt][0] = *reinterpret_cast<const uint32_t*>(p);
          bf[e][nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
        }
#pragma unroll
      for (int d = 0; d < ND_A; ++d)
#pragma unroll
        for (int e = 0; e < ND_B; ++e)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_s8(acc[d + e][mt][nt], af[d][mt], bf[e][nt]);
    }
    __syncthreads();
  }
  if (A_SIGNED) {
    if (tid < BN) colsum[tid] = cs;
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8
        const int col = wn + nt * 8 + t4 * 2;
        uint32_t v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t s = 0;  // unsigned: the shifted sum wraps like int32
#pragma unroll
          for (int si = 0; si < NS; ++si)
            s += (uint32_t)acc[si][mt][nt][2 * h + j] << (4 * si);
          if (A_SIGNED) s += (uint32_t)colsum[col + j] << 7;
          v[j] = s;
        }
        store_pair(ep, m0 + wm + mt * 16 + g + 8 * h, n0 + col, (int)v[0],
                   (int)v[1]);
      }
}

template <int ND_A, int ND_B, bool A_SIGNED, class ALoader>
int launch(const ALoader& la, const void* b, int mp, int kp, int np,
           const Epilogue& ep, cudaStream_t stream) {
  const dim3 grid(np / BN, mp / BM);
  gemm_kernel<ND_A, ND_B, A_SIGNED, ALoader><<<grid, THREADS, 0, stream>>>(
      la, static_cast<const int8_t*>(b), kp, ep);
  return (int)cudaGetLastError();
}

inline bool shapes_ok(int mp, int kp, int np, int kind, int out_bits,
                      int shift) {
  if (mp <= 0 || kp <= 0 || np <= 0) return false;
  if (mp % BM || kp % BK || np % BN) return false;
  if (kind < OUT_DIGITS || kind > OUT_I32) return false;
  if (kind == OUT_DIGITS && (out_bits < 1 || out_bits > 8 || shift < 0 ||
                             shift > 31))
    return false;
  return true;
}

}  // namespace qgtc
