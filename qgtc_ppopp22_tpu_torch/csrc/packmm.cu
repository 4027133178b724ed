// packmm: M-packed A x digit planes with the fused requantize epilogue.
//
// Replaces the TPU kernel qgtc_ppopp22_tpu/ops/packmm.py::_packmm
// (kernel_body at :840, pallas_call at :1022), dense-K form, for the
// PackedTensor layouts: 1-, 2- and 4-bit fields in int32 words, and the
// one offset-signed byte plane of 5-8 bit levels. The zero-tile K skip,
// the packed-words output and the PreparedRHS variant are not ported.
//
// A's layout (ops/packmm.py): within each 256-row group, logical row
// q*4*gw + 4*i + k sits in bits [8k + f*q, 8k + f*(q+1)) of word row i,
// with f the field width, rpw = 32 / f rows per word and gw = 256 / rpw
// word rows per group.
//
// What bounds it on an H100: the step engine's aggregations A x H are
// M = K = pn ~ 2560, N = 128 (16 or 40 real columns), about 0.84 GOP per
// digit pair against 0.8 MB of packed A. The tensor cores need about a
// microsecond for that; the unpack of A (shifts and masks, 8x the packed
// bytes written to shared memory) and launch overhead bound it.
// What the design does about it: A crosses device memory packed (1 bit
// per value) and is unpacked straight into the shared-memory int8 tile
// the mma fragments read; the requantize epilogue runs in registers.
#include "gemm_core.cuh"

using namespace qgtc;

namespace {

// int32 words [mp / (32 / F)][kp] of F-bit fields -> int8 A tile.
template <int F>
struct PackedLoader {
  const int32_t* __restrict__ w;
  int kp;

  template <int ND>
  __device__ __forceinline__ void load(int8_t (*As)[BM][LDS], int m0, int k0,
                                       int tid) const {
    static_assert(ND == 1, "packed A holds one digit plane");
    constexpr int GW = 8 * F;  // word rows per 256-row group
    constexpr uint32_t MASK = (1u << F) - 1;
    constexpr int CH = BK / 4;  // chunks of 4 columns (one int4 of words)
    for (int c = tid; c < BM * CH; c += THREADS) {
      const int r = c / CH, kc = (c % CH) * 4;
      const int m = m0 + r;
      const int rr = m & 255;
      const int q = rr / (4 * GW), rem = rr % (4 * GW);
      const int wrow = (m >> 8) * GW + (rem >> 2);
      const int sh = 8 * (rem & 3) + F * q;
      const int4 v =
          __ldg(reinterpret_cast<const int4*>(w + (size_t)wrow * kp + k0 + kc));
      const uint32_t packed = (((uint32_t)v.x >> sh) & MASK) |
                              ((((uint32_t)v.y >> sh) & MASK) << 8) |
                              ((((uint32_t)v.z >> sh) & MASK) << 16) |
                              ((((uint32_t)v.w >> sh) & MASK) << 24);
      *reinterpret_cast<uint32_t*>(&As[0][r][kc]) = packed;
    }
  }
};

template <int F>
int launch_packed(const void* a, const void* b, int nd_b, int mp, int kp,
                  int np, const Epilogue& ep, cudaStream_t s) {
  const PackedLoader<F> la{static_cast<const int32_t*>(a), kp};
  if (nd_b == 1) return launch<1, 1, false>(la, b, mp, kp, np, ep, s);
  if (nd_b == 2) return launch<1, 2, false>(la, b, mp, kp, np, ep, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// field_bits: 1, 2 or 4 for int32 words [mp / (32 / field_bits)][kp];
// 8 for the offset-signed int8 plane [mp][kp]. mp counts logical rows.
// b: int8[nd_b][kp][np]; see gemm_core.cuh.
extern "C" int qgtc_packmm(void* out, const void* a, const void* b,
                           int field_bits, int nd_b, int mp, int kp, int np,
                           int out_kind, int out_bits, int shift,
                           void* stream) {
  if (!shapes_ok(mp, kp, np, out_kind, out_bits, shift) || mp % 256)
    return (int)cudaErrorInvalidValue;
  const Epilogue ep{out, mp, np, out_kind, out_bits, shift};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (field_bits) {
    case 1: return launch_packed<1>(a, b, nd_b, mp, kp, np, ep, s);
    case 2: return launch_packed<2>(a, b, nd_b, mp, kp, np, ep, s);
    case 4: return launch_packed<4>(a, b, nd_b, mp, kp, np, ep, s);
    case 8: {
      const Int8Loader la{static_cast<const int8_t*>(a), mp, kp};
      if (nd_b == 1) return launch<1, 1, true>(la, b, mp, kp, np, ep, s);
      if (nd_b == 2) return launch<1, 2, true>(la, b, mp, kp, np, ep, s);
      return (int)cudaErrorInvalidValue;
    }
    default: return (int)cudaErrorInvalidValue;
  }
}
