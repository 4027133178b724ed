// packmm: M-packed A x digit planes with the fused requantize epilogue.
//
// Replaces the TPU kernel qgtc_ppopp22_tpu/ops/packmm.py::_packmm
// (kernel_body at :840, pallas_call at :1022) for the PackedTensor
// layouts: 1-, 2- and 4-bit fields in int32 words, and the one
// offset-signed byte plane of 5-8 bit levels. Outputs: digit planes,
// float32, int32, or the packed form again (M-packed words, or the signed
// byte plane for 5-8 bits: bit in, bit out), with out_cols narrowing the
// terminal stores. With a TileMap (kidx, kcnt) each CTA visits only the K
// tiles its row tile lists (zero-tile jumping, the TPU kernel's
// t < kcnt[i] guard at :890); for a signed-plane A the colsum correction
// is summed over those tiles only, as the TPU kernel's is (:875-888). The
// PreparedRHS variant is packmm_signed.cu.
//
// A's layout (ops/packmm.py): within each 256-row group, logical row
// q*4*gw + 4*i + k sits in bits [8k + f*q, 8k + f*(q+1)) of word row i,
// with f the field width, rpw = 32 / f rows per word and gw = 256 / rpw
// word rows per group. Packed words out use the same layout, so the output
// feeds the next product as its A.
//
// What bounds it on an H100: the step engine's aggregations A x H are
// M = K = pn ~ 2560, N = 128 (16 or 40 real columns), about 0.84 GOP per
// digit pair against 0.8 MB of packed A. The tensor cores need about a
// microsecond for that; the unpack of A (shifts and masks, 8x the packed
// bytes written to shared memory) and launch overhead bound it. The
// kernel sweep's 1-bit bit-in/bit-out shape M = K = 4096, N = 64 needs
// 2.15 G operations against 2.7 MB: 1.09 us at the int8 peak. With a map,
// only the listed tiles' bytes and operations are needed (C1: a quarter
// of the 256 x 256 tiles).
// What the design does about it: A crosses device memory packed (1 bit
// per value) and is unpacked straight into the shared-memory int8 tile
// the mma fragments read; the requantize epilogue runs in registers, and
// a packed-words output is built in shared memory by a CTA that owns the
// whole 256-row group (16 warps), so only packed words reach device memory.
// A skipped tile costs neither its load nor its K steps.
#include "gemm_core.cuh"

using namespace qgtc;

namespace {

template <int F>
int launch_packed(const void* a, const void* b, int nd_b, int mp, int kp,
                  int np, const Epilogue& ep, const KMap& km, cudaStream_t s) {
  const PackedLoader<F> la{static_cast<const int32_t*>(a), kp};
  if (nd_b == 1) return launch<1, 1, CORR_NONE>(la, b, mp, kp, np, ep, km, s);
  if (nd_b == 2) return launch<1, 2, CORR_NONE>(la, b, mp, kp, np, ep, km, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// field_bits: 1, 2 or 4 for int32 words [mp / (32 / field_bits)][kp];
// 8 for the offset-signed int8 plane [mp][kp]. mp counts logical rows.
// b: int8[nd_b][kp][np]; ocp: stored columns of the f32 / i32 / packed
// outputs (np for digits); kidx / kcnt: the TileMap, or null for the dense
// contraction (tile_m a multiple of 256, tile_k of 64); see gemm_core.cuh.
extern "C" int qgtc_packmm(void* out, const void* a, const void* b,
                           int field_bits, int nd_b, int mp, int kp, int np,
                           int out_kind, int out_bits, int shift, int ocp,
                           const void* kidx, const void* kcnt, int tile_m,
                           int tile_k, void* stream) {
  const KMap km{static_cast<const int*>(kidx), static_cast<const int*>(kcnt),
                tile_m, tile_k};
  if (!shapes_ok(mp, kp, np, out_kind, out_bits, shift, ocp) || mp % GROUP ||
      !map_ok(km, mp, kp, GROUP, BK))
    return (int)cudaErrorInvalidValue;
  const Epilogue ep{out, mp, np, out_kind, out_bits, shift, ocp, np, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (field_bits) {
    case 1: return launch_packed<1>(a, b, nd_b, mp, kp, np, ep, km, s);
    case 2: return launch_packed<2>(a, b, nd_b, mp, kp, np, ep, km, s);
    case 4: return launch_packed<4>(a, b, nd_b, mp, kp, np, ep, km, s);
    case 8: {
      const Int8Loader la{static_cast<const int8_t*>(a), mp, kp};
      if (nd_b == 1) return launch<1, 1, CORR_COLSUM>(la, b, mp, kp, np, ep, km, s);
      if (nd_b == 2) return launch<1, 2, CORR_COLSUM>(la, b, mp, kp, np, ep, km, s);
      return (int)cudaErrorInvalidValue;
    }
    default: return (int)cudaErrorInvalidValue;
  }
}
