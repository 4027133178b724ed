// packmm_signed: offset-signed 8-bit A plane x PreparedRHS plane, one
// int8 pass with the full offset correction in the epilogue.
//
// Replaces the TPU kernel qgtc_ppopp22_tpu/ops/packmm.py::
// _packmm_signed_stream (:473, pallas_call at :633), the 5-8 bit rows of
// the kernel sweep (prepare_rhs + packmm_to_packed).
//
// Operands: A int8[mp][kp] = level - 128 (a PackedTensor of 5-8 bits);
// plane int8[kp][np] = B level - 128 with lane np - 1 set to 1; corr int32
// [8][np], row 0 = 128 * colsum(plane) + 128^2 * kp. Then
//   A @ B = A_s @ plane + 128 * rowsum(A_s) + corr[0]
// exactly on every lane but np - 1 (padding rows and columns of both hold
// level 0 and come out as 0). The TPU kernel reads rowsum(A_s) from the
// dot's lane np - 1, where plane is 1; here only the CTA owning the last
// column tile sees that lane, so every CTA sums its A rows itself from the
// bytes it already stages (dp4a), the same integer. Lane np - 1 keeps the
// TPU kernel's junk value, and the wrapper's mask_n stores it as level 0
// wherever the TPU kernel masks it. The int32 guard of the wrapper
// (4 * 128^2 * kp < 2^31) keeps every term and the sum from wrapping.
//
// Outputs (gemm_core.cuh): f32 / i32 [mp][ocp], digit planes [nd][mp][np],
// the signed byte plane int8[1][mp][ocp] (5-8 bit out) or low-bit packed
// words int32[1][mp / (32 / f)][ocp], through the same epilogue as packmm.
//
// What bounds it on an H100: at the sweep's largest 8-bit shape
// (M = K = 4096, N = 64, out_cols = 64) it must read 16.8 MB of A and
// write 0.26 MB: 5.2 us at 3.35 TB/s, against 1.1 us for its 2.15 G int8
// operations, so bytes bound it. What the design does about it: A is
// read once per 64-column tile as plain int8 rows (no unpack), at 16
// bytes a thread, and the correction costs no extra pass over A (it is
// summed from the staged tile); the output crosses device memory as
// narrow bytes or packed words only. The grid covers only the column
// tiles that hold stored columns: with out_cols = 64 of the 128 padded
// columns, one tile, so A is read once (without out_cols, twice). The
// single-stage K loop (64 CTAs of 4
// warps, each through all 64 K steps) is what is left between it and the
// bound; a cp.async/TMA ring or split-K is later work.
#include "gemm_core.cuh"

using namespace qgtc;

// a: int8[mp][kp]; plane: int8[kp][np]; corr: int32[8][np];
// mask_n: columns >= mask_n are stored as level 0 (np: none).
extern "C" int qgtc_packmm_signed(void* out, const void* a, const void* plane,
                                  const void* corr, int mp, int kp, int np,
                                  int out_kind, int out_bits, int shift,
                                  int ocp, int mask_n, void* stream) {
  if (!shapes_ok(mp, kp, np, out_kind, out_bits, shift, ocp) || mp % GROUP ||
      mask_n < 0 || mask_n > np)
    return (int)cudaErrorInvalidValue;
  const Epilogue ep{out, mp, np, out_kind, out_bits, shift, ocp, mask_n,
                    static_cast<const int*>(corr)};
  const Int8Loader la{static_cast<const int8_t*>(a), mp, kp};
  return launch<1, 1, CORR_PREPARED>(la, plane, mp, kp, np, ep, KMap{},
                                     static_cast<cudaStream_t>(stream));
}
