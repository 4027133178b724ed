// packmm_signed: offset-signed 8-bit A plane x PreparedRHS plane, one
// int8 pass with the full offset correction in the epilogue.
//
// Replaces the TPU kernel qgtc_ppopp22_tpu/ops/packmm.py::
// _packmm_signed_stream (:473, pallas_call at :633), the 5-8 bit rows of
// the kernel sweep (prepare_rhs + packmm_to_packed).
//
// Operands: A int8[mp][kp] = level - 128 (a PackedTensor of 5-8 bits);
// plane int8[kp][np] = B level - 128 with lane np - 1 set to 1, given
// transposed (plane_t int8[np][kp], made once by prepare_rhs, so that its
// rows reach shared memory K-major as A's do); corr int32 [8][np], row 0 =
// 128 * colsum(plane) + 128^2 * kp. Then
//   A @ B = A_s @ plane + 128 * rowsum(A_s) + corr[0]
// exactly on every lane but np - 1 (padding rows and columns of both hold
// level 0 and come out as 0). The TPU kernel reads rowsum(A_s) from the
// dot's lane np - 1, where plane is 1; here only the CTA owning the last
// column tile would see that lane, so every CTA sums its A rows itself:
// its wgmmas run against 8 or 16 more rows of ones, the same integer.
// Lane np - 1
// keeps the TPU kernel's junk value, and the wrapper's mask_n stores it as
// level 0 wherever the TPU kernel masks it. The int32 guard of the
// wrapper (4 * 128^2 * kp < 2^31) keeps every term and the sum from
// wrapping.
//
// Outputs (gemm_core.cuh): f32 / i32 [mp][ocp], digit planes [nd][mp][np],
// the signed byte plane int8[1][mp][ocp] (5-8 bit out) or low-bit packed
// words int32[1][mp / (32 / f)][ocp], through the same epilogue stores as
// packmm.
//
// What bounds it on an H100: at the sweep's largest 8-bit shape
// (M = K = 4096, N = 64, out_cols = 64) it must read 16.8 MB of A and
// 0.26 MB of the plane's 64 real columns and write 0.26 MB: 17.30 MB,
// 5.16 us at 3.35 TB/s, against 1.1 us for its 2.15 G int8 operations,
// so bytes bound it. To stream 3.35 TB/s the card needs several MB of
// loads in flight. What the design (packmm_k4.cuh) does about it:
//   * A is read once: the grid covers only the column tiles that hold
//     computed columns (below round_up(mask_n, 8) and the stored width),
//     on a column tile sized to them (16, 32 or 64), so out_cols = 64 of
//     the 128 padded lanes is one tile; the padding past the grid is
//     stored as level 0 without a K loop;
//   * A and the transposed plane stream through a 4-slot cp.async ring in
//     128-deep steps, every row a whole 128-byte line in the swizzle that
//     wgmma reads, one barrier a step; the CTA's two warpgroups (128 rows)
//     read both operands from shared memory with wgmma, nothing transposed
//     in the loop;
//   * split-K over a thread-block cluster (S <= 4 CTAs per output tile,
//     reduced through distributed shared memory, each CTA storing a share
//     of the tile's rows): at 4096², 32 row tiles of 128 rows become 128
//     CTAs, all resident at once, several MB in flight;
//   * the correction costs no pass of its own: the rows of ones sum A's
//     rows on the tensor cores, each CTA's share joins the split-K
//     reduction, and corr[n] is added once;
//   * packed words out from 128-row CTAs, two to a cluster (a 256-row
//     group).
#include "packmm_k4.cuh"

using namespace qgtc;

// a: int8[mp][kp]; plane_t: int8[np][kp]; corr: int32[8][np]; mask_n:
// columns >= mask_n are stored as level 0 (np: none). bnt, grid (gx, gy,
// gz) and cluster (cx, cy, cz): the launch as ops/packmm.py
// packmm_signed_plan chose it for n = mask_n (k4::plan_ok), which this
// entry only checks.
extern "C" int qgtc_packmm_signed(void* out, const void* a, const void* plane_t,
                                  const void* corr, int mp, int kp, int np,
                                  int out_kind, int out_bits, int shift,
                                  int ocp, int mask_n, int bnt, int gx, int gy, int gz,
                                  int cx, int cy, int cz, void* stream) {
  if (!shapes_ok(mp, kp, np, out_kind, out_bits, shift, ocp) || mp % GROUP ||
      mask_n < 1 || mask_n > np ||
      !k4::plan_ok(k4::ROWS, mask_n, bnt, gx, gy, gz, cx, cy, cz, mp, np, out_kind, out_bits, ocp))
    return (int)cudaErrorInvalidValue;
  const Epilogue ep{out, mp, np, out_kind, out_bits, shift, ocp, mask_n,
                    static_cast<const int*>(corr)};
  return k4::launch_bnt<1, CORR_PREPARED>(static_cast<const int8_t*>(a),
                                          static_cast<const int8_t*>(plane_t), kp, ep, KMap{},
                                          bnt, gx, gz, static_cast<cudaStream_t>(stream));
}
