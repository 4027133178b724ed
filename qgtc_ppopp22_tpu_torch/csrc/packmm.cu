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
// t < kcnt[i] guard at :890, K skip at :811-814 and :840-895); for a
// signed-plane A the colsum correction is summed over those tiles only,
// as the TPU kernel's is (:875-888). The PreparedRHS variant is
// packmm_signed.cu.
//
// A's layout (ops/packmm.py): within each 256-row group, logical row
// q*4*gw + 4*i + k sits in bits [8k + f*q, 8k + f*(q+1)) of word row i,
// with f the field width, rpw = 32 / f rows per word and gw = 256 / rpw
// word rows per group. Packed words out use the same layout, so the output
// feeds the next product as its A.
//
// What bounds it on an H100. The step engine's aggregation at C1, A[2560²]
// 1-bit x H[2560 x 16] 2-bit to digits, needs 1.19 MB (0.82 MB of words,
// 0.04 MB for the 16 real columns of H, 0.33 MB for the 128-column digit
// plane out): 0.35 us at 3.35 TB/s, against 0.21 G int8 operations
// (0.11 us). The sweep's
// 1-bit 4096² x 64 to words needs 2.15 G operations (1.09 us at 1,979
// TOP/s) against 2.4 MB (0.72 us). Neither is near its bound: the time is
// the K loop's per-step cost times the steps a CTA runs in sequence (40
// at C1, 64 at 4096²), and how many CTAs share the card.
// What each lever does (packmm_k2.cuh, the 1/2/4-bit route):
//   * a column tile sized to N (16, 32 or 64 columns, chosen by the
//     wrapper's plan): no MMAs or B traffic for padding columns, and
//     column tiles past the real ones run no K loop at all (their outputs
//     are stored as level 0);
//   * each thread's word rows and bit offsets computed once per CTA, so
//     the loop only adds the K offset;
//   * a 4-stage cp.async ring for the words and B, unpacked from shared
//     memory into double-buffered int8 tiles: one barrier per step, the
//     loads in flight three steps ahead;
//   * split-K over a thread-block cluster (S <= 4 CTAs per output tile,
//     reduced through distributed shared memory): at C1, 40 row tiles
//     become 120 CTAs on 132 SMs;
//   * packed words from 64-row CTAs, four to a cluster, which assemble
//     each 256-row group's words over distributed shared memory: 64 CTAs
//     at M = 4096 where one CTA per group made 16.
// A skipped tile costs neither its loads nor its K steps. The 8-bit
// (signed plane) route runs K4's kernel (packmm_k4.cuh) with the colsum
// correction: the same ring, split-K and packed-words clusters, A's
// fragments loaded straight from the ring (its int8 rows need no unpack).
#include "packmm_k2.cuh"
#include "packmm_k4.cuh"

using namespace qgtc;

// field_bits: 1, 2 or 4 for int32 words [mp / (32 / field_bits)][kp];
// 8 for the offset-signed int8 plane [mp][kp]. mp counts logical rows.
// b: int8[nd_b][kp][np]; ocp: stored columns of the f32 / i32 / packed
// outputs (np for digits); kidx / kcnt: the TileMap, or null for the dense
// contraction (tile_m a multiple of 256, tile_k of 64); see gemm_core.cuh.
// n: B's real columns (those >= n hold level 0); bnt, grid (gx, gy, gz)
// and cluster (cx, cy, cz): the launch as ops/packmm.py packmm_plan (1/2/4
// bits) or packmm_signed_plan (8) chose it, which this entry only checks
// (k4::plan_ok: the column tile 16, 32 or 64, gx = ceil(min(round_up(n,
// 8), np or ocp) / bnt) column tiles, gy = mp / rows row tiles (64 rows a
// CTA for 1/2/4 bits, 128 for 8), gz = cz = the CTAs per output tile (1-4;
// 1-2 for packed words), cx = 1 and cy = 256 / rows for packed words (a
// 256-row group), else 1).
extern "C" int qgtc_packmm(void* out, const void* a, const void* b,
                           int field_bits, int nd_b, int mp, int kp, int np,
                           int out_kind, int out_bits, int shift, int ocp,
                           const void* kidx, const void* kcnt, int tile_m,
                           int tile_k, int n, int bnt, int gx, int gy, int gz,
                           int cx, int cy, int cz, void* stream) {
  const KMap km{static_cast<const int*>(kidx), static_cast<const int*>(kcnt),
                tile_m, tile_k};
  if (!shapes_ok(mp, kp, np, out_kind, out_bits, shift, ocp) || mp % GROUP ||
      !map_ok(km, mp, kp, GROUP, BK))
    return (int)cudaErrorInvalidValue;
  const Epilogue ep{out, mp, np, out_kind, out_bits, shift, ocp, np, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!k4::plan_ok(field_bits == 8 ? k4::ROWS : BM, n, bnt, gx, gy, gz, cx, cy, cz, mp, np, out_kind,
                   out_bits, ocp))
    return (int)cudaErrorInvalidValue;
  if (field_bits == 8)
    return k4::launch_colsum(static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), nd_b,
                             kp, ep, km, bnt, gx, gz, s);
  const int32_t* w = static_cast<const int32_t*>(a);
  const int8_t* bp = static_cast<const int8_t*>(b);
  switch (field_bits) {
    case 1: return k2::launch_f1(w, bp, nd_b, kp, ep, km, bnt, gx, gz, s);
    case 2: return k2::launch_f2(w, bp, nd_b, kp, ep, km, bnt, gx, gz, s);
    case 4: return k2::launch_f4(w, bp, nd_b, kp, ep, km, bnt, gx, gz, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
