// bitmm: BitTensor planes x BitTensor planes on the one-bit tensor cores.
//
// Replaces the TPU kernel qgtc_ppopp22_tpu/ops/bitgemm.py::_bitmm (kernel
// body _make_kernel.kernel, pallas_call at :345). The TPU's MXU has no
// one-bit product, so that kernel unpacks the planes into int8 digits in
// VMEM. Hopper still has one, and this kernel uses it, as the reference
// does (bmma_sync with bmmaBitOpAND):
//   C = sum_{i < a_bits, j < b_bits} popc(A_i AND B_j) << (i + j)
// with mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc, summed
// in unsigned 32-bit arithmetic so that a sum past 2^31 wraps as the JAX
// kernel's int32 does; then requantized and repacked into out_bits planes
// (bitMM2Bit) or stored as float32 (bitMM2Int).
//
// Layouts (ops/bitpack.py): planes int32[bits][rows / 32][cols], a word
// packing 32 consecutive rows of one column, both extents padded to 256.
// For B (K x N) a word is 32 consecutive k of one column: already the
// .col operand's register. For A (M x K) it is 32 consecutive m of one k,
// transposed relative to the .row operand, so each 32 x 32 bit block of A
// is transposed across a warp (5 shuffle rounds) on its way to the
// fragments.
//
// What bounds it on an H100. The bits step engine's aggregation at C1,
// A[2560²] 1-bit x H[2560 x 16] 2-bit to 2-bit planes, needs 0.99 MB
// (0.82 MB of A, 0.01 MB for H's 16 real columns, 0.16 MB for the planes
// out, padding included): 0.30 us at 3.35 TB/s, against 0.21 G one-bit
// operations counted as int8 ones (0.11 us). An update X[2560 x 128] x
// W[128 x 16] needs 0.25 MB (0.07 us). Neither is near its bound: the
// time is the K loop's per-step cost (the loads' latency, A's transpose)
// times the steps a CTA runs in sequence, plus launch and epilogue.
// What each lever does (bitmm_k6.cuh):
//   * a column tile sized to N (16, 32 or 64 columns, chosen by the
//     wrapper's plan): no MMAs, B traffic or second transpose of A for
//     padding columns, where a 64-column grid over the 256 padded columns
//     computed 16 times the work at N = 16;
//   * each thread's copy addresses and swizzles computed once per CTA;
//   * a 4-stage cp.async ring, B read by the MMAs from its slot, A
//     transposed from shared memory into a double-buffered tile: one
//     barrier per step, the copies in flight ahead of use;
//   * plane counts as template parameters for the pairs the engines run
//     (1 x 1, 2, 4, 8 and 2 x 2, 4 x 4, 8 x 8), one run-time instantiation
//     for every other pair;
//   * split-K over a thread-block cluster (S <= 4 CTAs per output tile,
//     reduced through distributed shared memory): at C1, 40 row tiles
//     become 160 CTAs on 132 SMs;
//   * an all-zero 32 x 32 block of A (padded K, an empty stretch of the
//     adjacency) skips its transpose.
// With a TileMap (kidx, kcnt) each CTA visits only the K tiles its row
// tile lists (zero-tile jumping, the TPU kernel's K skip); a skipped tile
// costs neither its loads nor its K steps.
#include <algorithm>

#include "bitmm_k6.cuh"

namespace qgtc {
namespace k6 {

// The run-time plane counts: every pair the two other units do not take.
int launch_general(const Args& p, int bnt, int col_tiles, int splits, cudaStream_t s) {
  return launch_pair<0, 0>(p, bnt, col_tiles, splits, s);
}

}  // namespace k6
}  // namespace qgtc

// meta: the host int array [a_bits, b_bits, mp, kp, np, out_bits, tile_m,
// tile_k, n, bnt, gx, gy, gz, cx, cy, cz] (one pointer where 16 ints would
// cost the caller's ctypes conversion ~2.6 us a call). out_bits 0 selects
// the float32 output. kidx / kcnt null: dense K (else tile_m a multiple of
// 64, tile_k of 256). n: B's real columns (those >= n hold level 0); bnt,
// grid (gx, gy, gz) and cluster (cx, cy, cz): the launch as
// ops/bitgemm.py bitmm_plan chose it, which this entry only checks: the
// column tile (16, 32 or 64), gx = ceil(min(round_up(n, 8), np) / bnt)
// column tiles, gy = mp / 64 row tiles, gz = cz = the CTAs per output tile
// (1-4), cx = cy = 1.
extern "C" int qgtc_bitmm(void* out, const void* a, const void* b, const void* kidx,
                          const void* kcnt, const int* meta, void* stream) {
  using namespace qgtc::k6;
  if (meta == nullptr) return (int)cudaErrorInvalidValue;
  const int a_bits = meta[0], b_bits = meta[1], mp = meta[2], kp = meta[3], np = meta[4],
            out_bits = meta[5], n = meta[8], bnt = meta[9], gx = meta[10], gy = meta[11],
            gz = meta[12], cx = meta[13], cy = meta[14], cz = meta[15];
  const qgtc::KMap map{static_cast<const int*>(kidx), static_cast<const int*>(kcnt), meta[6],
                       meta[7]};
  if (out == nullptr || a == nullptr || b == nullptr) return (int)cudaErrorInvalidValue;
  if (a_bits < 1 || a_bits > MAX_BITS || b_bits < 1 || b_bits > MAX_BITS || out_bits < 0 ||
      out_bits > MAX_BITS)
    return (int)cudaErrorInvalidValue;
  if (mp <= 0 || kp <= 0 || np <= 0 || mp % qgtc::BM || kp % KC || np % 16 ||
      !qgtc::map_ok(map, mp, kp, qgtc::BM, KC))
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || n > np || (bnt != 16 && bnt != 32 && bnt != 64)) return (int)cudaErrorInvalidValue;
  const int ncomp = std::min((n + 7) / 8 * 8, np);
  if (gx != (ncomp + bnt - 1) / bnt || gx * bnt > np || gy != mp / qgtc::BM || gz < 1 ||
      gz > MAX_SPLIT || cx != 1 || cy != 1 || cz != gz)
    return (int)cudaErrorInvalidValue;
  const Args p{out, static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
               map, a_bits, b_bits, mp, kp, np, out_bits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_bits == 1 && (b_bits == 1 || b_bits == 2 || b_bits == 4 || b_bits == 8))
    return launch_a1(p, bnt, gx, gz, s);
  if (a_bits == b_bits && (a_bits == 2 || a_bits == 4 || a_bits == 8))
    return launch_bb(p, bnt, gx, gz, s);
  return launch_general(p, bnt, gx, gz, s);
}
