// digitmm: digit planes x digit planes with the fused requantize epilogue.
//
// Replaces the TPU kernel qgtc_ppopp22_tpu/ops/digitmm.py::_digitmm
// (kernel body _make_kernel.kernel, pallas_call at :320), with its
// block-sparse K skip: given a TileMap (kidx, kcnt) each CTA visits only
// the K tiles its row tile lists (the TPU kernel's t < kcnt[i] guard at
// :153-158).
//
// What bounds it on an H100: the step engine's updates H x W are tiny. At
// C1 X[2560 x 128] x W[128 x 16] is 84 MOP per digit pair against 0.66 MB
// of operands (A, W's 16 real columns, the digit planes out): 0.20 us at
// 3.35 TB/s. The tensor cores would finish in well under a microsecond,
// so the launch, the loads' latency and the bytes moved through shared
// memory bound it, not arithmetic.
// What the design does about it (digitmm_k3.cuh): one launch per GEMM with
// the whole contraction (or its listed K tiles) inside each CTA, all digit
// pairs fused in one pass over A and B, the requantize + digit split done
// in registers so the int32 sum never reaches device memory; only the
// real K and N computed, on a column tile sized to N and CTAs of 16-64
// rows, with the copies in flight ahead of use in a 3-slot cp.async ring.
#include "digitmm_k3.cuh"

using namespace qgtc;

// meta: the host int array [nd_a, nd_b, mp, kp, np, out_kind, out_bits,
// shift, ocp, tile_m, tile_k, kr, nr, bnt, rows, ks, gx, gy, smem].
// a: int8[nd_a][mp][kp], b: int8[nd_b][kp][np]; f32 / i32 out stores ocp
// columns; kidx / kcnt: the TileMap, or null for the dense contraction
// (tile_m a multiple of rows, tile_k of ks). kr / nr: the real contraction
// and columns, rounded up to 32 and 8 (A's columns and B's rows past kr,
// B's columns past nr hold level 0). bnt, rows, ks, the grid (gx:
// the column tiles over nr, and one more where the output has padded
// columns past them; gy row tiles) and the dynamic shared memory: the launch as
// ops/digitmm.py digitmm_plan chose it, which this entry only checks.
// Packed words out is packmm's alone.
extern "C" int qgtc_digitmm(void* out, const void* a, const void* b, const void* kidx,
                            const void* kcnt, const int* meta, void* stream) {
  if (meta == nullptr) return (int)cudaErrorInvalidValue;
  const int nd_a = meta[0], nd_b = meta[1], mp = meta[2], kp = meta[3], np = meta[4],
            kind = meta[5], out_bits = meta[6], shift = meta[7], ocp = meta[8], tile_m = meta[9],
            tile_k = meta[10], kr = meta[11], nr = meta[12], bnt = meta[13], rows = meta[14],
            ks = meta[15], gx = meta[16], gy = meta[17], smem = meta[18];
  if (!shapes_ok(mp, kp, np, kind, out_bits, shift, ocp) || kind == OUT_PACKED)
    return (int)cudaErrorInvalidValue;
  const bool ok = nd_a >= 1 && nd_a <= 2 && nd_b >= 1 && nd_b <= 2 && kr > 0 && kr % 32 == 0 &&
                  kr <= kp && nr > 0 && nr % 8 == 0 && nr <= np &&
                  (bnt == 16 || bnt == 32) && (rows == 16 || rows == 32 || rows == 64) &&
                  mp % rows == 0 && ks > 0 && ks % 32 == 0 && ks <= k3::KS_MAX && gy == mp / rows;
  const int ct = ok ? (nr + bnt - 1) / bnt : 0;  // column tiles; one more stores the padding past them
  const bool gx_ok = gx == ct + (ct * bnt < (kind == OUT_DIGITS ? np : ocp));
  const KMap km{static_cast<const int*>(kidx), static_cast<const int*>(kcnt), tile_m, tile_k};
  const k3::Layout L = k3::layout(nd_a, nd_b, rows, bnt, ks);
  if (!ok || !gx_ok || !map_ok(km, mp, kp, rows, ks) || smem != L.total || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  k3::Args p{};
  p.ep = Epilogue{out, mp, np, kind, out_bits, shift, ocp, np, nullptr};
  p.a = static_cast<const int8_t*>(a);
  p.b = static_cast<const int8_t*>(b);
  p.km = km;
  p.mp = mp;
  p.kp = kp;
  p.np = np;
  p.kr = kr;
  p.rows = rows;
  p.ks = ks;
  p.col_tiles = ct;
  p.ld = L.ld;
  p.slot = L.slot;
  p.off_b = L.off_b;
  p.off_bt = L.off_bt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nd_a == 1 && nd_b == 1) return k3::launch_pair<1, 1>(p, bnt, smem, s);
  if (nd_a == 1 && nd_b == 2) return k3::launch_pair<1, 2>(p, bnt, smem, s);
  if (nd_a == 2 && nd_b == 1) return k3::launch_pair<2, 1>(p, bnt, smem, s);
  return k3::launch_pair<2, 2>(p, bnt, smem, s);
}
