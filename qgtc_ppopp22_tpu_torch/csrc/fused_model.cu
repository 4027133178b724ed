// fused_model: a bucket's whole GCN / GIN chain in one launch.
//
// Replaces the TPU kernel qgtc_ppopp22_tpu/ops/fused_model.py::
// fused_model_epoch (kernel at :616, pallas_call at :1279): the dense
// digit chain and the occupancy-compacted block schedule (blk_sched),
// with 1 or 2 base-16 digit planes per operand, per-GEMM requantize
// shifts and the out_cols store slice. The predicated chunk_occ form
// runs as a block schedule (ops/fused_model.py compacts the map on its
// device), and the streamed adjacency is this launch too. Levels-form X
// (x_levels_bits: one plane of byte levels) runs the offset-signed
// single-plane chain when every weight has a free padded lane, else the
// digit chain with the bytes split into digits as they are loaded (the
// JAX kernel's x_split), both described in fused_model.cuh. The lane
// stacking of digit planes and the ones lane of the signed chain are TPU
// mechanisms with nothing to port: here the row sums come from the
// staged tiles.
//
// Chain per batch (ops/fused_model.py):
//   GCN: XW1 -> A(.) -> (.)W2 -> A(.) -> (.)W3 -> A(.) [f32 out]
//   GIN: AX -> (.)W1 -> A(.) -> (.)W2 -> A(.) -> (.)W3 [f32 out]
//
// What bounds it on an H100: per batch at pn = 2560 and hidden 16, three
// aggregations A x H (1-bit A of 0.8 MB packed, 6.5 M values to unpack
// each time) and three small updates H x W. The tensor cores need a few
// microseconds for a batch; the unpack of A and the shared-memory traffic
// of the simple single-stage tile loop bound it. The TPU kernel kept a
// batch's A in 16 MB of VMEM; an SM has 228 KB, so here A stays packed
// in device memory and is re-read per aggregation from the 50 MB L2.
//
// Design: one launch per bucket; one thread-block cluster of CL <= 8
// CTAs per batch. CTA r owns the 64-row tiles r, r + CL, ... of its
// batch. Each GEMM runs the tile loop of gemm_core.cuh (int8
// mma.sync.m16n8k32, one accumulator set per digit shift, the shared
// requantizer) on the tile's real columns, rounded up to 32. An
// aggregation's output rows feed only the update of the same rows, so a
// CTA runs both back to back on its own rows through an int8 scratch
// (Q); the update's rows go to a ping-pong scratch (P0 / P1) that the
// next aggregation reads whole, after a cluster barrier. The scratch
// lives in device memory ([B][3][nd_h][pn][hw] int8, 0.5 MB per batch at
// hidden 16) and stays in L2 while the batch runs. Scratch is read with
// ld.global.cg: it is written during the launch, so the read-only path
// (__ldg) may not serve it. With a block schedule, each row chunk's K
// loop runs over exactly the listed column blocks. The signed chain makes
// one int8 pass per GEMM where 2-digit operands make 2 (aggregations) or
// 4 (updates), and stores one hidden plane where they store 2.
#include "fused_model.cuh"

using namespace qgtc;
using namespace qgtc::mega;

// meta (host ints): B, pn, nd_x, xp, nd_w, nd_h, n_layers, gin, out_bits,
// oc, chunk, nj, hw, x_form, x_bits; then per layer kp, np, nw, w_off,
// c_off; then the 2n - 1 shifts. x_form is an XForm, x_bits the bits of
// levels-form X (5-8; 0 for digit planes); nd_x counts X's digit planes
// (X_SPLIT: 2), nd_w the weights' and nd_h the scratch's (X_SIGNED: 1
// each; corr is then required, else null).
// Shapes as in Params; ops/fused_model.py checks them first and this
// entry refuses anything the kernel cannot index safely.
extern "C" int qgtc_fused_model(void* out, const void* a, const void* x,
                                const void* w, const void* corr,
                                const void* sched, void* scratch,
                                const int* meta, int n_meta, void* stream) {
  constexpr int HEAD = 15, PER_LAYER = 5;
  if (n_meta < HEAD) return (int)cudaErrorInvalidValue;
  Params p{};
  p.out = static_cast<float*>(out);
  p.a = static_cast<const int32_t*>(a);
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.corr = static_cast<const int*>(corr);
  p.sched = static_cast<const int*>(sched);
  p.scratch = static_cast<int8_t*>(scratch);
  p.B = meta[0];
  p.pn = meta[1];
  const int nd_x = meta[2];
  p.xp = meta[3];
  const int nd_w = meta[4], nd_h = meta[5];
  p.n_layers = meta[6];
  p.gin = meta[7];
  p.out_bits = meta[8];
  p.oc = meta[9];
  p.chunk = meta[10];
  p.nj = meta[11];
  p.hw = meta[12];
  const int x_form = meta[13], x_bits = meta[14];
  const int n = p.n_layers;
  if (n < 1 || n > MAX_LAYERS || n_meta != HEAD + PER_LAYER * n + 2 * n - 1)
    return (int)cudaErrorInvalidValue;
  bool ok = p.B > 0 && p.pn > 0 && p.pn % 256 == 0 && p.xp > 0 &&
            p.xp % 32 == 0 && p.out_bits >= 1 && p.out_bits <= 8 &&
            p.oc > 0 && p.oc % 8 == 0 &&
            (p.chunk == 256 || p.chunk == 512) && p.pn % p.chunk == 0 &&
            p.hw % 32 == 0 && p.hw >= p.xp * p.gin;
  if (x_form == X_DIGITS)
    ok = ok && x_bits == 0 && nd_h == (p.out_bits + 3) / 4 && !corr;
  else if (x_form == X_SPLIT)
    ok = ok && x_bits >= 5 && x_bits <= 8 && nd_x == 2 &&
         nd_h == (p.out_bits + 3) / 4 && !corr;
  else if (x_form == X_SIGNED)
    ok = ok && x_bits >= 5 && x_bits <= 8 && nd_x == 1 && nd_w == 1 &&
         nd_h == 1 && corr;
  else
    ok = false;
  if (x_form == X_SPLIT)  // each byte's mask of its high digit
    p.x_hi = 0x01010101u * ((1u << (x_bits - 4)) - 1);
  if (p.nj) ok = ok && sched && p.pn % p.nj == 0 && (p.pn / p.nj) % 128 == 0;
  else ok = ok && !sched;
  int k_in = p.xp;  // each update's contraction
  for (int l = 0; l < n && ok; ++l) {
    const int* m = meta + HEAD + PER_LAYER * l;
    p.kp[l] = m[0];
    p.np[l] = m[1];
    p.nw[l] = m[2];
    p.w_off[l] = m[3];
    p.c_off[l] = m[4];
    ok = ok && p.nw[l] > 0 && p.nw[l] % 32 == 0 && p.nw[l] <= p.np[l] &&
         p.np[l] % 32 == 0 && p.nw[l] <= p.hw && k_in <= p.kp[l] &&
         p.w_off[l] % 16 == 0 && p.c_off[l] >= 0;
    k_in = p.nw[l];
  }
  ok = ok && p.oc <= p.nw[n - 1];
  for (int i = 0; i < 2 * n - 1 && ok; ++i) {
    p.shift[i] = meta[HEAD + PER_LAYER * n + i];
    ok = p.shift[i] >= 0 && p.shift[i] <= 31;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  p.cl = p.pn / BM < MAX_CLUSTER ? p.pn / BM : MAX_CLUSTER;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_form == X_SIGNED) return launch_signed(p, s);
  if (x_form == X_SPLIT) return launch_split(p, nd_w, nd_h, s);
  if (nd_x == 1) return launch_x<X_DIGITS, 1>(p, nd_w, nd_h, s);
  if (nd_x == 2) return launch_x2(p, nd_w, nd_h, s);
  return (int)cudaErrorInvalidValue;
}
