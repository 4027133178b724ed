// fused_model: a bucket's whole GCN / GIN chain in one launch.
//
// Replaces the TPU kernel qgtc_ppopp22_tpu/ops/fused_model.py::
// fused_model_epoch (kernel at :616, pallas_call at :1279): the dense
// digit chain and the occupancy-compacted block schedule (blk_sched),
// with 1 or 2 base-16 digit planes per operand, per-GEMM requantize
// shifts and the out_cols store slice. The predicated chunk_occ form
// runs as a block schedule (ops/fused_model.py compacts the map on its
// device), and the streamed adjacency is this launch too. Levels-form X
// (x_levels_bits 1-8: one plane of byte levels) runs the offset-signed
// single-plane chain when every weight has a free padded lane, else the
// digit chain with the bytes split into 1 or 2 digits as they are loaded
// (the JAX kernel's x_split). The lane stacking of digit planes and the
// ones lane of the signed chain are TPU mechanisms with nothing to port:
// here the row sums come from the A fragments.
//
// Chain per batch (ops/fused_model.py):
//   GCN: XW1 -> A(.) -> (.)W2 -> A(.) -> (.)W3 -> A(.) [f32 out]
//   GIN: AX -> (.)W1 -> A(.) -> (.)W2 -> A(.) -> (.)W3 [f32 out]
//
// What bounds it on an H100: per batch at pn = 2560 and hidden 16, three
// aggregations A x H (1-bit A of 0.8 MB packed, 6.5 M values to unpack
// each time) and three small updates H x W. Over C1's 75 batches the
// inputs and logits are 116.8 MB, 34.9 us at 3.35 TB/s, and the tensor
// cores need less for the real widths: bytes bound it. What costs is the
// per-step work of the aggregations: a 64-deep step of a 64-row tile is
// 2 KB of packed words to unpack and a handful of MMAs. The TPU kernel
// kept a batch's A in 16 MB of VMEM; an SM has 228 KB, so A stays packed
// in device memory (and the 50 MB L2) and is re-read per aggregation.
//
// Design (fused_model_k1.cuh says what each lever does): one launch per
// bucket, one thread-block cluster per batch, the launch ops/fused_model.py
// fused_model_plan chooses (rows per CTA, CTAs per batch, the ring's depth
// and stage depth), which this entry checks: a cp.async ring of the packed
// words, each warp building its A fragments straight from them; the hidden
// plane written transposed and streamed through the ring beside A; the
// aggregation's rows kept in shared memory for the same warp's update. The
// only global scratch is the ping-pong hidden plane P0 / P1
// ([B][2][nd_h][hw][pn] int8, read with cp.async.cg after a cluster
// barrier), 0.2 MB a batch at C1.
#include "fused_model_k1.cuh"

using namespace qgtc;
using namespace qgtc::k1;

// The launches of one form of X at the plan's tile height (instantiated
// in fused_model_<form>_r<rows>.cu).
template <int XF, int ND_X>
static int by_rows(const Params& p, int rows, int nd_w, int nd_h, int smem, cudaStream_t s) {
  return rows == 64 ? launch_form<XF, ND_X, 64>(p, nd_w, nd_h, smem, s)
                    : launch_form<XF, ND_X, 128>(p, nd_w, nd_h, smem, s);
}

// meta (host ints): B, pn, nd_x, xp, nd_w, nd_h, n_layers, gin, out_bits,
// oc, chunk, nj, hw, x_form, x_bits, then the plan: rows, cl, stages,
// smem, depth; then per layer kp, np, nw, w_off, c_off; then the 2n - 1
// shifts. x_form is an XForm, x_bits the bits of levels-form X (1-8; 0
// for digit planes); nd_x counts X's digit planes (X_SPLIT: those of
// x_bits), nd_w the weights' and nd_h the scratch's (X_SIGNED: 1 each;
// corr is then required, else null). Shapes as in Params;
// ops/fused_model.py checks them first and this entry refuses anything
// the kernel cannot index safely, and any launch other than the one the
// plan's rules give (the grid, the cluster, the shared memory).
extern "C" int qgtc_fused_model(void* out, const void* a, const void* x, const void* w,
                                const void* corr, const void* sched, void* scratch,
                                const int* meta, int n_meta, void* stream) {
  constexpr int HEAD = 20, PER_LAYER = 5;
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
  const int rows = meta[15];
  p.cl = meta[16];
  p.stages = meta[17];
  const int smem = meta[18];
  p.kd = meta[19];
  const int n = p.n_layers;
  if (n < 1 || n > MAX_LAYERS || n_meta != HEAD + PER_LAYER * n + 2 * n - 1)
    return (int)cudaErrorInvalidValue;
  bool ok = p.B > 0 && p.pn > 0 && p.pn % 256 == 0 && p.xp > 0 && p.xp % 32 == 0 &&
            p.out_bits >= 1 && p.out_bits <= 8 && p.oc > 0 && p.oc % 8 == 0 &&
            (p.chunk == 256 || p.chunk == 512) && p.pn % p.chunk == 0 && p.hw % 16 == 0;
  if (x_form == X_DIGITS)
    ok = ok && x_bits == 0 && (nd_x == 1 || nd_x == 2) && nd_h == (p.out_bits + 3) / 4 && !corr;
  else if (x_form == X_SPLIT)
    ok = ok && x_bits >= 1 && x_bits <= 8 && nd_x == (x_bits + 3) / 4 &&
         nd_h == (p.out_bits + 3) / 4 && !corr;
  else if (x_form == X_SIGNED)
    ok = ok && x_bits >= 1 && x_bits <= 8 && nd_x == 1 && nd_w == 1 && nd_h == 1 && corr;
  else
    ok = false;
  ok = ok && (nd_w == 1 || nd_w == 2) && (nd_h == 1 || nd_h == 2);
  if (x_form == X_SPLIT) {  // each byte's masks of its low and high digit
    p.x_lo = 0x01010101u * ((1u << (x_bits < 4 ? x_bits : 4)) - 1);
    p.x_hi = x_bits > 4 ? 0x01010101u * ((1u << (x_bits - 4)) - 1) : 0u;
  }
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
    ok = ok && p.nw[l] > 0 && p.nw[l] % 16 == 0 && p.nw[l] <= p.np[l] && p.np[l] % 32 == 0 &&
         p.nw[l] <= p.hw && round_up(k_in, 32) <= p.kp[l] && p.w_off[l] % 16 == 0 &&
         p.c_off[l] >= 0;
    k_in = p.nw[l];
  }
  ok = ok && p.oc <= p.nw[n - 1];
  for (int i = 0; i < 2 * n - 1 && ok; ++i) {
    p.shift[i] = meta[HEAD + PER_LAYER * n + i];
    ok = p.shift[i] >= 0 && p.shift[i] <= 31;
  }
  // the plan: a CTA tile of 64 or 128 rows, at most one CTA per row tile,
  // a ring of 3 or 4 stages of 64, 128 or 256 columns, and the shared
  // memory its layout takes
  const int tiles = (rows == 64 || rows == 128) && p.pn % rows == 0 ? p.pn / rows : 0;
  ok = ok && tiles > 0 && p.cl >= 1 && p.cl <= MAX_CLUSTER && p.cl <= tiles && p.stages >= 3 &&
       p.stages <= MAX_STAGES && (p.kd == 64 || p.kd == 128 || p.kd == 256);
  if (!ok) return (int)cudaErrorInvalidValue;
  const bool sg = x_form == X_SIGNED;
  const int nd_xm = x_form == X_DIGITS ? nd_x : 1, nd_xd = sg ? 1 : nd_x;
  const Layout L = layout(rows, p.stages, p.kd, p.xp, p.gin != 0, nd_h, nd_w, nd_xm, nd_xd, p.nw, n);
  if (L.total != smem || smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  p.slot = L.slot;
  p.off_bs = L.off_bs;
  p.off_q = L.off_q;
  p.qld = L.qld;
  p.off_wt = L.off_wt;
  p.off_pst = L.off_pst;
  p.off_meta = L.off_meta;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sg) return by_rows<X_SIGNED, 1>(p, rows, 1, 1, smem, s);
  if (x_form == X_SPLIT)
    return nd_x == 1 ? by_rows<X_SPLIT, 1>(p, rows, nd_w, nd_h, smem, s)
                     : by_rows<X_SPLIT, 2>(p, rows, nd_w, nd_h, smem, s);
  return nd_x == 1 ? by_rows<X_DIGITS, 1>(p, rows, nd_w, nd_h, smem, s)
                   : by_rows<X_DIGITS, 2>(p, rows, nd_w, nd_h, smem, s);
}
