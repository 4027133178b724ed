// fused_baseline: a bucket's whole full-precision (bf16) model in one launch.
//
// Replaces the TPU kernel qgtc_ppopp22_tpu/ops/fused_model.py::
// fused_baseline_epoch (:1299, pallas_call at :1427), the baseline the
// quantized engine is compared with. Per batch and layer:
//   h = relu(bf16(bf16(A @ h) @ W))    (no relu after the last layer,
//                                        which stores float32 logits)
// with both products summed in float32 and the JAX kernel's rounding
// points (fused_model.py:1404-1414): X rounds to bf16 once, each
// aggregation's f32 sum rounds to bf16 before the update, each relu
// output rounds to bf16. Every rounding is __float2bfloat16_rn (to
// nearest even, as JAX's astype); A (int8) converts to bf16 exactly.
//
// What bounds it on an H100: reading A, and the first layer's MMAs. At C1
// (75 batches, pn = 2560, widths 128 -> 16 -> 16 -> 40) the int8
// adjacency is 491.5 MB per epoch; reading A, X and the logits once is
// 620.6 MB (0.19 ms at 3.35 TB/s); the bf16 MMAs are 157 GFLOP (0.16 ms at
// 989 TFLOP/s), 126 of them in the first layer's aggregation. The first
// kernel took 2.0 ms: its mma.sync aggregation read each h stage
// through every warp's ldmatrix (13% of the bf16 peak), its two-slot ring
// streamed A at 29% of the memory rate, and every batch was in flight at
// once, so each layer read A from device memory again.
// The design (fused_baseline_k5.cuh): wgmma for the aggregation, a ring of
// 3 TMA slots 128-256 columns deep fed by a producer warp, a persistent
// grid that keeps as many batches in flight as the card holds groups of
// their CTAs (whether their A then stays in L2 across the layers is not
// shown: PERF.md §7), and X rounded to bf16 once per batch.
#include <algorithm>

#include "fused_baseline_k5.cuh"

// meta (host ints): B, pn, xp, cp, kx, hw, n_layers, groups, ctas, smem;
// then per layer kp, np, w_off (elements). kx: X's padded width (kp[0]);
// hw: the hidden planes' width (the widest np but the last layer's, 0 for
// one layer); groups, ctas and smem: the launch as ops/fused_model.py
// fused_baseline_plan chose it, which this entry only checks (the shared
// memory recomputed, every CTA resident). ops/fused_model.py checks the
// shapes first and this entry refuses anything the kernel cannot index
// safely. scratch: bf16, X's plane [B * pn][kx], then the two hidden
// planes [B * pn][hw]; bar: int32 [groups], zero.
extern "C" int qgtc_fused_baseline(void* out, const void* a, const void* x, const void* w,
                                   void* scratch, void* bar, const int* meta, int n_meta,
                                   void* stream) {
  using namespace qgtc::k5;
  if (meta == nullptr || n_meta < 10) return (int)cudaErrorInvalidValue;
  Params p{};
  p.out = static_cast<float*>(out);
  p.a = static_cast<const int8_t*>(a);
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const bf16*>(w);
  p.bar = static_cast<unsigned*>(bar);
  p.B = meta[0];
  p.pn = meta[1];
  p.xp = meta[2];
  p.cp = meta[3];
  p.kx = meta[4];
  p.hw = meta[5];
  p.n_layers = meta[6];
  p.groups = meta[7];
  p.ctas = meta[8];
  const int smem = meta[9], n = p.n_layers;
  if (n < 1 || n > MAX_LAYERS || n_meta != 10 + 3 * n) return (int)cudaErrorInvalidValue;
  bool ok = p.B > 0 && p.pn > 0 && p.pn % 256 == 0 && p.xp > 0 && p.cp > 0 && p.hw >= 0 &&
            p.hw % 16 == 0 && p.groups >= 1 && p.groups <= p.B && p.ctas >= 1 && p.ctas <= p.pn / ROWS;
  int npmax = 0, hw = 0;
  for (int l = 0; l < n && ok; ++l) {
    p.kp[l] = meta[10 + 3 * l];
    p.np[l] = meta[11 + 3 * l];
    p.w_off[l] = meta[12 + 3 * l];
    ok = p.kp[l] > 0 && p.kp[l] % 16 == 0 && p.np[l] > 0 && p.np[l] % 16 == 0 && p.np[l] <= NC &&
         p.w_off[l] % 8 == 0 && (l == 0 ? p.kp[0] >= p.xp : p.kp[l] == p.np[l - 1]);
    npmax = std::max(npmax, p.np[l]);
    if (l < n - 1) hw = std::max(hw, p.np[l]);
  }
  ok = ok && p.cp <= p.np[n - 1] && p.kx == p.kp[0] && p.hw == hw;
  if (!ok) return (int)cudaErrorInvalidValue;
  const Layout L = layout(p.kp, p.np, n);
  if (smem != L.total || smem > SMEM_CTA) return (int)cudaErrorInvalidValue;
  p.slot = L.slot;
  p.off_w = L.off_w;
  p.off_bar = L.off_bar;
  p.h[0] = static_cast<bf16*>(scratch);
  p.h[1] = p.h[0] + (size_t)p.B * p.pn * p.kx;
  p.h[2] = p.h[1] + (size_t)p.B * p.pn * p.hw;
  for (int l = 0; l < n; ++l) p.kd[l] = L.kd[l];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return npmax <= 64 ? launch<8>(p, smem, s) : launch<16>(p, smem, s);
}

#if K5_TRACE
extern "C" int qgtc_k5_trace(void* host, int reset) { return qgtc::k5::read_trace(host, reset); }
#endif
