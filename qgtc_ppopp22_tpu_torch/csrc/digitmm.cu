// digitmm: digit planes x digit planes with the fused requantize epilogue.
//
// Replaces the TPU kernel qgtc_ppopp22_tpu/ops/digitmm.py::_digitmm
// (kernel body _make_kernel.kernel, pallas_call at :320), dense-K form.
// The block-sparse K skip (TileMap) is not ported.
//
// What bounds it on an H100: the step engine's updates H x W are tiny
// (M = pn ~ 2560, K = 128, N = 128 padded from 16..64), about 42 MOP per
// digit pair against ~0.6 MB of operands. The tensor cores would finish
// in well under a microsecond, so launch overhead and the bytes moved
// through shared memory bound it, not arithmetic.
// What the design does about it: one launch per GEMM with the whole
// contraction inside each CTA, all digit pairs fused in one pass over A
// and B, and the requantize + digit split done in registers so the
// int32 sum never reaches device memory (gemm_core.cuh).
#include "gemm_core.cuh"

using namespace qgtc;

// a: int8[nd_a][mp][kp], b: int8[nd_b][kp][np]; see gemm_core.cuh.
extern "C" int qgtc_digitmm(void* out, const void* a, const void* b, int nd_a,
                            int nd_b, int mp, int kp, int np, int out_kind,
                            int out_bits, int shift, void* stream) {
  if (!shapes_ok(mp, kp, np, out_kind, out_bits, shift))
    return (int)cudaErrorInvalidValue;
  const Epilogue ep{out, mp, np, out_kind, out_bits, shift};
  const Int8Loader la{static_cast<const int8_t*>(a), mp, kp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nd_a == 1 && nd_b == 1) return launch<1, 1, false>(la, b, mp, kp, np, ep, s);
  if (nd_a == 1 && nd_b == 2) return launch<1, 2, false>(la, b, mp, kp, np, ep, s);
  if (nd_a == 2 && nd_b == 1) return launch<2, 1, false>(la, b, mp, kp, np, ep, s);
  if (nd_a == 2 && nd_b == 2) return launch<2, 2, false>(la, b, mp, kp, np, ep, s);
  return (int)cudaErrorInvalidValue;
}
