// exp_packmm: the packed-A GEMM probe's C entry and its concat, noextract,
// int8 and packed-out instantiations (slabs, bres, bres_chunk and k2loader
// are in exp_packmm_var.cu). The template, the layout and what each variant does
// are described in exp_packmm.cuh.
//
// Replaces the TPU experiment benchmarks/exp_packmm.py::make_packmm
// (pallas_call at :236) and make_packmm_packedout (:135).
#include "exp_packmm.cuh"

using namespace qgtc;
using namespace qgtc::probe;

// variant: a Variant; field_bits: 1, 2 or 4 (ignored for V_INT8); a:
// int32 words [mp / (32 / field_bits)][kp] in the layout of tile tm
// (V_INT8: int8 [mp][kp]); b: int8 [kp][np]; out: float [mp][np], or with
// out_bits in 1..4 (V_CONCAT only) int32 words [mp / (32 / field_bits)][np]
// that the caller has zeroed. The column tile is 64 when np % 64 == 0,
// else 16. Refused: mp % tm, tm % 256, kp % 64 or np % 16 not 0, a tm
// other than 256 for V_K2LOADER, and a resident B that does not fit in
// shared memory.
extern "C" int qgtc_exp_packmm(void* out, const void* a, const void* b,
                               int variant, int field_bits, int mp, int kp,
                               int np, int tm, int out_bits, void* stream) {
  const bool packed = variant != V_INT8;
  if (mp <= 0 || kp <= 0 || np <= 0 || mp % BM || kp % BK || np % 16)
    return (int)cudaErrorInvalidValue;
  if (packed && (field_bits != 1 && field_bits != 2 && field_bits != 4))
    return (int)cudaErrorInvalidValue;
  if (packed && (tm <= 0 || tm % 256 || mp % tm)) return (int)cudaErrorInvalidValue;
  if (variant == V_K2LOADER && tm != GROUP) return (int)cudaErrorInvalidValue;
  if (out_bits && (variant != V_CONCAT || out_bits < 1 || out_bits > 4 ||
                   (out_bits <= 2 ? out_bits : 4) != field_bits))
    return (int)cudaErrorInvalidValue;
  const ExpArgs p{a, static_cast<const int8_t*>(b), out, mp, kp, np, packed ? tm : 0, out_bits};
  const int nt = np % 64 == 0 ? 4 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case V_CONCAT:
      return out_bits ? launch_fields<V_CONCAT, true>(p, field_bits, nt, s)
                      : launch_fields<V_CONCAT>(p, field_bits, nt, s);
    case V_NOEXTRACT: return launch_fields<V_NOEXTRACT>(p, field_bits, nt, s);
    case V_INT8: return launch_fields<V_INT8>(p, 8, nt, s);
    case V_SLABS:
    case V_BRES:
    case V_BRES_CHUNK:
    case V_K2LOADER: return launch_var(p, variant, field_bits, nt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
