// exp_packmm: P1a's C entry and its concat, slabs and int8 instantiations
// (noextract, bres, bres_chunk and rowrange are in exp_packmm_var.cu). The
// kernel, the row map and what each variant does are described in
// exp_packmm.cuh.
//
// Replaces the TPU experiment benchmarks/exp_packmm.py::make_packmm
// (pallas_call at :236).
#include "exp_packmm.cuh"

using namespace qgtc;
using namespace qgtc::probe;

#if PROBE_TRACE
// The traced build (benchmarks/probe_trace.py) holds this source alone:
// concat, slabs and int8.
int qgtc::probe::launch_var(const ExpArgs&, int, int, int, int, int, cudaStream_t) {
  return (int)cudaErrorNotSupported;
}
#endif

// variant: a Variant; field_bits: 1, 2 or 4 (ignored for V_INT8); a:
// int32 words [mp / (32 / field_bits)][kp] in the layout of tile tm
// (V_INT8: int8 [mp][kp]); b: int8 [kp][np]; out: float [mp][np], written
// whole; exp_packmm.exp_packmm_plan's column tile bnt, split, ring depth
// and K step. Refused: what the plan refuses (mp % 64, mp % tm, tm % 256,
// kp % depth or np % bnt not 0; a tm other than 256 for V_ROWRANGE; a step
// other than 64, 128 or 256 columns; a split beyond 8 or the K steps; a
// ring other than 3 or 4 slots; more than 227 KB of shared memory).
extern "C" int qgtc_exp_packmm(void* out, const void* a, const void* b, int variant, int field_bits,
                               int mp, int kp, int np, int tm, int bnt, int splits, int stages,
                               int depth, void* stream) {
  const bool packed = variant != V_INT8;
  if (variant < V_CONCAT || variant > V_ROWRANGE) return (int)cudaErrorInvalidValue;
  if (mp <= 0 || mp % EXP_ROWS || (depth != 64 && depth != 128 && depth != 256) || kp <= 0 ||
      kp % depth || np <= 0 || (bnt != 16 && bnt != 32 && bnt != 64) || np % bnt || splits < 1 ||
      splits > EXP_MAX_SPLIT || splits > kp / depth || (stages != 3 && stages != 4))
    return (int)cudaErrorInvalidValue;
  if (packed && (field_bits != 1 && field_bits != 2 && field_bits != 4))
    return (int)cudaErrorInvalidValue;
  if (packed && (tm <= 0 || tm % 256 || mp % tm)) return (int)cudaErrorInvalidValue;
  if (variant == V_ROWRANGE && tm != GROUP) return (int)cudaErrorInvalidValue;
  const ExpArgs p{a, static_cast<const int8_t*>(b), static_cast<float*>(out), kp, np,
                  packed ? tm : 0, stages, depth};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case V_CONCAT: return launch_fields<V_CONCAT>(p, mp, field_bits, bnt, splits, s);
    case V_SLABS: return launch_fields<V_SLABS>(p, mp, field_bits, bnt, splits, s);
    case V_INT8: return launch_fields<V_INT8>(p, mp, 8, bnt, splits, s);
    default: return launch_var(p, variant, mp, field_bits, bnt, splits, s);
  }
}
