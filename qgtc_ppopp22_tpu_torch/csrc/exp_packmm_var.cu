// exp_packmm's noextract, bres, bres_chunk and rowrange instantiations
// (exp_packmm.cuh), a translation unit of their own so that the build
// compiles them in parallel with exp_packmm.cu.
#include "exp_packmm.cuh"

namespace qgtc {
namespace probe {

int launch_var(const ExpArgs& p, int variant, int mp, int f, int bnt, int splits, cudaStream_t s) {
  switch (variant) {
    case V_NOEXTRACT: return launch_fields<V_NOEXTRACT>(p, mp, f, bnt, splits, s);
    case V_BRES: return launch_fields<V_BRES>(p, mp, f, bnt, splits, s);
    case V_BRES_CHUNK: return launch_fields<V_BRES_CHUNK>(p, mp, f, bnt, splits, s);
    case V_ROWRANGE: return launch_fields<V_ROWRANGE>(p, mp, f, bnt, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace probe
}  // namespace qgtc
