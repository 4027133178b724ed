// exp_packmm's slabs, bres, bres_chunk and k2loader instantiations
// (exp_packmm.cuh),
// a translation unit of their own so that the build compiles them in
// parallel with exp_packmm.cu.
#include "exp_packmm.cuh"

namespace qgtc {
namespace probe {

int launch_var(const ExpArgs& p, int variant, int f, int nt, cudaStream_t s) {
  switch (variant) {
    case V_SLABS: return launch_fields<V_SLABS>(p, f, nt, s);
    case V_BRES: return launch_fields<V_BRES>(p, f, nt, s);
    case V_BRES_CHUNK: return launch_fields<V_BRES_CHUNK>(p, f, nt, s);
    case V_K2LOADER: return launch_fields<V_K2LOADER>(p, f, nt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace probe
}  // namespace qgtc
