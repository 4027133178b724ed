// fused_model for X with 2 digit planes (5-8 bit features); see
// fused_model.cu. A translation unit of its own so that it builds in
// parallel with the 1-plane instantiations.
#include "fused_model.cuh"

namespace qgtc {
namespace mega {

int launch_x2(const Params& p, int nd_w, int nd_h, cudaStream_t s) {
  return launch_x<X_DIGITS, 2>(p, nd_w, nd_h, s);
}

}  // namespace mega
}  // namespace qgtc
