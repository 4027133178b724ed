// fused_model for X as one plane of 5-8-bit byte levels when some weight
// has no free padded lane: the digit chain, with each byte split into
// its 2 base-16 digits as the tile is loaded (the JAX kernel's x_split,
// qgtc_ppopp22_tpu/ops/fused_model.py:655-669); see fused_model.cu. A
// translation unit of its own so that it builds in parallel.
#include "fused_model.cuh"

namespace qgtc {
namespace mega {

int launch_split(const Params& p, int nd_w, int nd_h, cudaStream_t s) {
  return launch_x<X_SPLIT, 2>(p, nd_w, nd_h, s);
}

}  // namespace mega
}  // namespace qgtc
