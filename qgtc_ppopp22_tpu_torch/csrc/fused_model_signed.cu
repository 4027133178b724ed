// fused_model for X as one plane of byte levels when every weight has a
// free padded lane: the offset-signed single-plane chain (fused_model.cuh;
// the JAX kernel's x_signed, qgtc_ppopp22_tpu/ops/fused_model.py:442-459,
// 495-517, 674-691, 767-785, 1148-1160, 1193-1200). A translation unit
// of its own so that it builds in parallel; see fused_model.cu.
#include "fused_model.cuh"

namespace qgtc {
namespace mega {

int launch_signed(const Params& p, cudaStream_t s) {
  return launch_fused<X_SIGNED, 1, 1, 1>(p, s);
}

}  // namespace mega
}  // namespace qgtc
