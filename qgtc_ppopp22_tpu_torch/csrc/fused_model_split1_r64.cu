// fused_model, K1 (fused_model_k1.cuh) for X as one plane of 1-4-bit byte
// levels when some weight has no free padded lane, each byte masked to its 1
// digit as it is loaded (the JAX kernel's x_split,
// qgtc_ppopp22_tpu/ops/fused_model.py:655-669), in 64-row CTAs; see
// fused_model.cu. A translation unit of its own so that nvcc builds it in
// parallel with the other forms.
#include "fused_model_k1.cuh"

namespace qgtc {
namespace k1 {

template int launch_form<X_SPLIT, 1, 64>(const Params&, int, int, int, cudaStream_t);

}  // namespace k1
}  // namespace qgtc
