// fused_model, K1 (fused_model_k1.cuh) for X as one plane of byte levels when
// every weight has a free padded lane: the offset-signed single-plane chain
// (the JAX kernel's x_signed, qgtc_ppopp22_tpu/ops/fused_model.py:442-459,
// 495-517, 674-691, 767-785, 1148-1160, 1193-1200), in 128-row CTAs; see
// fused_model.cu. A translation unit of its own so that nvcc builds it in
// parallel with the other forms.
#include "fused_model_k1.cuh"

namespace qgtc {
namespace k1 {

template int launch_form<X_SIGNED, 1, 128>(const Params&, int, int, int, cudaStream_t);

}  // namespace k1
}  // namespace qgtc
