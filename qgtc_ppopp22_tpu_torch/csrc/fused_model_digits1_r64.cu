// fused_model, K1 (fused_model_k1.cuh) for X as 1 base-16 digit plane, in
// 64-row CTAs; see fused_model.cu. A translation unit of its own so that nvcc
// builds it in parallel with the other forms.
#include "fused_model_k1.cuh"

namespace qgtc {
namespace k1 {

template int launch_form<X_DIGITS, 1, 64>(const Params&, int, int, int, cudaStream_t);

}  // namespace k1
}  // namespace qgtc
