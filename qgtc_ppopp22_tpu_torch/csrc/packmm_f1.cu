// K2's kernel instantiations for a 1-bit field A (packmm_k2.cuh), a
// translation unit of their own so that the build compiles the three
// field widths in parallel.
#include "packmm_k2.cuh"

namespace qgtc {
namespace k2 {

int launch_f1(const int32_t* a, const int8_t* b, int nd_b, int kp, const Epilogue& ep,
              const KMap& km, int bnt, int col_tiles, int splits, cudaStream_t s) {
  return launch_field<1>(a, b, nd_b, kp, ep, km, bnt, col_tiles, splits, s);
}

}  // namespace k2
}  // namespace qgtc
