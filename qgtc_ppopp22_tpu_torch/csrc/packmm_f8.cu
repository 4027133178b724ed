// K2's kernel instantiations for an 8-bit field A (the offset-signed byte
// plane of 5-8-bit levels), on K4's kernel (packmm_k4.cuh) with the
// colsum correction: a translation unit of its own so that the build
// compiles it beside the other field widths.
#include "packmm_k4.cuh"

namespace qgtc {
namespace k4 {

int launch_colsum(const int8_t* a, const int8_t* b, int nd_b, int kp, const Epilogue& ep,
                  const KMap& km, int bnt, int col_tiles, int splits, cudaStream_t s) {
  if (nd_b == 1) return launch_bnt<1, CORR_COLSUM>(a, b, kp, ep, km, bnt, col_tiles, splits, s);
  if (nd_b == 2) return launch_bnt<2, CORR_COLSUM>(a, b, kp, ep, km, bnt, col_tiles, splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace k4
}  // namespace qgtc
