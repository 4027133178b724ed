// K6's instantiations for equal plane counts (bitmm_k6.cuh): the updates
// of the bits step engine at 2, 4 and 8 bits. A translation unit of their
// own, so that the build compiles them in parallel.
#include "bitmm_k6.cuh"

namespace qgtc {
namespace k6 {

int launch_bb(const Args& p, int bnt, int col_tiles, int splits, cudaStream_t s) {
  if (p.a_bits != p.b_bits) return (int)cudaErrorInvalidValue;
  switch (p.a_bits) {
    case 2: return launch_pair<2, 2>(p, bnt, col_tiles, splits, s);
    case 4: return launch_pair<4, 4>(p, bnt, col_tiles, splits, s);
    case 8: return launch_pair<8, 8>(p, bnt, col_tiles, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace k6
}  // namespace qgtc
