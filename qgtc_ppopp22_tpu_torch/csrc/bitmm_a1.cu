// K6's instantiations for a 1-bit A (bitmm_k6.cuh): the aggregations of
// the bits step engine, against 1-, 2-, 4- and 8-bit B. A translation
// unit of their own, so that the build compiles them in parallel.
#include "bitmm_k6.cuh"

namespace qgtc {
namespace k6 {

int launch_a1(const Args& p, int bnt, int col_tiles, int splits, cudaStream_t s) {
  switch (p.b_bits) {
    case 1: return launch_pair<1, 1>(p, bnt, col_tiles, splits, s);
    case 2: return launch_pair<1, 2>(p, bnt, col_tiles, splits, s);
    case 4: return launch_pair<1, 4>(p, bnt, col_tiles, splits, s);
    case 8: return launch_pair<1, 8>(p, bnt, col_tiles, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace k6
}  // namespace qgtc
