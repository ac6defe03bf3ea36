// mega_kernel at problem size MP = 32 (mega_stream.cuh), in a source of
// its own so that it compiles beside the other sizes.

#include "mega_stream.cuh"

namespace bf_mega {

cudaError_t launch_32(const MegaArgs& a, bool lcmv, cudaStream_t st) {
  return launch_lanes<32>(a, lcmv, st);
}

}  // namespace bf_mega
