// lcmv_stream_kernel at problem size MP = 32 (lcmv_stream.cuh), in a
// source of its own so that it compiles beside the other sizes.

#include "lcmv_stream.cuh"

namespace bf_lcmv {

cudaError_t launch_32(BF_LCMV_ARGS) {
  return launch_lanes<32>(spec, ib, hist, c, idx, gate, y, B, T, M, NB, NIB,
                           W, U, S, st);
}

}  // namespace bf_lcmv
