// K2's profiling variants (ablate, fused_solve_tc.cuh) at the plane side
// P = 128 (113 <= n + 1 <= 128), compiled beside the P = 112 ones.
#include "fused_solve_tc.cuh"

namespace admmk {

int fused_tc_ablate_p128(int ablate, const SolveRows& io, const SolveParams& prm,
                         const Schedule& sched, void* stream) {
  return launch_fused_tc_ablate<128>(ablate, io, prm, sched, stream);
}

}  // namespace admmk
