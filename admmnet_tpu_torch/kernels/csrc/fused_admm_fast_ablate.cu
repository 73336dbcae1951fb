// K2's profiling variants (ablate, fused_solve_tc.cuh) at the plane side
// P = 112: the unfolded lean instantiation with one component removed per
// variant, in a translation unit of its own so that it compiles beside the
// production instantiations.
#include "fused_solve_tc.cuh"

namespace admmk {

int fused_tc_ablate(int ablate, const SolveRows& io, const SolveParams& prm,
                    const Schedule& sched, void* stream) {
  return launch_fused_tc_ablate<112>(ablate, io, prm, sched, stream);
}

}  // namespace admmk
