// K2/K3 (fused_admm_fast.cu) at the plane side P = 128, for lifted sides
// 113 <= n + 1 <= 128: the same kernel body (fused_solve_tc.cuh) on
// clusters of 8 CTAs, instantiated in a translation unit of its own so that
// it compiles beside the P = 112 instantiations instead of after them.
#include "fused_solve_tc.cuh"

namespace admmk {

int fused_tc_p128(int layout, bool three_pass, const SolveRows& io, const SolveParams& prm,
                  const Schedule& sched, void* stream) {
  return launch_fused_tc_layout<128>(layout, three_pass, io, prm, sched, stream);
}

}  // namespace admmk
