// K2/K3 (fused_admm_fast.cu) at the plane side P = 128, for lifted sides
// 113 <= n + 1 <= 128: the same kernel body (fused_solve.cuh), instantiated
// in a translation unit of its own so that it compiles beside the P = 112
// instantiations instead of after them.
#include "fused_solve.cuh"

namespace admmk {

int fused_admm_fast_p128(int layout, const SolveIO& io, const SolveParams& prm,
                         const Schedule& sched, void* stream) {
  return launch_fused_layout<128, NewtonProjection>(layout, io, prm, sched, stream);
}

}  // namespace admmk
