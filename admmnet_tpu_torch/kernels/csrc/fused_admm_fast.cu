// The whole fixed-iteration ADMM solve of one instance on one thread-block
// cluster, with the Newton-waterline H-projection.
//
// Replaces admmnet_tpu/kernels/fused_admm_fast.py :: admm_solve_fused_fast,
// both layouts:
//   lean  (K2, kernel body _fused_fast_kernel_lean): the g_update=
//         "fused_fast" (production, detection grade, fold_diag) and
//         "fused_exact" (phi-faithful) contracts, the unfolded carry and
//         the ablate profiling variants;
//   lists (K3, kernel body _fused_fast_kernel): the escape hatch
//         ADMMOptions(fused_layout="lists"), cold root, no three_pass.
// The kernel body, its dataflow, its bound and its design are in
// fused_solve_tc.cuh (the products on the tensor cores, the planes in the
// cluster's shared memory); this file holds the P = 112 instantiations
// (n + 1 <= 112, the 101 x 101 lifted matrix) and the C entry point,
// fused_admm_fast_p128.cu the P = 128 ones, fused_admm_fast_ablate{,_p128}.cu
// the profiling variants.
#include "fused_solve_tc.cuh"

// C entry point.  yob_r, yob_i, w: (B, n) float rows; A: (B,) constraint
// weights; phi_r, phi_i: (B, n), written.  coeffs: host array of nsteps
// (a, b, c) triples.  lists selects K3's layout, which takes none of
// fold_diag, warm_root, all_hi, three_pass.  ablate: AB_NONE or a profiling
// variant of the unfolded lean layout without three_pass.  The products
// that are not hi run one-pass (fused_solve_tc.cuh).  Returns the launch's
// cudaError_t.
extern "C" int fused_admm_fast_launch(const float* yob_r, const float* yob_i, const float* w,
                                      const float* A, float* phi_r, float* phi_i, int B, int n,
                                      int P, int num_iters, float rho, float lam_inv_sq,
                                      const float* coeffs, int nsteps, int hi_steps,
                                      int outer_iters, int inner_iters, int final_hi,
                                      int warm_root, int all_hi, int three_pass, int fold_diag,
                                      int lists, int ablate, void* stream) {
  using namespace admmk;
  if (nsteps < 0 || nsteps > MAX_STEPS || B <= 0 || n < 1 || n + 1 > P || n > ROW)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lists && (fold_diag || warm_root || all_hi || three_pass))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ablate < AB_NONE || ablate > AB_FINALS ||
      (ablate != AB_NONE && (lists || fold_diag || three_pass)))
    return static_cast<int>(cudaErrorInvalidValue);
  Schedule sched{};
  for (int s = 0; s < nsteps; ++s) {
    sched.a[s] = coeffs[3 * s];
    sched.b[s] = coeffs[3 * s + 1];
    sched.c[s] = coeffs[3 * s + 2];
  }
  sched.n = nsteps;
  const SolveParams prm{n,   num_iters,  hi_steps, outer_iters, inner_iters, rho,
                        lam_inv_sq, final_hi, warm_root, all_hi,     three_pass};
  const SolveRows io{yob_r, yob_i, w, A, phi_r, phi_i, B};
  if (ablate != AB_NONE) {
    if (P == 112) return fused_tc_ablate(ablate, io, prm, sched, stream);
    if (P == 128) return fused_tc_ablate_p128(ablate, io, prm, sched, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int layout = lists ? LISTS : (fold_diag ? FOLDED : LEAN);
  if (P == 112) return launch_fused_tc_layout<112>(layout, three_pass != 0, io, prm, sched, stream);
  if (P == 128) return fused_tc_p128(layout, three_pass != 0, io, prm, sched, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
