// The first-generation whole fixed-iteration ADMM solve (K7), one instance
// per thread block, with the nested-bisection H-projection.
//
// Replaces admmnet_tpu/kernels/fused_admm.py :: admm_solve_fused (kernel
// body _fused_kernel): the per-step g_update="polar" solve fused whole.
// Its iteration is fused_solve.cuh's lists layout (corner reads, B,
// M = herm(B - Z/rho), output re-symmetrization, Z' = Z + rho (G' - B))
// with the quintic-7 schedule, every step hi and every product IEEE fp32,
// no per-step re-projection; the H-projection below is the JAX kernel's
// _project_sum_inf_row (32 x 32 serial bisection steps by default), run in
// warp 0 with shuffle reductions, 4 lanes of the 100-long row per thread.
// Bound on this card: arithmetic, 66 real P^3 products per iteration.
#include "fused_solve.cuh"

namespace admmk {

// h(mu) = v - Proj_{||x||_1 <= mu A}(v), v = t - mu (masked to n): the l1
// projection by bisection on the soft threshold over [0, max |v|], then
// rescaled onto the sphere; v itself when it lies inside the ball.
__device__ __forceinline__ void h_nested(const float (&t)[4], int n, float mu, float A,
                                         int inner, float (&h)[4]) {
  const int lane = threadIdx.x % 32;
  const float radius = mu * A;
  float v[4], av[4], s = 0.f, mx = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = lane + 32 * q < n ? t[q] - mu : 0.f;
    av[q] = fabsf(v[q]);
    s += av[q];
    mx = fmaxf(mx, av[q]);
  }
  const bool inside = warp_sum(s) <= radius;
  float lo = 0.f, hi = warp_max(mx);
  for (int k = 0; k < inner; ++k) {
    const float tau = 0.5f * (lo + hi);
    float part = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) part += fmaxf(av[q] - tau, 0.f);
    if (warp_sum(part) > radius)
      lo = tau;
    else
      hi = tau;
  }
  const float tau = 0.5f * (lo + hi);
  float x[4], xs = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    x[q] = fmaxf(av[q] - tau, 0.f);  // 0 on masked entries
    xs += x[q];
  }
  xs = warp_sum(xs);
  const float scale = xs > 0.f ? radius / fmaxf(xs, 1e-30f) : 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float sgn = v[q] > 0.f ? 1.f : (v[q] < 0.f ? -1.f : 0.f);
    const float p = inside ? v[q] : sgn * (x[q] * scale);
    h[q] = lane + 32 * q < n ? v[q] - p : 0.f;
  }
}

// Projection of t (masked to n) onto {A ||h||_inf + sum h <= 1}, warp 0:
// bisection on mu over [0, max(1, |t|^2 / 2 + 1)], then h(hi), and t where
// t is feasible.  Always cold: the bracket arguments are not used.
struct NestedProjection {
  __device__ static void project(const float (&t)[4], int n, float A, int outer, int inner,
                                 bool, float&, float&, float (&h)[4]) {
    const bool feasible = f_of(t, A) <= 1.f;
    float tt = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) tt += t[q] * t[q];
    float lo = 0.f, hi = fmaxf(1.f, 0.5f * warp_sum(tt) + 1.f);
    for (int k = 0; k < outer; ++k) {
      const float mu = 0.5f * (lo + hi);
      h_nested(t, n, mu, A, inner, h);
      if (f_of(h, A) > 1.f)
        lo = mu;
      else
        hi = mu;
    }
    h_nested(t, n, hi, A, inner, h);
    if (feasible) {
#pragma unroll
      for (int q = 0; q < 4; ++q) h[q] = t[q];
    }
  }
};

}  // namespace admmk

// C entry point.  yob_r, yob_i, w: (B, n) float rows; A: (B,) constraint
// weights; phi_r, phi_i: (B, n), written; scratch: B * 11 * P * P floats.
// coeffs: host array of nsteps (a, b, c) triples (the quintic-7 schedule).
// Returns the launch's cudaError_t.
extern "C" int fused_admm_launch(const float* yob_r, const float* yob_i, const float* w,
                                 const float* A, float* phi_r, float* phi_i, float* scratch,
                                 int B, int n, int P, int num_iters, float rho, float lam_inv_sq,
                                 const float* coeffs, int nsteps, int outer_iters,
                                 int inner_iters, void* stream) {
  using namespace admmk;
  if (nsteps < 0 || nsteps > MAX_STEPS || B <= 0 || n < 1 || n + 1 > P || n > ROW)
    return static_cast<int>(cudaErrorInvalidValue);
  Schedule sched{};
  for (int s = 0; s < nsteps; ++s) {
    sched.a[s] = coeffs[3 * s];
    sched.b[s] = coeffs[3 * s + 1];
    sched.c[s] = coeffs[3 * s + 2];
  }
  sched.n = nsteps;
  // every step hi with fp32 products (all_hi, no three_pass), cold root
  const SolveParams prm{n, num_iters, 0, outer_iters, inner_iters, rho, lam_inv_sq, 1, 0, 1, 0};
  const SolveIO io{yob_r, yob_i, w, A, phi_r, phi_i, scratch, B};
  if (P == 112) return launch_fused_solve<112, NestedProjection, LISTS>(io, prm, sched, stream);
  if (P == 128) return launch_fused_solve<128, NestedProjection, LISTS>(io, prm, sched, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
