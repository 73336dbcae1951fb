// Shared pieces of the fused ADMM solves: the layouts, the solve's
// parameters, the lifted matrix's entries and the Newton-waterline
// H-projection of K2 and K3, whose kernel body is fused_solve_tc.cuh; the
// first-generation solve K7 (fused_admm.cu) takes lifted_b and f_of here
// and runs on polar_cta.cuh.  The H-projection is the template's Proj
// policy:
//   Proj::project(t, n, A, outer, inner, warm, lo, hi, h)
// runs in warp 0 on the logical entries lane + 32 q (q < 4, masked to n).
#pragma once

#include "common.cuh"

namespace admmk {

// FOLDED: lean with fold_diag; LEAN: lean, unfolded carry; LISTS: lists.
enum Layout { FOLDED, LEAN, LISTS };

struct SolveParams {
  int n, num_iters, hi_steps, outer_iters, inner_iters;
  float rho, lam_inv_sq;
  int final_hi, warm_root, all_hi, three_pass;
};

// A ||h||_inf + sum h over the logical entries (masked entries hold 0).
__device__ __forceinline__ float f_of(const float (&h)[4], float A) {
  float m = 0.f, s = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    m = fmaxf(m, fabsf(h[q]));
    s += h[q];
  }
  return A * warp_max(m) + warp_sum(s);
}

// prox of mu*A*||.||_inf at t - mu (warp 0; entry lane + 32 q, masked to n):
// clamp at the l1 waterline tau found by monotone Newton from below.
__device__ __forceinline__ void prox_h(const float (&t)[4], int n, float mu, float A,
                                       int inner, float (&h)[4]) {
  const int lane = threadIdx.x % 32;
  const float r = mu * A;
  float v[4], av[4], tot = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = lane + 32 * q < n ? t[q] - mu : 0.f;
    av[q] = fabsf(v[q]);
    tot += av[q];
  }
  const float total = warp_sum(tot);
  float tau = fmaxf(0.f, (total - r) / static_cast<float>(n));
  for (int k = 0; k < inner; ++k) {
    float s = 0.f, cnt = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (lane + 32 * q < n) {
        s += fmaxf(av[q] - tau, 0.f);
        cnt += av[q] > tau ? 1.f : 0.f;
      }
    }
    s = warp_sum(s);
    cnt = fmaxf(warp_sum(cnt), 1.f);
    tau = tau + (s - r) / cnt;
  }
  // prox radius >= ||v||_1: the l1 projection returns v, so h = 0
  const bool zero = total <= r;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    h[q] = (lane + 32 * q < n && !zero) ? fminf(fmaxf(v[q], -tau), tau) : 0.f;
}

// Projection of t (masked to n) onto {A ||h||_inf + sum h <= 1}, warp 0:
// bisection on mu, the prox by prox_h.  With warm, (lo_b, hi_b) is the
// bracket carried across iterations: clamped into [0, glob_hi] on entry,
// re-widened by max(hi - lo, 0.05 hi + 1e-2) on exit, and reset to
// (0, 3e37) when t is feasible.
struct NewtonProjection {
  __device__ static void project(const float (&t)[4], int n, float A, int outer, int inner,
                                 bool warm, float& lo_b, float& hi_b, float (&h)[4]) {
    const bool feasible = f_of(t, A) <= 1.f;
    float tt = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) tt += t[q] * t[q];
    const float glob_hi = fmaxf(1.f, 0.5f * warp_sum(tt) + 1.f);
    float lo = 0.f, hi = glob_hi;
    if (warm) {
      lo = fminf(fmaxf(lo_b, 0.f), glob_hi);
      hi = fminf(fmaxf(hi_b, lo), glob_hi);
    }
    for (int k = 0; k < outer; ++k) {
      const float mu = 0.5f * (lo + hi);
      prox_h(t, n, mu, A, inner, h);
      if (f_of(h, A) > 1.f)
        lo = mu;
      else
        hi = mu;
    }
    prox_h(t, n, hi, A, inner, h);  // the hi endpoint is feasible
    if (feasible) {
#pragma unroll
      for (int q = 0; q < 4; ++q) h[q] = t[q];
    }
    if (warm) {
      const float wd = fmaxf(hi - lo, 0.05f * hi + 1e-2f);
      lo_b = feasible ? 0.f : fmaxf(lo - wd, 0.f);
      hi_b = feasible ? 3e37f : hi + wd;
    }
  }
};

// Entry (r, c) of B = [[diag h, phi], [phi^H, lam_inv_sq]] (zero past n).
__device__ __forceinline__ void lifted_b(int r, int c, int n, const float* h, const float* phr,
                                         const float* phi, float lam_inv_sq, float& br,
                                         float& bi) {
  br = 0.f;
  bi = 0.f;
  if (r == c) br = h[c];  // zero past n
  if (r == n) {
    br = phr[c];
    bi = -phi[c];
  }
  if (c == n) {
    br = phr[r];
    bi = phi[r];
  }
  if (r == n && c == n) {
    br = lam_inv_sq;
    bi = 0.f;
  }
}

}  // namespace admmk
