// The whole fixed-iteration ADMM solve of one instance in one thread block.
//
// Replaces admmnet_tpu/kernels/fused_admm_fast.py :: admm_solve_fused_fast
// with layout="lean" (kernel body _fused_fast_kernel_lean), fold_diag on:
// the g_update="fused_fast" (production, detection grade) and "fused_exact"
// (phi-faithful) contracts of the classical solver.
//
// Per iteration, per instance:
//   phi  = w (y/b + rho arow)          arow: row n of the last |M| product
//   h    = projection of diag(A) onto {A ||h||_inf + sum h <= 1}
//          (warm- or cold-bracketed bisection x Newton waterline)
//   M    = [[diag h, phi], [phi^H, 1/lambda^2]] - Z / rho
//   A    = herm(sign(M) M) through the sign schedule (common.cuh)
//   Z'   = rho ((M + A)/2 - M);  diag(A) and row n of A are kept for the
//          next iteration (so the G planes are never stored).
// Only the (B, n) rows go in and the (B, n) phi rows come out.
//
// Bound on this card: arithmetic.  An iteration is 9 real P^3 products per
// schedule step plus 3 closing ones (P = 112: 59 MFLOP for the 2-step
// production schedule; 3x that per product with three_pass).  The TPU
// kernel held ~1 MB of state per instance in VMEM; an SM has 227 KB of
// shared memory, so here the Z, M and schedule planes (11 x 49 KB) live in
// a per-instance global scratch that stays in L2 while the block runs, the
// row state (phi, the folded |M| rows, the bisection bracket) lives in
// shared memory, and the products stream 16-deep shared-memory tiles into
// per-thread 7 x 7 register micro-tiles (IEEE fp32, or the literal 3-pass
// split-bf16 product for the "hi" products of three_pass).  One block per
// instance and no interleave: at B = 8192 the 132 SMs stay full.  The
// H-projection runs in warp 0 with shuffle reductions (4 lanes of the
// n <= 128 logical entries per thread), the other warps wait at a barrier.
#include "common.cuh"

namespace admmk {

constexpr int FUSED_PLANES = 11;  // Zr, Zi, Mr, Mi, then the 7 SignPlanes

struct SolveParams {
  int n, num_iters, hi_steps, outer_iters, inner_iters;
  float rho, lam_inv_sq;
  int final_hi, warm_root, all_hi, three_pass;
};

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

__device__ __forceinline__ float f_of(const float (&h)[4], float A) {
  float m = 0.f, s = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    m = fmaxf(m, fabsf(h[q]));
    s += h[q];
  }
  return A * warp_max(m) + warp_sum(s);
}

// Projection of t (masked to n) onto {A ||h||_inf + sum h <= 1}, warp 0.
// With warm, (lo_b, hi_b) is the bracket carried across iterations: clamped
// into [0, glob_hi] on entry, re-widened by max(hi - lo, 0.05 hi + 1e-2) on
// exit, and reset to (0, 3e37) when t is feasible.
__device__ void project_sum_inf_warp(const float (&t)[4], int n, float A, int outer, int inner,
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

template <int P>
__global__ void __launch_bounds__(NT) fused_admm_fast_kernel(
    const float* __restrict__ yob_r, const float* __restrict__ yob_i,
    const float* __restrict__ w_in, const float* __restrict__ A_in, float* phi_r_out,
    float* phi_i_out, float* scratch, SolveParams prm, Schedule sched) {
  constexpr int MT = P / TS;
  __shared__ Tiles<P> sm;
  __shared__ float s_yr[ROW], s_yi[ROW], s_w[ROW];      // inputs, zero past n
  __shared__ float s_adiag[ROW], s_arr[ROW], s_ari[ROW];  // folded |M| stats
  __shared__ float s_phr[ROW], s_phi[ROW], s_h[ROW];
  __shared__ float s_lo, s_hi;

  const int n = prm.n;
  const int tid = threadIdx.x;
  const int ty = tid / TS, tx = tid % TS;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * n;
  float* base = scratch + static_cast<size_t>(blockIdx.x) * FUSED_PLANES * P * P;
  float* Zr = base;
  float* Zi = base + 1 * P * P;
  float* Mr = base + 2 * P * P;
  float* Mi = base + 3 * P * P;
  SignPlanes w;
  w.Xr = base + 4 * P * P;
  w.Xi = base + 5 * P * P;
  w.X2r = base + 6 * P * P;
  w.X2i = base + 7 * P * P;
  w.Yr = base + 8 * P * P;
  w.Yi = base + 9 * P * P;
  w.T = base + 10 * P * P;
  const float A = A_in[blockIdx.x];
  const bool rho1 = prm.rho == 1.f;

  for (int l = tid; l < ROW; l += NT) {
    const bool ok = l < n;
    s_yr[l] = ok ? yob_r[row0 + l] : 0.f;
    s_yi[l] = ok ? yob_i[row0 + l] : 0.f;
    s_w[l] = ok ? w_in[row0 + l] : 0.f;
    s_adiag[l] = s_arr[l] = s_ari[l] = 0.f;  // |M| = 0 at the zero start
    s_phr[l] = s_phi[l] = s_h[l] = 0.f;
  }
  for (int e = tid; e < P * P; e += NT) {
    Zr[e] = 0.f;
    Zi[e] = 0.f;
  }
  if (tid == 0) {
    s_lo = 0.f;
    s_hi = 3e37f;
  }
  __syncthreads();

  for (int it = 0; it < prm.num_iters; ++it) {
    // phi-update from row n of the previous |M| product
    for (int l = tid; l < ROW; l += NT) {
      const float ar = rho1 ? s_arr[l] : prm.rho * s_arr[l];
      const float ai = rho1 ? s_ari[l] : prm.rho * s_ari[l];
      s_phr[l] = l < n ? s_w[l] * (s_yr[l] + ar) : 0.f;
      s_phi[l] = l < n ? s_w[l] * (s_yi[l] - ai) : 0.f;
    }
    __syncthreads();

    // H-projection of diag(A) in warp 0
    if (tid < 32) {
      float t[4], h[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) t[q] = tid + 32 * q < n ? s_adiag[tid + 32 * q] : 0.f;
      float lo = s_lo, hi = s_hi;
      project_sum_inf_warp(t, n, A, prm.outer_iters, prm.inner_iters, prm.warm_root != 0, lo,
                           hi, h);
#pragma unroll
      for (int q = 0; q < 4; ++q) s_h[tid + 32 * q] = h[q];
      __syncwarp();
      if (tid == 0) {
        s_lo = lo;
        s_hi = hi;
      }
    }
    __syncthreads();

    // M = B - Z / rho, assembled directly (exactly Hermitian), and ||M||_F
    float fro = 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int r = ty + TS * i, c = tx + TS * j, idx = r * P + c;
        float br = 0.f, bi = 0.f;
        if (r == c) br = s_h[c];  // zero past n
        if (r == n) {
          br = s_phr[c];
          bi = -s_phi[c];
        }
        if (c == n) {
          br = s_phr[r];
          bi = s_phi[r];
        }
        if (r == n && c == n) {
          br = prm.lam_inv_sq;
          bi = 0.f;
        }
        const float zr = Zr[idx], zi = Zi[idx];
        const float mr = br - (rho1 ? zr : zr / prm.rho);
        const float mi = bi - (rho1 ? zi : zi / prm.rho);
        Mr[idx] = mr;
        Mi[idx] = mi;
        fro += mr * mr + mi * mi;
      }
    const float inv = 1.f / fmaxf(sqrtf(block_sum<P>(sm, fro)), 1e-30f);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int idx = (ty + TS * i) * P + tx + TS * j;
        w.Xr[idx] = Mr[idx] * inv;
        w.Xi[idx] = Mi[idx] * inv;
      }
    __syncthreads();

    sign_schedule<P>(sm, w, sched, prm.hi_steps, prm.all_hi != 0, prm.three_pass != 0);

    float ar[MT][MT], ai[MT][MT];
    abs_product<P>(sm, w, Mr, Mi, prm.final_hi != 0 && prm.three_pass != 0, ar, ai);
    // next iteration's reads come from A; Z' = rho (P - M), P = (M + A) / 2
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int r = ty + TS * i, c = tx + TS * j, idx = r * P + c;
        if (r == c) s_adiag[c] = ar[i][j];
        if (r == n) {
          s_arr[c] = ar[i][j];
          s_ari[c] = ai[i][j];
        }
        const float mr = Mr[idx], mi = Mi[idx];
        const float pr = 0.5f * (mr + ar[i][j]);
        const float pi = 0.5f * (mi + ai[i][j]);
        Zr[idx] = rho1 ? pr - mr : prm.rho * (pr - mr);
        Zi[idx] = rho1 ? pi - mi : prm.rho * (pi - mi);
      }
    __syncthreads();
  }

  // phi of the last iteration (computed from the pre-update state)
  for (int l = tid; l < n; l += NT) {
    phi_r_out[row0 + l] = s_phr[l];
    phi_i_out[row0 + l] = s_phi[l];
  }
}

}  // namespace admmk

// C entry point.  yob_r, yob_i, w: (B, n) float rows; A: (B,) constraint
// weights; phi_r, phi_i: (B, n), written; scratch: B * 11 * P * P floats.
// coeffs: host array of nsteps (a, b, c) triples.  Returns the launch's
// cudaError_t.
extern "C" int fused_admm_fast_launch(const float* yob_r, const float* yob_i, const float* w,
                                      const float* A, float* phi_r, float* phi_i,
                                      float* scratch, int B, int n, int P, int num_iters,
                                      float rho, float lam_inv_sq, const float* coeffs,
                                      int nsteps, int hi_steps, int outer_iters,
                                      int inner_iters, int final_hi, int warm_root, int all_hi,
                                      int three_pass, void* stream) {
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
  SolveParams prm{n,   num_iters,  hi_steps, outer_iters, inner_iters, rho,
                  lam_inv_sq, final_hi, warm_root, all_hi,      three_pass};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P == 112)
    fused_admm_fast_kernel<112><<<B, NT, 0, st>>>(yob_r, yob_i, w, A, phi_r, phi_i, scratch,
                                                   prm, sched);
  else if (P == 128)
    fused_admm_fast_kernel<128><<<B, NT, 0, st>>>(yob_r, yob_i, w, A, phi_r, phi_i, scratch,
                                                   prm, sched);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
