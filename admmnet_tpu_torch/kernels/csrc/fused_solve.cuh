// The whole fixed-iteration ADMM solve of one instance in one thread block,
// on SIMT fp32 FMAs: the kernel body of fused_admm.cu (K7, the first-
// generation fused solve; the nested bisection H-projection).  K2 and K3
// run on the tensor-core body of fused_solve_tc.cuh, which takes this
// file's NewtonProjection, SolveParams and Layout; the launch templates and
// the P = 128 declaration below are K7's and an earlier K2's, kept as they
// were so that K7's code generation stays the same.  The H-projection is
// the template's Proj policy:
//   Proj::project(t, n, A, outer, inner, warm, lo, hi, h)
// runs in warp 0 on the logical entries lane + 32 q (q < 4, masked to n).
// The layout is a template parameter too, so that each instantiation
// carries only its own dataflow.
//
// Per iteration, per instance (B = [[diag h, phi], [phi^H, 1/lambda^2]]):
//   phi  = w (y/b + rho g + z)         g, z: conj of row n of G and Z
//   t    = diag(G + Z/rho);  h = projection of t onto
//          {A ||h||_inf + sum h <= 1}
//   M    = B - Z/rho                   lean: assembled directly, exactly
//                                      Hermitian; lists: herm(B - Z/rho)
//   A    = herm(sign(M) M) through the sign schedule (common.cuh)
//   G'   = (M + A)/2                   lists: then its Hermitian part
//   Z'   = rho (G' - M)                lean;  lists: Z + rho (G' - B)
// With fold_diag (lean only), phi and t read rho A[n, :] and diag(A) of the
// previous iteration instead of G and Z.  Without it only row n and the
// diagonal of G are read, so G is carried as those two rows in shared
// memory, not as planes: the values are the same fp32 numbers.  Only the
// (B, n) rows go in and the (B, n) phi rows come out.
//
// Bound on this card: arithmetic.  An iteration is 9 real P^3 products per
// schedule step plus 3 closing ones (K7's quintic-7: 66; 3x the FMAs per
// product with three_pass).  The TPU kernels held ~1 MB of state per
// instance in VMEM; an SM has 227 KB of shared memory, so here the Z, M
// and schedule planes live in a per-instance global scratch: 11 planes of
// 49 KB at P = 112, 552 KB a block.  One 256-thread block runs an SM (255
// registers), so 132 resident blocks hold 72.9 MB against the card's 50 MB
// L2: the working set does not stay in L2 (the hit rate is not measured).
// The row state (phi, the carried rows, h, the bisection bracket) lives in
// shared memory, and the products stream 16-deep shared-memory tiles into
// per-thread 7 x 7 register micro-tiles.  One block per instance and no
// interleave.  The H-projection runs in warp 0 with shuffle reductions
// while the other warps wait at a barrier.
//
// The folded instantiation was K2's production kernel before the tensor-
// core body, and its code generation was sensitive to spelling: the forms
// below of its phi update, of its t read and of B's entries in the M pass
// (written out, not through lifted_b) ran 1% faster at B = 8192 x 100 on
// an H100 than equivalent ones, with the same SASS instruction count
// within 0.2%.
#pragma once

#include "common.cuh"

namespace admmk {

constexpr int FUSED_PLANES = 11;  // Zr, Zi, Mr, Mi, then the 7 SignPlanes

// FOLDED: lean with fold_diag; LEAN: lean, unfolded carry; LISTS: lists.
enum Layout { FOLDED, LEAN, LISTS };

struct SolveParams {
  int n, num_iters, hi_steps, outer_iters, inner_iters;
  float rho, lam_inv_sq;
  int final_hi, warm_root, all_hi, three_pass;
};

// The solve's device buffers: (B, n) rows in, (B,) weights, (B, n) phi out,
// the per-block scratch planes.
struct SolveIO {
  const float *yob_r, *yob_i, *w, *A;
  float *phi_r, *phi_i, *scratch;
  int B;
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

template <int P, class Proj, int LAYOUT>
__global__ void __launch_bounds__(NT) fused_solve_kernel(
    const float* __restrict__ yob_r, const float* __restrict__ yob_i,
    const float* __restrict__ w_in, const float* __restrict__ A_in, float* phi_r_out,
    float* phi_i_out, float* scratch, SolveParams prm, Schedule sched) {
  constexpr int MT = P / TS;
  __shared__ Tiles<P> sm;
  __shared__ float s_yr[ROW], s_yi[ROW], s_w[ROW];  // inputs, zero past n
  // carried rows: diag and row n of A (fold_diag) or of G (otherwise)
  __shared__ float s_cd[ROW], s_cr[ROW], s_ci[ROW];
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
  const float rho = prm.rho;
  const bool rho1 = rho == 1.f;
  constexpr bool fold = LAYOUT == FOLDED, lists = LAYOUT == LISTS;

  for (int l = tid; l < ROW; l += NT) {
    const bool ok = l < n;
    s_yr[l] = ok ? yob_r[row0 + l] : 0.f;
    s_yi[l] = ok ? yob_i[row0 + l] : 0.f;
    s_w[l] = ok ? w_in[row0 + l] : 0.f;
    s_cd[l] = s_cr[l] = s_ci[l] = 0.f;  // G = 0 and A = 0 at the zero start
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
    // phi-update from row n of the carried A or of G and Z
    for (int l = tid; l < ROW; l += NT) {
      float pr = 0.f, pi = 0.f;
      if constexpr (fold) {
        const float ar = rho1 ? s_cr[l] : rho * s_cr[l];
        const float ai = rho1 ? s_ci[l] : rho * s_ci[l];
        s_phr[l] = l < n ? s_w[l] * (s_yr[l] + ar) : 0.f;
        s_phi[l] = l < n ? s_w[l] * (s_yi[l] - ai) : 0.f;
        continue;
      } else if (l < n) {
        // corner column by the Hermitian row read: g = conj(G[n, :])
        const float gr = s_cr[l], gi = -s_ci[l];
        const float zr = Zr[n * P + l], zi = -Zi[n * P + l];
        pr = s_w[l] * ((s_yr[l] + (rho1 ? gr : rho * gr)) + zr);
        pi = s_w[l] * ((s_yi[l] + (rho1 ? gi : rho * gi)) + zi);
      }
      s_phr[l] = pr;
      s_phi[l] = pi;
    }
    __syncthreads();

    // H-projection of t in warp 0
    if (tid < 32) {
      float t[4], h[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int l = tid + 32 * q;
        float v = 0.f;
        if constexpr (fold) {
          v = l < n ? s_cd[l] : 0.f;
        } else if (l < n) {
          const float zd = Zr[l * P + l];
          v = s_cd[l] + (rho1 ? zd : zd / rho);
        }
        t[q] = v;
      }
      float lo = s_lo, hi = s_hi;
      Proj::project(t, n, A, prm.outer_iters, prm.inner_iters, prm.warm_root != 0, lo, hi, h);
#pragma unroll
      for (int q = 0; q < 4; ++q) s_h[tid + 32 * q] = h[q];
      __syncwarp();
      if (tid == 0) {
        s_lo = lo;
        s_hi = hi;
      }
    }
    __syncthreads();

    // M = B - Z / rho (lean: exactly Hermitian as assembled; lists: its
    // Hermitian part, the transposed Z read from the plane), and ||M||_F
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
        float mr = br - (rho1 ? zr : zr / rho);
        float mi = bi - (rho1 ? zi : zi / rho);
        if constexpr (lists) {
          // (B - Z/rho)^T at (r, c): B's real part is symmetric, its
          // imaginary part antisymmetric
          const float zrt = Zr[c * P + r], zit = Zi[c * P + r];
          const float mrt = br - (rho1 ? zrt : zrt / rho);
          const float mit = -bi - (rho1 ? zit : zit / rho);
          mr = 0.5f * (mr + mrt);
          mi = 0.5f * (mi - mit);
        }
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
    if constexpr (lists) {
      // G' = herm((M + A) / 2); Z' = Z + rho (G' - B)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const int idx = (ty + TS * i) * P + tx + TS * j;
          ar[i][j] = 0.5f * (Mr[idx] + ar[i][j]);
          ai[i][j] = 0.5f * (Mi[idx] + ai[i][j]);
        }
      hermitian_part<P>(w.Xr, w.Xi, ar, ai);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const int r = ty + TS * i, c = tx + TS * j, idx = r * P + c;
          const float gr = ar[i][j], gi = ai[i][j];
          if (r == c) s_cd[c] = gr;
          if (r == n) {
            s_cr[c] = gr;
            s_ci[c] = gi;
          }
          float br, bi;
          lifted_b(r, c, n, s_h, s_phr, s_phi, prm.lam_inv_sq, br, bi);
          Zr[idx] = Zr[idx] + rho * (gr - br);
          Zi[idx] = Zi[idx] + rho * (gi - bi);
        }
    } else {
      // G' = (M + A) / 2; Z' = rho (G' - M)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const int r = ty + TS * i, c = tx + TS * j, idx = r * P + c;
          const float mr = Mr[idx], mi = Mi[idx];
          const float pr = 0.5f * (mr + ar[i][j]);
          const float pi = 0.5f * (mi + ai[i][j]);
          // the next iteration reads A (fold_diag) or G'
          const float cr = fold ? ar[i][j] : pr, ci = fold ? ai[i][j] : pi;
          if (r == c) s_cd[c] = cr;
          if (r == n) {
            s_cr[c] = cr;
            s_ci[c] = ci;
          }
          Zr[idx] = rho1 ? pr - mr : rho * (pr - mr);
          Zi[idx] = rho1 ? pi - mi : rho * (pi - mi);
        }
    }
    __syncthreads();
  }

  // phi of the last iteration (computed from the pre-update state)
  for (int l = tid; l < n; l += NT) {
    phi_r_out[row0 + l] = s_phr[l];
    phi_i_out[row0 + l] = s_phi[l];
  }
}

// Launch of the solve with plane side P on io.B blocks; the caller checks
// B, n and nsteps.  Returns the launch's cudaError_t.
template <int P, class Proj, int LAYOUT>
int launch_fused_solve(const SolveIO& io, const SolveParams& prm, const Schedule& sched,
                       void* stream) {
  fused_solve_kernel<P, Proj, LAYOUT><<<io.B, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      io.yob_r, io.yob_i, io.w, io.A, io.phi_r, io.phi_i, io.scratch, prm, sched);
  return static_cast<int>(cudaGetLastError());
}

// The same with the layout chosen at run time.
template <int P, class Proj>
int launch_fused_layout(int layout, const SolveIO& io, const SolveParams& prm,
                        const Schedule& sched, void* stream) {
  switch (layout) {
    case FOLDED:
      return launch_fused_solve<P, Proj, FOLDED>(io, prm, sched, stream);
    case LEAN:
      return launch_fused_solve<P, Proj, LEAN>(io, prm, sched, stream);
    case LISTS:
      return launch_fused_solve<P, Proj, LISTS>(io, prm, sched, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2/K3 at P = 128 (113 <= n + 1 <= 128), defined in fused_admm_fast_p128.cu
// so that the two plane sides compile in parallel.
int fused_admm_fast_p128(int layout, const SolveIO& io, const SolveParams& prm,
                         const Schedule& sched, void* stream);

}  // namespace admmk
