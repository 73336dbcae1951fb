// The first-generation whole fixed-iteration ADMM solve (K7), with the
// nested-bisection H-projection.
//
// Replaces admmnet_tpu/kernels/fused_admm.py :: admm_solve_fused (kernel
// body _fused_kernel): the per-step g_update="polar" solve fused whole.
// Per iteration, per instance (B = [[diag h, phi], [phi^H, 1/lambda^2]]):
//   phi = w (y/b + rho g + z)         g, z: conj of row n of G and Z
//   t   = diag(G + Z/rho);  h = the nested projection of t (the JAX
//         kernel's _project_sum_inf_row: 32 x 32 serial bisection steps by
//         default, polar_cta.cuh's nested_projection in warp 0)
//   M   = B - Z/rho;  X = M / ||M||_F, then the quintic-7 schedule, every
//         step hi, no re-projection
//   A   = herm(X M);  G' = (M + A)/2;  Z' = Z + rho (G' - B)
// B is Hermitian and Z starts at 0, so M, G' and Z' are exactly Hermitian:
// the JAX kernel's herm(B - Z/rho) and its re-symmetrization of G' return
// their input bit for bit and are not run, and row n of G and Z is read as
// the conjugate of column n.
//
// Bound on this card: arithmetic.  An iteration is 66 real P^3 products at
// the logical side n + 1 (7 steps x 9 + 3), against a read of the (B, n)
// rows and a write of phi; in 3xTF32 on the tensor cores 42.2 ms at B = 512
// x 100 iterations (fp32 SIMT: 103.9 ms).
//
// Design: the body of polar_cta.cuh (K1's), one CTA of 7 warps per
// instance at P = 112 (n + 1 <= 112), a cluster of two CTAs of 16 warps at
// P = 128.  The planes X and W live in shared memory, every product is a
// whole 3xTF32 product per CTA (or pair); the closing product's right
// operand M is recomputed into W from Z and B after the schedule.  Z does
// not fit beside them (two more planes) nor in the registers beside a
// whole product's output, so it lives in a two-plane global scratch per
// instance, read and written once an iteration at each thread's own
// elements (132 instances in flight hold 13 MB: L2-resident).  The carried
// vectors (column n and the diagonal of G and Z), phi, h and the inputs
// live in shared-memory rows; at P = 128 each CTA fills the entries of its
// own rows and copies the peer's after a cluster barrier.  The
// H-projection runs serially in warp 0 of each CTA while the other warps
// wait.
//
// Shared memory per CTA: the body (polar_cta.cuh: 215040 B at P = 112,
// 208896 B at P = 128, + 256 B of slots) and 12 rows of 128 floats (6144 B).
#include "polar_cta.cuh"

namespace pcta {

constexpr int K7_ROWS = 12;

struct K7Params {
  int n, num_iters, outer_iters, inner_iters;
  float rho, lam_inv_sq;
};

template <class C>
__global__ void __launch_bounds__(C::NT, 1)
    fused_cta_kernel(const float* __restrict__ yob_r, const float* __restrict__ yob_i,
                     const float* __restrict__ w_in, const float* __restrict__ A_in,
                     float* phi_r_out, float* phi_i_out, float* zscratch, K7Params prm,
                     Schedule sched) {
  constexpr int P = C::P, NTW = C::NTW, S = C::S;
  using admmk::ROW;
  extern __shared__ __align__(16) float smem[];
  const Body<C> bd(smem, prm.n + 1);
  float* s_yr = smem + C::FLOATS;  // inputs, zero past n
  float* s_yi = s_yr + ROW;
  float* s_w = s_yi + ROW;
  float* s_phr = s_w + ROW;  // phi
  float* s_phi = s_phr + ROW;
  float* s_h = s_phi + ROW;
  float* s_gd = s_h + ROW;  // diagonal of G, column n of G (conj of row n)
  float* s_gnr = s_gd + ROW;
  float* s_gni = s_gnr + ROW;
  float* s_zd = s_gni + ROW;  // the same of Z
  float* s_znr = s_zd + ROW;
  float* s_zni = s_znr + ROW;

  const int n = prm.n, tid = threadIdx.x;
  const int inst = blockIdx.x / C::NC;
  const size_t row0 = static_cast<size_t>(inst) * n;
  float* Zr = zscratch + static_cast<size_t>(inst) * 2 * P * P;
  float* Zi = Zr + P * P;
  const float A = A_in[inst];
  const float rho = prm.rho;
  const bool rho1 = rho == 1.f;
  auto zscale = [&](float z) { return rho1 ? z : z / rho; };
  auto lifted_b = [&](int r, int c, float& br, float& bi) {
    admmk::lifted_b(r, c, n, s_h, s_phr, s_phi, prm.lam_inv_sq, br, bi);
  };

  for (int l = tid; l < ROW; l += C::NT) {
    const bool ok = l < n;
    s_yr[l] = ok ? yob_r[row0 + l] : 0.f;
    s_yi[l] = ok ? yob_i[row0 + l] : 0.f;
    s_w[l] = ok ? w_in[row0 + l] : 0.f;
    s_phr[l] = s_phi[l] = s_h[l] = 0.f;
    s_gd[l] = s_gnr[l] = s_gni[l] = s_zd[l] = s_znr[l] = s_zni[l] = 0.f;  // G = Z = 0
  }
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int o = (bd.row0 + bd.lrow(e)) * P + bd.col(j, e);
      *reinterpret_cast<float2*>(Zr + o) = make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(Zi + o) = make_float2(0.f, 0.f);
    }
  __syncthreads();

  for (int it = 0; it < prm.num_iters; ++it) {
    // phi-update (every CTA, every row): g = G[:, n], z = Z[:, n]
    for (int l = tid; l < ROW; l += C::NT) {
      float pr = 0.f, pi = 0.f;
      if (l < n) {
        const float gr = s_gnr[l], gi = s_gni[l], zr = s_znr[l], zi = s_zni[l];
        pr = s_w[l] * ((s_yr[l] + (rho1 ? gr : rho * gr)) + zr);
        pi = s_w[l] * ((s_yi[l] + (rho1 ? gi : rho * gi)) + zi);
      }
      s_phr[l] = pr;
      s_phi[l] = pi;
    }
    __syncthreads();

    // H-projection of t in warp 0 (each CTA of a pair alike)
    if (tid < 32) {
      float t[4], h[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int l = tid + 32 * q;
        t[q] = l < n ? s_gd[l] + zscale(s_zd[l]) : 0.f;
      }
      nested_projection(t, n, A, prm.outer_iters, prm.inner_iters, h);
#pragma unroll
      for (int q = 0; q < 4; ++q) s_h[tid + 32 * q] = h[q];
    }
    __syncthreads();

    // M = B - Z/rho (own elements) into X, ||M||_F, then X = M / ||M||_F
    float fro = 0.f;
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lr = bd.lrow(e), c = bd.col(j, e), r = bd.row0 + lr;
        float br, bi;
        lifted_b(r, c, br, bi);
        const float mr = br - zscale(Zr[r * P + c]);
        const float mi = bi - zscale(Zi[r * P + c]);
        bd.Xr[lr * S + c] = mr;
        bd.Xi[lr * S + c] = mi;
        fro += mr * mr + mi * mi;
      }
    const float inv = 1.f / fmaxf(sqrtf(bd.matrix_sum(fro)), 1e-30f);
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = bd.idx(j, e);
        bd.Xr[i] *= inv;
        bd.Xi[i] *= inv;
      }
    bd.sync_all();

    bd.template sign_schedule<false, false>(sched, sched.n);  // all hi

    // M again into W (the same fp32 operations), then A = herm(X M)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lr = bd.lrow(e), c = bd.col(j, e), r = bd.row0 + lr;
        float br, bi;
        lifted_b(r, c, br, bi);
        bd.Wr[lr * S + c] = br - zscale(Zr[r * P + c]);
        bd.Wi[lr * S + c] = bi - zscale(Zi[r * P + c]);
      }
    bd.sync_all();
    float ar[NTW][4], ai[NTW][4];
    bd.abs_product(ar, ai);

    // G' = (M + A) / 2, Z' = Z + rho (G' - B), and the carried entries of
    // the own rows
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lr = bd.lrow(e), c = bd.col(j, e), r = bd.row0 + lr;
        const float gr = 0.5f * (bd.Wr[lr * S + c] + ar[j][e]);
        const float gi = 0.5f * (bd.Wi[lr * S + c] + ai[j][e]);
        float br, bi;
        lifted_b(r, c, br, bi);
        const float zr = Zr[r * P + c] + rho * (gr - br);
        const float zi = Zi[r * P + c] + rho * (gi - bi);
        Zr[r * P + c] = zr;
        Zi[r * P + c] = zi;
        if (r == c) {
          s_gd[r] = gr;
          s_zd[r] = zr;
        }
        if (c == n) {
          s_gnr[r] = gr;
          s_gni[r] = gi;
          s_znr[r] = zr;
          s_zni[r] = zi;
        }
      }
    bd.sync_all();
    if constexpr (C::NC > 1) {
      // the peer's rows of the carried vectors
      cg::cluster_group cl = cg::this_cluster();
      const int peer = bd.rank ^ 1, lo = peer * C::ROWS;
      for (int u = tid; u < 6 * C::ROWS; u += C::NT) {
        float* v = s_gd + (u / C::ROWS) * ROW + lo + u % C::ROWS;
        *v = *cl.map_shared_rank(v, peer);
      }
      // the peer reads these rows of this CTA's no more before the next
      // iteration's writes
      cl.sync();
    }
  }

  // phi of the last iteration (computed from the pre-update state)
  if (bd.rank == 0) {
    for (int l = tid; l < n; l += C::NT) {
      phi_r_out[row0 + l] = s_phr[l];
      phi_i_out[row0 + l] = s_phi[l];
    }
  }
  if constexpr (C::NC > 1) cg::this_cluster().sync();  // no CTA leaves while the peer reads it
}

}  // namespace pcta

// C entry point.  yob_r, yob_i, w: (B, n) float rows; A: (B,) constraint
// weights; phi_r, phi_i: (B, n), written; zscratch: B * 2 * P * P floats
// (Z's planes, overwritten).  coeffs: host array of nsteps (a, b, c)
// triples (the quintic-7 schedule).  Returns the launch's cudaError_t.
extern "C" int fused_admm_launch(const float* yob_r, const float* yob_i, const float* w,
                                 const float* A, float* phi_r, float* phi_i, float* zscratch,
                                 int B, int n, int P, int num_iters, float rho, float lam_inv_sq,
                                 const float* coeffs, int nsteps, int outer_iters,
                                 int inner_iters, void* stream) {
  using namespace pcta;
  if (nsteps < 0 || nsteps > admmk::MAX_STEPS || B <= 0 || n < 1 || n + 1 > P ||
      n > admmk::ROW)
    return static_cast<int>(cudaErrorInvalidValue);
  Schedule sched{};
  for (int s = 0; s < nsteps; ++s) {
    sched.a[s] = coeffs[3 * s];
    sched.b[s] = coeffs[3 * s + 1];
    sched.c[s] = coeffs[3 * s + 2];
  }
  sched.n = nsteps;
  const K7Params prm{n, num_iters, outer_iters, inner_iters, rho, lam_inv_sq};
  const int rows = K7_ROWS * admmk::ROW;
  if (P == 112)
    return launch<Cfg112>(fused_cta_kernel<Cfg112>, B, Cfg112::FLOATS + rows, stream,
                          yob_r, yob_i, w, A, phi_r, phi_i, zscratch, prm, sched);
  if (P == 128)
    return launch<Cfg128>(fused_cta_kernel<Cfg128>, B, Cfg128::FLOATS + rows, stream,
                          yob_r, yob_i, w, A, phi_r, phi_i, zscratch, prm, sched);
  return static_cast<int>(cudaErrorInvalidValue);
}
