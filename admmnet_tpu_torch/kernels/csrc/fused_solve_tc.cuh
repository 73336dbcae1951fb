// The whole fixed-iteration ADMM solve of one instance on one thread-block
// cluster, every product on the tensor cores: the kernel body of K2 (lean:
// FOLDED, the production fused_fast and fused_exact; LEAN, the unfolded
// carry and its ablate variants) and K3 (LISTS), launched by
// fused_admm_fast{,_p128,_ablate,_ablate_p128}.cu.
//
// Per iteration, per instance (B = [[diag h, phi], [phi^H, 1/lambda^2]]):
//   phi  = w (y/b + rho g + z)         g, z: conj of row n of G and Z
//   t    = diag(G + Z/rho);  h = NewtonProjection of t
//   M    = B - Z/rho
//   X    = M / ||M||_F, then the sign schedule (kernels/polar.py's rule: a
//          step is hi iff all_hi or s >= nsteps - hi_steps, its products split
//          iff three_pass, one-pass iff it is not hi (without three_pass),
//          the iterate re-projected iff not hi or three_pass)
//   A    = herm(X M);  G' = (M + A)/2
//   Z'   = rho (G' - M)                lean;  lists: Z + rho (G' - B)
// With fold_diag (FOLDED), phi and t read rho A[n, :] and diag(A) of the
// previous iteration instead of G and Z.
//
// Exactly Hermitian: B is; Z starts at 0; A is made so by its re-projection;
// so G', Z' and M are, bit for bit (elementwise sums, differences and
// halvings of symmetric / antisymmetric pairs stay so).  Hence (1) row n of
// A, G or Z equals the conjugate of column n: each CTA forms phi for its own
// rows from its own band, and the CTA holding row n forms all of it; (2)
// K3's herm(B - Z/rho) and its output re-symmetrization return their input
// bit for bit, so K3 runs without them (its B is still materialized for
// Z + rho (G' - B)).
//
// Bound on this card: arithmetic.  An iteration is 3 complex products per
// schedule step and 1 closing one, 9 nsteps + 3 real P^3 products (sched2:
// 21), against a read of the (B, n) rows and a write of phi.  At the
// production point (sched2, no hi step, final_hi off) all 21 are one-pass
// TF32 products (495 TFLOP/s dense); fused_exact's are fp32-faithful
// (3xTF32, three TF32 products each).
//
// Design: one cluster of NC = P / 16 CTAs per instance (tc_product.cuh's
// layout).  CTA q holds rows [16 q, 16 q + 16) of the working planes in
// shared memory: M, X (the sign iterate), U (X^2, then the exchange plane of
// a re-projection) and Y (the schedule polynomial), real and imaginary, 8
// band planes.  Z (and, for ablate "assemble", G) lives in registers in the
// mma accumulator layout: it is only used elementwise.  Products run in
// tc_product.cuh's tiers, selected per product by a branch uniform over
// the cluster (so the tier multiplies no instantiation): a hi product in
// 3xTF32 (fp32-faithful) or, with three_pass, in the split-bf16 contract
// (4 mma per real product); a product of a step that is not hi, and the
// closing product when final_hi is off, one-pass (one TF32 m16n8k8 mma per
// real product and 8-deep step, operands rounded to tf32; tc_product.cuh
// says why tf32 and not the MXU's bf16).  A three_pass launch has no low
// product: the wrapper runs it only with every step and the closing
// product hi (fused_exact).
// Split and one-pass squarings take the 4-multiplication form, which
// rounds and drops what kernels/polar.py's herm_square does (4 products a
// square where the plain version has 3).  Every right operand is read band by
// band from its owner over distributed shared memory.  Nothing but the
// rows in and phi out touches device memory.
//
// Shared memory per CTA: 8 planes of 16 (P + 4) floats, the staging double
// buffer of 4 x 16 (P + 8) floats, 10 rows of 128 floats and 80 floats of
// band and cluster slots: at P = 112, 59392 + 30720 + 5120 + 320 = 95552 B,
// so two CTAs share an SM (2 x (95552 + 1024) B of 233472 B); at P = 128,
// 67584 + 34816 + 5120 + 320 = 107840 B, one CTA an SM.
//
// Cluster barriers per iteration: 1 to gather t, the Frobenius partial sums
// and diag(Z) (the H-projection then runs redundantly in warp 0 of every
// CTA, and each CTA finishes ||M||_F itself); 1 to publish X and M; per
// schedule step 4 (X^2 | X^4 | X Y | the re-projection's transposed reads),
// 3 without re-projection; 1 for the closing product's transposed reads.
// sched2 (two re-projected steps): 11.  The projection is a serial chain in
// warp 0; the SM's other CTA (another instance) can use the SM meanwhile,
// but with ~37 instances in flight it still costs ~6% of an iteration at a
// cold 4/3 root (chip_smoke.py --profile-k2 on an H100).
#pragma once

#include "fused_solve.cuh"
#include "tc_product.cuh"

namespace admmk {

namespace cg = cooperative_groups;

// K2's profiling variants (LEAN only), in the order of the wrapper's ABLATE
// names: each removes one component of the iteration.
enum Ablate { AB_NONE, AB_CORNER, AB_DIAG, AB_H, AB_NORM, AB_ASSEMBLE, AB_ZUPD, AB_FINALS };

// The solve's device buffers: (B, n) rows in, (B,) weights, (B, n) phi out.
struct SolveRows {
  const float *yob_r, *yob_i, *w, *A;
  float *phi_r, *phi_i;
  int B;
};

constexpr int TC_PLANES = 8;
constexpr int TC_ROWS = 10;
constexpr int TC_SLOTS = 5 * tcp::BAND;  // s_cd, s_zd, pub_t, pub_zd, misc

template <int P>
constexpr int tc_smem_floats() {
  return TC_PLANES * tcp::Layout<P>::PLANE + 4 * tcp::Layout<P>::SLICE + TC_ROWS * ROW +
         TC_SLOTS;
}

template <int P, int LAYOUT, int ABLATE, bool THREE_PASS>
__global__ void __launch_bounds__(tcp::Layout<P>::NT, P == 112 ? 2 : 1)
    fused_tc_kernel(SolveRows io, SolveParams prm, Schedule sched) {
  using L = tcp::Layout<P>;
  using tcp::BAND;
  using tcp::CAcc;
  using tcp::NPW;
  constexpr int SA = L::SA;
  constexpr bool fold = LAYOUT == FOLDED, lists = LAYOUT == LISTS;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int inst = blockIdx.x / L::NC;
  const int row0 = rank * BAND;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int n = prm.n, m = n + 1;
  const bool own_n = row0 <= n && n < row0 + BAND;  // this CTA holds row n
  const float rho = prm.rho;
  const bool rho1 = rho == 1.f;
  const float A = io.A[inst];

  float* Mr = smem;
  float* Mi = Mr + L::PLANE;
  float* Xr = Mi + L::PLANE;
  float* Xi = Xr + L::PLANE;
  float* Ur = Xi + L::PLANE;
  float* Ui = Ur + L::PLANE;
  float* Yr = Ui + L::PLANE;
  float* Yi = Yr + L::PLANE;
  float* stage = Yi + L::PLANE;
  float* s_yr = stage + 4 * L::SLICE;  // inputs, zero past n
  float* s_yi = s_yr + ROW;
  float* s_w = s_yi + ROW;
  float* s_phr = s_w + ROW;  // phi of the rows this CTA needs
  float* s_phi = s_phr + ROW;
  float* s_h = s_phi + ROW;  // h, every entry
  float* s_nr = s_h + ROW;   // row n of A (fold) or G, where this CTA needs it
  float* s_ni = s_nr + ROW;
  float* s_znr = s_ni + ROW;  // row n of Z (unfolded)
  float* s_zni = s_znr + ROW;
  float* s_cd = s_zni + ROW;      // diag of A (fold) or G, own rows
  float* s_zd = s_cd + BAND;      // diag of Z, own rows
  float* pub_t = s_zd + BAND;     // cluster slots: t of the own rows,
  float* pub_zd = pub_t + BAND;   // their Z diagonal / rho,
  float* misc = pub_zd + BAND;    // [0] ||M||_F^2 but the h diagonal; [1] 1/||M||_F;
                                  // [2], [3] the bracket; [4..] warp partials

  auto row_of = [&](int e) { return g + 8 * (e >> 1); };
  auto col_of = [&](int j, int e) { return warp * 16 + 8 * j + 2 * q4 + (e & 1); };
  auto zscale = [&](float z) { return rho1 ? z : z / rho; };
  // entry (r, c) of B (zero past n)
  auto lifted_b = [&](int r, int c, float& br, float& bi) {
    br = r == c ? s_h[c] : 0.f;
    bi = 0.f;
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
  };
  // the transposed entry (c, r) of a plane whose band c / 16 lies in that CTA
  auto transposed = [&](const float* plane, int r, int c) {
    return *cluster.map_shared_rank(plane + (c % BAND) * SA + r, c / BAND);
  };
  // one complex product, acc = L R (L: this band; R: every band): split
  // (three_pass) or one-pass (never both), Karatsuba's form or (kara =
  // false) the 4-multiplication form, else 3xTF32
  using tcp::Prec;
  auto product = [&](bool split, bool one, bool kara, float* Rr, float* Ri, const float* Lr,
                     const float* Li, CAcc (&acc)[1][NPW]) {
    const float* const lr[1] = {Lr};
    const float* const li[1] = {Li};
    if constexpr (THREE_PASS) {
      if (split) {
        if (kara)
          tcp::band_product<P, 1, Prec::SPLIT, true>(cluster, Rr, Ri, lr, li, stage, m, acc);
        else
          tcp::band_product<P, 1, Prec::SPLIT, false>(cluster, Rr, Ri, lr, li, stage, m, acc);
        return;
      }
    } else {
      if (one) {
        if (kara)
          tcp::band_product<P, 1, Prec::ONE_PASS, true>(cluster, Rr, Ri, lr, li, stage, m, acc);
        else
          tcp::band_product<P, 1, Prec::ONE_PASS, false>(cluster, Rr, Ri, lr, li, stage, m, acc);
        return;
      }
    }
    tcp::band_product<P, 1>(cluster, Rr, Ri, lr, li, stage, m, acc);
  };
  auto im_of = [&](bool four, const CAcc& c, int e) {
    return four ? tcp::acc_im4(c, e) : tcp::acc_im(c, e);
  };

  const size_t rowbase = static_cast<size_t>(inst) * n;
  for (int l = tid; l < ROW; l += L::NT) {
    const bool ok = l < n;
    s_yr[l] = ok ? io.yob_r[rowbase + l] : 0.f;
    s_yi[l] = ok ? io.yob_i[rowbase + l] : 0.f;
    s_w[l] = ok ? io.w[rowbase + l] : 0.f;
    s_phr[l] = s_phi[l] = s_h[l] = 0.f;  // G = 0 and A = 0 at the zero start
    s_nr[l] = s_ni[l] = s_znr[l] = s_zni[l] = 0.f;
  }
  if (tid < BAND) s_cd[tid] = s_zd[tid] = 0.f;
  if (tid == 0) {
    misc[2] = 0.f;
    misc[3] = 3e37f;
  }
  float zr[NPW][4], zi[NPW][4], gr[NPW][4], gi[NPW][4];  // gr, gi: ablate "assemble"
#pragma unroll
  for (int j = 0; j < NPW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) zr[j][e] = zi[j][e] = gr[j][e] = gi[j][e] = 0.f;
  __syncthreads();

  for (int it = 0; it < prm.num_iters; ++it) {
    // phi of the own rows, of all rows in the CTA that holds row n
    for (int l = tid; l < n; l += L::NT) {
      if (!own_n && (l < row0 || l >= row0 + BAND)) continue;
      float pr, pi;
      if constexpr (fold) {
        const float ar = rho1 ? s_nr[l] : rho * s_nr[l];
        const float ai = rho1 ? s_ni[l] : rho * s_ni[l];
        pr = s_w[l] * (s_yr[l] + ar);
        pi = s_w[l] * (s_yi[l] - ai);
      } else {
        // corner column by the Hermitian row read: g = conj(G[n, :]);
        // ablate "corner": the previous phi stands in for both rows
        const bool ab = ABLATE == AB_CORNER;
        const float g_r = ab ? s_phr[l] : s_nr[l], g_i = ab ? s_phi[l] : -s_ni[l];
        const float z_r = ab ? s_phr[l] : s_znr[l], z_i = ab ? s_phi[l] : -s_zni[l];
        pr = s_w[l] * ((s_yr[l] + (rho1 ? g_r : rho * g_r)) + z_r);
        pi = s_w[l] * ((s_yi[l] + (rho1 ? g_i : rho * g_i)) + z_i);
      }
      s_phr[l] = pr;
      s_phi[l] = pi;
    }
    __syncthreads();

    // publish t and diag(Z)/rho of the own rows; assemble M but for its
    // h-dependent diagonal, and publish the rest of ||M||_F^2
    if (tid < BAND) {
      const int l = row0 + tid;
      float t = 0.f, zd = 0.f;
      if (l < n) {
        zd = zscale(s_zd[tid]);
        if constexpr (fold)
          t = s_cd[tid];
        else if constexpr (ABLATE == AB_DIAG)
          t = s_phr[l];
        else
          t = s_cd[tid] + zd;
      }
      pub_t[tid] = t;
      pub_zd[tid] = zd;
    }
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < NPW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lr = row_of(e), c = col_of(j, e), r = row0 + lr, idx = lr * SA + c;
        const bool hdiag = r == c && r < n && ABLATE != AB_ASSEMBLE;
        float br, bi;
        lifted_b(r, c, br, bi);  // the h-dependent diagonal is set after the projection
        float mr = br - zscale(zr[j][e]);
        float mi = bi - zscale(zi[j][e]);
        if constexpr (ABLATE == AB_ASSEMBLE) {
          mr = 0.5f * gr[j][e] - zscale(zr[j][e]);
          mi = 0.5f * gi[j][e] - zscale(zi[j][e]);
        }
        if (!hdiag) {
          Mr[idx] = mr;
          part += mr * mr;
        }
        Mi[idx] = mi;
        part += mi * mi;
      }
    part = warp_sum(part);
    if (lane == 0) misc[4 + warp] = part;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < L::NC; ++w) s += misc[4 + w];
      misc[0] = s;
    }
    cluster.sync();  // gather: every CTA's t, diag(Z)/rho and partial sum

    // the H-projection of the whole t, redundantly in warp 0 of every CTA,
    // then ||M||_F from the partial sums and the h-dependent diagonal
    if (warp == 0) {
      float t[4], h[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int l = lane + 32 * q;
        t[q] = l < n ? *cluster.map_shared_rank(pub_t + l % BAND, l / BAND) : 0.f;
      }
      float lo = misc[2], hi = misc[3];
      if constexpr (ABLATE == AB_H) {
#pragma unroll
        for (int q = 0; q < 4; ++q) h[q] = t[q];
      } else {
        NewtonProjection::project(t, n, A, prm.outer_iters, prm.inner_iters,
                                  prm.warm_root != 0, lo, hi, h);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) s_h[lane + 32 * q] = h[q];
      float inv = 1.f / 64.f;  // ablate "norm": the fixed scaling
      if constexpr (ABLATE != AB_NORM) {
        float d = 0.f;
        if constexpr (ABLATE != AB_ASSEMBLE) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int l = lane + 32 * q;
            if (l < n) {
              const float mr = h[q] - *cluster.map_shared_rank(pub_zd + l % BAND, l / BAND);
              d += mr * mr;
            }
          }
        }
        d = warp_sum(d);
        float rest = 0.f;
        for (int c = 0; c < L::NC; ++c) rest += *cluster.map_shared_rank(misc, c);
        inv = 1.f / fmaxf(sqrtf(rest + d), 1e-30f);
      }
      if (lane == 0) {
        misc[1] = inv;
        misc[2] = lo;
        misc[3] = hi;
      }
    }
    __syncthreads();

    // M's diagonal, then X = M / ||M||_F
    const float inv = misc[1];
#pragma unroll
    for (int j = 0; j < NPW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lr = row_of(e), c = col_of(j, e), r = row0 + lr, idx = lr * SA + c;
        if (r == c && r < n && ABLATE != AB_ASSEMBLE) Mr[idx] = s_h[c] - zscale(zr[j][e]);
        Xr[idx] = Mr[idx] * inv;
        Xi[idx] = Mi[idx] * inv;
      }
    cluster.sync();  // X and M visible

    for (int s = 0; s < sched.n; ++s) {
      const bool hi = prm.all_hi || s >= sched.n - prm.hi_steps;
      const bool split = THREE_PASS && hi;
      const bool one = !THREE_PASS && !hi;
      const bool four = split || one;  // the squares' 4-multiplication form
      const bool reproject = !hi || THREE_PASS;
      const float a = sched.a[s], b = sched.b[s], c = sched.c[s];
      CAcc acc[1][NPW];
      // X^2 (split, one-pass: the 4-multiplication form, herm_square's terms)
      product(split, one, !four, Xr, Xi, Xr, Xi, acc);
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = row_of(e) * SA + col_of(j, e);
          Ur[idx] = tcp::acc_re(acc[0][j], e);
          Ui[idx] = im_of(four, acc[0][j], e);
        }
      cluster.sync();  // X^2 visible
      // X^4, then Y = a I + b X^2 + c X^4
      product(split, one, !four, Ur, Ui, Ur, Ui, acc);
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lr = row_of(e), cc = col_of(j, e), idx = lr * SA + cc;
          const float eye = row0 + lr == cc ? a : 0.f;
          Yr[idx] = (eye + b * Ur[idx]) + c * tcp::acc_re(acc[0][j], e);
          Yi[idx] = b * Ui[idx] + c * im_of(four, acc[0][j], e);
        }
      cluster.sync();  // Y visible; every read of X^2 done
      // X Y (Karatsuba)
      product(split, one, true, Yr, Yi, Xr, Xi, acc);
      if (reproject) {
#pragma unroll
        for (int j = 0; j < NPW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = row_of(e) * SA + col_of(j, e);
            Ur[idx] = tcp::acc_re(acc[0][j], e);
            Ui[idx] = tcp::acc_im(acc[0][j], e);
          }
        cluster.sync();  // X Y visible
#pragma unroll
        for (int j = 0; j < NPW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int lr = row_of(e), cc = col_of(j, e), idx = lr * SA + cc;
            const int r = row0 + lr;
            Xr[idx] = 0.5f * (Ur[idx] + transposed(Ur, r, cc));
            Xi[idx] = 0.5f * (Ui[idx] - transposed(Ui, r, cc));
          }
      } else {
        __syncthreads();  // this CTA's reads of X as the left operand are done
#pragma unroll
        for (int j = 0; j < NPW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = row_of(e) * SA + col_of(j, e);
            Xr[idx] = tcp::acc_re(acc[0][j], e);
            Xi[idx] = tcp::acc_im(acc[0][j], e);
          }
      }
      cluster.sync();  // the new X visible; every read of the exchange done
    }

    // A = herm(X M) (ablate "finals": G' is the sign iterate), then G',
    // Z' and the carried rows
    float ar[NPW][4], ai[NPW][4];
    if constexpr (ABLATE != AB_FINALS) {
      CAcc acc[1][NPW];
      product(THREE_PASS && prm.final_hi != 0, !THREE_PASS && prm.final_hi == 0, true, Mr, Mi,
              Xr, Xi, acc);
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = row_of(e) * SA + col_of(j, e);
          Ur[idx] = tcp::acc_re(acc[0][j], e);
          Ui[idx] = tcp::acc_im(acc[0][j], e);
        }
      cluster.sync();  // X M visible
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lr = row_of(e), cc = col_of(j, e), idx = lr * SA + cc;
          const int r = row0 + lr;
          ar[j][e] = 0.5f * (Ur[idx] + transposed(Ur, r, cc));
          ai[j][e] = 0.5f * (Ui[idx] - transposed(Ui, r, cc));
        }
    }
#pragma unroll
    for (int j = 0; j < NPW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lr = row_of(e), c = col_of(j, e), r = row0 + lr, idx = lr * SA + c;
        const float mr = Mr[idx], mi = Mi[idx];
        float pr, pi;
        if constexpr (ABLATE == AB_FINALS) {
          pr = Xr[idx];
          pi = Xi[idx];
        } else {
          pr = 0.5f * (mr + ar[j][e]);
          pi = 0.5f * (mi + ai[j][e]);
        }
        if constexpr (lists) {
          float br, bi;
          lifted_b(r, c, br, bi);
          zr[j][e] = zr[j][e] + rho * (pr - br);
          zi[j][e] = zi[j][e] + rho * (pi - bi);
        } else if constexpr (ABLATE == AB_ZUPD) {
          zr[j][e] = pr;
          zi[j][e] = pi;
        } else {
          zr[j][e] = rho1 ? pr - mr : rho * (pr - mr);
          zi[j][e] = rho1 ? pi - mi : rho * (pi - mi);
        }
        if constexpr (ABLATE == AB_ASSEMBLE) {
          gr[j][e] = pr;
          gi[j][e] = pi;
        }
        // the next iteration reads A (fold_diag) or G': its diagonal and
        // row n (from row n where this CTA holds it, else from column n)
        float cr = pr, ci = pi;
        if constexpr (fold) {
          cr = ar[j][e];
          ci = ai[j][e];
        }
        if (r == c) {
          s_cd[lr] = cr;
          s_zd[lr] = zr[j][e];
        }
        if (own_n && r == n) {
          s_nr[c] = cr;
          s_ni[c] = ci;
          s_znr[c] = zr[j][e];
          s_zni[c] = zi[j][e];
        } else if (!own_n && c == n) {
          s_nr[r] = cr;
          s_ni[r] = -ci;
          s_znr[r] = zr[j][e];
          s_zni[r] = -zi[j][e];
        }
      }
    __syncthreads();
  }

  // phi of the last iteration (from the pre-update state), own rows; an
  // ablation's debug output reads the final G' row n: the chain stays live
  for (int l = row0 + tid; l < row0 + BAND && l < n; l += L::NT) {
    io.phi_r[rowbase + l] = ABLATE == AB_NONE ? s_phr[l] : s_phr[l] + 0.f * s_nr[l];
    io.phi_i[rowbase + l] = s_phi[l];
  }
  cluster.sync();  // no CTA leaves while another still reads its planes
}

// Launch of the solve with plane side P: io.B clusters of P / 16 CTAs.
// Returns the launch's cudaError_t.
template <int P, int LAYOUT, int ABLATE, bool THREE_PASS>
int launch_fused_tc(const SolveRows& io, const SolveParams& prm, const Schedule& sched,
                    void* stream) {
  using L = tcp::Layout<P>;
  const int bytes = tc_smem_floats<P>() * static_cast<int>(sizeof(float));
  auto kernel = fused_tc_kernel<P, LAYOUT, ABLATE, THREE_PASS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(io.B * L::NC);
  cfg.blockDim = dim3(L::NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L::NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, io, prm, sched);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The production and escape-hatch instantiations at side P (layout:
// FOLDED, LEAN or LISTS; three_pass only on the lean layouts).
template <int P>
int launch_fused_tc_layout(int layout, bool three_pass, const SolveRows& io,
                           const SolveParams& prm, const Schedule& sched, void* stream) {
  switch (layout) {
    case FOLDED:
      return three_pass ? launch_fused_tc<P, FOLDED, AB_NONE, true>(io, prm, sched, stream)
                        : launch_fused_tc<P, FOLDED, AB_NONE, false>(io, prm, sched, stream);
    case LEAN:
      return three_pass ? launch_fused_tc<P, LEAN, AB_NONE, true>(io, prm, sched, stream)
                        : launch_fused_tc<P, LEAN, AB_NONE, false>(io, prm, sched, stream);
    case LISTS:
      if (three_pass) break;
      return launch_fused_tc<P, LISTS, AB_NONE, false>(io, prm, sched, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2's profiling variants of the unfolded lean layout, ablate in
// AB_CORNER .. AB_FINALS (without three_pass).
template <int P>
int launch_fused_tc_ablate(int ablate, const SolveRows& io, const SolveParams& prm,
                           const Schedule& sched, void* stream) {
  switch (ablate) {
    case AB_CORNER:
      return launch_fused_tc<P, LEAN, AB_CORNER, false>(io, prm, sched, stream);
    case AB_DIAG:
      return launch_fused_tc<P, LEAN, AB_DIAG, false>(io, prm, sched, stream);
    case AB_H:
      return launch_fused_tc<P, LEAN, AB_H, false>(io, prm, sched, stream);
    case AB_NORM:
      return launch_fused_tc<P, LEAN, AB_NORM, false>(io, prm, sched, stream);
    case AB_ASSEMBLE:
      return launch_fused_tc<P, LEAN, AB_ASSEMBLE, false>(io, prm, sched, stream);
    case AB_ZUPD:
      return launch_fused_tc<P, LEAN, AB_ZUPD, false>(io, prm, sched, stream);
    case AB_FINALS:
      return launch_fused_tc<P, LEAN, AB_FINALS, false>(io, prm, sched, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Defined in fused_admm_fast_p128.cu, fused_admm_fast_ablate.cu and
// fused_admm_fast_ablate_p128.cu, so that they compile in parallel.
int fused_tc_p128(int layout, bool three_pass, const SolveRows& io, const SolveParams& prm,
                  const Schedule& sched, void* stream);
int fused_tc_ablate(int ablate, const SolveRows& io, const SolveParams& prm,
                    const Schedule& sched, void* stream);
int fused_tc_ablate_p128(int ablate, const SolveRows& io, const SolveParams& prm,
                         const Schedule& sched, void* stream);

}  // namespace admmk
