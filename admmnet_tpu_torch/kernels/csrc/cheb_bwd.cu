// Reversible, checkpoint-free backward of the batched Clenshaw evaluation
// of cheb_filter.cu: for the output G = herm(c_0 I + A b_1 - b_2) and its
// cotangent Y, the cotangents of the normalized matrix A (Abar) and of the
// coefficients (cbar).  The chain through A = M / ||M||_F is torch work
// outside the kernel.
//
// Replaces admmnet_tpu/kernels/cheb_filter.py :: _cheb_bwd (kernel body
// _cheb_bwd_kernel), the backward of the chebyshev GLayer's custom VJP.
//
// The three-term recurrence is reversible: from the forward's final carries
// (b_1, b_2) the kernel rebuilds b_{j+2} = herm(c_j I + 2 A b_{j+1} - b_j)
// walking j upward, while it runs the cotangent chain in lockstep.  In
// torch's complex convention (the conjugate of JAX's raw cotangent) and for
// Hermitian A and b_j, per matrix:
//
//   V = herm(Y)                        (adjoint of the closing re-projection)
//   cbar_0 = Re tr V;  Abar = V b_1;  u = A V;  v = -V
//   for j = 1 .. degree-2:             (s, t) = (b_j, b_{j+1})
//     cbar_j = Re tr u
//     Abar  += 2 u t
//     (u, v) <- (v + 2 A u, -u)
//     (s, t) <- (t, herm(c_j I + 2 A t - s))      (skipped at j = degree-2)
//   cbar_{degree-1} = Re tr u          (its Abar term, 2 u b_degree, is 0)
//
// A and every b_j are Hermitian, so no product needs a transposed operand:
// A u and u t are plain complex products.  u and t do not commute, so each
// product is common.cuh's general Karatsuba product (3 real products, exact
// for any complex matrices).  Products are IEEE fp32 (SIMT FMA), or with
// SPLIT the literal 3-pass split-bf16 product of the TPU kernel's default.
//
// Bound on this card: arithmetic.  3 degree - 5 complex products of side m
// per matrix (degree 48, m = 101: 8.6e8 FLOP of useful work) against one
// read of M, Y, the four carry planes and one write of Abar (0.4 MB).  Work
// planes: A, u, v, s, t as real/imaginary pairs and the Karatsuba temporary
// (11 planes, 552 KB per block at P = 112) sit in a per-block global scratch
// that L2 serves while the block runs; Abar accumulates in its output
// planes; every product streams through common.cuh's shared-memory tiles
// into 7 x 7 register micro-tiles.  One thread block per matrix.  132
// resident blocks need 73 MB of work planes, more than the 50 MB L2.
//
// Padding: Y, M and the carries are zero past the logical side m and c_j is
// added on the logical diagonal only, so every padded row and column of
// every plane stays exactly zero.
#include "common.cuh"

namespace admmk {

constexpr int BWD_PLANES = 11;  // Ar, Ai, ur, ui, vr, vi, sr, si, tr, ti, T

// Re tr X over the logical diagonal; every thread gets the result.
template <int P>
__device__ __forceinline__ float real_trace(Tiles<P>& sm, const float* Xr, int m) {
  float s = 0.f;
  for (int i = threadIdx.x; i < m; i += NT) s += Xr[i * P + i];
  return block_sum<P>(sm, s);
}

template <int P, bool SPLIT>
__global__ void __launch_bounds__(NT) cheb_bwd_kernel(
    const float* __restrict__ Mr_all, const float* __restrict__ Mi_all,
    const float* __restrict__ coeffs, const float* __restrict__ Yr_all,
    const float* __restrict__ Yi_all, const float* __restrict__ b1r_all,
    const float* __restrict__ b1i_all, const float* __restrict__ b2r_all,
    const float* __restrict__ b2i_all, float* ABr_all, float* ABi_all, float* cbar_all,
    float* scratch, int m, int degree) {
  constexpr int MT = P / TS;
  constexpr int PP = P * P;
  __shared__ Tiles<P> sm;
  const size_t off = static_cast<size_t>(blockIdx.x) * PP;
  const float* Mr = Mr_all + off;
  const float* Mi = Mi_all + off;
  const float* Yr = Yr_all + off;
  const float* Yi = Yi_all + off;
  float* ABr = ABr_all + off;
  float* ABi = ABi_all + off;
  const float* c = coeffs + static_cast<size_t>(blockIdx.x) * degree;
  float* cb = cbar_all + static_cast<size_t>(blockIdx.x) * degree;
  float* base = scratch + static_cast<size_t>(blockIdx.x) * BWD_PLANES * PP;
  float* Ar = base;
  float* Ai = base + 1 * PP;
  float* ur = base + 2 * PP;
  float* ui = base + 3 * PP;
  float* vr = base + 4 * PP;
  float* vi = base + 5 * PP;
  float* sr = base + 6 * PP;
  float* si = base + 7 * PP;
  float* tr = base + 8 * PP;
  float* ti = base + 9 * PP;
  float* T = base + 10 * PP;
  const int ty = threadIdx.x / TS, tx = threadIdx.x % TS;

  // A = M / max(||M||_F, 1e-20), computed exactly as the forward computes
  // it; V = herm(Y) in (vr, vi); (s, t) = (b_1, b_2)
  float ss = 0.f;
  for (int e = threadIdx.x; e < PP; e += NT) ss += Mr[e] * Mr[e] + Mi[e] * Mi[e];
  const float rinv = 1.f / fmaxf(sqrtf(block_sum<P>(sm, ss)), 1e-20f);
  for (int e = threadIdx.x; e < PP; e += NT) {
    const int et = (e % P) * P + e / P;
    Ar[e] = Mr[e] * rinv;
    Ai[e] = Mi[e] * rinv;
    vr[e] = 0.5f * (Yr[e] + Yr[et]);
    vi[e] = 0.5f * (Yi[e] - Yi[et]);
    sr[e] = b1r_all[off + e];
    si[e] = b1i_all[off + e];
    tr[e] = b2r_all[off + e];
    ti[e] = b2i_all[off + e];
  }
  __syncthreads();
  const float tr0 = real_trace<P>(sm, vr, m);
  if (threadIdx.x == 0) cb[0] = tr0;

  float cr[MT][MT], ci[MT][MT];
  // Abar = V b_1
  karatsuba<P, SPLIT>(sm, vr, vi, sr, si, T, cr, ci);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jj = 0; jj < MT; ++jj) {
      const int idx = (ty + TS * i) * P + tx + TS * jj;
      ABr[idx] = cr[i][jj];
      ABi[idx] = ci[i][jj];
    }
  // u = A V, v = -V (V's last reader was the product above, which ends with
  // a barrier)
  karatsuba<P, SPLIT>(sm, Ar, Ai, vr, vi, T, cr, ci);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jj = 0; jj < MT; ++jj) {
      const int idx = (ty + TS * i) * P + tx + TS * jj;
      ur[idx] = cr[i][jj];
      ui[idx] = ci[i][jj];
      vr[idx] = -vr[idx];
      vi[idx] = -vi[idx];
    }
  __syncthreads();

  for (int j = 1; j <= degree - 2; ++j) {
    const float trj = real_trace<P>(sm, ur, m);
    if (threadIdx.x == 0) cb[j] = trj;
    // Abar += 2 u b_{j+1}; each thread updates only its own entries
    karatsuba<P, SPLIT>(sm, ur, ui, tr, ti, T, cr, ci);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jj = 0; jj < MT; ++jj) {
        const int idx = (ty + TS * i) * P + tx + TS * jj;
        ABr[idx] += 2.f * cr[i][jj];
        ABi[idx] += 2.f * ci[i][jj];
      }
    // (u, v) <- (v + 2 A u, -u)
    karatsuba<P, SPLIT>(sm, Ar, Ai, ur, ui, T, cr, ci);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jj = 0; jj < MT; ++jj) {
        const int idx = (ty + TS * i) * P + tx + TS * jj;
        const float u0r = ur[idx], u0i = ui[idx];
        ur[idx] = vr[idx] + 2.f * cr[i][jj];
        ui[idx] = vi[idx] + 2.f * ci[i][jj];
        vr[idx] = -u0r;
        vi[idx] = -u0i;
      }
    __syncthreads();
    if (j == degree - 2) break;  // b_degree feeds nothing
    // (s, t) <- (t, herm(c_j I + 2 A t - s)); each thread reads only the s
    // entries it then overwrites, so s serves as hermitian_part's exchange
    // plane, and the new t lands in the old s planes
    karatsuba<P, SPLIT>(sm, Ar, Ai, tr, ti, T, cr, ci);
    const float cj = c[j];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jj = 0; jj < MT; ++jj) {
        const int r = ty + TS * i, cc = tx + TS * jj;
        const int idx = r * P + cc;
        const float d = (r == cc && r < m) ? cj : 0.f;
        cr[i][jj] = (d + 2.f * cr[i][jj]) - sr[idx];
        ci[i][jj] = 2.f * ci[i][jj] - si[idx];
      }
    hermitian_part<P>(sr, si, cr, ci);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jj = 0; jj < MT; ++jj) {
        const int idx = (ty + TS * i) * P + tx + TS * jj;
        sr[idx] = cr[i][jj];
        si[idx] = ci[i][jj];
      }
    __syncthreads();
    float* x = sr;
    sr = tr;
    tr = x;
    x = si;
    si = ti;
    ti = x;
  }
  if (degree >= 2) {
    const float trl = real_trace<P>(sm, ur, m);
    if (threadIdx.x == 0) cb[degree - 1] = trl;
  }
}

}  // namespace admmk

// C entry point.  Mr, Mi, Yr, Yi: (B, P, P) float planes of M and of the
// output's cotangent Y, zero-padded past the logical side m; coeffs:
// (B, degree) floats; b1r, b1i, b2r, b2i: the forward's final carries as
// cheb_filter_launch writes them; ABr, ABi: (B, P, P) planes of Abar,
// written; cbar: (B, degree) floats, written; scratch: B * 11 * P * P
// floats.  three_pass selects the split-bf16 products.  Returns the
// launch's cudaError_t.
extern "C" int cheb_bwd_launch(const float* Mr, const float* Mi, const float* coeffs,
                               const float* Yr, const float* Yi, const float* b1r,
                               const float* b1i, const float* b2r, const float* b2i,
                               float* ABr, float* ABi, float* cbar, float* scratch, int B, int P,
                               int m, int degree, int three_pass, void* stream) {
  using namespace admmk;
  if (B <= 0 || degree < 1 || m < 1 || m > P) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ADMMK_CHEB_BWD(PS, SPL)                                                               \
  cheb_bwd_kernel<PS, SPL><<<B, NT, 0, st>>>(Mr, Mi, coeffs, Yr, Yi, b1r, b1i, b2r, b2i, ABr, \
                                             ABi, cbar, scratch, m, degree)
  if (P == 112 && !three_pass)
    ADMMK_CHEB_BWD(112, false);
  else if (P == 112)
    ADMMK_CHEB_BWD(112, true);
  else if (P == 128 && !three_pass)
    ADMMK_CHEB_BWD(128, false);
  else if (P == 128)
    ADMMK_CHEB_BWD(128, true);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef ADMMK_CHEB_BWD
  return static_cast<int>(cudaGetLastError());
}
