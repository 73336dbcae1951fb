// Batched Clenshaw evaluation of a Chebyshev matrix polynomial
//   G = sum_k c_k T_k(A),  A = M / max(||M||_F, 1e-20),
// of Hermitian matrices M with per-matrix coefficients (c_0 pre-halved):
// the learned spectral filter of the chebyshev GLayer.
//
// Replaces admmnet_tpu/kernels/cheb_filter.py :: cheb_filter_matrices
// (kernel body _cheb_kernel), the GLayer's cheb_impl="pallas" engine, and,
// with the carry planes given, :: _cheb_fwd_with_residuals (the same body
// with res_refs), the forward of its custom VJP.
//
// Recurrence, per matrix (b_1 = b_2 = 0):
//   b_0 = herm(c_j I + 2 A b_1 - b_2),  j = degree-1 .. 1;  (b_1, b_2) <- (b_0, b_1)
//   G   = herm(c_0 I + A b_1 - b_2)
// herm(X) = (X + X^H) / 2.  Every b_j is a polynomial in A, so A and b_1
// commute and their product is Hermitian in exact arithmetic: the complex
// product is common.cuh's Karatsuba product of commuting Hermitians (3 real
// products), and the re-projection removes only the rounding's
// non-Hermitian part before the 2 A b_1 doubling compounds it.  Products
// are IEEE fp32 (SIMT FMA); the TPU kernel's one-pass bf16 products have
// no counterpart here, nor has its final_hi option.
//
// Bound on this card: arithmetic.  degree x 3 real products of side P per
// matrix (degree 48, m = 101 logical: 2.97e8 FLOP of useful work, 4.05e8
// at P = 112) against one read of M and one write of G (163 KB): at the
// fp32 SIMT peak of 67 TFLOP/s the products take ~90x longer than the
// bytes at 3.35 TB/s.  The TPU kernel kept A, b_1, b_2 in VMEM; an SM has
// 227 KB of shared memory, so this design keeps the seven working planes
// (A, b_1, b_2 as real/imaginary pairs and the Karatsuba temporary) in a
// per-block global scratch that stays in L2 while the block runs, streams
// each product's operands through 16-deep shared-memory tiles into 7 x 7
// per-thread register micro-tiles (common.cuh), and rotates b_1 / b_2 by
// pointer instead of copying.  One thread block per matrix.
//
// Padding: the planes are zero-padded from m to P.  c_j is added on the
// logical diagonal only (row < m), so every padded row and column stays
// exactly zero through the whole recurrence (a zero row of A or column of
// b_1 gives a zero row or column of the product).
#include "common.cuh"

namespace admmk {

constexpr int CHEB_PLANES = 7;  // Ar, Ai, b1r, b1i, b2r, b2i, T

template <int P>
__global__ void __launch_bounds__(NT) cheb_filter_kernel(const float* __restrict__ Mr_all,
                                                          const float* __restrict__ Mi_all,
                                                          const float* __restrict__ coeffs,
                                                          float* Gr_all, float* Gi_all,
                                                          float* C1r_all, float* C1i_all,
                                                          float* C2r_all, float* C2i_all,
                                                          float* scratch, int m, int degree) {
  constexpr int MT = P / TS;
  __shared__ Tiles<P> sm;
  const size_t off = static_cast<size_t>(blockIdx.x) * P * P;
  const float* Mr = Mr_all + off;
  const float* Mi = Mi_all + off;
  float* Gr = Gr_all + off;
  float* Gi = Gi_all + off;
  const float* c = coeffs + static_cast<size_t>(blockIdx.x) * degree;
  float* base = scratch + static_cast<size_t>(blockIdx.x) * CHEB_PLANES * P * P;
  float* Ar = base;
  float* Ai = base + 1 * P * P;
  float* b1r = base + 2 * P * P;
  float* b1i = base + 3 * P * P;
  float* b2r = base + 4 * P * P;
  float* b2i = base + 5 * P * P;
  float* T = base + 6 * P * P;
  const int ty = threadIdx.x / TS, tx = threadIdx.x % TS;

  // A = M / max(||M||_F, 1e-20); b_1 = b_2 = 0
  float s = 0.f;
  for (int e = threadIdx.x; e < P * P; e += NT) s += Mr[e] * Mr[e] + Mi[e] * Mi[e];
  const float rinv = 1.f / fmaxf(sqrtf(block_sum<P>(sm, s)), 1e-20f);
  for (int e = threadIdx.x; e < P * P; e += NT) {
    Ar[e] = Mr[e] * rinv;
    Ai[e] = Mi[e] * rinv;
    b1r[e] = 0.f;
    b1i[e] = 0.f;
    b2r[e] = 0.f;
    b2i[e] = 0.f;
  }
  __syncthreads();

  float cr[MT][MT], ci[MT][MT];
  for (int j = degree - 1; j >= 1; --j) {
    const float cj = c[j];
    karatsuba<P, false>(sm, Ar, Ai, b1r, b1i, T, cr, ci);  // A b_1
    // b_0 = c_j I + 2 A b_1 - b_2; each thread reads only the b_2 entries
    // it then overwrites, so b_2 can serve as hermitian_part's exchange plane
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jj = 0; jj < MT; ++jj) {
        const int r = ty + TS * i, cc = tx + TS * jj;
        const int idx = r * P + cc;
        const float d = (r == cc && r < m) ? cj : 0.f;
        cr[i][jj] = (d + 2.f * cr[i][jj]) - b2r[idx];
        ci[i][jj] = 2.f * ci[i][jj] - b2i[idx];
      }
    hermitian_part<P>(b2r, b2i, cr, ci);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jj = 0; jj < MT; ++jj) {
        const int idx = (ty + TS * i) * P + tx + TS * jj;
        b2r[idx] = cr[i][jj];
        b2i[idx] = ci[i][jj];
      }
    __syncthreads();
    // (b_1, b_2) <- (b_0, b_1): b_0 now sits in the old b_2 planes
    float* t = b1r;
    b1r = b2r;
    b2r = t;
    t = b1i;
    b1i = b2i;
    b2i = t;
  }

  // G = herm(c_0 I + A b_1 - b_2)
  karatsuba<P, false>(sm, Ar, Ai, b1r, b1i, T, cr, ci);
  const float c0 = c[0];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jj = 0; jj < MT; ++jj) {
      const int r = ty + TS * i, cc = tx + TS * jj;
      const int idx = r * P + cc;
      const float d = (r == cc && r < m) ? c0 : 0.f;
      cr[i][jj] = (d + cr[i][jj]) - b2r[idx];
      ci[i][jj] = ci[i][jj] - b2i[idx];
    }
  hermitian_part<P>(Gr, Gi, cr, ci);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jj = 0; jj < MT; ++jj) {
      const int idx = (ty + TS * i) * P + tx + TS * jj;
      Gr[idx] = cr[i][jj];
      Gi[idx] = ci[i][jj];
    }
  // training forward (K5): the final carries (b_1, b_2), the only residuals
  // the reversible backward (cheb_bwd.cu) needs.  The last loop step ended
  // with a barrier and nothing since wrote b_1 or b_2.
  if (C1r_all != nullptr) {
    for (int e = threadIdx.x; e < P * P; e += NT) {
      C1r_all[off + e] = b1r[e];
      C1i_all[off + e] = b1i[e];
      C2r_all[off + e] = b2r[e];
      C2i_all[off + e] = b2i[e];
    }
  }
}

}  // namespace admmk

// C entry point.  Mr, Mi: (B, P, P) float planes, zero-padded past the
// logical side m; coeffs: (B, degree) floats on the device; Gr, Gi: (B, P, P),
// written; scratch: B * 7 * P * P floats.  b1r, b1i, b2r, b2i: all null (the
// inference forward) or all (B, P, P) planes that receive the final Clenshaw
// carries (the training forward); the output G is the same either way, bit
// for bit, since both run the same instantiation.  Returns the launch's
// cudaError_t.
extern "C" int cheb_filter_launch(const float* Mr, const float* Mi, const float* coeffs,
                                  float* Gr, float* Gi, float* b1r, float* b1i, float* b2r,
                                  float* b2i, float* scratch, int B, int P, int m, int degree,
                                  void* stream) {
  using namespace admmk;
  if (B <= 0 || degree < 1 || m < 1 || m > P) return static_cast<int>(cudaErrorInvalidValue);
  const bool carries = b1r != nullptr;
  if ((b1i != nullptr) != carries || (b2r != nullptr) != carries || (b2i != nullptr) != carries)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P == 112)
    cheb_filter_kernel<112><<<B, NT, 0, st>>>(Mr, Mi, coeffs, Gr, Gi, b1r, b1i, b2r, b2i,
                                              scratch, m, degree);
  else if (P == 128)
    cheb_filter_kernel<128><<<B, NT, 0, st>>>(Mr, Mi, coeffs, Gr, Gi, b1r, b1i, b2r, b2i,
                                              scratch, m, degree);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
