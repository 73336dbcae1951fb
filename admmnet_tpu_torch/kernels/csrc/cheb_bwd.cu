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
//     (s, t) <- (t, herm(c_j I + 2 A t - s))
//   cbar_{degree-1} = Re tr u;  Abar += 2 u b_degree   (degree >= 3)
//
// b_degree is zero in exact arithmetic; rebuilt from the carries of a
// one-pass forward it is not, and the TPU kernel adds its term, so this
// kernel does too (degree 2 rebuilds nothing: its b_degree is the zero
// carry b_2).
// The kernel runs the first line as step 0 of the loop, with u = V, t = b_1,
// v = 0 and the factor 1 in place of 2, then sets (s, t) = (b_1, b_2).
// A and every b_j are Hermitian, so no product needs a transposed operand;
// u and t do not commute, so each product is the general Karatsuba form.
//
// Bound on this card: arithmetic.  3 degree - 3 complex products of side m
// per matrix (degree 48, m = 101: 8.8e8 FLOP of useful work) against one
// read of M, Y, the four carry planes and one write of Abar (0.4 MB).
//
// Precision, the TPU kernel's two tiers: three_pass (the JAX package's
// default) multiplies with its _mm3, the 3-pass split-bf16 product whose
// three products are one-pass DEFAULT products on the MXU; here
// tc_product.cuh's Prec::SPLIT_BF16, three bf16 mma.sync m16n8k16 per real
// product and 16-deep step (x = xh + xl, xh = bf16_rn(x), xl =
// bf16_rn(x - xh); xh yl + xl yh + xh yh).  Without three_pass the TPU
// kernel multiplies at HIGHEST; here in 3xTF32 (Prec::TF32X3).  Either way
// the kernel rebuilds the forward's states from the carries in its own
// tier, whatever tier the forward ran, as the TPU kernel does.
//
// Design (tc_product.cuh): one thread-block cluster of P / 16 CTAs per
// matrix; CTA q owns rows [16 q, 16 q + 16) of every working plane in its
// shared memory: A, u, t and s as real/imaginary band planes (s doubles as
// the exchange plane of herm), with v and Abar in registers in the mma
// accumulator layout.  Each step is two passes over K on the tensor cores
// (at the tier above): u t and A t share the staged bands of t, A u reads the bands of
// u; every CTA reads every band of t and u from its owner through
// distributed shared memory.  herm's transpose and the trace's sum read
// across the cluster between two cluster barriers per step.  Nothing but the
// inputs and outputs touches device memory.  The two tiers are two
// instantiations (PREC).
//
// Padding: Y, M and the carries are zero past the logical side m and c_j is
// added on the logical diagonal only, so every padded row and column of
// every plane stays exactly zero (a zero splits into zero halves).
#include "common.cuh"
#include "tc_product.cuh"

namespace admmk {

namespace cg = cooperative_groups;
using tcp::BAND;
using tcp::CAcc;
using tcp::NPW;

template <int P>
constexpr int bwd_smem_floats() {
  // 8 band planes (Ar, Ai, ur, ui, tr, ti, sr, si), the staging double
  // buffer, the block reduction's partials and two cluster-visible slots
  return 8 * tcp::Layout<P>::PLANE + 4 * tcp::Layout<P>::SLICE + 16;
}

// At P = 112 two CTAs share an SM (128 registers a thread, with some
// spills); at P = 128 the shared memory holds one.
template <int P, tcp::Prec PREC>
__global__ void __launch_bounds__(tcp::Layout<P>::NT, P == 112 ? 2 : 1) cheb_bwd_kernel(
    const float* __restrict__ Mr_all, const float* __restrict__ Mi_all,
    const float* __restrict__ coeffs, const float* __restrict__ Yr_all,
    const float* __restrict__ Yi_all, const float* __restrict__ b1r_all,
    const float* __restrict__ b1i_all, const float* __restrict__ b2r_all,
    const float* __restrict__ b2i_all, float* ABr_all, float* ABi_all, float* cbar_all, int m,
    int degree) {
  using L = tcp::Layout<P>;
  constexpr int SA = L::SA;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int mat = blockIdx.x / L::NC;
  const int row0 = rank * BAND;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;

  float* Ar = smem;
  float* Ai = Ar + L::PLANE;
  float* ur = Ai + L::PLANE;
  float* ui = ur + L::PLANE;
  float* tr = ui + L::PLANE;
  float* ti = tr + L::PLANE;
  float* sr = ti + L::PLANE;
  float* si = sr + L::PLANE;
  float* stage = si + L::PLANE;
  float* red = stage + 4 * L::SLICE;  // one partial per warp
  float* slot = red + 8;              // [0]: ||M||_F^2 partial, [1]: trace partial

  const size_t base = static_cast<size_t>(mat) * P * P;
  const float* c = coeffs + static_cast<size_t>(mat) * degree;
  float* cb = cbar_all + static_cast<size_t>(mat) * degree;

  // element e of this thread's n-tile j: band row, column
  auto row_of = [&](int e) { return g + 8 * (e >> 1); };
  auto col_of = [&](int j, int e) { return warp * 16 + 8 * j + 2 * q4 + (e & 1); };

  // ||M||_F over the cluster, summed in rank order (the same in every CTA)
  float ss = 0.f;
  for (int e = tid; e < BAND * P; e += L::NT) {
    const float a = Mr_all[base + row0 * P + e], b = Mi_all[base + row0 * P + e];
    ss += a * a + b * b;
  }
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < L::NC; ++w) s += red[w];
    slot[0] = s;
  }
  cluster.sync();
  float tot = 0.f;
  for (int q = 0; q < L::NC; ++q) tot += *cluster.map_shared_rank(slot, q);
  const float rinv = 1.f / fmaxf(sqrtf(tot), 1e-20f);

  // this CTA's bands of A = M / ||M||_F, u = V = herm(Y) and t = b_1
  for (int e = tid; e < BAND * P; e += L::NT) {
    const int r = e / P, cc = e % P, gr = row0 + r;
    const size_t ge = base + static_cast<size_t>(gr) * P + cc;
    const size_t gt = base + static_cast<size_t>(cc) * P + gr;
    const int li = r * SA + cc;
    Ar[li] = Mr_all[ge] * rinv;
    Ai[li] = Mi_all[ge] * rinv;
    ur[li] = 0.5f * (Yr_all[ge] + Yr_all[gt]);
    ui[li] = 0.5f * (Yi_all[ge] - Yi_all[gt]);
    tr[li] = b1r_all[ge];
    ti[li] = b1i_all[ge];
  }
  float abr[NPW][4], abi[NPW][4], vr[NPW][4], vi[NPW][4];
#pragma unroll
  for (int j = 0; j < NPW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) abr[j][e] = abi[j][e] = vr[j][e] = vi[j][e] = 0.f;

  // Re tr u over this band's logical diagonal into slot[1] (warp 0)
  auto band_trace = [&]() {
    if (warp == 0) {
      const int gr = row0 + lane;
      float d = (lane < BAND && gr < m) ? ur[lane * SA + gr] : 0.f;
      d = warp_sum(d);
      if (lane == 0) slot[1] = d;
    }
  };
  // the cluster's trace, summed in rank order, into cbar[j] (rank 0);
  // between two cluster barriers
  auto write_trace = [&](int j) {
    if (rank == 0 && tid == 0) {
      float s = 0.f;
      for (int q = 0; q < L::NC; ++q) s += *cluster.map_shared_rank(slot + 1, q);
      cb[j] = s;
    }
  };
  cluster.sync();

  const int last = degree >= 2 ? degree - 2 : 0;
  for (int j = 0; j <= last; ++j) {
    const bool rebuild = j >= 1;  // (s, t) <- (t, herm(...))
    const float alpha = j == 0 ? 1.f : 2.f;
    band_trace();
    // pass over t: P = u t (Abar += alpha P) and, when rebuilding,
    // X = c_j I + 2 A t - s, written over s (each thread reads only the
    // s entries it overwrites)
    if (rebuild) {
      CAcc acc[2][NPW];
      const float* const lr[2] = {ur, Ar};
      const float* const li[2] = {ui, Ai};
      tcp::band_product<P, 2, PREC>(cluster, tr, ti, lr, li, stage, m, acc);
      const float cj = c[j];
#pragma unroll
      for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          abr[jj][e] += alpha * tcp::acc_re(acc[0][jj], e);
          abi[jj][e] += alpha * tcp::acc_im(acc[0][jj], e);
          const int r = row_of(e), cc = col_of(jj, e), idx = r * SA + cc;
          const float d = (row0 + r == cc && cc < m) ? cj : 0.f;
          sr[idx] = (d + 2.f * tcp::acc_re(acc[1][jj], e)) - sr[idx];
          si[idx] = 2.f * tcp::acc_im(acc[1][jj], e) - si[idx];
        }
    } else {
      CAcc acc[1][NPW];
      const float* const lr[1] = {ur};
      const float* const li[1] = {ui};
      tcp::band_product<P, 1, PREC>(cluster, tr, ti, lr, li, stage, m, acc);
#pragma unroll
      for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          abr[jj][e] += alpha * tcp::acc_re(acc[0][jj], e);
          abi[jj][e] += alpha * tcp::acc_im(acc[0][jj], e);
        }
    }
    // pass over u: Q = A u
    CAcc qa[1][NPW];
    {
      const float* const lr[1] = {Ar};
      const float* const li[1] = {Ai};
      tcp::band_product<P, 1, PREC>(cluster, ur, ui, lr, li, stage, m, qa);
    }
    cluster.sync();  // every read of u and t is done; X and the traces are visible
    write_trace(j);
    // (u, v) <- (v + alpha A u, -u); the next s waits in registers while
    // the other CTAs read X from the s planes
    float nsr[NPW][4], nsi[NPW][4];
#pragma unroll
    for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row_of(e), cc = col_of(jj, e), idx = r * SA + cc;
        const float u0r = ur[idx], u0i = ui[idx];
        ur[idx] = vr[jj][e] + alpha * tcp::acc_re(qa[0][jj], e);
        ui[idx] = vi[jj][e] + alpha * tcp::acc_im(qa[0][jj], e);
        vr[jj][e] = -u0r;
        vi[jj][e] = -u0i;
        if (rebuild) {
          // t <- herm(X): X^T's entry lies in the band of row cc, at column
          // row0 + r
          const float* xr = cluster.map_shared_rank(sr, cc / BAND);
          const float* xi = cluster.map_shared_rank(si, cc / BAND);
          const int tidx = (cc % BAND) * SA + row0 + r;
          nsr[jj][e] = tr[idx];
          nsi[jj][e] = ti[idx];
          tr[idx] = 0.5f * (sr[idx] + xr[tidx]);
          ti[idx] = 0.5f * (si[idx] - xi[tidx]);
        } else if (j == 0) {  // (s, t) = (b_1, b_2)
          const size_t ge = base + static_cast<size_t>(row0 + r) * P + cc;
          nsr[jj][e] = b1r_all[ge];
          nsi[jj][e] = b1i_all[ge];
          tr[idx] = b2r_all[ge];
          ti[idx] = b2i_all[ge];
        }
      }
    cluster.sync();  // the new u and t are visible; X and the traces are read
    if (rebuild || j == 0) {
#pragma unroll
      for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = row_of(e) * SA + col_of(jj, e);
          sr[idx] = nsr[jj][e];
          si[idx] = nsi[jj][e];
        }
    }
  }
  if (degree >= 2) {
    band_trace();
    cluster.sync();
    write_trace(degree - 1);
  }
  if (degree >= 3) {  // Abar += 2 u b_degree
    CAcc acc[1][NPW];
    const float* const lr[1] = {ur};
    const float* const li[1] = {ui};
    tcp::band_product<P, 1, PREC>(cluster, tr, ti, lr, li, stage, m, acc);
#pragma unroll
    for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        abr[jj][e] += 2.f * tcp::acc_re(acc[0][jj], e);
        abi[jj][e] += 2.f * tcp::acc_im(acc[0][jj], e);
      }
  }
#pragma unroll
  for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const size_t ge = base + static_cast<size_t>(row0 + row_of(e)) * P + col_of(jj, e);
      ABr_all[ge] = abr[jj][e];
      ABi_all[ge] = abi[jj][e];
    }
  cluster.sync();  // no CTA leaves while another still reads its slots
}

template <int P, tcp::Prec PREC>
int launch_cheb_bwd(const float* Mr, const float* Mi, const float* coeffs, const float* Yr,
                    const float* Yi, const float* b1r, const float* b1i, const float* b2r,
                    const float* b2i, float* ABr, float* ABi, float* cbar, int B, int m,
                    int degree, cudaStream_t st) {
  using L = tcp::Layout<P>;
  const int bytes = bwd_smem_floats<P>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(cheb_bwd_kernel<P, PREC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * L::NC);
  cfg.blockDim = dim3(L::NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L::NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cheb_bwd_kernel<P, PREC>, Mr, Mi, coeffs, Yr, Yi, b1r, b1i, b2r,
                           b2i, ABr, ABi, cbar, m, degree);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace admmk

// C entry point.  Mr, Mi, Yr, Yi: (B, P, P) float planes of M and of the
// output's cotangent Y, zero-padded past the logical side m; coeffs:
// (B, degree) floats; b1r, b1i, b2r, b2i: the forward's final carries as
// cheb_filter_launch writes them; ABr, ABi: (B, P, P) planes of Abar,
// written; cbar: (B, degree) floats, written.  three_pass: split-bf16
// products, else 3xTF32.  Returns the launch's cudaError_t.
extern "C" int cheb_bwd_launch(const float* Mr, const float* Mi, const float* coeffs,
                               const float* Yr, const float* Yi, const float* b1r,
                               const float* b1i, const float* b2r, const float* b2i,
                               float* ABr, float* ABi, float* cbar, int B, int P, int m,
                               int degree, int three_pass, void* stream) {
  using namespace admmk;
  using tcp::Prec;
  if (B <= 0 || degree < 1 || m < 1 || m > P) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CHEB_BWD(PV, PR)                                                                      \
  launch_cheb_bwd<PV, PR>(Mr, Mi, coeffs, Yr, Yi, b1r, b1i, b2r, b2i, ABr, ABi, cbar, B, m, \
                          degree, st)
  if (P == 112)
    return three_pass ? CHEB_BWD(112, Prec::SPLIT_BF16) : CHEB_BWD(112, Prec::TF32X3);
  if (P == 128)
    return three_pass ? CHEB_BWD(128, Prec::SPLIT_BF16) : CHEB_BWD(128, Prec::TF32X3);
#undef CHEB_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
