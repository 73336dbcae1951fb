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
// herm(X) = (X + X^H) / 2.  The first step multiplies by b_1 = 0, so the
// kernel starts from its result, b_1 = c_{degree-1} I, and runs degree - 1
// products.  Every b_j is a polynomial in A, so the product is Hermitian in
// exact arithmetic, and the re-projection removes only the rounding's
// non-Hermitian part before the 2 A b_1 doubling compounds it.
//
// Precision, the TPU kernel's: its cmul multiplies at Precision.DEFAULT,
// a one-pass bf16 product on the MXU, and so does its closing product
// unless final_hi, which makes that one HIGHEST.  Here every step's
// product, and the closing one without final_hi, is a one-pass bf16
// product on the tensor cores (tc_product.cuh's Prec::ONE_PASS_BF16: A and
// b_1 rounded to bf16, Karatsuba's operand sums formed in fp32 and rounded
// once, mma.sync m16n8k16 with fp32 accumulation); with final_hi the
// closing product is 3xTF32 (fp32-faithful), a branch on a kernel argument
// that every CTA of the cluster takes alike.  The plain version with
// one_pass=True rounds the same operands (kernels/cheb_filter.py).
//
// Bound on this card: arithmetic.  degree - 1 complex products of side m
// per matrix, each three real products (Karatsuba): at degree 48 and
// m = 101, 2.9e8 FLOP of useful work against one read of M and one write
// of G (163 KB; K5 adds the four carry planes).  At the dense bf16 peak
// (989 TFLOP/s) that is 0.29 us a matrix; in 3xTF32 (three TF32 products
// per useful one at 495 TFLOP/s) it was 1.76 us.
//
// Design (tc_product.cuh, as cheb_bwd.cu): one thread-block cluster of
// P / 16 CTAs per matrix; CTA q owns rows [16 q, 16 q + 16) of A, b_1 and
// b_2 as real/imaginary band planes in its shared memory, beside the
// staging double buffer (75328 B a CTA at P = 112, two CTAs an SM).  A
// step is one band_product on the tensor cores (bf16 mma.sync, Karatsuba):
// the CTA's band of A against b_1's bands, staged from their
// owners through distributed shared memory, own band first.  X = c_j I +
// 2 A b_1 - b_2 is formed in the accumulator layout in the stage's first
// half; after a cluster barrier each warp copies the one 16 x 16 block of
// X^T its columns need from the CTA that owns it, as float4 reads, into
// the stage's second half (scalar remote reads there cost 15% of the
// kernel), and writes b_0 = herm(X) over b_2, which no other CTA reads;
// b_1 and b_2 swap by pointer, and a second cluster barrier publishes b_0.
// ||M||_F is summed over the cluster in rank order, as cheb_bwd.cu sums it,
// so K6 rebuilds the forward's states from the same A.  Nothing but the
// inputs and outputs touches device memory.  K4 and K5 are one
// instantiation: the carry pointers are a run-time choice, so K5's G is
// K4's bit for bit.
//
// Padding: the planes are zero-padded from m to P.  c_j is added on the
// logical diagonal only (row < m), so every padded row and column stays
// exactly zero through the whole recurrence (a zero row of A or column of
// b_1 gives a zero row or column of the product; a zero rounds to a zero
// bf16 and splits into zero tf32 halves).
#include "common.cuh"
#include "tc_product.cuh"

#include <type_traits>

namespace admmk {

namespace cg = cooperative_groups;
using tcp::BAND;
using tcp::CAcc;
using tcp::NPW;
using tcp::Prec;
template <Prec PR>
using PrecTag = std::integral_constant<Prec, PR>;

template <int P>
constexpr int fwd_smem_floats() {
  // 6 band planes (Ar, Ai, b1r, b1i, b2r, b2i), the staging double buffer
  // (between products: X and herm's transposed blocks), the block
  // reduction's partials and one cluster-visible slot
  return 6 * tcp::Layout<P>::PLANE + 4 * tcp::Layout<P>::SLICE + 16;
}

// Row stride of a warp's transposed 16 x 16 block in herm (scalar stores;
// 2-way bank conflicts on the transposed reads)
constexpr int WS = 17;

// Two CTAs an SM (75328 B of shared memory a CTA at P = 112, 85568 B at
// P = 128; a third at P = 112 would cap the registers at 80 and spill).
template <int P>
__global__ void __launch_bounds__(tcp::Layout<P>::NT, 2) cheb_filter_kernel(
    const float* __restrict__ Mr_all, const float* __restrict__ Mi_all,
    const float* __restrict__ coeffs, float* Gr_all, float* Gi_all, float* C1r_all,
    float* C1i_all, float* C2r_all, float* C2i_all, int m, int degree, int final_hi) {
  using L = tcp::Layout<P>;
  constexpr int SA = L::SA, SB = L::SB;
  static_assert(L::NC * 2 * BAND * WS <= 2 * L::SLICE, "herm's blocks exceed the stage");
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int mat = blockIdx.x / L::NC;
  const int row0 = rank * BAND;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;

  float* Ar = smem;
  float* Ai = Ar + L::PLANE;
  float* b1r = Ai + L::PLANE;
  float* b1i = b1r + L::PLANE;
  float* b2r = b1i + L::PLANE;
  float* b2i = b2r + L::PLANE;
  float* stage = b2i + L::PLANE;
  // between a product and the next: X's band, read across the cluster by
  // herm, in the stage's first half, row stride SB; this warp's transposed
  // block in its second half
  float* Xr = stage;
  float* Xi = stage + L::SLICE;
  float* w = stage + 2 * L::SLICE + warp * 2 * BAND * WS;
  float* red = stage + 4 * L::SLICE;  // one partial per warp
  float* slot = red + 8;              // ||M||_F^2 partial

  const size_t base = static_cast<size_t>(mat) * P * P;
  const float* c = coeffs + static_cast<size_t>(mat) * degree;

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

  // this CTA's bands of A, b_1 = herm(c_{degree-1} I) = c_{degree-1} I (the
  // first step's result) and b_2 = 0; degree 1 has no step: b_1 = 0
  const float top = degree >= 2 ? c[degree - 1] : 0.f;
  for (int e = tid; e < BAND * P; e += L::NT) {
    const int r = e / P, cc = e % P, gr = row0 + r;
    const size_t ge = base + static_cast<size_t>(gr) * P + cc;
    const int li = r * SA + cc;
    Ar[li] = Mr_all[ge] * rinv;
    Ai[li] = Mi_all[ge] * rinv;
    b1r[li] = (gr == cc && cc < m) ? top : 0.f;
    b1i[li] = 0.f;
    b2r[li] = 0.f;
    b2i[li] = 0.f;
  }
  cluster.sync();

  // X = cj I + alpha A b_1 - b_2 into the stage's first half, the product
  // at the tier of the tag; returns once X is visible to the cluster
  auto form_x = [&](float cj, float alpha, auto tier) {
    CAcc acc[1][NPW];
    const float* const lr[1] = {Ar};
    const float* const li[1] = {Ai};
    tcp::band_product<P, 1, decltype(tier)::value>(cluster, b1r, b1i, lr, li, stage, m, acc);
    __syncthreads();  // every warp is done with the stage
#pragma unroll
    for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row_of(e), cc = col_of(jj, e), idx = r * SA + cc;
        const float d = (row0 + r == cc && cc < m) ? cj : 0.f;
        Xr[r * SB + cc] = (d + alpha * tcp::acc_re(acc[0][jj], e)) - b2r[idx];
        Xi[r * SB + cc] = alpha * tcp::acc_im(acc[0][jj], e) - b2i[idx];
      }
    cluster.sync();
  };
  // herm(X) at this thread's entries (row0 + r, cc) into (hr, hi): X^T's
  // entry lies in the band of row cc, at column row0 + r.  Warp w's columns
  // are rows [16 w, 16 w + 16), so the warp copies that one 16 x 16 block
  // from CTA w (float4 reads over distributed shared memory) into its block
  // w and reads it transposed.
  auto herm = [&](float (&hr)[NPW][4], float (&hi)[NPW][4]) {
    const float* xr = cluster.map_shared_rank(Xr, warp);
    const float* xi = cluster.map_shared_rank(Xi, warp);
    float4 blk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = lane + 32 * k, row = (e >> 2) & 15, c4 = e & 3;
      blk[k] = *reinterpret_cast<const float4*>((e >= 64 ? xi : xr) + row * SB + row0 + 4 * c4);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = lane + 32 * k, row = (e >> 2) & 15, c4 = e & 3;
      float* t = w + (e >= 64 ? BAND * WS : 0) + row * WS + 4 * c4;
      t[0] = blk[k].x;
      t[1] = blk[k].y;
      t[2] = blk[k].z;
      t[3] = blk[k].w;
    }
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row_of(e), cc = col_of(jj, e), t = (cc - 16 * warp) * WS + r;
        hr[jj][e] = 0.5f * (Xr[r * SB + cc] + w[t]);
        hi[jj][e] = 0.5f * (Xi[r * SB + cc] - w[BAND * WS + t]);
      }
  };

  for (int j = degree - 2; j >= 1; --j) {
    form_x(c[j], 2.f, PrecTag<Prec::ONE_PASS_BF16>{});
    // b_0 = herm(X) over b_2, which no other CTA reads; then
    // (b_1, b_2) <- (b_0, b_1)
    float hr[NPW][4], hi[NPW][4];
    herm(hr, hi);
#pragma unroll
    for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = row_of(e) * SA + col_of(jj, e);
        b2r[idx] = hr[jj][e];
        b2i[idx] = hi[jj][e];
      }
    float* t = b1r;
    b1r = b2r;
    b2r = t;
    t = b1i;
    b1i = b2i;
    b2i = t;
    cluster.sync();  // b_0 is visible; every read of X is done
  }

  // G = herm(c_0 I + A b_1 - b_2), final_hi: in 3xTF32
  if (final_hi)
    form_x(c[0], 1.f, PrecTag<Prec::TF32X3>{});
  else
    form_x(c[0], 1.f, PrecTag<Prec::ONE_PASS_BF16>{});
  {
    float hr[NPW][4], hi[NPW][4];
    herm(hr, hi);
#pragma unroll
    for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const size_t ge = base + static_cast<size_t>(row0 + row_of(e)) * P + col_of(jj, e);
        Gr_all[ge] = hr[jj][e];
        Gi_all[ge] = hi[jj][e];
      }
  }
  // training forward (K5): the final carries (b_1, b_2), the only residuals
  // the reversible backward (cheb_bwd.cu) needs
  if (C1r_all != nullptr) {
    for (int e = tid; e < BAND * P; e += L::NT) {
      const int r = e / P, cc = e % P, li = r * SA + cc;
      const size_t ge = base + static_cast<size_t>(row0 + r) * P + cc;
      C1r_all[ge] = b1r[li];
      C1i_all[ge] = b1i[li];
      C2r_all[ge] = b2r[li];
      C2i_all[ge] = b2i[li];
    }
  }
  cluster.sync();  // no CTA leaves while another still reads its X
}

template <int P>
int launch_cheb_filter(const float* Mr, const float* Mi, const float* coeffs, float* Gr,
                       float* Gi, float* b1r, float* b1i, float* b2r, float* b2i, int B, int m,
                       int degree, int final_hi, cudaStream_t st) {
  using L = tcp::Layout<P>;
  const int bytes = fwd_smem_floats<P>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(cheb_filter_kernel<P>,
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
  err = cudaLaunchKernelEx(&cfg, cheb_filter_kernel<P>, Mr, Mi, coeffs, Gr, Gi, b1r, b1i, b2r,
                           b2i, m, degree, final_hi);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace admmk

// C entry point.  Mr, Mi: (B, P, P) float planes, zero-padded past the
// logical side m; coeffs: (B, degree) floats on the device; Gr, Gi: (B, P, P),
// written.  b1r, b1i, b2r, b2i: all null (the inference forward) or all
// (B, P, P) planes that receive the final Clenshaw carries (the training
// forward); the output G is the same either way, bit for bit, since both
// run the same instantiation.  final_hi: the closing product in 3xTF32
// instead of one-pass bf16.  Returns the launch's cudaError_t.
extern "C" int cheb_filter_launch(const float* Mr, const float* Mi, const float* coeffs,
                                  float* Gr, float* Gi, float* b1r, float* b1i, float* b2r,
                                  float* b2i, int B, int P, int m, int degree, int final_hi,
                                  void* stream) {
  using namespace admmk;
  if (B <= 0 || degree < 1 || m < 1 || m > P) return static_cast<int>(cudaErrorInvalidValue);
  const bool carries = b1r != nullptr;
  if ((b1i != nullptr) != carries || (b2r != nullptr) != carries || (b2i != nullptr) != carries)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P == 112)
    return launch_cheb_filter<112>(Mr, Mi, coeffs, Gr, Gi, b1r, b1i, b2r, b2i, B, m, degree,
                                   final_hi, st);
  if (P == 128)
    return launch_cheb_filter<128>(Mr, Mi, coeffs, Gr, Gi, b1r, b1i, b2r, b2i, B, m, degree,
                                   final_hi, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
