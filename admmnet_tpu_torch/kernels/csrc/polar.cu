// Batched PSD projection P = (M + |M|) / 2 of Hermitian matrices through a
// matrix-sign polynomial schedule (K1).
//
// Replaces admmnet_tpu/kernels/polar.py :: psd_project_polar_pallas (kernel
// body _polar_kernel), the per-step G-update of the "polar" and "polar_fast"
// solver modes.
//
// Per matrix: X = M / max(||M||_F, 1e-30); per step (a, b, c) X^2 and X^4 by
// the Hermitian square, Y = a I + b X^2 + c X^4, X <- X Y, re-projected onto
// the Hermitian subspace after every step that is not hi; A = herm(X M);
// P = herm((M + A) / 2).
//
// Bound on this card: arithmetic.  A projection is 9 real P^3 products per
// schedule step plus 3 closing ones at the logical side m (101 for the
// lifted 101 x 101 matrix: 7 steps -> 66 products, 0.14 GFLOP useful),
// against one read of M and one write of P.  The accurate mode's are all
// fp32 products, in 3xTF32 on the tensor cores (three TF32 products per
// useful one, 495 TFLOP/s): 1.68 ms at B = 2048.  The fast mode's 54 low
// products are one-pass bf16 products (989 TFLOP/s dense), its 3 closing
// ones 3xTF32: 0.31 ms at B = 2048.
//
// Design: the body of polar_cta.cuh.  At P = 112 (m <= 112) one CTA of 7
// warps per matrix holds the four working planes X and W in shared memory
// (215040 B + 256 B of slots; one CTA an SM); at P = 128 a cluster of two
// CTAs of 16 warps holds 64 rows each plus a stage for the peer's rows of a
// right operand (208896 B + 256 B each).  Every product is one whole
// product per CTA (or pair): 3xTF32 mma.sync m16n8k8 on the tensor cores
// for the hi steps and the closing product, one-pass bf16 mma.sync
// m16n8k16 for the low steps (kernels/polar.py's precision rule).  M is not held on
// chip: it is read from device memory for ||M||_F and X_0 and into W for
// the closing product, which also supplies P = (M + A) / 2.  There is no
// global scratch.
//
// bf16_store (fast mode, the JAX kernel's bf16_store=True): the iterate of
// the low steps is kept bf16-valued and every product output and
// elementwise result of those steps is rounded to bf16 at the points of
// psd_project_polar_plain's bf16_step; the products accumulate in fp32.  A
// hi step and the closing products read the iterate as fp32.
#include "polar_cta.cuh"

namespace pcta {

template <class C, bool BF16_STORE>
__global__ void __launch_bounds__(C::NT, 1)
    polar_cta_kernel(const float* __restrict__ Mr_all, const float* __restrict__ Mi_all,
                     float* Pr_all, float* Pi_all, Schedule sched, int hi_steps, int m) {
  constexpr int P = C::P, NTW = C::NTW, Q4 = P / 4;
  extern __shared__ __align__(16) float smem[];
  const Body<C> bd(smem, m);
  const size_t off = static_cast<size_t>(blockIdx.x / C::NC) * P * P;
  const float* Mr = Mr_all + off;
  const float* Mi = Mi_all + off;
  float* Pr = Pr_all + off;
  float* Pi = Pi_all + off;
  const int tid = threadIdx.x;

  // ||M||_F over the whole matrix, then X_0 = M / ||M||_F (own rows)
  float s = 0.f;
  for (int e = tid; e < C::ROWS * Q4; e += C::NT) {
    const int o = (bd.row0 + e / Q4) * P + 4 * (e % Q4);
    const float4 a = *reinterpret_cast<const float4*>(Mr + o);
    const float4 b = *reinterpret_cast<const float4*>(Mi + o);
    s += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
    s += b.x * b.x + b.y * b.y + b.z * b.z + b.w * b.w;
  }
  const float inv = 1.f / fmaxf(sqrtf(bd.matrix_sum(s)), 1e-30f);
  for (int e = tid; e < C::ROWS * Q4; e += C::NT) {
    const int r = e / Q4, c = 4 * (e % Q4);
    const float4 a = *reinterpret_cast<const float4*>(Mr + (bd.row0 + r) * P + c);
    const float4 b = *reinterpret_cast<const float4*>(Mi + (bd.row0 + r) * P + c);
    float4 xr = make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
    float4 xi = make_float4(b.x * inv, b.y * inv, b.z * inv, b.w * inv);
    if constexpr (BF16_STORE) {
      xr = make_float4(bf16_round(xr.x), bf16_round(xr.y), bf16_round(xr.z), bf16_round(xr.w));
      xi = make_float4(bf16_round(xi.x), bf16_round(xi.y), bf16_round(xi.z), bf16_round(xi.w));
    }
    *reinterpret_cast<float4*>(bd.Xr + r * C::S + c) = xr;
    *reinterpret_cast<float4*>(bd.Xi + r * C::S + c) = xi;
  }
  bd.sync_all();

  bd.template sign_schedule<BF16_STORE, true>(sched, hi_steps);

  // M into W, then A = herm(X M)
  for (int e = tid; e < C::ROWS * Q4; e += C::NT) {
    const int r = e / Q4, c = 4 * (e % Q4);
    *reinterpret_cast<float4*>(bd.Wr + r * C::S + c) =
        *reinterpret_cast<const float4*>(Mr + (bd.row0 + r) * P + c);
    *reinterpret_cast<float4*>(bd.Wi + r * C::S + c) =
        *reinterpret_cast<const float4*>(Mi + (bd.row0 + r) * P + c);
  }
  bd.sync_all();
  float ar[NTW][4], ai[NTW][4];
  bd.abs_product(ar, ai);

  // P = herm((M + A) / 2): the owner of (r, c) forms (M + A)(c, r) / 2 too,
  // from M^T and A's Hermitian part (symmetric real, antisymmetric
  // imaginary, bit for bit)
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    float2 outr, outi;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int lr = bd.lrow(e), c = bd.col(j, e), r = bd.row0 + lr;
      const float pr = 0.5f * (bd.Wr[lr * C::S + c] + ar[j][e]);
      const float pi = 0.5f * (bd.Wi[lr * C::S + c] + ai[j][e]);
      const float prt = 0.5f * (bd.at(bd.Wr, c, r) + ar[j][e]);
      const float pit = 0.5f * (bd.at(bd.Wi, c, r) - ai[j][e]);
      const float vr = 0.5f * (pr + prt), vi = 0.5f * (pi - pit);
      if (e & 1) {
        outr.y = vr;
        outi.y = vi;
        *reinterpret_cast<float2*>(Pr + r * P + c - 1) = outr;
        *reinterpret_cast<float2*>(Pi + r * P + c - 1) = outi;
      } else {
        outr.x = vr;
        outi.x = vi;
      }
    }
  }
  if constexpr (C::NC > 1) cg::this_cluster().sync();  // no CTA leaves while the peer reads it
}

}  // namespace pcta

// C entry point.  Mr, Mi: (B, P, P) float planes, zero past the logical
// side m; Pr, Pi: the same shape, written.  coeffs: host array of nsteps
// (a, b, c) triples; bf16_store: bf16 iterate storage of the low steps.
// Returns the launch's cudaError_t.
extern "C" int polar_psd_launch(const float* Mr, const float* Mi, float* Pr, float* Pi, int B,
                                int P, int m, const float* coeffs, int nsteps, int hi_steps,
                                int bf16_store, void* stream) {
  using namespace pcta;
  if (nsteps < 0 || nsteps > admmk::MAX_STEPS || B <= 0 || m < 1 || m > P)
    return static_cast<int>(cudaErrorInvalidValue);
  Schedule sched{};
  for (int s = 0; s < nsteps; ++s) {
    sched.a[s] = coeffs[3 * s];
    sched.b[s] = coeffs[3 * s + 1];
    sched.c[s] = coeffs[3 * s + 2];
  }
  sched.n = nsteps;
  if (P == 112 && bf16_store)
    return launch<Cfg112>(polar_cta_kernel<Cfg112, true>, B, Cfg112::FLOATS, stream, Mr,
                          Mi, Pr, Pi, sched, hi_steps, m);
  if (P == 112)
    return launch<Cfg112>(polar_cta_kernel<Cfg112, false>, B, Cfg112::FLOATS, stream, Mr,
                          Mi, Pr, Pi, sched, hi_steps, m);
  if (P == 128 && bf16_store)
    return launch<Cfg128>(polar_cta_kernel<Cfg128, true>, B, Cfg128::FLOATS, stream, Mr,
                          Mi, Pr, Pi, sched, hi_steps, m);
  if (P == 128)
    return launch<Cfg128>(polar_cta_kernel<Cfg128, false>, B, Cfg128::FLOATS, stream, Mr,
                          Mi, Pr, Pi, sched, hi_steps, m);
  return static_cast<int>(cudaErrorInvalidValue);
}
