// Batched PSD projection P = (M + |M|) / 2 of Hermitian matrices through a
// matrix-sign polynomial schedule.
//
// Replaces admmnet_tpu/kernels/polar.py :: psd_project_polar_pallas (kernel
// body _polar_kernel), the per-step G-update of the "polar" and "polar_fast"
// solver modes.
//
// Bound on this card: arithmetic.  Each projection is 9 real P^3 products
// per schedule step plus 3 closing ones (P = 112 for the 101 x 101 lifted
// matrix: 7 steps -> 66 products, 0.19 GFLOP), against one read and one
// write of the two input planes.  The TPU kernel kept every intermediate
// in VMEM; an SM's 227 KB of shared memory holds only four 112^2 planes, so
// this design keeps the schedule's seven working planes in a per-matrix
// global scratch (351 KB at P = 112, L2-resident while its block runs),
// streams each product's operands through 16-deep shared-memory tiles, and
// accumulates a 7 x 7 register micro-tile per thread in IEEE fp32 FMAs.
// The Hermitian structure of the iterate is used as on the TPU: X^2 costs 3
// real products (X2i = XrXi - (XrXi)^T), a general product of commuting
// Hermitians 3 (Karatsuba).  One thread block per matrix; tensor cores
// (wgmma) and a bf16 / TF32 precision remap are later work.
//
// bf16_store (fast mode, the JAX kernel's bf16_store=True): the iterate of
// the low steps is kept bf16-valued and every product output and
// elementwise result of those steps is rounded to bf16 (common.cuh's BF
// flag); the products still accumulate in IEEE fp32.  The first hi step
// and the closing products read the iterate as fp32.
#include "common.cuh"

namespace admmk {

constexpr int POLAR_PLANES = 7;  // Xr, Xi, X2r, X2i, Yr, Yi, T

template <int P, bool BF16_STORE>
__global__ void __launch_bounds__(NT) polar_psd_kernel(const float* __restrict__ Mr_all,
                                                        const float* __restrict__ Mi_all,
                                                        float* Pr_all, float* Pi_all,
                                                        float* scratch, Schedule sched,
                                                        int hi_steps) {
  constexpr int MT = P / TS;
  __shared__ Tiles<P> sm;
  const size_t off = static_cast<size_t>(blockIdx.x) * P * P;
  const float* Mr = Mr_all + off;
  const float* Mi = Mi_all + off;
  float* Pr = Pr_all + off;
  float* Pi = Pi_all + off;
  float* base = scratch + static_cast<size_t>(blockIdx.x) * POLAR_PLANES * P * P;
  SignPlanes w;
  w.Xr = base;
  w.Xi = base + 1 * P * P;
  w.X2r = base + 2 * P * P;
  w.X2i = base + 3 * P * P;
  w.Yr = base + 4 * P * P;
  w.Yi = base + 5 * P * P;
  w.T = base + 6 * P * P;

  scale_by_frobenius<P, BF16_STORE>(sm, Mr, Mi, w.Xr, w.Xi);
  sign_schedule<P, BF16_STORE>(sm, w, sched, hi_steps, false, false);

  float ar[MT][MT], ai[MT][MT];
  abs_product<P>(sm, w, Mr, Mi, false, ar, ai);
  // P = (M + A) / 2, then its Hermitian part
  const int ty = threadIdx.x / TS, tx = threadIdx.x % TS;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int idx = (ty + TS * i) * P + tx + TS * j;
      ar[i][j] = 0.5f * (Mr[idx] + ar[i][j]);
      ai[i][j] = 0.5f * (Mi[idx] + ai[i][j]);
    }
  hermitian_part<P>(Pr, Pi, ar, ai);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int idx = (ty + TS * i) * P + tx + TS * j;
      Pr[idx] = ar[i][j];
      Pi[idx] = ai[i][j];
    }
}

}  // namespace admmk

// C entry point.  Mr, Mi: (B, P, P) float planes, zero-padded; Pr, Pi: the
// same shape, written; scratch: B * 7 * P * P floats.  coeffs: host array of
// nsteps (a, b, c) triples; bf16_store: bf16 iterate storage of the low
// steps.  Returns the launch's cudaError_t.
extern "C" int polar_psd_launch(const float* Mr, const float* Mi, float* Pr, float* Pi,
                                float* scratch, int B, int P, const float* coeffs, int nsteps,
                                int hi_steps, int bf16_store, void* stream) {
  using namespace admmk;
  if (nsteps < 0 || nsteps > MAX_STEPS || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Schedule sched{};
  for (int s = 0; s < nsteps; ++s) {
    sched.a[s] = coeffs[3 * s];
    sched.b[s] = coeffs[3 * s + 1];
    sched.c[s] = coeffs[3 * s + 2];
  }
  sched.n = nsteps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P == 112 && bf16_store)
    polar_psd_kernel<112, true><<<B, NT, 0, st>>>(Mr, Mi, Pr, Pi, scratch, sched, hi_steps);
  else if (P == 112)
    polar_psd_kernel<112, false><<<B, NT, 0, st>>>(Mr, Mi, Pr, Pi, scratch, sched, hi_steps);
  else if (P == 128 && bf16_store)
    polar_psd_kernel<128, true><<<B, NT, 0, st>>>(Mr, Mi, Pr, Pi, scratch, sched, hi_steps);
  else if (P == 128)
    polar_psd_kernel<128, false><<<B, NT, 0, st>>>(Mr, Mi, Pr, Pi, scratch, sched, hi_steps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
