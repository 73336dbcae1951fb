// Device code shared by the polar PSD kernel (polar.cu), the fused ADMM
// solve kernel (fused_admm_fast.cu) and the Clenshaw kernel (cheb_filter.cu).
//
// One thread block works on one matrix.  A complex Hermitian matrix is two
// float planes (real, imaginary) of side P (112 or 128), zero-padded past
// the logical side; zero rows and columns stay exactly zero through every
// product and polynomial step, so the padding changes nothing.  P = 112 is
// the smallest multiple of 16 that holds the 101 x 101 lifted matrix: the
// 16 x 16 thread grid then owns 7 x 7 outputs per thread with no ragged
// edge, a third fewer FLOPs than P = 128, and 16 is also the tile granularity
// of Hopper's wgmma, so the layout is ready for tensor cores.  Planes live
// in a per-block global scratch (L2-resident while the block runs); every
// product streams its operands through shared-memory tiles of depth KT.
//
// Thread layout: 256 threads as a 16 x 16 grid; thread (ty, tx) owns the
// MT x MT outputs (ty + 16 i, tx + 16 j), MT = P / 16, so a warp's reads of
// a tile row are broadcasts and its writes of an output row are coalesced.
//
// Precision: every product is IEEE fp32 (SIMT FMA), except that a "split"
// product reproduces the TPU kernel's 3-pass split-bf16 product literally:
// each operand x becomes xh = bf16_rn(x) and xl = x - xh (fp32), and
// x*y is accumulated as xh*yh + xh*yl + xl*yh.  With bf16 storage (the BF
// template flag, polar.cu's bf16_store) the planes hold bf16 values: each
// product accumulates in fp32 and is rounded once, and each elementwise
// result (sums, differences, the polynomial's terms, the re-projection) is
// rounded to bf16 as it is formed.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace admmk {

constexpr int TS = 16;        // thread grid side
constexpr int NT = TS * TS;   // threads per block
constexpr int KT = 16;        // depth of one shared-memory operand tile
constexpr int ROW = 128;      // length of the shared row buffers (>= P)
constexpr int MAX_STEPS = 8;  // longest sign schedule

struct Schedule {
  float a[MAX_STEPS], b[MAX_STEPS], c[MAX_STEPS];
  int n;
};

template <int P>
struct Tiles {
  static constexpr int SP = P + 4;  // padded stride: fewer bank conflicts on store
  float l0[KT][SP], l1[KT][SP];     // left operands, k-major: l[kk][row]
  float r0[KT][SP], r1[KT][SP];     // right operands: r[kk][col]
  float red[NT / 32];               // block-reduction partials
  float bcast;                      // block-reduction result
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Sum over a warp, the same value in every lane (lane 0's order).
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return __shfl_sync(0xffffffffu, v, 0);
}

// Sum of one value per thread over the block; every thread gets the result.
template <int P>
__device__ float block_sum(Tiles<P>& sm, float v) {
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) sm.red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < NT / 32 ? sm.red[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) sm.bcast = s;
  }
  __syncthreads();
  const float out = sm.bcast;
  __syncthreads();  // sm.red / sm.bcast may be reused right after
  return out;
}

// Which operand pairs one pass over k accumulates:
//   PAIRS: acc0 += L0 R0, acc1 += L1 R1
//   ONE:   acc0 += L0 R0
//   SUMS:  acc0 += (L0 + L1)(R0 + R1)
enum Mode { PAIRS, ONE, SUMS };

template <int P, int MODE, bool BF>
__device__ __forceinline__ void load_tiles(Tiles<P>& sm, const float* L0, const float* L1,
                                           const float* R0, const float* R1, int k0) {
  for (int e = threadIdx.x; e < KT * P; e += NT) {
    const int row = e / KT, kk = e % KT;
    const int li = row * P + k0 + kk;
    if (MODE == SUMS) {
      const float v = L0[li] + L1[li];
      sm.l0[kk][row] = BF ? bf16_round(v) : v;
    } else {
      sm.l0[kk][row] = L0[li];
      if (MODE == PAIRS) sm.l1[kk][row] = L1[li];
    }
  }
  for (int e = threadIdx.x; e < KT * P; e += NT) {
    const int kk = e / P, col = e % P;
    const int ri = (k0 + kk) * P + col;
    if (MODE == SUMS) {
      const float v = R0[ri] + R1[ri];
      sm.r0[kk][col] = BF ? bf16_round(v) : v;
    } else {
      sm.r0[kk][col] = R0[ri];
      if (MODE == PAIRS) sm.r1[kk][col] = R1[ri];
    }
  }
}

template <int MT, bool SPLIT>
__device__ __forceinline__ void outer_acc(float (&acc)[MT][MT], const float (&x)[MT],
                                          const float (&y)[MT]) {
  if constexpr (SPLIT) {
    float xh[MT], xl[MT], yh[MT], yl[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      xh[i] = bf16_round(x[i]);
      xl[i] = x[i] - xh[i];
      yh[i] = bf16_round(y[i]);
      yl[i] = y[i] - yh[i];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        float a = acc[i][j];
        a = fmaf(xh[i], yh[j], a);
        a = fmaf(xh[i], yl[j], a);
        a = fmaf(xl[i], yh[j], a);
        acc[i][j] = a;
      }
  } else {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// One tiled pass over k of the product(s) named by MODE; results stay in
// the accumulators.  Ends with __syncthreads(), after which every read of
// L*/R* is complete and those planes may be overwritten.  BF rounds the
// operand sums of SUMS to bf16.
template <int P, int MODE, bool SPLIT, bool BF = false>
__device__ __forceinline__ void gemm_pass(Tiles<P>& sm, const float* L0, const float* L1,
                                          const float* R0, const float* R1,
                                          float (&acc0)[P / TS][P / TS],
                                          float (&acc1)[P / TS][P / TS]) {
  constexpr int MT = P / TS;
  const int ty = threadIdx.x / TS, tx = threadIdx.x % TS;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      acc0[i][j] = 0.f;
      acc1[i][j] = 0.f;
    }
  for (int k0 = 0; k0 < P; k0 += KT) {
    load_tiles<P, MODE, BF>(sm, L0, L1, R0, R1, k0);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float x[MT], y[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) x[i] = sm.l0[kk][ty + TS * i];
#pragma unroll
      for (int j = 0; j < MT; ++j) y[j] = sm.r0[kk][tx + TS * j];
      outer_acc<MT, SPLIT>(acc0, x, y);
      if (MODE == PAIRS) {
#pragma unroll
        for (int i = 0; i < MT; ++i) x[i] = sm.l1[kk][ty + TS * i];
#pragma unroll
        for (int j = 0; j < MT; ++j) y[j] = sm.r1[kk][tx + TS * j];
        outer_acc<MT, SPLIT>(acc1, x, y);
      }
    }
    __syncthreads();
  }
}

// X2 = X X for Hermitian X (3 real products):
//   X2r = Xr Xr - Xi Xi,  X2i = XrXi - (XrXi)^T.
// With poly, writes Y = a I + b X2in + c X2 instead, where X2in = (Xr, Xi)
// are this call's inputs (the previous square) -- the schedule's polynomial.
// BF: bf16 storage (a, b, c already rounded to bf16 by the caller).
template <int P, bool SPLIT, bool BF = false>
__device__ void herm_square(Tiles<P>& sm, const float* Xr, const float* Xi, float* Or,
                            float* Oi, float* T, bool poly, float a, float b, float c) {
  constexpr int MT = P / TS;
  const int ty = threadIdx.x / TS, tx = threadIdx.x % TS;
  float acc0[MT][MT], acc1[MT][MT];
  gemm_pass<P, PAIRS, SPLIT, BF>(sm, Xr, Xi, Xr, Xi, acc0, acc1);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int r = ty + TS * i, cc = tx + TS * j;
      if constexpr (BF) {
        const float eye = r == cc ? a : 0.f;
        const float x2r = bf16_round(bf16_round(acc0[i][j]) - bf16_round(acc1[i][j]));
        Or[r * P + cc] = poly ? bf16_round(bf16_round(eye + bf16_round(b * Xr[r * P + cc])) +
                                           bf16_round(c * x2r))
                              : x2r;
      } else {
        const float x2r = acc0[i][j] - acc1[i][j];
        if (poly) {
          const float eye = r == cc ? a : 0.f;
          Or[r * P + cc] = (eye + b * Xr[r * P + cc]) + c * x2r;
        } else {
          Or[r * P + cc] = x2r;
        }
      }
    }
  gemm_pass<P, ONE, SPLIT, BF>(sm, Xr, Xr, Xi, Xi, acc0, acc1);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if constexpr (BF) acc0[i][j] = bf16_round(acc0[i][j]);
      T[(ty + TS * i) * P + tx + TS * j] = acc0[i][j];
    }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int r = ty + TS * i, cc = tx + TS * j;
      if constexpr (BF) {
        const float x2i = bf16_round(acc0[i][j] - T[cc * P + r]);
        Oi[r * P + cc] =
            poly ? bf16_round(bf16_round(b * Xi[r * P + cc]) + bf16_round(c * x2i)) : x2i;
      } else {
        const float x2i = acc0[i][j] - T[cc * P + r];
        Oi[r * P + cc] = poly ? b * Xi[r * P + cc] + c * x2i : x2i;
      }
    }
  __syncthreads();
}

// Karatsuba complex product of commuting Hermitians (3 real products):
//   t1 = Lr Rr, t2 = Li Ri, t3 = (Lr + Li)(Rr + Ri),
//   Cr = t1 - t2, Ci = t3 - t1 - t2, left in the accumulators (cr, ci).
// T receives t3.  Ends synchronized; L and R may then be overwritten.
// BF: bf16 storage (each product, sum and difference rounded to bf16).
template <int P, bool SPLIT, bool BF = false>
__device__ __forceinline__ void karatsuba(Tiles<P>& sm, const float* Lr, const float* Li,
                                          const float* Rr, const float* Ri, float* T,
                                          float (&cr)[P / TS][P / TS],
                                          float (&ci)[P / TS][P / TS]) {
  constexpr int MT = P / TS;
  const int ty = threadIdx.x / TS, tx = threadIdx.x % TS;
  gemm_pass<P, SUMS, SPLIT, BF>(sm, Lr, Li, Rr, Ri, cr, ci);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j)
      T[(ty + TS * i) * P + tx + TS * j] = BF ? bf16_round(cr[i][j]) : cr[i][j];
  // each thread reads back only the T entries it wrote, so no barrier is
  // needed between this write and the epilogue below
  gemm_pass<P, PAIRS, SPLIT, BF>(sm, Lr, Li, Rr, Ri, cr, ci);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const float t3 = T[(ty + TS * i) * P + tx + TS * j];
      if constexpr (BF) {
        const float t1 = bf16_round(cr[i][j]), t2 = bf16_round(ci[i][j]);
        cr[i][j] = bf16_round(t1 - t2);
        ci[i][j] = bf16_round(bf16_round(t3 - t1) - t2);
      } else {
        const float t1 = cr[i][j], t2 = ci[i][j];
        cr[i][j] = t1 - t2;
        ci[i][j] = t3 - t1 - t2;
      }
    }
}

// Replace the accumulators (cr, ci) by their Hermitian part:
//   cr <- (cr + cr^T) / 2,  ci <- (ci - ci^T) / 2,
// exchanging transposes through the planes Er, Ei (overwritten).  BF rounds
// the sums and the halves to bf16.
template <int P, bool BF = false>
__device__ __forceinline__ void hermitian_part(float* Er, float* Ei, float (&cr)[P / TS][P / TS],
                                               float (&ci)[P / TS][P / TS]) {
  constexpr int MT = P / TS;
  const int ty = threadIdx.x / TS, tx = threadIdx.x % TS;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int idx = (ty + TS * i) * P + tx + TS * j;
      Er[idx] = cr[i][j];
      Ei[idx] = ci[i][j];
    }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int tidx = (tx + TS * j) * P + ty + TS * i;
      if constexpr (BF) {
        cr[i][j] = bf16_round(0.5f * bf16_round(cr[i][j] + Er[tidx]));
        ci[i][j] = bf16_round(0.5f * bf16_round(ci[i][j] - Ei[tidx]));
      } else {
        cr[i][j] = 0.5f * (cr[i][j] + Er[tidx]);
        ci[i][j] = 0.5f * (ci[i][j] - Ei[tidx]);
      }
    }
  __syncthreads();
}

// Scratch planes of the sign schedule, each P x P floats.
struct SignPlanes {
  float *Xr, *Xi, *X2r, *X2i, *Yr, *Yi, *T;
};

// X <- sign schedule applied to X (already scaled by 1/||M||_F).
// Step s is "hi" iff all_hi or s >= nsteps - hi_steps; a hi step's products
// are split products iff three_pass; the iterate is re-projected onto the
// Hermitian subspace after a step iff it is not hi or three_pass.
// BF16_STORE: the low steps run with bf16 storage on the bf16-valued
// iterate and coefficients; a hi step reads the iterate as fp32.
template <int P, bool BF16_STORE = false>
__device__ void sign_schedule(Tiles<P>& sm, const SignPlanes& w, const Schedule& sched,
                              int hi_steps, bool all_hi, bool three_pass) {
  constexpr int MT = P / TS;
  const int ty = threadIdx.x / TS, tx = threadIdx.x % TS;
  for (int s = 0; s < sched.n; ++s) {
    const bool hi = all_hi || s >= sched.n - hi_steps;
    const bool split = hi && three_pass;
    const bool reproject = !hi || three_pass;
    const float a = sched.a[s], b = sched.b[s], c = sched.c[s];
    float cr[MT][MT], ci[MT][MT];
    bool done = false;
    if constexpr (BF16_STORE) {
      if (!hi) {
        const float ab = bf16_round(a), bb = bf16_round(b), cb = bf16_round(c);
        herm_square<P, false, true>(sm, w.Xr, w.Xi, w.X2r, w.X2i, w.T, false, 0.f, 0.f, 0.f);
        herm_square<P, false, true>(sm, w.X2r, w.X2i, w.Yr, w.Yi, w.T, true, ab, bb, cb);
        karatsuba<P, false, true>(sm, w.Xr, w.Xi, w.Yr, w.Yi, w.T, cr, ci);
        hermitian_part<P, true>(w.Xr, w.Xi, cr, ci);
        done = true;
      }
    }
    if (!done) {
      if (split) {
        herm_square<P, true>(sm, w.Xr, w.Xi, w.X2r, w.X2i, w.T, false, 0.f, 0.f, 0.f);
        herm_square<P, true>(sm, w.X2r, w.X2i, w.Yr, w.Yi, w.T, true, a, b, c);
        karatsuba<P, true>(sm, w.Xr, w.Xi, w.Yr, w.Yi, w.T, cr, ci);
      } else {
        herm_square<P, false>(sm, w.Xr, w.Xi, w.X2r, w.X2i, w.T, false, 0.f, 0.f, 0.f);
        herm_square<P, false>(sm, w.X2r, w.X2i, w.Yr, w.Yi, w.T, true, a, b, c);
        karatsuba<P, false>(sm, w.Xr, w.Xi, w.Yr, w.Yi, w.T, cr, ci);
      }
      if (reproject) hermitian_part<P>(w.Xr, w.Xi, cr, ci);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int idx = (ty + TS * i) * P + tx + TS * j;
        w.Xr[idx] = cr[i][j];
        w.Xi[idx] = ci[i][j];
      }
    __syncthreads();
  }
}

// X <- M / max(||M||_F, 1e-30), with M given as planes (Mr, Mi); BF rounds
// X to bf16.
template <int P, bool BF = false>
__device__ void scale_by_frobenius(Tiles<P>& sm, const float* Mr, const float* Mi, float* Xr,
                                   float* Xi) {
  float s = 0.f;
  for (int e = threadIdx.x; e < P * P; e += NT) s += Mr[e] * Mr[e] + Mi[e] * Mi[e];
  const float inv = 1.f / fmaxf(sqrtf(block_sum<P>(sm, s)), 1e-30f);
  for (int e = threadIdx.x; e < P * P; e += NT) {
    Xr[e] = BF ? bf16_round(Mr[e] * inv) : Mr[e] * inv;
    Xi[e] = BF ? bf16_round(Mi[e] * inv) : Mi[e] * inv;
  }
  __syncthreads();
}

// The symmetrized |M| product A = herm(S M), S the sign iterate in (Xr, Xi),
// left in the accumulators (ar, ai).  Overwrites Xr, Xi and T.
template <int P>
__device__ __forceinline__ void abs_product(Tiles<P>& sm, const SignPlanes& w, const float* Mr,
                                            const float* Mi, bool split,
                                            float (&ar)[P / TS][P / TS],
                                            float (&ai)[P / TS][P / TS]) {
  if (split)
    karatsuba<P, true>(sm, w.Xr, w.Xi, Mr, Mi, w.T, ar, ai);
  else
    karatsuba<P, false>(sm, w.Xr, w.Xi, Mr, Mi, w.T, ar, ai);
  hermitian_part<P>(w.Xr, w.Xi, ar, ai);
}

}  // namespace admmk
