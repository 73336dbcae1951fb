// The sign schedule and the closing |M| product of a PSD projection by a
// matrix-sign polynomial, with each whole complex product computed by one
// CTA on the tensor cores: the body of the polar PSD kernel (polar.cu, K1)
// and of the first-generation fused solve (fused_admm.cu, K7).
//
// Layout.  A Hermitian P x P complex matrix (P = 112 or 128, zero past its
// logical side m) lives as real and imaginary float planes with row stride
// S = P + 8 in shared memory.  A CTA holds ROWS = P / NC rows of four
// planes: X (the sign iterate) and W (X^2, then the polynomial Y, then the
// closing product's right operand M).  At P = 112, NC = 1: one CTA holds
// the whole matrix, 4 x 112 x 120 x 4 B = 215040 B, and runs alone on an
// SM.  At P = 128 four whole planes do not fit (278528 B), so NC = 2: a
// cluster of two CTAs holds 64 rows each, and before every product each
// CTA copies the peer's 64 rows of the right operand into a local stage
// over distributed shared memory, in whole rows of float4 (2 x 64 x 136 x
// 4 B; 208896 B in all).  (56-row halves at P = 112 are not a multiple of
// the 16-row mma tile, so P = 112 has no NC = 2 form.)  The stride makes
// the right operands' fragment reads, which every warp of a column group
// repeats, conflict-free; the left ones, read once per warp and k-step,
// take two wavefronts.
//
// Warps.  Warp w owns output rows [16 b, 16 b + 16) of the CTA's rows, b =
// w / CG, and NTW 8-column tiles from column 8 NTW (w % CG); the whole
// product's output stays in registers in the mma accumulator layout (PTX
// m16n8k8: lane = 4 g + q holds rows g and g + 8, columns 2q and
// 2q + 1 of each tile), so a product's result can replace its own operand
// after a barrier.  P = 112: 7 warps, one per band, each over all 14
// tiles (255 registers a thread; 14 warps of 7 tiles, capped at 128
// registers, ran slower on an H100); P = 128: 4 bands x 4 groups of 4
// tiles, 16 warps (8 warps of 8 tiles ran slower).  Every fragment a warp
// loads feeds NTW tiles (left) or one tile (right).
//
// Products, in the JAX package's tiers (kernels/polar.py).  fp32 products
// -- a hi step's and the closing |M| product -- run in 3xTF32
// (tc_product.cuh's split: x = hi + lo, x y ~ lo hi + hi lo + hi hi), each
// 8-deep step's sum fresh and folded into the running sum in fp32.  A
// square of a Hermitian X takes three real products into two
// accumulators, X2r = Xr Xr - Xi Xi (the negated Xi fragment) and T = Xr
// Xi, with X2i = T - T^T; a general complex product takes the
// 4-multiplication form, Cr = Lr Rr - Li Ri and Ci = Lr Ri + Li Rr (two
// accumulators: Karatsuba's third would not fit the registers beside a
// whole product's output and the 3xTF32 fragments).  A low step's products
// run one-pass (product16): bf16 mma.sync m16n8k16, each operand rounded to
// nearest-even bf16 (cvt.rn.bf16x2.f32), the exact products summed in the
// fp32 accumulator over the whole K, each of the plain version's terms in
// its own accumulator -- t1 = Lr Rr, t2 = Li Ri and T = Lr Ri, or Karatsuba's t3 =
// (Lr + Li)(Rr + Ri) with the operand sums formed in fp32 and rounded once
// -- so that the step subtracts and rounds them where the plain version
// does (its fp32 X2r = t1 - t2; with bf16 storage bf(bf(t1) - bf(t2))).
// Three accumulators fit where 3xTF32's two did: a one-pass fragment is a
// packed bf16 pair, no split.  With bf16 storage (BF) the operands are
// bf16-valued already, so every term is exact and the kernel differs from
// the plain version only in the order of the fp32 sums; where that flips
// a bf16 rounding the later low steps carry it (the JAX package accepts
// the MXU's order under the fast tier's noise ceiling).
//
// Plane schedule of one step (X visible to the cluster on entry and exit):
//   X^2 = X X -> W                   (W_i first holds T; after a barrier each
//                                     thread reads T^T at its own elements,
//                                     after another writes T - T^T)
//   X^4 = W W -> registers; after a barrier (every read of W done)
//   Y = a I + b X^2 + c X^4 -> W     (the imaginary part through W_i as above)
//   X Y -> registers; after a barrier X <- X Y, re-projected onto the
//                                     Hermitian subspace (X^T through X)
//                                     unless the step is hi
// The closing product A = X M reads M from W and leaves A in registers; its
// Hermitian part takes A^T through X.  Transposed entries of the peer's
// rows are read over distributed shared memory.  At NC = 1 every barrier
// is __syncthreads; at NC = 2 the barriers that order writes against the
// peer's reads are cluster barriers.
#pragma once

#include <cooperative_groups.h>

#include "fused_solve.cuh"
#include "tc_product.cuh"

namespace pcta {

namespace cg = cooperative_groups;
using admmk::bf16_round;
using admmk::Schedule;

template <int P_, int NC_, int NTW_>
struct Cfg {
  static constexpr int P = P_, NC = NC_, NTW = NTW_;
  static constexpr int ROWS = P / NC;                   // rows of each plane a CTA holds
  static constexpr int BANDS = ROWS / 16;               // 16-row bands: the mma's M
  static constexpr int CG = P / (8 * NTW);              // column groups of NTW 8-column tiles
  static constexpr int NW = BANDS * CG;                 // warps: one per (band, group)
  static constexpr int NT = 32 * NW;                    // threads per CTA
  static constexpr int S = P + 8;                       // row stride: conflict-free B fragments
  static constexpr int PLANE = ROWS * S;                // floats of one plane
  static constexpr int STAGE = (NC - 1) * 2 * ROWS * S; // the peer's rows of a right operand
  static constexpr int SLOTS = 64;                      // reduction partials and published sums
  static constexpr int FLOATS = 4 * PLANE + STAGE + SLOTS;  // the body's shared memory
  static_assert(NC == 1 || NC == 2, "one CTA or a pair per matrix");
  static_assert(ROWS % 16 == 0 && P % (8 * NTW) == 0, "the warp tiles do not cover the rows");
  static_assert(S % 32 == 8 || S % 32 == 24, "B-fragment reads would conflict");
  static_assert(NW <= 32 && SLOTS > NW + 4, "reduction slots");
};
using Cfg112 = Cfg<112, 1, 14>;  // 7 warps, one CTA per matrix
using Cfg128 = Cfg<128, 2, 4>;   // 16 warps, two CTAs per matrix

__device__ __forceinline__ uint32_t neg(uint32_t x) { return x ^ 0x80000000u; }

template <class C>
struct Body {
  static constexpr int NTW = C::NTW, S = C::S, ROWS = C::ROWS;
  using Acc = float[NTW][4];

  float *Xr, *Xi, *Wr, *Wi, *Sr, *Si, *slots;
  int rank, row0, warp, lane, g, q, band, grp, m, kmax8, kmax16;

  __device__ Body(float* smem, int m) {
    Xr = smem;
    Xi = Xr + C::PLANE;
    Wr = Xi + C::PLANE;
    Wi = Wr + C::PLANE;
    Sr = Wi + C::PLANE;
    Si = Sr + C::STAGE / 2;
    slots = Sr + C::STAGE;
    rank = 0;
    if constexpr (C::NC > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
    row0 = rank * ROWS;
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    g = lane >> 2;
    q = lane & 3;
    band = warp / C::CG;
    grp = warp % C::CG;
    this->m = m;
    kmax8 = min(C::P, (m + 7) / 8 * 8);
    kmax16 = min(C::P, (m + 15) / 16 * 16);
  }

  // local row and column of element e of tile j of this warp's output
  __device__ __forceinline__ int lrow(int e) const { return band * 16 + g + 8 * (e >> 1); }
  __device__ __forceinline__ int col(int j, int e) const {
    return (grp * NTW + j) * 8 + 2 * q + (e & 1);
  }
  __device__ __forceinline__ int idx(int j, int e) const { return lrow(e) * S + col(j, e); }

  // every thread of the matrix's CTAs: the barrier that orders writes of
  // a plane against reads of it anywhere
  __device__ __forceinline__ void sync_all() const {
    if constexpr (C::NC == 1)
      __syncthreads();
    else
      cg::this_cluster().sync();
  }

  // entry (r, c) of a plane (r a row of the whole matrix), from its owner
  __device__ __forceinline__ float at(const float* plane, int r, int c) const {
    if constexpr (C::NC == 1) {
      return plane[r * S + c];
    } else {
      const float* p = plane + (r % ROWS) * S + c;
      const int owner = r / ROWS;
      return owner == rank ? *p : *cg::this_cluster().map_shared_rank(p, owner);
    }
  }

  // NC = 2: the peer's rows of the right operand (Rr, Ri) into the stage,
  // in whole rows of float4; after a sync_all that made them final, before
  // a product that reads them.  Ends with __syncthreads.
  __device__ void stage(const float* Rr, const float* Ri) const {
    if constexpr (C::NC == 2) {
      constexpr int Q4 = C::P / 4, PER = 2 * ROWS * Q4 / C::NT;
      static_assert(PER * C::NT == 2 * ROWS * Q4, "staging does not tile the half");
      cg::cluster_group cl = cg::this_cluster();
      const float* pr = cl.map_shared_rank(Rr, rank ^ 1);
      const float* pi = cl.map_shared_rank(Ri, rank ^ 1);
      constexpr int CH = 4;  // float4 in flight per thread
      static_assert(PER % CH == 0, "staging chunks");
#pragma unroll
      for (int u0 = 0; u0 < PER; u0 += CH) {
        float4 v[CH];
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const int e = threadIdx.x + (u0 + u) * C::NT;
          const int pl = e / (ROWS * Q4), rem = e % (ROWS * Q4);
          const float* src = (pl ? pi : pr) + (rem / Q4) * S + 4 * (rem % Q4);
          v[u] = *reinterpret_cast<const float4*>(src);
        }
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const int e = threadIdx.x + (u0 + u) * C::NT;
          const int pl = e / (ROWS * Q4), rem = e % (ROWS * Q4);
          *reinterpret_cast<float4*>((pl ? Si : Sr) + (rem / Q4) * S + 4 * (rem % Q4)) = v[u];
        }
      }
      __syncthreads();
    }
  }

  // row k of a right operand held in (R: own rows, St: the staged peer rows)
  __device__ __forceinline__ const float* rrow(const float* R, const float* St, int k) const {
    if constexpr (C::NC == 1) {
      return R + k * S;
    } else {
      return (k >= row0 && k < row0 + ROWS) ? R + (k - row0) * S : St + (k % ROWS) * S;
    }
  }

  // c0 = Lr Rr - Li Ri, c1 = Lr Ri (+ Li Rr with FULL) in 3xTF32 over the
  // first kmax8 k; L: this CTA's rows, R: own rows and the stage.
  template <bool FULL>
  __device__ void product32(const float* Lr, const float* Li, const float* Rr, const float* Ri,
                            Acc& c0, Acc& c1) const {
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c0[j][e] = c1[j][e] = 0.f;
    const int r0 = band * 16 + g;
    const int n0 = grp * NTW * 8 + g;
    for (int k0 = 0; k0 < kmax8; k0 += 8) {
      tcp::AFrag ar, ai, ni;
      const int ia[4] = {r0 * S + k0 + q, (r0 + 8) * S + k0 + q, r0 * S + k0 + q + 4,
                         (r0 + 8) * S + k0 + q + 4};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tcp::split(Lr[ia[e]], ar.hi[e], ar.lo[e]);
        tcp::split(Li[ia[e]], ai.hi[e], ai.lo[e]);
        ni.hi[e] = neg(ai.hi[e]);
        ni.lo[e] = neg(ai.lo[e]);
      }
      const float* br = rrow(Rr, Sr, k0) + q * S + n0;
      const float* bi = rrow(Ri, Si, k0) + q * S + n0;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        tcp::BFrag fr, fi;
        tcp::split(br[8 * j], fr.hi[0], fr.lo[0]);
        tcp::split(br[4 * S + 8 * j], fr.hi[1], fr.lo[1]);
        tcp::split(bi[8 * j], fi.hi[0], fi.lo[0]);
        tcp::split(bi[4 * S + 8 * j], fi.hi[1], fi.lo[1]);
        float p0[4], p1[4];
        tcp::mma_new(p0, ar.lo, fr.hi);
        tcp::mma(p0, ar.hi, fr.lo);
        tcp::mma(p0, ni.lo, fi.hi);
        tcp::mma(p0, ni.hi, fi.lo);
        tcp::mma(p0, ar.hi, fr.hi);
        tcp::mma(p0, ni.hi, fi.hi);
        tcp::mma_new(p1, ar.lo, fi.hi);
        tcp::mma(p1, ar.hi, fi.lo);
        if constexpr (FULL) {
          tcp::mma(p1, ai.lo, fr.hi);
          tcp::mma(p1, ai.hi, fr.lo);
        }
        tcp::mma(p1, ar.hi, fi.hi);
        if constexpr (FULL) tcp::mma(p1, ai.hi, fr.hi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          c0[j][e] += p0[e];
          c1[j][e] += p1[e];
        }
      }
    }
  }

  // One-pass products over the first kmax16 k (module header): t1 = Lr Rr,
  // t2 = Li Ri and t3 (KARA: (Lr + Li)(Rr + Ri), the operand sums formed in
  // fp32; else Lr Ri), each operand rounded to bf16, each term in its own
  // fp32 accumulator.  A register of a fragment holds PTX's k pair (2q, 2q
  // + 1) or (2q + 8, 2q + 9), read from columns / rows (q, q + 4) or (q +
  // 8, q + 12) of the 16-deep step (tc_product.cuh's order).
  template <bool KARA>
  __device__ void product16(const float* Lr, const float* Li, const float* Rr, const float* Ri,
                            Acc& t1, Acc& t2, Acc& t3) const {
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t1[j][e] = t2[j][e] = t3[j][e] = 0.f;
    const int r0 = band * 16 + g;
    const int n0 = grp * NTW * 8 + g;
    for (int k0 = 0; k0 < kmax16; k0 += 16) {
      tcp::CAFrag16 a;
      const int ia[4] = {r0 * S + k0 + q, (r0 + 8) * S + k0 + q, r0 * S + k0 + q + 8,
                         (r0 + 8) * S + k0 + q + 8};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xr0 = Lr[ia[e]], xr1 = Lr[ia[e] + 4];
        const float xi0 = Li[ia[e]], xi1 = Li[ia[e] + 4];
        a.r[e] = tcp::pack_bf16(xr0, xr1);
        a.i[e] = tcp::pack_bf16(xi0, xi1);
        if (KARA) a.s[e] = tcp::pack_bf16(xr0 + xi0, xr1 + xi1);
      }
      const float* br = rrow(Rr, Sr, k0) + q * S + n0;
      const float* bi = rrow(Ri, Si, k0) + q * S + n0;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        tcp::CBFrag16 b;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float yr0 = br[8 * e * S + 8 * j], yr1 = br[(8 * e + 4) * S + 8 * j];
          const float yi0 = bi[8 * e * S + 8 * j], yi1 = bi[(8 * e + 4) * S + 8 * j];
          b.r[e] = tcp::pack_bf16(yr0, yr1);
          b.i[e] = tcp::pack_bf16(yi0, yi1);
          if (KARA) b.s[e] = tcp::pack_bf16(yr0 + yi0, yr1 + yi1);
        }
        tcp::mma16(t1[j], a.r, b.r);
        tcp::mma16(t2[j], a.i, b.i);
        if constexpr (KARA)
          tcp::mma16(t3[j], a.s, b.s);
        else
          tcp::mma16(t3[j], a.r, b.i);
      }
    }
  }

  // Sum of one value per thread over the CTA, every thread the same
  // result in the same order.
  __device__ float cta_sum(float v) const {
    v = admmk::warp_sum(v);
    if (lane == 0) slots[warp] = v;
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < C::NW; ++w) s += slots[w];
    __syncthreads();  // the slots may be reused right after
    return s;
  }

  // Sum over the whole matrix: the CTA's sum, then (NC = 2) both CTAs'
  // in rank order, the same value in each.  Calls are separated by far
  // more cluster barriers than the peer needs to read the published sum.
  __device__ float matrix_sum(float v) const {
    float s = cta_sum(v);
    if constexpr (C::NC == 2) {
      float* pub = slots + C::NW;
      if (threadIdx.x == 0) *pub = s;
      cg::cluster_group cl = cg::this_cluster();
      cl.sync();
      s = *cl.map_shared_rank(pub, 0) + *cl.map_shared_rank(pub, 1);
    }
    return s;
  }

  // c0 = Lr Rr - Li Ri, c1 = Lr Ri (FULL: Lr Ri + Li Rr), fp32 products;
  // ONE: one-pass, c1 = Lr Ri (FULL: Karatsuba's imaginary part), t scratch
  template <bool ONE, bool FULL>
  __device__ __forceinline__ void product(const float* Lr, const float* Li, const float* Rr,
                                          const float* Ri, Acc& c0, Acc& c1, Acc& t) const {
    if constexpr (ONE) {
      product16<FULL>(Lr, Li, Rr, Ri, c0, t, c1);
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (FULL) c1[j][e] = (c1[j][e] - c0[j][e]) - t[j][e];
          c0[j][e] = c0[j][e] - t[j][e];
        }
    } else {
      product32<FULL>(Lr, Li, Rr, Ri, c0, c1);
    }
  }

  // One step on the fp32 iterate, its products fp32 or (ONE) one-pass; a
  // step that is not hi is re-projected.
  template <bool ONE>
  __device__ void step32(float a, float b, float c, bool reproject) const {
    Acc c0, c1, t;
    // X^2 = X X: X2r = XrXr - XiXi, X2i = T - T^T with T = Xr Xi
    stage(Xr, Xi);
    product<ONE, false>(Xr, Xi, Xr, Xi, c0, c1, t);
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Wr[idx(j, e)] = c0[j][e];
        Wi[idx(j, e)] = c1[j][e];
      }
    transpose_into(Wi, t);
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) Wi[idx(j, e)] = c1[j][e] - t[j][e];
    sync_all();  // X^2 visible
    // X^4 = X^2 X^2, then Y = a I + b X^2 + c X^4 over W
    stage(Wr, Wi);
    product<ONE, false>(Wr, Wi, Wr, Wi, c0, c1, t);
    Acc x2i;
    sync_all();  // every read of W done
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = idx(j, e);
        const float eye = row0 + lrow(e) == col(j, e) ? a : 0.f;
        Wr[i] = (eye + b * Wr[i]) + c * c0[j][e];
        x2i[j][e] = Wi[i];
        Wi[i] = c1[j][e];
      }
    transpose_into(Wi, t);
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) Wi[idx(j, e)] = b * x2i[j][e] + c * (c1[j][e] - t[j][e]);
    sync_all();  // Y visible
    // X <- X Y
    stage(Wr, Wi);
    product<ONE, true>(Xr, Xi, Wr, Wi, c0, c1, t);
    __syncthreads();  // this CTA's reads of X (only it reads X as a left operand)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Xr[idx(j, e)] = c0[j][e];
        Xi[idx(j, e)] = c1[j][e];
      }
    if (reproject) {
      Acc u;
      transpose_pair(t, u);
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          Xr[idx(j, e)] = 0.5f * (c0[j][e] + t[j][e]);
          Xi[idx(j, e)] = 0.5f * (c1[j][e] - u[j][e]);
        }
    }
    sync_all();  // the new X visible
  }

  // One low step with bf16 storage: every product one-pass and rounded
  // once, every elementwise result rounded, as psd_project_polar_plain's
  // bf16_step.
  __device__ void step16(float a, float b, float c) const {
    Acc t1, t2, t3, t;
    // X^2: X2r = bf(bf(XrXr) - bf(XiXi)), X2i = bf(T - T^T), T = bf(XrXi)
    stage(Xr, Xi);
    product16<false>(Xr, Xi, Xr, Xi, t1, t2, t3);
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Wr[idx(j, e)] = bf16_round(bf16_round(t1[j][e]) - bf16_round(t2[j][e]));
        t3[j][e] = bf16_round(t3[j][e]);
        Wi[idx(j, e)] = t3[j][e];
      }
    transpose_into(Wi, t);
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) Wi[idx(j, e)] = bf16_round(t3[j][e] - t[j][e]);
    sync_all();
    // X^4 and Y = bf(bf(a I + bf(b X2)) + bf(c X4)) over W
    stage(Wr, Wi);
    product16<false>(Wr, Wi, Wr, Wi, t1, t2, t3);
    Acc x2i;
    sync_all();
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = idx(j, e);
        const float eye = row0 + lrow(e) == col(j, e) ? a : 0.f;
        const float x4r = bf16_round(bf16_round(t1[j][e]) - bf16_round(t2[j][e]));
        Wr[i] = bf16_round(bf16_round(eye + bf16_round(b * Wr[i])) + bf16_round(c * x4r));
        x2i[j][e] = Wi[i];
        t3[j][e] = bf16_round(t3[j][e]);
        Wi[i] = t3[j][e];
      }
    transpose_into(Wi, t);
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x4i = bf16_round(t3[j][e] - t[j][e]);
        Wi[idx(j, e)] = bf16_round(bf16_round(b * x2i[j][e]) + bf16_round(c * x4i));
      }
    sync_all();
    // X Y (Karatsuba), then its Hermitian part
    stage(Wr, Wi);
    product16<true>(Xr, Xi, Wr, Wi, t1, t2, t3);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float r1 = bf16_round(t1[j][e]), r2 = bf16_round(t2[j][e]);
        t1[j][e] = bf16_round(r1 - r2);
        t2[j][e] = bf16_round(bf16_round(bf16_round(t3[j][e]) - r1) - r2);
        Xr[idx(j, e)] = t1[j][e];
        Xi[idx(j, e)] = t2[j][e];
      }
    Acc u;
    transpose_pair(t, u);
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Xr[idx(j, e)] = bf16_round(0.5f * bf16_round(t1[j][e] + t[j][e]));
        Xi[idx(j, e)] = bf16_round(0.5f * bf16_round(t2[j][e] - u[j][e]));
      }
    sync_all();
  }

  // t = the transposed entries of plane P at this thread's elements, after
  // a barrier that makes P's own entries (just written) visible; ends with
  // a barrier after which P may be overwritten.
  __device__ void transpose_into(const float* Pl, Acc& t) const {
    sync_all();
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[j][e] = at(Pl, col(j, e), row0 + lrow(e));
    sync_all();
  }
  // the same for X's two planes
  __device__ void transpose_pair(Acc& tr, Acc& ti) const {
    sync_all();
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tr[j][e] = at(Xr, col(j, e), row0 + lrow(e));
        ti[j][e] = at(Xi, col(j, e), row0 + lrow(e));
      }
    sync_all();
  }

  // X <- the sign schedule applied to X (scaled, visible on entry).  Step s
  // is hi iff s >= nsteps - hi_steps; a step that is not hi is re-projected
  // and its products are one-pass; with BF it runs with bf16 storage (X
  // bf16-valued on entry).  LOW: the caller's schedules have low steps (K7's
  // is all hi, so its kernel builds no one-pass product).
  template <bool BF, bool LOW>
  __device__ void sign_schedule(const Schedule& sched, int hi_steps) const {
    for (int s = 0; s < sched.n; ++s) {
      const bool hi = s >= sched.n - hi_steps;
      if constexpr (BF) {
        if (!hi) {
          step16(bf16_round(sched.a[s]), bf16_round(sched.b[s]), bf16_round(sched.c[s]));
          continue;
        }
      }
      if constexpr (LOW && !BF) {
        if (!hi) {
          step32<true>(sched.a[s], sched.b[s], sched.c[s], true);
          continue;
        }
      }
      step32<false>(sched.a[s], sched.b[s], sched.c[s], !hi);
    }
  }

  // (ar, ai) = herm(X M), M in W (visible on entry); overwrites X.
  __device__ void abs_product(Acc& ar, Acc& ai) const {
    stage(Wr, Wi);
    product32<true>(Xr, Xi, Wr, Wi, ar, ai);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Xr[idx(j, e)] = ar[j][e];
        Xi[idx(j, e)] = ai[j][e];
      }
    Acc tr, ti;
    transpose_pair(tr, ti);
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ar[j][e] = 0.5f * (ar[j][e] + tr[j][e]);
        ai[j][e] = 0.5f * (ai[j][e] - ti[j][e]);
      }
  }
};

// Launch of kernel on B matrices or instances: B CTAs (NC = 1) or B
// clusters of two (NC = 2), NT threads and `floats` of dynamic shared
// memory each.  Returns the launch's cudaError_t.
template <class C, class Kernel, class... Args>
int launch(Kernel kernel, int B, int floats, void* stream, Args... args) {
  const int bytes = floats * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C::NC);
  cfg.blockDim = dim3(C::NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C::NC > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The first-generation solve's H-projection (the JAX kernel's
// _project_sum_inf_row), in warp 0 on the logical entries lane + 32 q
// (q < 4, masked to n).
//
// h(mu) = v - Proj_{||x||_1 <= mu A}(v), v = t - mu (masked to n): the l1
// projection by bisection on the soft threshold over [0, max |v|], then
// rescaled onto the sphere; v itself when it lies inside the ball.
__device__ __forceinline__ void h_nested(const float (&t)[4], int n, float mu, float A,
                                         int inner, float (&h)[4]) {
  using admmk::warp_max;
  using admmk::warp_sum;
  const int lane = threadIdx.x % 32;
  const float radius = mu * A;
  float v[4], av[4], s = 0.f, mx = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = lane + 32 * q < n ? t[q] - mu : 0.f;
    av[q] = fabsf(v[q]);
    s += av[q];
    mx = fmaxf(mx, av[q]);
  }
  const bool inside = warp_sum(s) <= radius;
  float lo = 0.f, hi = warp_max(mx);
  for (int k = 0; k < inner; ++k) {
    const float tau = 0.5f * (lo + hi);
    float part = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) part += fmaxf(av[q] - tau, 0.f);
    if (warp_sum(part) > radius)
      lo = tau;
    else
      hi = tau;
  }
  const float tau = 0.5f * (lo + hi);
  float x[4], xs = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    x[q] = fmaxf(av[q] - tau, 0.f);  // 0 on masked entries
    xs += x[q];
  }
  xs = warp_sum(xs);
  const float scale = xs > 0.f ? radius / fmaxf(xs, 1e-30f) : 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float sgn = v[q] > 0.f ? 1.f : (v[q] < 0.f ? -1.f : 0.f);
    const float p = inside ? v[q] : sgn * (x[q] * scale);
    h[q] = lane + 32 * q < n ? v[q] - p : 0.f;
  }
}

// Projection of t (masked to n) onto {A ||h||_inf + sum h <= 1}, warp 0:
// bisection on mu over [0, max(1, |t|^2 / 2 + 1)], then h(hi), and t where
// t is feasible.  Always cold.
__device__ __forceinline__ void nested_projection(const float (&t)[4], int n, float A, int outer,
                                                  int inner, float (&h)[4]) {
  const bool feasible = admmk::f_of(t, A) <= 1.f;
  float tt = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) tt += t[q] * t[q];
  float lo = 0.f, hi = fmaxf(1.f, 0.5f * admmk::warp_sum(tt) + 1.f);
  for (int k = 0; k < outer; ++k) {
    const float mu = 0.5f * (lo + hi);
    h_nested(t, n, mu, A, inner, h);
    if (admmk::f_of(h, A) > 1.f)
      lo = mu;
    else
      hi = mu;
  }
  h_nested(t, n, hi, A, inner, h);
  if (feasible) {
#pragma unroll
    for (int q = 0; q < 4; ++q) h[q] = t[q];
  }
}

}  // namespace pcta
