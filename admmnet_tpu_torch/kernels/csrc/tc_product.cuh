// Tensor-core complex products for kernels that keep a matrix's planes on
// chip across a thread-block cluster, in the precision tiers of the JAX
// package: fp32-faithful products (its HIGHEST), the 3-pass split-bf16
// product (three_pass) and one-pass products (its DEFAULT), each on the
// tensor cores.
//
// Layout: a P x P complex matrix (P = 112 or 128, zero-padded past its
// logical side) is split into P / 16 row bands of 16 rows; CTA q of a
// cluster of P / 16 CTAs holds band q of every plane in its own shared
// memory, each band a 16 x P float array with row stride SA.  A product
// C = L R of a local left band L (16 x P) and a right operand R held across
// the cluster needs R's K rows band by band: band q is read from CTA q
// through distributed shared memory (cluster.map_shared_rank) into a local
// double buffer (row stride SB), the next band's loads in flight while the
// current one feeds the tensor cores.  CTA r starts with its own band and
// walks the others in rank order from there, so in each round every CTA
// serves one reader.
//
// fp32 products (Prec::TF32X3): mma.sync m16n8k8 TF32 with fp32
// accumulation, in the 3xTF32 split x = hi + lo, hi = tf32_rn(x), lo = x -
// hi (exact; the tensor core reads its top 19 bits), x y ~ lo_x hi_y + hi_x
// lo_y + hi_x hi_y: the dropped lo_x lo_y term and lo's truncation leave
// ~2^-21 relative per product, fp32's level.  Each 8-deep step's sum starts
// fresh and is added to the running sum in fp32 (the tensor cores truncate
// what they accumulate).  A complex product is the 3-product Karatsuba form
// t1 = Lr Rr, t2 = Li Ri, t3 = (Lr + Li)(Rr + Ri), Cr = t1 - t2, Ci = t3 -
// t1 - t2; the operand sums are formed in fp32 before the split, so no
// temporary plane is needed and the three real products accumulate in
// registers.
//
// Split-bf16 products (Prec::SPLIT): the 3-pass contract of
// kernels/polar.py's split product (mm with split), x y ~ xh yh + xh yl +
// xl yh with xh = bf16_rn(x), xl = x - xh, realized as xh y + xl yh: xh is
// exact in TF32, so xh y is two mma against y's TF32 split, and xl yh two
// mma of xl's TF32 split against yh.  The dropped xl yl is the contract's
// own; what the tensor cores add is fp32's level (~2^-21).  Four mma per
// real product instead of three.
//
// One-pass products (Prec::ONE_PASS, K2/K3's tier for the products of a
// step that is not hi): one mma.sync m16n8k8 TF32 per real product and
// 8-deep step, each operand rounded to tf32 (to_tf32: the hi part of the
// split alone; Karatsuba's operand sums formed in fp32 and rounded once),
// its exact products summed in the mma's fp32 accumulator over the whole
// K (at tf32's 2^-11 the tensor cores' truncated sums, ~2^-23 a step, cost
// nothing).  The JAX package's DEFAULT is a bf16 one-pass product; K2 and
// K3 take tf32 because at bf16 two valid summation orders of the same
// arithmetic leave phi further apart after 100 iterations than the gate
// that holds the kernel to its plain version allows (PERF.md, section 6).
//
// bf16 one-pass products (Prec::ONE_PASS_BF16, K4/K5's Clenshaw steps;
// polar_cta.cuh's K1 uses the same helpers): one mma.sync m16n8k16 bf16
// per real product and 16-deep step, each operand rounded to nearest-even
// bf16 (pack_bf16: cvt.rn.bf16x2.f32, two values a register; Karatsuba's
// operand sums formed in fp32 and rounded once), the exact products summed
// in the mma's fp32 accumulator over the whole K.
//
// Split-bf16 products as the TPU's MXU computes them (Prec::SPLIT_BF16,
// K6's three_pass tier): the JAX package's _mm3, ah bh + ah bl + al bh with
// xh = bf16_rn(x) and xl = bf16_rn(x - xh) (its three products are
// one-pass DEFAULT products, which round the residual to bf16 too): three
// m16n8k16 bf16 mma per real product and 16-deep step, the small terms
// first, summed in the accumulator over the whole K.  Against Prec::SPLIT
// it drops xl's bits below bf16 (~2^-16 relative, the size of the
// contract's own dropped xl yl) and issues three bf16 mma where SPLIT
// issues eight TF32 m16n8k8 for the same depth.
//
// A split or one-pass product that must round the same operands as the
// Hermitian square's three products (KARA = false) takes the
// 4-multiplication form instead of Karatsuba's: Cr = Lr Rr - Li Ri, Ci =
// Lr Ri + Li Rr, whose terms are the square's (Li Rr = -(Lr Ri)^T for a
// Hermitian square).
//
// Warps: P / 16; warp w owns output columns [16 w, 16 w + 16) of the band,
// two 8-column n-tiles, for every product.  Fragment and accumulator
// layouts are PTX's for m16n8k8 .tf32: with g = lane / 4 and q = lane % 4,
// a = {L[g][k+q], L[g+8][k+q], L[g][k+q+4], L[g+8][k+q+4]}, b = {R[k+q][n+g],
// R[k+q+4][n+g]}, d = {C[g][n+2q], C[g][n+2q+1], C[g+8][n+2q],
// C[g+8][n+2q+1]}.  For m16n8k16 .bf16 the accumulator layout is the same,
// and a register holds two k of a fragment: PTX's k = 2q + i (i = 0, 1) and
// 2q + 8 + i.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tcp {

namespace cg = cooperative_groups;

constexpr int BAND = 16;  // rows of a band: the mma's M
constexpr int NPW = 2;    // 8-column n-tiles per warp

template <int P>
struct Layout {
  static constexpr int NC = P / BAND;         // CTAs (bands) per cluster
  static constexpr int NT = 32 * NC;          // threads per CTA: one warp per 16 columns
  static constexpr int SA = P + 4;            // band row stride: conflict-free A fragments
  static constexpr int SB = P + 8;            // staged row stride: conflict-free B fragments
  static constexpr int PLANE = BAND * SA;     // floats of one band plane
  static constexpr int SLICE = BAND * SB;     // floats of one staged band
  static constexpr int NV = 2 * BAND * P / 4 / NT;  // float4 per thread per staged band
  static_assert(SA % 32 == 4 || SA % 32 == 20, "A-fragment reads would conflict");
  static_assert(SB % 32 == 8 || SB % 32 == 24, "B-fragment reads would conflict");
  static_assert(NV * NT * 4 == 2 * BAND * P, "staging does not tile the band");
};

// tf32_rn(x), ties away from zero, by integer ops on the full-rate pipes
// (cvt.rna.tf32.f32 lowers to a longer compare-and-select sequence): add
// half of the dropped 13 bits' range to the magnitude, then clear them
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct AFrag {
  uint32_t hi[4], lo[4];
};
struct BFrag {
  uint32_t hi[2], lo[2];
};

// x = hi + lo exactly; the tensor core reads lo's top 19 bits (truncation,
// as CUTLASS's 3xTF32 passes its small part), 2^-21 |x| at most
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b (the accumulator input is zero)
__device__ __forceinline__ void mma_new(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// d = a b in 3xTF32, the small cross terms first
__device__ __forceinline__ void mma3_new(float (&d)[4], const AFrag& a, const BFrag& b) {
  mma_new(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// Split-bf16 fragments: a left value x = h + l1 + l2 with h = bf16_rn(x) and
// (l1, l2) the TF32 split of x - h; a right value y = t1 + t2 (its TF32
// split) with h = bf16_rn(y).
struct SAFrag {
  uint32_t h[4], l1[4], l2[4];
};
struct SBFrag {
  uint32_t t1[2], t2[2], h[2];
};

__device__ __forceinline__ uint32_t to_bf16(float x) {
  return __float_as_uint(__bfloat162float(__float2bfloat16_rn(x)));
}

__device__ __forceinline__ void split_left(float x, uint32_t& h, uint32_t& l1, uint32_t& l2) {
  h = to_bf16(x);
  split(x - __uint_as_float(h), l1, l2);  // x - h is exact
}

__device__ __forceinline__ void split_right(float y, uint32_t& t1, uint32_t& t2, uint32_t& h) {
  split(y, t1, t2);
  h = to_bf16(y);
}

// d (+)= xh y + xl yh, the small terms first
__device__ __forceinline__ void mmabf(float (&d)[4], const SAFrag& a, const SBFrag& b) {
  mma(d, a.l2, b.h);
  mma(d, a.l1, b.h);
  mma(d, a.h, b.t2);
  mma(d, a.h, b.t1);
}
__device__ __forceinline__ void mmabf_new(float (&d)[4], const SAFrag& a, const SBFrag& b) {
  mma_new(d, a.l2, b.h);
  mma(d, a.l1, b.h);
  mma(d, a.h, b.t2);
  mma(d, a.h, b.t1);
}

// Two values rounded to nearest-even bf16, packed: lo in bits 0-15, hi in
// bits 16-31 (one cvt.rn.bf16x2.f32)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// d += a b, one-pass: bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Split-bf16 halves of two values: h = bf16_rn(x) and l = bf16_rn(x - h),
// each pair packed as pack_bf16 packs it (x - h is exact in fp32)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& h, uint32_t& l) {
  h = pack_bf16(x0, x1);
  l = pack_bf16(x0 - __uint_as_float(h << 16), x1 - __uint_as_float(h & 0xffff0000u));
}

// Fragments of a complex operand: real part, imaginary part, their sum.
struct CAFrag {
  AFrag r, i, s;
};
struct CBFrag {
  BFrag r, i, s;
};
struct CSAFrag {
  SAFrag r, i, s;
};
struct CSBFrag {
  SBFrag r, i, s;
};
// bf16 one-pass fragments of a 16-deep step (polar_cta.cuh): real part,
// imaginary part and (Karatsuba) their fp32 sum, each rounded to bf16 and
// packed.
struct CAFrag16 {
  uint32_t r[4], i[4], s[4];
};
struct CBFrag16 {
  uint32_t r[2], i[2], s[2];
};
// Split-bf16 fragments of a 16-deep step: the bf16 halves h and l of each
// part, packed.
struct SAFrag16 {
  uint32_t h[4], l[4];
};
struct SBFrag16 {
  uint32_t h[2], l[2];
};
struct CSAFrag16 {
  SAFrag16 r, i, s;
};
struct CSBFrag16 {
  SBFrag16 r, i, s;
};
// Karatsuba accumulators of one complex n-tile (the 4-multiplication form
// keeps Lr Ri + Li Rr in t3).
struct CAcc {
  float t1[4], t2[4], t3[4];
};

__device__ __forceinline__ void zero(CAcc& c) {
#pragma unroll
  for (int e = 0; e < 4; ++e) c.t1[e] = c.t2[e] = c.t3[e] = 0.f;
}

// acc += part in IEEE fp32 (round to nearest).  The tensor cores truncate
// the sum they accumulate; folding each 8-deep step's fresh sum this way
// keeps the truncation to one step's partial sum, not the running one
// (which carried ~10x fp32's error through the backward's 46 steps).
__device__ __forceinline__ void fold(CAcc& acc, const CAcc& part) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc.t1[e] += part.t1[e];
    acc.t2[e] += part.t2[e];
    acc.t3[e] += part.t3[e];
  }
}

// (Cr, Ci) of element e from the Karatsuba accumulators
__device__ __forceinline__ float acc_re(const CAcc& c, int e) { return c.t1[e] - c.t2[e]; }
__device__ __forceinline__ float acc_im(const CAcc& c, int e) { return c.t3[e] - c.t1[e] - c.t2[e]; }
__device__ __forceinline__ float acc_im4(const CAcc& c, int e) { return c.t3[e]; }

// Left fragment at columns [k0, k0 + 8) of a band plane pair.
template <int SA>
__device__ __forceinline__ void load_a(CAFrag& f, const float* Lr, const float* Li, int k0,
                                       int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int idx[4] = {g * SA + k0 + q, (g + 8) * SA + k0 + q, g * SA + k0 + q + 4,
                      (g + 8) * SA + k0 + q + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float xr = Lr[idx[e]], xi = Li[idx[e]];
    split(xr, f.r.hi[e], f.r.lo[e]);
    split(xi, f.i.hi[e], f.i.lo[e]);
    split(xr + xi, f.s.hi[e], f.s.lo[e]);
  }
}

// Right fragment at rows [k0, k0 + 8), columns [n0, n0 + 8) of a staged block.
template <int SB>
__device__ __forceinline__ void load_b(CBFrag& f, const float* Sr, const float* Si, int k0, int n0,
                                       int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int idx[2] = {(k0 + q) * SB + n0 + g, (k0 + q + 4) * SB + n0 + g};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float xr = Sr[idx[e]], xi = Si[idx[e]];
    split(xr, f.r.hi[e], f.r.lo[e]);
    split(xi, f.i.hi[e], f.i.lo[e]);
    split(xr + xi, f.s.hi[e], f.s.lo[e]);
  }
}

// c = the Karatsuba products of one 8-deep step, fresh
__device__ __forceinline__ void karatsuba_mma(CAcc& c, const CAFrag& a, const CBFrag& b) {
  mma3_new(c.t1, a.r, b.r);
  mma3_new(c.t2, a.i, b.i);
  mma3_new(c.t3, a.s, b.s);
}

// Split-bf16 fragments at the same positions as load_a / load_b; KARA also
// splits the operand sums.
template <int SA, bool KARA>
__device__ __forceinline__ void load_a_bf(CSAFrag& f, const float* Lr, const float* Li, int k0,
                                          int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int idx[4] = {g * SA + k0 + q, (g + 8) * SA + k0 + q, g * SA + k0 + q + 4,
                      (g + 8) * SA + k0 + q + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float xr = Lr[idx[e]], xi = Li[idx[e]];
    split_left(xr, f.r.h[e], f.r.l1[e], f.r.l2[e]);
    split_left(xi, f.i.h[e], f.i.l1[e], f.i.l2[e]);
    if (KARA) split_left(xr + xi, f.s.h[e], f.s.l1[e], f.s.l2[e]);
  }
}

template <int SB, bool KARA>
__device__ __forceinline__ void load_b_bf(CSBFrag& f, const float* Sr, const float* Si, int k0,
                                          int n0, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int idx[2] = {(k0 + q) * SB + n0 + g, (k0 + q + 4) * SB + n0 + g};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float xr = Sr[idx[e]], xi = Si[idx[e]];
    split_right(xr, f.r.t1[e], f.r.t2[e], f.r.h[e]);
    split_right(xi, f.i.t1[e], f.i.t2[e], f.i.h[e]);
    if (KARA) split_right(xr + xi, f.s.t1[e], f.s.t2[e], f.s.h[e]);
  }
}

// c = one 8-deep step's split-bf16 products, fresh: Karatsuba's three, or
// the 4-multiplication form's t1 = Lr Rr, t2 = Li Ri, t3 = Lr Ri + Li Rr
template <bool KARA>
__device__ __forceinline__ void split_mma(CAcc& c, const CSAFrag& a, const CSBFrag& b) {
  mmabf_new(c.t1, a.r, b.r);
  mmabf_new(c.t2, a.i, b.i);
  if (KARA) {
    mmabf_new(c.t3, a.s, b.s);
  } else {
    mmabf_new(c.t3, a.r, b.i);
    mmabf(c.t3, a.i, b.r);
  }
}

// One-pass fragments at the positions of load_a / load_b: each operand
// (KARA: and the fp32 operand sums) rounded to tf32, the hi part of the
// 3xTF32 split alone.
template <int SA, bool KARA>
__device__ __forceinline__ void load_a_tf32(CAFrag& f, const float* Lr, const float* Li, int k0,
                                            int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int idx[4] = {g * SA + k0 + q, (g + 8) * SA + k0 + q, g * SA + k0 + q + 4,
                      (g + 8) * SA + k0 + q + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float xr = Lr[idx[e]], xi = Li[idx[e]];
    f.r.hi[e] = to_tf32(xr);
    f.i.hi[e] = to_tf32(xi);
    if (KARA) f.s.hi[e] = to_tf32(xr + xi);
  }
}

template <int SB, bool KARA>
__device__ __forceinline__ void load_b_tf32(CBFrag& f, const float* Sr, const float* Si, int k0,
                                            int n0, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int idx[2] = {(k0 + q) * SB + n0 + g, (k0 + q + 4) * SB + n0 + g};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float xr = Sr[idx[e]], xi = Si[idx[e]];
    f.r.hi[e] = to_tf32(xr);
    f.i.hi[e] = to_tf32(xi);
    if (KARA) f.s.hi[e] = to_tf32(xr + xi);
  }
}

// c += one 8-deep step's one-pass products: Karatsuba's three, or the
// 4-multiplication form's t1 = Lr Rr, t2 = Li Ri, t3 = Lr Ri + Li Rr
template <bool KARA>
__device__ __forceinline__ void one_pass_mma(CAcc& c, const CAFrag& a, const CBFrag& b) {
  mma(c.t1, a.r.hi, b.r.hi);
  mma(c.t2, a.i.hi, b.i.hi);
  if (KARA) {
    mma(c.t3, a.s.hi, b.s.hi);
  } else {
    mma(c.t3, a.r.hi, b.i.hi);
    mma(c.t3, a.i.hi, b.r.hi);
  }
}

// bf16 fragments of a 16-deep step at columns (left) or rows (right)
// [k0, k0 + 16): a register holds PTX's k pair (2q, 2q + 1) or (2q + 8,
// 2q + 9), read from columns / rows (q, q + 4) or (q + 8, q + 12) of the
// step (the same relabelling of k on both sides, so the sum is unchanged).
// load_a16 / load_b16 round each value to bf16, the _split forms split it
// into its bf16 halves; KARA also forms the fp32 operand sums.
template <int SA, bool KARA>
__device__ __forceinline__ void load_a16(CAFrag16& f, const float* Lr, const float* Li, int k0,
                                         int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int idx[4] = {g * SA + k0 + q, (g + 8) * SA + k0 + q, g * SA + k0 + q + 8,
                      (g + 8) * SA + k0 + q + 8};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float xr0 = Lr[idx[e]], xr1 = Lr[idx[e] + 4];
    const float xi0 = Li[idx[e]], xi1 = Li[idx[e] + 4];
    f.r[e] = pack_bf16(xr0, xr1);
    f.i[e] = pack_bf16(xi0, xi1);
    if (KARA) f.s[e] = pack_bf16(xr0 + xi0, xr1 + xi1);
  }
}

template <int SB, bool KARA>
__device__ __forceinline__ void load_b16(CBFrag16& f, const float* Sr, const float* Si, int k0,
                                         int n0, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int idx[2] = {(k0 + q) * SB + n0 + g, (k0 + q + 8) * SB + n0 + g};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float yr0 = Sr[idx[e]], yr1 = Sr[idx[e] + 4 * SB];
    const float yi0 = Si[idx[e]], yi1 = Si[idx[e] + 4 * SB];
    f.r[e] = pack_bf16(yr0, yr1);
    f.i[e] = pack_bf16(yi0, yi1);
    if (KARA) f.s[e] = pack_bf16(yr0 + yi0, yr1 + yi1);
  }
}

template <int SA, bool KARA>
__device__ __forceinline__ void load_a16_split(CSAFrag16& f, const float* Lr, const float* Li,
                                               int k0, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int idx[4] = {g * SA + k0 + q, (g + 8) * SA + k0 + q, g * SA + k0 + q + 8,
                      (g + 8) * SA + k0 + q + 8};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float xr0 = Lr[idx[e]], xr1 = Lr[idx[e] + 4];
    const float xi0 = Li[idx[e]], xi1 = Li[idx[e] + 4];
    split_bf16(xr0, xr1, f.r.h[e], f.r.l[e]);
    split_bf16(xi0, xi1, f.i.h[e], f.i.l[e]);
    if (KARA) split_bf16(xr0 + xi0, xr1 + xi1, f.s.h[e], f.s.l[e]);
  }
}

template <int SB, bool KARA>
__device__ __forceinline__ void load_b16_split(CSBFrag16& f, const float* Sr, const float* Si,
                                               int k0, int n0, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int idx[2] = {(k0 + q) * SB + n0 + g, (k0 + q + 8) * SB + n0 + g};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float yr0 = Sr[idx[e]], yr1 = Sr[idx[e] + 4 * SB];
    const float yi0 = Si[idx[e]], yi1 = Si[idx[e] + 4 * SB];
    split_bf16(yr0, yr1, f.r.h[e], f.r.l[e]);
    split_bf16(yi0, yi1, f.i.h[e], f.i.l[e]);
    if (KARA) split_bf16(yr0 + yi0, yr1 + yi1, f.s.h[e], f.s.l[e]);
  }
}

// c += one 16-deep step's bf16 one-pass products: Karatsuba's three, or
// the 4-multiplication form's
template <bool KARA>
__device__ __forceinline__ void one_pass_mma16(CAcc& c, const CAFrag16& a, const CBFrag16& b) {
  mma16(c.t1, a.r, b.r);
  mma16(c.t2, a.i, b.i);
  if (KARA) {
    mma16(c.t3, a.s, b.s);
  } else {
    mma16(c.t3, a.r, b.i);
    mma16(c.t3, a.i, b.r);
  }
}

// d += xh yl + xl yh + xh yh, one 16-deep step of a split-bf16 product
__device__ __forceinline__ void split_mma16(float (&d)[4], const SAFrag16& a, const SBFrag16& b) {
  mma16(d, a.h, b.l);
  mma16(d, a.l, b.h);
  mma16(d, a.h, b.h);
}

// c += one 16-deep step's split-bf16 products (Karatsuba's three, or the
// 4-multiplication form's)
template <bool KARA>
__device__ __forceinline__ void split_mma16_c(CAcc& c, const CSAFrag16& a, const CSBFrag16& b) {
  split_mma16(c.t1, a.r, b.r);
  split_mma16(c.t2, a.i, b.i);
  if (KARA) {
    split_mma16(c.t3, a.s, b.s);
  } else {
    split_mma16(c.t3, a.r, b.i);
    split_mma16(c.t3, a.i, b.r);
  }
}

// The tier of band_product's products (header).
enum class Prec { TF32X3, SPLIT, ONE_PASS, ONE_PASS_BF16, SPLIT_BF16 };

// C_l = L_l R for NL local left bands (Lr[l], Li[l]: band planes in this
// CTA's shared memory) and the right operand R whose band q lies in CTA q's
// planes at the offsets of this CTA's (Rr, Ri).  Only the first ceil(m / 16)
// bands of R are read (the rest are zero padding).  acc[l][j] receives
// n-tile j of this warp's columns of C_l.  stage: 4 SLICE floats (two
// buffers of two planes).  Every thread of the CTA must call it; it starts
// with a barrier, so the caller may rewrite the stage right before, and it
// leaves the left and right planes untouched.  PREC: the products' tier;
// SPLIT, ONE_PASS, ONE_PASS_BF16 and SPLIT_BF16 take Karatsuba's form, or
// with KARA = false the 4-multiplication form, whose imaginary part is
// acc_im4 (TF32X3 is always Karatsuba's).
template <int P, int NL, Prec PREC = Prec::TF32X3, bool KARA = true>
__device__ __forceinline__ void band_product(cg::cluster_group& cluster, float* Rr,
                                             float* Ri, const float* const (&Lr)[NL],
                                             const float* const (&Li)[NL], float* stage, int m,
                                             CAcc (&acc)[NL][NPW]) {
  using L = Layout<P>;
  constexpr int Q4 = P / 4;  // float4 per band row
  const int nbands = (m + BAND - 1) / BAND;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int l = 0; l < NL; ++l)
#pragma unroll
    for (int j = 0; j < NPW; ++j) zero(acc[l][j]);
  const int rank = static_cast<int>(cluster.block_rank());
  float4 buf[L::NV];
  auto fetch = [&](int q) {  // this CTA's own band through its local address
    const float* rr = q == rank ? Rr : cluster.map_shared_rank(Rr, q);
    const float* ri = q == rank ? Ri : cluster.map_shared_rank(Ri, q);
#pragma unroll
    for (int v = 0; v < L::NV; ++v) {
      const int e = tid + v * L::NT;
      const int pl = e / (BAND * Q4), rem = e % (BAND * Q4);
      buf[v] = *reinterpret_cast<const float4*>((pl ? ri : rr) + (rem / Q4) * L::SA +
                                                4 * (rem % Q4));
    }
  };
  auto put = [&](float* st) {
#pragma unroll
    for (int v = 0; v < L::NV; ++v) {
      const int e = tid + v * L::NT;
      const int pl = e / (BAND * Q4), rem = e % (BAND * Q4);
      *reinterpret_cast<float4*>(st + pl * L::SLICE + (rem / Q4) * L::SB + 4 * (rem % Q4)) =
          buf[v];
    }
  };
  // bands in the order r, r + 1, ..., wrapping at nbands
  const int first = rank % nbands;
  auto band = [&](int i) { return first + i < nbands ? first + i : first + i - nbands; };
  __syncthreads();  // the previous reader of the stage is done
  fetch(band(0));
  for (int i = 0; i < nbands; ++i) {
    const int q = band(i);
    float* st = stage + (i & 1) * 2 * L::SLICE;
    put(st);
    __syncthreads();
    if (i + 1 < nbands) fetch(band(i + 1));
    if constexpr (PREC == Prec::ONE_PASS_BF16) {  // one 16-deep step a band
      CBFrag16 b[NPW];
#pragma unroll
      for (int j = 0; j < NPW; ++j)
        load_b16<L::SB, KARA>(b[j], st, st + L::SLICE, 0, warp * 16 + 8 * j, lane);
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        CAFrag16 a;
        load_a16<L::SA, KARA>(a, Lr[l], Li[l], q * BAND, lane);
#pragma unroll
        for (int j = 0; j < NPW; ++j) one_pass_mma16<KARA>(acc[l][j], a, b[j]);
      }
      continue;
    }
    if constexpr (PREC == Prec::SPLIT_BF16) {
      CSBFrag16 b[NPW];
#pragma unroll
      for (int j = 0; j < NPW; ++j)
        load_b16_split<L::SB, KARA>(b[j], st, st + L::SLICE, 0, warp * 16 + 8 * j, lane);
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        CSAFrag16 a;
        load_a16_split<L::SA, KARA>(a, Lr[l], Li[l], q * BAND, lane);
#pragma unroll
        for (int j = 0; j < NPW; ++j) split_mma16_c<KARA>(acc[l][j], a, b[j]);
      }
      continue;
    }
#pragma unroll
    for (int kk = 0; kk < BAND; kk += 8) {
      if constexpr (PREC == Prec::ONE_PASS) {
        CBFrag b[NPW];
#pragma unroll
        for (int j = 0; j < NPW; ++j)
          load_b_tf32<L::SB, KARA>(b[j], st, st + L::SLICE, kk, warp * 16 + 8 * j, lane);
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          CAFrag a;
          load_a_tf32<L::SA, KARA>(a, Lr[l], Li[l], q * BAND + kk, lane);
#pragma unroll
          for (int j = 0; j < NPW; ++j) one_pass_mma<KARA>(acc[l][j], a, b[j]);
        }
      } else if constexpr (PREC == Prec::SPLIT) {
        CSBFrag b[NPW];
#pragma unroll
        for (int j = 0; j < NPW; ++j)
          load_b_bf<L::SB, KARA>(b[j], st, st + L::SLICE, kk, warp * 16 + 8 * j, lane);
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          CSAFrag a;
          load_a_bf<L::SA, KARA>(a, Lr[l], Li[l], q * BAND + kk, lane);
#pragma unroll
          for (int j = 0; j < NPW; ++j) {
            CAcc part;
            split_mma<KARA>(part, a, b[j]);
            fold(acc[l][j], part);
          }
        }
      } else {
        CBFrag b[NPW];
#pragma unroll
        for (int j = 0; j < NPW; ++j)
          load_b<L::SB>(b[j], st, st + L::SLICE, kk, warp * 16 + 8 * j, lane);
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          CAFrag a;
          load_a<L::SA>(a, Lr[l], Li[l], q * BAND + kk, lane);
#pragma unroll
          for (int j = 0; j < NPW; ++j) {
            CAcc part;
            karatsuba_mma(part, a, b[j]);
            fold(acc[l][j], part);
          }
        }
      }
    }
  }
}

}  // namespace tcp
