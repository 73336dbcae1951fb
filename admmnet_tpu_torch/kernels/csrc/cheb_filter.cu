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
// Design: one thread-block cluster of P / 16 CTAs per matrix; CTA q owns
// rows [16 q, 16 q + 16) of A, b_1 and b_2 as fp32 real/imaginary band
// planes in its shared memory (row stride P + 4), warp w its columns
// [16 w, 16 w + 16).  A step's product A b_1 reads its operands as bf16,
// rounded once where they are made, not at every fragment load:
// - A's band is packed once, after the normalization, in fragment order
//   (Apk: for each 16-deep step q and lane, three uint4 holding load_a16's
//   re, im and bf16(re + im) registers, the sum formed in fp32); every
//   warp of the CTA reads the same 3 x 16 B a lane and step;
// - b_1's owner packs its band when it writes it (Bop), in the fragment
//   order of load_b16: for each column block w and lane, three uint4 of
//   the re, im and sum registers of the warp's two n-tiles, a register
//   holding rows (k, k + 4) of a column, as load_b16 pairs them.  The
//   initial b_1 = c_{degree-1} I is packed the same way.
// Each warp pulls its own column block of b_1's bands from their owners
// through distributed shared memory (cluster.map_shared_rank), 16-byte
// loads straight into registers, the next band's in flight while the
// current one multiplies (two or three bands ahead timed the same), in the
// rotated band order of tc_product.cuh's band_product, own band first, and
// runs three bf16 mma.sync m16n8k16 (Karatsuba) a band and n-tile.  No
// warp reads another's columns, so the product has no staging buffer and
// no barrier.
// The rounding, the k pairing within each 16-deep step, the band order and
// the accumulation order are band_product<ONE_PASS_BF16>'s, so G and the
// carries are its bits.  One operand buffer is enough: every product of
// a step has ended before the step's first cluster barrier (X is visible),
// the owner repacks b_0 only after it, and nobody reads the operand again
// before the second barrier publishes it.
//
// Bytes over distributed shared memory a CTA and product at m = 101
// (P = 112): b_1's six remote bands, 6 x 10752 B (bf16, three planes)
// where fp32 staging of two planes moved 6 x 14336 B, and herm's six
// remote 16 x 16 blocks of X, 12288 B: 76800 B, 98304 B before.  K4 at
// B = 8192 fell from 138.5 to 106.6 ms on an H100 with these bytes, both
// ~1.9 TB/s over the cluster: the network sets the kernel's pace.
//
// Between products: X = c_j I + 2 A b_1 - b_2 is formed in the accumulator
// layout in the stage's first half; after a cluster barrier each warp
// copies the one 16 x 16 block of X^T its columns need from the CTA that
// owns it, as float4 reads, into the stage's second half (scalar remote
// reads there cost 15% of the kernel), and writes b_0 = herm(X) over b_2,
// which no other CTA reads, then packs its column block of b_0 into Bop;
// b_1 and b_2 swap by pointer, and a second cluster barrier publishes b_0.
// The closing product with final_hi is band_product<TF32X3> on the fp32
// planes of A and b_1 through the stage, as a double buffer of staged fp32
// bands (tc_product.cuh).  Shared memory a CTA: 6 band planes, the stage
// (4 staged fp32 bands: X and herm's blocks, or final_hi's double buffer),
// Apk and Bop (NC x 1536 B each) and 16 floats: 96832 B at P = 112 (two
// CTAs an SM), 110144 B at P = 128.  ||M||_F is summed over the cluster in
// rank order, as cheb_bwd.cu sums it, so K6 rebuilds the forward's states
// from the same A.  Nothing but the inputs and outputs touches device
// memory.  K4 and K5 are one instantiation: the carry pointers are a
// run-time choice, so K5's G is K4's bit for bit.
//
// Padding: the planes are zero-padded from m to P.  c_j is added on the
// logical diagonal only (row < m), so every padded row and column stays
// exactly zero through the whole recurrence (a zero row of A or column of
// b_1 gives a zero row or column of the product; a zero rounds to a zero
// bf16 and splits into zero tf32 halves).
#include "common.cuh"
#include "tc_product.cuh"

namespace admmk {

namespace cg = cooperative_groups;
using tcp::BAND;
using tcp::CAcc;
using tcp::NPW;
using tcp::pack_bf16;

// uint4 of one block of a packed operand (A's 16-deep step, or a column
// block of b_1's band): three planes (re, im, sum) of 32 lanes
constexpr int PACKED = 3 * 32;

// uint4 of one packed operand (Apk or Bop): NC blocks
template <int P>
__host__ __device__ constexpr int packed_vecs() {
  return tcp::Layout<P>::NC * PACKED;
}

// One lane's three fragment registers of each plane into a packed block
__device__ __forceinline__ void put_packed(uint4* block, int lane, const uint32_t (&r)[4],
                                           const uint32_t (&i)[4], const uint32_t (&s)[4]) {
  block[lane] = make_uint4(r[0], r[1], r[2], r[3]);
  block[32 + lane] = make_uint4(i[0], i[1], i[2], i[3]);
  block[64 + lane] = make_uint4(s[0], s[1], s[2], s[3]);
}

template <int P>
constexpr int fwd_smem_floats() {
  // 6 band planes (Ar, Ai, b1r, b1i, b2r, b2i), the stage (X and herm's
  // transposed blocks; final_hi's double buffer), the packed A and b_1
  // (Apk, Bop), the block reduction's partials and one cluster-visible slot
  return 6 * tcp::Layout<P>::PLANE + 4 * tcp::Layout<P>::SLICE + 2 * 4 * packed_vecs<P>() + 16;
}

// Row stride of a warp's transposed 16 x 16 block in herm (scalar stores;
// 2-way bank conflicts on the transposed reads)
constexpr int WS = 17;

// Warp w packs A's 16-deep step q = w (columns [16 w, 16 w + 16) of the
// band planes, row stride SA) into Apk: for each lane, three uint4 of
// load_a16's re, im and sum registers (its PTX k pairs from columns
// (k, k + 4), the sum formed in fp32 and rounded once).
template <int SA>
__device__ __forceinline__ void pack_a(uint4* Apk, const float* Ar, const float* Ai, int q,
                                       int lane) {
  const int g = lane >> 2, q4 = lane & 3, k0 = q * BAND;
  const int idx[4] = {g * SA + k0 + q4, (g + 8) * SA + k0 + q4, g * SA + k0 + q4 + 8,
                      (g + 8) * SA + k0 + q4 + 8};
  uint32_t r[4], i[4], s[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float xr0 = Ar[idx[e]], xr1 = Ar[idx[e] + 4];
    const float xi0 = Ai[idx[e]], xi1 = Ai[idx[e] + 4];
    r[e] = pack_bf16(xr0, xr1);
    i[e] = pack_bf16(xi0, xi1);
    s[e] = pack_bf16(xr0 + xi0, xr1 + xi1);
  }
  put_packed(Apk + q * PACKED, lane, r, i, s);
}

// Warp w packs its column block of a b band (planes Sr, Si, row stride SA)
// into Bop: for each lane, three uint4 of load_b16's re, im and sum
// registers, words (n-tile j, register e) in the order (0, 0), (0, 1),
// (1, 0), (1, 1); register e pairs rows (k, k + 4), k = lane % 4 + 8 e, of
// column 16 w + 8 j + lane / 4.
template <int SA>
__device__ __forceinline__ void pack_b(uint4* Bop, const float* Sr, const float* Si, int w,
                                       int lane) {
  const int g = lane >> 2, q4 = lane & 3;
  uint32_t r[4], i[4], s[4];
#pragma unroll
  for (int j = 0; j < NPW; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int idx = (q4 + 8 * e) * SA + 16 * w + 8 * j + g;
      const float yr0 = Sr[idx], yr1 = Sr[idx + 4 * SA];
      const float yi0 = Si[idx], yi1 = Si[idx + 4 * SA];
      r[2 * j + e] = pack_bf16(yr0, yr1);
      i[2 * j + e] = pack_bf16(yi0, yi1);
      s[2 * j + e] = pack_bf16(yr0 + yi0, yr1 + yi1);
    }
  put_packed(Bop + w * PACKED, lane, r, i, s);
}

// acc = A b_1 in one-pass bf16 from the packed operands: this CTA's Apk and
// b_1's Bop in each owner, read at this CTA's Bop offset.  Only the first
// ceil(m / 16) bands are read (the rest are zero padding), in the order
// rank, rank + 1, ... wrapping at nbands, as band_product reads them.  No
// barrier: each warp reads only its own column block of every band.
template <int P>
__device__ __forceinline__ void packed_product(cg::cluster_group& cluster, const uint4* Apk,
                                               uint4* Bop, int m, CAcc (&acc)[NPW]) {
  static_assert(NPW == 2, "a packed block holds two n-tiles");
  const int nbands = (m + BAND - 1) / BAND;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = static_cast<int>(cluster.block_rank());
#pragma unroll
  for (int j = 0; j < NPW; ++j) tcp::zero(acc[j]);
  const int first = rank % nbands;
  auto band = [&](int i) { return first + i < nbands ? first + i : first + i - nbands; };
  auto fetch = [&](int i, uint4 (&b)[3]) {  // this CTA's own band through its local address
    const int q = band(i);
    const uint4* src =
        (q == rank ? Bop : cluster.map_shared_rank(Bop, q)) + warp * PACKED + lane;
    b[0] = src[0];
    b[1] = src[32];
    b[2] = src[64];
  };
  uint4 nxt[3];
  fetch(0, nxt);
  for (int i = 0; i < nbands; ++i) {
    const uint4 br = nxt[0], bi = nxt[1], bs = nxt[2];
    if (i + 1 < nbands) fetch(i + 1, nxt);  // in flight while this band multiplies
    const uint4* ap = Apk + band(i) * PACKED + lane;
    const uint4 ar = ap[0], ai = ap[32], as = ap[64];
    const tcp::CAFrag16 a = {{ar.x, ar.y, ar.z, ar.w},
                             {ai.x, ai.y, ai.z, ai.w},
                             {as.x, as.y, as.z, as.w}};
    const tcp::CBFrag16 b[NPW] = {{{br.x, br.y}, {bi.x, bi.y}, {bs.x, bs.y}},
                                  {{br.z, br.w}, {bi.z, bi.w}, {bs.z, bs.w}}};
#pragma unroll
    for (int j = 0; j < NPW; ++j) tcp::one_pass_mma16<true>(acc[j], a, b[j]);
  }
}

// Two CTAs an SM (96832 B of shared memory a CTA at P = 112, 110144 B at
// P = 128; a third at P = 112 would not fit).
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
  uint4* Apk = reinterpret_cast<uint4*>(stage + 4 * L::SLICE);
  uint4* Bop = Apk + packed_vecs<P>();
  // between a product and the next: X's band, read across the cluster by
  // herm, in the stage's first half, row stride SB; this warp's transposed
  // block in its second half
  float* Xr = stage;
  float* Xi = stage + L::SLICE;
  float* w = stage + 2 * L::SLICE + warp * 2 * BAND * WS;
  float* red = reinterpret_cast<float*>(Bop + packed_vecs<P>());  // one partial per warp
  float* slot = red + 8;                                          // ||M||_F^2 partial

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
    for (int q = 0; q < L::NC; ++q) s += red[q];
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
  __syncthreads();
  // A's bf16 fragments for the whole recurrence, and b_1's operand
  pack_a<SA>(Apk, Ar, Ai, warp, lane);
  pack_b<SA>(Bop, b1r, b1i, warp, lane);
  cluster.sync();

  // X = cj I + alpha acc - b_2 into the stage's first half; returns once X
  // is visible to the cluster
  auto form_x = [&](float cj, float alpha, const CAcc (&acc)[NPW]) {
#pragma unroll
    for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row_of(e), cc = col_of(jj, e), idx = r * SA + cc;
        const float d = (row0 + r == cc && cc < m) ? cj : 0.f;
        Xr[r * SB + cc] = (d + alpha * tcp::acc_re(acc[jj], e)) - b2r[idx];
        Xi[r * SB + cc] = alpha * tcp::acc_im(acc[jj], e) - b2i[idx];
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
    {
      CAcc acc[NPW];
      packed_product<P>(cluster, Apk, Bop, m, acc);
      form_x(c[j], 2.f, acc);
    }
    // b_0 = herm(X) over b_2, which no other CTA reads, and its operand over
    // b_1's, which every product of this step has read; then
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
    __syncwarp();  // the warp's column block of b_0 is whole
    pack_b<SA>(Bop, b2r, b2i, warp, lane);
    float* t = b1r;
    b1r = b2r;
    b2r = t;
    t = b1i;
    b1i = b2i;
    b2i = t;
    cluster.sync();  // b_0 is visible; every read of X is done
  }

  // G = herm(c_0 I + A b_1 - b_2), final_hi: the product in 3xTF32 from the
  // fp32 planes, through the stage
  {
    CAcc acc[NPW];
    if (final_hi) {
      CAcc acc1[1][NPW];
      const float* const lr[1] = {Ar};
      const float* const li[1] = {Ai};
      tcp::band_product<P, 1, tcp::Prec::TF32X3>(cluster, b1r, b1i, lr, li, stage, m, acc1);
      __syncthreads();  // every warp is done with the stage
#pragma unroll
      for (int jj = 0; jj < NPW; ++jj) acc[jj] = acc1[0][jj];
    } else {
      packed_product<P>(cluster, Apk, Bop, m, acc);
    }
    form_x(c[0], 1.f, acc);
  }
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
