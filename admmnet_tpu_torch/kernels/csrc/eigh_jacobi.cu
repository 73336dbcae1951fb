// Batched eigendecomposition of Hermitian matrices by the two-sided cyclic
// Jacobi method in round-robin order: one thread block a matrix, one launch
// a batch (kernels/eigh.py launches it).
//
// Replaces no TPU kernel: the JAX package's eigh GLayer calls jnp.linalg.eigh
// (XLA's own solver on the TPU).  The port's plain path casts to complex128
// and calls torch.linalg.eigh, which on the card solves a batch of sides
// above 32 one matrix at a time (cuSOLVER); this kernel solves every matrix
// of the batch at once, in complex64, the JAX package's precision.
//
// Per matrix (side m, padded to an even mp with a zero row and column when
// m is odd, so that every index has a partner in every round):
//
//   1. load herm(M) = (M + M^H) / 2 into the upper triangle and the
//      diagonal of A (the entry (i, j), i > j, is read as conj of (j, i):
//      A is Hermitian by construction), V^T = I into shared memory, and the
//      Frobenius norm ||A||_F (invariant under the rotations);
//   2. sweeps of mp - 1 rounds; round r pairs index r with mp - 1 and
//      (r + k) mod (mp - 1) with (r - k) mod (mp - 1), k = 1 .. mp/2 - 1,
//      so that every pair meets once a sweep and the mp/2 pairs of a round
//      are disjoint.  Phase 1: one thread a pair computes the rotation that
//      zeroes its a_pq, J = [[c, z], [-conj(z), c]] with t = sign(tau) /
//      (|tau| + sqrt(1 + tau^2)), tau = (a_qq - a_pp) / (2 |a_pq|), c = 1 /
//      sqrt(1 + t^2), z = t c a_pq / |a_pq| (the smaller angle), or none
//      where |a_pq| <= tol = 2^-24 ||A||_F / m, and sets a rotated pair's
//      own block to diag(a_pp - t |a_pq|, a_qq + t |a_pq|) exactly.  Phase
//      2: A <- J^H A J over the other blocks (rows of pair P, columns of
//      pair Q), each unordered pair {P, Q} once: X = J_P^H A_PQ J_Q, whose
//      entries below the diagonal are stored conjugated in their mirror
//      places (the block (Q, P) = X^H); and V <- V J, as rows p and q of
//      V^T.  A round with no rotation skips phase 2;
//   3. stop after the first sweep that rotates nothing (every |a_pq| <=
//      tol, so the off-diagonal part is below 2^-24 ||A||_F), or after
//      max_sweeps; the number of sweeps that rotated is written per matrix;
//   4. sort the eigenvalues ascending (ties by index) and write w and the
//      matching columns of V, as torch.linalg.eigh returns them.
//
// A sweep-count stop rather than a fixed count: the matrices of a batch
// need different numbers of sweeps (a near-diagonal one 1-2, a random one
// 7-8), and a block that stops frees its SM for the next matrix.
//
// What bounds it on the card: the SIMT instructions of phase 2 (fp32
// work, addresses, the rotations' loads) and their shared-memory traffic,
// then phase 1.  A rotating round reads and writes the upper triangle of A
// and all of V^T once (~mp^2 / 2 + mp^2 complex values, ~250 KB at m =
// 101), so a sweep is ~25 MB of shared-memory traffic a matrix; the two
// barriers of a round and the serial latency of phase 1 (a division chain
// in mp / 2 threads) are the rest: on an H100 at m = 101, ~0.6 us of a
// ~2.4 us round.  A and V (167 KB at m = 101) take most of an SM's shared
// memory, so one block runs on an SM; its 1024 threads hide the
// shared-memory latency.  Device-memory traffic is M in and w, V out, once.
//
// Phase 2's deal.  Its units are the np (np - 1) / 2 block pairs of A (np =
// mp / 2; P < Q, in row order) and the np^2 updates of V (pair Q and row
// pair i: entries 2i and 2i + 1 of V^T's rows p and q, one 16-byte access
// each; i fastest), each 32 consecutive units one step of a warp.  Warp w
// takes an even share of A's steps, then as many of V's as bring its cost
// to the running share of the total, a step of A costing COST_A steps of V:
// every thread works, and the warps finish together.  At m = 101 that is 40
// steps of A and 82 of V over 32 warps: a warp takes two of A, or one of A
// and three or four of V.  The banks: a step of V reads 32 consecutive
// entries of V^T's rows, its rotation broadcast; a step of A reads the rows
// of one or two pairs P and the columns of consecutive pairs Q, and A's
// row stride mp + 1 is odd, so the entries that land below the diagonal (a
// walk down a column) spread over the banks too.  The rotation of a pair is
// one 16-byte record: c, z and, in its fourth word, the pair's indices and
// whether it rotates.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace admmk {
namespace eigh {

constexpr int NT = 1024;  // threads a block
constexpr int NW = NT / 32;
constexpr float TOL_REL = 5.9604644775390625e-08f;  // 2^-24
// A step of A's cost in phase 2's deal, in steps of V.  Its 8 rotation steps
// a unit against V's 4 say 2, but its loads wait on the rotations' and its
// entries need the triangle's addresses: timed on an H100 at m = 101 with
// weights 1 to 8, 3 was the fastest (weight 2 took 6% longer, 4 1%, 8 11%)
constexpr int COST_A = 3;

// Byte offsets of the block's shared memory; kernels/eigh.py's smem_bytes
// mirrors total, and the launcher refuses a launch where they differ.
struct Layout {
  int A;    // float2 [mp][mp + 1]: the upper triangle and the diagonal
  int V;    // float2 [mp][mp]: V^T, row j the j-th column of V (entry m: padding)
  int rot;  // float4 [mp / 2]: c, Re z, Im z, bits p | q << 8 | rotates << 16;
            // after the sweeps, int [m]: the index of the j-th smallest eigenvalue
  int red;  // float [NW]: the norm's partial sums
  int total;
};

__host__ __device__ inline Layout layout(int m) {
  const int mp = m + (m & 1), np = mp / 2;
  Layout L;
  L.A = 0;
  L.V = L.A + 8 * mp * (mp + 1);
  L.rot = L.V + 8 * mp * mp;  // float4 wants 16-byte alignment: mp is even
  L.red = L.rot + 16 * np;
  L.total = L.red + 4 * NW;
  return L;
}

// The two indices of pair k in round r (n1 = mp - 1 players on the circle).
__device__ __forceinline__ void pair_of(int r, int k, int n1, int& p, int& q) {
  if (k == 0) {
    p = r;
    q = n1;
  } else {
    p = r + k;
    if (p >= n1) p -= n1;
    q = r - k;
    if (q < 0) q += n1;
  }
}

// Where A's entry (i, j), i != j, is kept: (i, j) above the diagonal, else
// its conjugate at (j, i).
__device__ __forceinline__ int upper(int i, int j, int S) { return i < j ? i * S + j : j * S + i; }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// conj(x) where flip, else x
__device__ __forceinline__ float2 conj_if(bool flip, float2 x) {
  return make_float2(x.x, flip ? -x.y : x.y);
}

// c x - z y, with c real
__device__ __forceinline__ float2 rot_sub(float c, float2 x, float2 z, float2 y) {
  const float2 zy = cmul(z, y);
  return make_float2(c * x.x - zy.x, c * x.y - zy.y);
}

// z x + c y, with c real
__device__ __forceinline__ float2 rot_add(float2 z, float2 x, float c, float2 y) {
  const float2 zx = cmul(z, x);
  return make_float2(zx.x + c * y.x, zx.y + c * y.y);
}

__global__ void __launch_bounds__(NT, 1)
    eigh_jacobi_kernel(const float2* __restrict__ M, float* __restrict__ w_out,
                       float2* __restrict__ V_out, int* __restrict__ sweeps_out, int m,
                       int max_sweeps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(m);
  const int mp = m + (m & 1), np = mp / 2, n1 = mp - 1, S = mp + 1;
  float2* A = reinterpret_cast<float2*>(smem + L.A);
  float2* V = reinterpret_cast<float2*>(smem + L.V);
  float4* rot = reinterpret_cast<float4*>(smem + L.rot);
  int* perm = reinterpret_cast<int*>(smem + L.rot);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float2* Mb = M + b * m * m;

  // 1. A = M (the padding zero), V^T = I
  for (int e = tid; e < mp * mp; e += NT) {
    const int i = e / mp, j = e - i * mp;
    A[i * S + j] = (i < m && j < m) ? Mb[i * m + j] : make_float2(0.f, 0.f);
  }
  for (int e = tid; e < mp * mp; e += NT) {
    const int i = e / mp, j = e - i * mp;
    V[e] = make_float2(i == j ? 1.f : 0.f, 0.f);
  }
  __syncthreads();
  // A = herm(A) above the diagonal and on it; ||A||_F^2
  float part = 0.f;
  for (int e = tid; e < m * m; e += NT) {
    const int i = e / m, j = e - i * m;
    if (i < j) {
      const float2 x = A[i * S + j], y = A[j * S + i];
      const float2 h = make_float2(0.5f * (x.x + y.x), 0.5f * (x.y - y.y));
      A[i * S + j] = h;
      part += 2.f * (h.x * h.x + h.y * h.y);
    } else if (i == j) {
      const float d = A[i * S + i].x;
      A[i * S + i] = make_float2(d, 0.f);
      part += d * d;
    }
  }
  part = warp_sum(part);
  if ((tid & 31) == 0) red[tid >> 5] = part;
  __syncthreads();
  float norm2 = 0.f;
  for (int i = 0; i < NW; ++i) norm2 += red[i];
  const float tol = TOL_REL * sqrtf(norm2) / static_cast<float>(m);

  // phase 2's deal (the note above): this warp's steps [a0, a1) of A and
  // [v0, v1) of V, and this lane's first units: A's block pair (P0, Q0) of
  // unit 32 a0 + lane, V's (pair Q, row pair i) (vQ0, vi0) of unit 32 v0 +
  // lane; a unit past the last reads Q >= np
  const int lane = tid & 31, wid = tid >> 5;
  const int nA = (np * (np - 1) / 2 + 31) / 32, nV = (np * np + 31) / 32;
  const int cost = COST_A * nA + nV;
  const int a0 = wid * nA / NW, a1 = (wid + 1) * nA / NW;
  int v0 = 0, v1 = 0;
  // got: V's steps before warp k, never fewer than before warp k - 1
  for (int k = 1, got = 0; k <= wid + 1; ++k) {
    got = max(got, min(nV, (k * cost - COST_A * NW * (k * nA / NW)) / NW));
    if (k == wid) v0 = got;
    v1 = got;
  }
  int P0 = 0, Q0 = 32 * a0 + lane;
  while (P0 < np && Q0 >= np - 1 - P0) {  // row P holds the np - 1 - P units (P, P + 1 ..)
    Q0 -= np - 1 - P0;
    ++P0;
  }
  Q0 += P0 + 1;
  const int vQ0 = (32 * v0 + lane) / np, vi0 = 32 * v0 + lane - vQ0 * np;

  // 2. sweeps
  int sweeps = 0;
  while (sweeps < max_sweeps) {
    int rotated = 0;
    for (int r = 0; r < n1; ++r) {
      int on = 0;
      if (tid < np) {
        int p, q;
        pair_of(r, tid, n1, p, q);
        const float a = A[p * S + p].x, d = A[q * S + q].x;
        const float2 h = conj_if(p > q, A[upper(p, q, S)]);
        const float ah = hypotf(h.x, h.y);
        float4 R = make_float4(1.f, 0.f, 0.f, 0.f);
        if (ah > tol) {
          const float tau = (d - a) / (2.f * ah);
          const float t = copysignf(1.f, tau) / (fabsf(tau) + sqrtf(fmaf(tau, tau, 1.f)));
          const float c = 1.f / sqrtf(fmaf(t, t, 1.f));
          const float s = t * c;
          R = make_float4(c, s * (h.x / ah), s * (h.y / ah), 0.f);
          // the pair's own block, diagonalised exactly
          const float tb = t * ah;
          A[p * S + p] = make_float2(a - tb, 0.f);
          A[q * S + q] = make_float2(d + tb, 0.f);
          A[upper(p, q, S)] = make_float2(0.f, 0.f);
          on = 1;
        }
        R.w = __int_as_float(p | q << 8 | on << 16);
        rot[tid] = R;
      }
      if (!__syncthreads_or(on)) continue;  // the same answer in every thread
      rotated = 1;
      // A <- J^H A J, block (P, Q): rows of pair P, columns of pair Q
      for (int k = a0, P = P0, Q = Q0; k < a1; ++k) {
        if (Q < np) {
          const float4 RP = rot[P], RQ = rot[Q];
          const int bP = __float_as_int(RP.w), bQ = __float_as_int(RQ.w);
          if ((bP | bQ) >> 16) {
            const int i0 = bP & 255, i1 = (bP >> 8) & 255, j0 = bQ & 255, j1 = (bQ >> 8) & 255;
            const int e00 = upper(i0, j0, S), e01 = upper(i0, j1, S);
            const int e10 = upper(i1, j0, S), e11 = upper(i1, j1, S);
            float2 x00 = conj_if(i0 > j0, A[e00]), x01 = conj_if(i0 > j1, A[e01]);
            float2 x10 = conj_if(i1 > j0, A[e10]), x11 = conj_if(i1 > j1, A[e11]);
            if (bP >> 16) {  // rows: p <- c p - z q, q <- conj(z) p + c q
              const float2 z = make_float2(RP.y, RP.z), zc = make_float2(RP.y, -RP.z);
              const float2 y00 = rot_sub(RP.x, x00, z, x10), y01 = rot_sub(RP.x, x01, z, x11);
              x10 = rot_add(zc, x00, RP.x, x10);
              x11 = rot_add(zc, x01, RP.x, x11);
              x00 = y00;
              x01 = y01;
            }
            if (bQ >> 16) {  // columns: p <- c p - conj(z) q, q <- z p + c q
              const float2 z = make_float2(RQ.y, RQ.z), zc = make_float2(RQ.y, -RQ.z);
              const float2 y00 = rot_sub(RQ.x, x00, zc, x01);
              const float2 y10 = rot_sub(RQ.x, x10, zc, x11);
              x01 = rot_add(z, x00, RQ.x, x01);
              x11 = rot_add(z, x10, RQ.x, x11);
              x00 = y00;
              x10 = y10;
            }
            A[e00] = conj_if(i0 > j0, x00);
            A[e01] = conj_if(i0 > j1, x01);
            A[e10] = conj_if(i1 > j0, x10);
            A[e11] = conj_if(i1 > j1, x11);
          }
        }
        Q += 32;  // 32 units on: rows of np - 1 - P units each
        while (Q >= np && P < np) {
          ++P;
          Q += P + 1 - np;
        }
      }
      // V <- V J: rows p and q of V^T, entries 2 i and 2 i + 1
      for (int k = v0, Q = vQ0, i = vi0; k < v1; ++k) {
        if (Q < np) {
          const float4 R = rot[Q];
          const int bits = __float_as_int(R.w);
          if (bits >> 16) {
            float4* vp = reinterpret_cast<float4*>(V + (bits & 255) * mp) + i;
            float4* vq = reinterpret_cast<float4*>(V + ((bits >> 8) & 255) * mp) + i;
            const float4 x = *vp, y = *vq;
            const float2 z = make_float2(R.y, R.z), zc = make_float2(R.y, -R.z);
            const float2 x0 = make_float2(x.x, x.y), x1 = make_float2(x.z, x.w);
            const float2 y0 = make_float2(y.x, y.y), y1 = make_float2(y.z, y.w);
            const float2 p0 = rot_sub(R.x, x0, zc, y0), p1 = rot_sub(R.x, x1, zc, y1);
            const float2 q0 = rot_add(z, x0, R.x, y0), q1 = rot_add(z, x1, R.x, y1);
            *vp = make_float4(p0.x, p0.y, p1.x, p1.y);
            *vq = make_float4(q0.x, q0.y, q1.x, q1.y);
          }
        }
        i += 32;  // 32 units on: rows of np units each
        while (i >= np) {
          i -= np;
          ++Q;
        }
      }
      __syncthreads();
    }
    if (!rotated) break;
    ++sweeps;
  }

  // 3. ascending order, ties by index; NaN last
  for (int i = tid; i < m; i += NT) {
    const float wi = A[i * S + i].x;
    const float ki = wi != wi ? INFINITY : wi;
    int rank = 0;
    for (int j = 0; j < m; ++j) {
      const float wj = A[j * S + j].x;
      const float kj = wj != wj ? INFINITY : wj;
      rank += (kj < ki || (kj == ki && j < i)) ? 1 : 0;
    }
    perm[rank] = i;
  }
  __syncthreads();
  for (int j = tid; j < m; j += NT) w_out[b * m + j] = A[perm[j] * S + perm[j]].x;
  float2* Vb = V_out + b * m * m;
  for (int e = tid; e < m * m; e += NT) {
    const int i = e / m, j = e - i * m;
    Vb[e] = V[perm[j] * mp + i];
  }
  if (sweeps_out != nullptr && tid == 0) sweeps_out[b] = sweeps;
}

}  // namespace eigh
}  // namespace admmk

// C entry point.  M: (B, m, m) complex64 (hermitianized here); w: (B, m)
// float32 and V: (B, m, m) complex64, written; sweeps: (B,) int32 or null.
// smem is the caller's count of the block's shared memory in bytes.
// Returns -1 where smem is not layout's total, else the launch's
// cudaError_t.
extern "C" int eigh_jacobi_launch(const void* M, void* w, void* V, void* sweeps, int B, int m,
                                  int max_sweeps, int smem, void* stream) {
  using namespace admmk::eigh;
  if (B <= 0 || m < 1 || max_sweeps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = layout(m).total;
  if (bytes != smem) return -1;
  cudaError_t err = cudaFuncSetAttribute(eigh_jacobi_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  eigh_jacobi_kernel<<<B, NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(M), static_cast<float*>(w), static_cast<float2*>(V),
      static_cast<int*>(sweeps), m, max_sweeps);
  return static_cast<int>(cudaGetLastError());
}
