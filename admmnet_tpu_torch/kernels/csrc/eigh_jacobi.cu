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
//   1. load A = herm(M) = (M + M^H) / 2 and V = I into shared memory, and
//      the Frobenius norm ||A||_F (invariant under the rotations);
//   2. sweeps of mp - 1 rounds; round r pairs index r with mp - 1 and
//      (r + k) mod (mp - 1) with (r - k) mod (mp - 1), k = 1 .. mp/2 - 1,
//      so that every pair meets once a sweep and the mp/2 pairs of a round
//      are disjoint.  Phase 1: one thread a pair computes the rotation that
//      zeroes its a_pq, J = [[c, z], [-conj(z), c]] with t = sign(tau) /
//      (|tau| + sqrt(1 + tau^2)), tau = (a_qq - a_pp) / (2 |a_pq|), c = 1 /
//      sqrt(1 + t^2), z = t c a_pq / |a_pq| (the smaller angle), or none
//      where |a_pq| <= tol = 2^-24 ||A||_F / m.  Phase 2: A <- J^H A J as
//      independent 2 x 2 blocks (rows of pair P, columns of pair Q), each
//      read and written by one thread, and V <- V J; a rotated pair's own
//      block is set to diag(a_pp - t |a_pq|, a_qq + t |a_pq|) exactly.  A
//      round with no rotation skips phase 2;
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
// What bounds it on the card: shared-memory traffic and the SIMT
// instructions around it (fp32 work, addresses, the rotations' loads).  A
// rotating round reads and writes all of A and V once (mp^2 + m mp complex
// values, ~330 KB at m = 101), so a sweep is ~33 MB of shared-memory
// traffic a matrix; the two barriers of a round and the serial latency of
// phase 1 (a division chain in 51 threads) are the rest.  A and V (166 KB
// at m = 101) take most of an SM's shared memory, so one block runs on an
// SM; its 1024 threads hide the shared-memory latency.  Device-memory
// traffic is M in and w, V out, once.  In phase 2 each thread keeps one
// column pair Q for the round (its rotation and indices loaded once) and
// takes the row pairs P = g, g + G, ... of A and the rows g, g + G, ... of
// V; consecutive threads hold consecutive pairs, whose columns (r + k) and
// (r - k) are consecutive addresses, so the gathers do not conflict in the
// banks.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace admmk {
namespace eigh {

constexpr int NT = 1024;  // threads a block
constexpr int NW = NT / 32;
constexpr float TOL_REL = 5.9604644775390625e-08f;  // 2^-24

// Byte offsets of the block's shared memory; kernels/eigh.py's smem_bytes
// mirrors total, and the launcher refuses a launch where they differ.
struct Layout {
  int A;     // float2 [mp][mp]
  int V;     // float2 [m][mp]
  int rot;   // float4 [mp / 2]: c, Re z, Im z, t |a_pq|
  int pair;  // int2 [mp / 2]: the round's pairs (p, q); after the sweeps, int [mp]:
             // the index of the j-th smallest eigenvalue
  int act;   // int [mp / 2]: the pair rotates this round
  int red;   // float [NW]: the norm's partial sums
  int total;
};

__host__ __device__ inline Layout layout(int m) {
  const int mp = m + (m & 1), np = mp / 2;
  Layout L;
  L.A = 0;
  L.V = L.A + 8 * mp * mp;
  L.rot = L.V + 8 * m * mp;
  L.pair = L.rot + 16 * np;  // int2 wants 8-byte alignment: rot's is 16
  L.act = L.pair + 8 * np;
  L.red = L.act + 4 * np;
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

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 conjf2(float2 a) { return make_float2(a.x, -a.y); }

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
  const int mp = m + (m & 1), np = mp / 2, n1 = mp - 1;
  float2* A = reinterpret_cast<float2*>(smem + L.A);
  float2* V = reinterpret_cast<float2*>(smem + L.V);
  float4* rot = reinterpret_cast<float4*>(smem + L.rot);
  int* act = reinterpret_cast<int*>(smem + L.act);
  int2* pair = reinterpret_cast<int2*>(smem + L.pair);
  int* perm = reinterpret_cast<int*>(smem + L.pair);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float2* Mb = M + b * m * m;

  // 1. A = M (the padding zero), V = I
  for (int e = tid; e < mp * mp; e += NT) {
    const int i = e / mp, j = e - i * mp;
    A[e] = (i < m && j < m) ? Mb[i * m + j] : make_float2(0.f, 0.f);
  }
  for (int e = tid; e < m * mp; e += NT) {
    const int i = e / mp, j = e - i * mp;
    V[e] = make_float2(i == j ? 1.f : 0.f, 0.f);
  }
  __syncthreads();
  // A = herm(A): the thread of (i, j), i < j, writes both; ||A||_F^2
  float part = 0.f;
  for (int e = tid; e < m * m; e += NT) {
    const int i = e / m, j = e - i * m;
    if (i < j) {
      const float2 x = A[i * mp + j], y = A[j * mp + i];
      const float2 h = make_float2(0.5f * (x.x + y.x), 0.5f * (x.y - y.y));
      A[i * mp + j] = h;
      A[j * mp + i] = conjf2(h);
      part += 2.f * (h.x * h.x + h.y * h.y);
    } else if (i == j) {
      const float d = A[i * mp + i].x;
      A[i * mp + i] = make_float2(d, 0.f);
      part += d * d;
    }
  }
  part = warp_sum(part);
  if ((tid & 31) == 0) red[tid >> 5] = part;
  __syncthreads();
  float norm2 = 0.f;
  for (int i = 0; i < NW; ++i) norm2 += red[i];
  const float tol = TOL_REL * sqrtf(norm2) / static_cast<float>(m);

  // phase 2's work of this thread: pair Q of the columns (and of V's
  // columns), the groups of rows P = g, g + G, ... (and V's rows i = g,
  // g + G, ...); threads past G np have none
  const int G = NT / np, Q = tid % np, g = tid / np;

  // 2. sweeps
  int sweeps = 0;
  while (sweeps < max_sweeps) {
    int rotated = 0;
    for (int r = 0; r < n1; ++r) {
      int on = 0;
      if (tid < np) {
        int p, q;
        pair_of(r, tid, n1, p, q);
        const float a = A[p * mp + p].x, d = A[q * mp + q].x;
        const float2 h = A[p * mp + q];
        const float ah = hypotf(h.x, h.y);
        float4 R = make_float4(1.f, 0.f, 0.f, 0.f);
        if (ah > tol) {
          const float tau = (d - a) / (2.f * ah);
          const float t = copysignf(1.f, tau) / (fabsf(tau) + sqrtf(fmaf(tau, tau, 1.f)));
          const float c = 1.f / sqrtf(fmaf(t, t, 1.f));
          const float s = t * c;
          R = make_float4(c, s * (h.x / ah), s * (h.y / ah), t * ah);
          on = 1;
        }
        rot[tid] = R;
        act[tid] = on;
        pair[tid] = make_int2(p, q);
      }
      if (!__syncthreads_or(on)) continue;  // the same answer in every thread
      rotated = 1;
      if (g < G) {
        const int aQ = act[Q];
        const int2 cQ = pair[Q];
        const float4 RQ = rot[Q];
        const float2 zQ = make_float2(RQ.y, RQ.z), zQc = make_float2(RQ.y, -RQ.z);
        // A <- J^H A J, block (P, Q): rows of pair P, columns of pair Q
        for (int P = g; P < np; P += G) {
          const int aP = act[P];
          if (!(aP | aQ)) continue;
          const int2 rP = pair[P];
          float2* r0 = A + rP.x * mp;
          float2* r1 = A + rP.y * mp;
          float2 x00 = r0[cQ.x], x01 = r0[cQ.y], x10 = r1[cQ.x], x11 = r1[cQ.y];
          if (P == Q) {  // the pair's own block, diagonalised exactly
            const float tb = RQ.w;
            x00 = make_float2(x00.x - tb, 0.f);
            x11 = make_float2(x11.x + tb, 0.f);
            x01 = x10 = make_float2(0.f, 0.f);
          } else {
            if (aP) {  // rows: p <- c p - z q, q <- conj(z) p + c q
              const float4 R = rot[P];
              const float2 z = make_float2(R.y, R.z), zc = make_float2(R.y, -R.z);
              const float2 y00 = rot_sub(R.x, x00, z, x10), y01 = rot_sub(R.x, x01, z, x11);
              x10 = rot_add(zc, x00, R.x, x10);
              x11 = rot_add(zc, x01, R.x, x11);
              x00 = y00;
              x01 = y01;
            }
            if (aQ) {  // columns: p <- c p - conj(z) q, q <- z p + c q
              const float2 y00 = rot_sub(RQ.x, x00, zQc, x01);
              const float2 y10 = rot_sub(RQ.x, x10, zQc, x11);
              x01 = rot_add(zQ, x00, RQ.x, x01);
              x11 = rot_add(zQ, x10, RQ.x, x11);
              x00 = y00;
              x10 = y10;
            }
          }
          r0[cQ.x] = x00;
          r0[cQ.y] = x01;
          r1[cQ.x] = x10;
          r1[cQ.y] = x11;
        }
        // V <- V J, rows i, columns of pair Q
        if (aQ) {
          for (int i = g; i < m; i += G) {
            float2* v = V + i * mp;
            const float2 vp = v[cQ.x], vq = v[cQ.y];
            v[cQ.x] = rot_sub(RQ.x, vp, zQc, vq);
            v[cQ.y] = rot_add(zQ, vp, RQ.x, vq);
          }
        }
      }
      __syncthreads();
    }
    if (!rotated) break;
    ++sweeps;
  }

  // 3. ascending order, ties by index; NaN last
  for (int i = tid; i < m; i += NT) {
    const float wi = A[i * mp + i].x;
    const float ki = wi != wi ? INFINITY : wi;
    int rank = 0;
    for (int j = 0; j < m; ++j) {
      const float wj = A[j * mp + j].x;
      const float kj = wj != wj ? INFINITY : wj;
      rank += (kj < ki || (kj == ki && j < i)) ? 1 : 0;
    }
    perm[rank] = i;
  }
  __syncthreads();
  for (int j = tid; j < m; j += NT) w_out[b * m + j] = A[perm[j] * mp + perm[j]].x;
  float2* Vb = V_out + b * m * m;
  for (int e = tid; e < m * m; e += NT) {
    const int i = e / m, j = e - i * m;
    Vb[e] = V[i * mp + perm[j]];
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
