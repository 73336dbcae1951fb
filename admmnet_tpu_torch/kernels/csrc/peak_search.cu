// Coarse-to-fine peak search of a batch of scenes: one thread block a scene,
// one launch a batch (kernels/peak_search.py launches it).
//
// Replaces no TPU kernel: the JAX package computes the search with XLA ops
// (admmnet_tpu/peaks/search.py), and so does the port's plain version
// (peaks/search.py), about 60 small launches a call on the card.  Each
// block does, for its scene, what the plain version does for the batch:
//
//   1. coarse: Z = |S conj(Phi) Dc^T|^2 on the (ny, nx) grid in fp32, with
//      T = S conj(Phi) first, both in shared memory (Z never reaches device
//      memory);
//   2. select: the 8-neighbour local maxima of Z (-inf past the borders,
//      equality allowed), then the K largest of them, equal heights in
//      flat index order; fewer than K pad with height -inf, valid false,
//      the start at (delay_min, doppler_min);
//   3. refine: ``iters`` rounds of a P x P local grid per peak (one warp a
//      peak), padded entries included; the steering computed in the block
//      as ops/atoms.py computes it (theta = (2 pi f) m in fp32, then
//      sincosf); the first maximum in flat index order, as torch.argmax;
//      with ``one_pass`` the two products round their operands to bf16 (S,
//      Phi, then S Phi and Dc), the exact products summed in fp32;
//   4. order: padded heights to -inf, then a stable descending sort of the
//      K entries (argsort(-h, stable=True)) by one warp.
//
// What bounds it on the card: fp32 SIMT work (~0.9 MFLOP a scene on the
// 100 x 100 grid, the refine's ~0.3 MFLOP and its sincosf) and the grid's
// shared memory (4 ny nx bytes for Z; 58 KB a block at the production
// sizes, three blocks an SM).  The coarse product keeps four rows of Z in
// registers per thread, so one shared load of Dc serves four outputs and
// the T loads are broadcasts; bytes to and from device memory are phi in
// and the peak lists out.  No -use_fast_math: sincosf and the products
// round as the plain version's (the explicit __fmul_rn / __fadd_rn keep
// the steering's and the window's roundings unfused).

#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace admmk {
namespace peaks {

constexpr int NT = 256;        // threads a block
constexpr int NW = NT / 32;    // warps a block
constexpr int RY = 4;          // rows of the coarse grid a thread computes at once
constexpr float TWO_PI = 6.283185307179586f;  // float32(2 pi), as torch rounds 2j * pi

struct Args {
  const float2* phi;  // (B, Nb * Nd) complex64
  const float2* S;    // (ny, Nb) coarse doppler steering
  const float2* DcT;  // (Nd, nx) conjugated coarse delay steering, transposed
  const float* taus;  // (nx,) coarse delay axis
  const float* fs;    // (ny,) coarse doppler axis
  const float* rel;   // (P,) linspace(-1, 1, P)
  float* tau_out;     // (B, K)
  float* f_out;
  float* h_out;
  uint8_t* valid_out;
  int Nb, Nd, ny, nx, K, P, iters, one_pass;
  float tau_lo, tau_hi, f_lo, f_hi;  // the refine's clamp bounds (float32, as torch.clamp)
  double half_t, half_f, reduce;     // first half-widths and their factor, in double as Python
};

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// Offsets (in floats, each 16-byte aligned) of the block's shared memory.
// kernels/peak_search.py's smem_bytes mirrors total, to refuse a grid that
// does not fit before any CUDA call; the launcher takes its bytes and
// refuses a launch where they differ from total, so the two cannot drift
// apart unseen.
struct Layout {
  int phi;     // float2 [Nb * Nd]: conj(phi), rounded to bf16 before the refine if one_pass
  int T;       // float2 [Nd][ny4]: T = S conj(Phi), k-major, rows past ny zero
  int D;       // float2 [Nd][nx]: Dc, k-major
  int Z;       // float [ny * nx]; before Z, S staged as float2 [ny * Nb]
  int cand;    // uint32 [words]: local-maximum bits, word w = points 32 w .. 32 w + 31
  int warp;    // refine scratch of warp 0 (aliases T..cand); warp w at warp + w * wstride
  int wstride;
  int pk;      // tau [K], f [K], h [K], valid [K] of the K peaks (4 * align4(K) floats)
  int red;     // reduction scratch: NW values, NW indices, the pick's index
  int total;
  int ny4, words;
};

__host__ __device__ inline Layout layout(int Nb, int Nd, int ny, int nx, int K, int P) {
  Layout L;
  L.ny4 = (ny + RY - 1) / RY * RY;
  L.words = (ny * nx + 31) / 32;
  L.phi = 0;
  L.T = L.phi + align4(2 * Nb * Nd);
  L.D = L.T + 2 * Nd * L.ny4;
  L.Z = L.D + align4(2 * Nd * nx);
  const int zs = ny * nx > 2 * ny * Nb ? ny * nx : 2 * ny * Nb;
  L.cand = L.Z + align4(zs);
  const int coarse_end = L.cand + align4(L.words);
  L.warp = L.T;
  L.wstride = 2 * align4(P) + align4(2 * P * Nb) + 2 * align4(2 * P * Nd);
  const int refine_end = L.warp + NW * L.wstride;
  L.pk = coarse_end > refine_end ? coarse_end : refine_end;
  L.red = L.pk + 4 * align4(K);
  L.total = L.red + align4(2 * NW + 1);
  return L;
}

__device__ __forceinline__ float sq_abs(float re, float im) {
  const float a = hypotf(re, im);  // torch.abs of a complex value, then ** 2
  return __fmul_rn(a, a);
}

__device__ __forceinline__ void cmac(float& re, float& im, float ar, float ai, float br,
                                     float bi) {
  re = fmaf(ar, br, re);
  re = fmaf(-ai, bi, re);
  im = fmaf(ar, bi, im);
  im = fmaf(ai, br, im);
}

__device__ __forceinline__ float2 round_if(float2 v, int one_pass) {
  return one_pass ? make_float2(bf16_round(v.x), bf16_round(v.y)) : v;
}

__device__ __forceinline__ float clamp_like_torch(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// (v, i) better than (w, j): larger, or equal and earlier
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(NT, 3) peak_search_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const Layout L = layout(a.Nb, a.Nd, a.ny, a.nx, a.K, a.P);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Nb = a.Nb, Nd = a.Nd, ny = a.ny, nx = a.nx, K = a.K, P = a.P;
  const int n = Nb * Nd;

  float2* Ph = reinterpret_cast<float2*>(sm + L.phi);
  float2* T = reinterpret_cast<float2*>(sm + L.T);
  float2* D = reinterpret_cast<float2*>(sm + L.D);
  float* Z = sm + L.Z;
  float2* Ss = reinterpret_cast<float2*>(Z);  // S, until Z is written
  uint32_t* cand = reinterpret_cast<uint32_t*>(sm + L.cand);
  float* pk_tau = sm + L.pk;
  float* pk_f = pk_tau + align4(K);
  float* pk_h = pk_f + align4(K);
  float* pk_valid = pk_h + align4(K);
  float* red_v = sm + L.red;
  int* red_i = reinterpret_cast<int*>(red_v + NW);
  int* pick = red_i + NW;

  // ---- 1. coarse -----------------------------------------------------------
  // every global load first: phi, S, Dc^T (coalesced), this lane's offset
  const float2* phi = a.phi + static_cast<size_t>(blockIdx.x) * n;
  for (int i = tid; i < n; i += NT) {
    const float2 v = phi[i];
    Ph[i] = make_float2(v.x, -v.y);
  }
  for (int i = tid; i < ny * Nb; i += NT) Ss[i] = a.S[i];
  for (int i = tid; i < Nd * nx; i += NT) D[i] = a.DcT[i];
  for (int w = tid; w < L.words; w += NT) cand[w] = 0u;
  const float rel = lane < P ? a.rel[lane] : 0.f;
  __syncthreads();
  for (int i = tid; i < Nd * L.ny4; i += NT) {
    const int k = i / L.ny4, y = i - k * L.ny4;
    float re = 0.f, im = 0.f;
    if (y < ny) {
      for (int m = 0; m < Nb; ++m) {
        const float2 s = Ss[y * Nb + m], p = Ph[m * Nd + k];
        cmac(re, im, s.x, s.y, p.x, p.y);
      }
    }
    T[i] = make_float2(re, im);
  }
  __syncthreads();
  const int groups = L.ny4 / RY;
  for (int t = tid; t < groups * nx; t += NT) {
    const int g = t / nx, x = t - g * nx, y0 = g * RY;
    float re[RY], im[RY];
#pragma unroll
    for (int r = 0; r < RY; ++r) re[r] = im[r] = 0.f;
    for (int k = 0; k < Nd; ++k) {
      const float2 d = D[k * nx + x];
      const float4 t01 = *reinterpret_cast<const float4*>(T + k * L.ny4 + y0);
      const float4 t23 = *reinterpret_cast<const float4*>(T + k * L.ny4 + y0 + 2);
      cmac(re[0], im[0], t01.x, t01.y, d.x, d.y);
      cmac(re[1], im[1], t01.z, t01.w, d.x, d.y);
      cmac(re[2], im[2], t23.x, t23.y, d.x, d.y);
      cmac(re[3], im[3], t23.z, t23.w, d.x, d.y);
    }
    // |.|^2 as re^2 + im^2: the grid only seeds the refine, whose heights
    // are the ones reported (as torch.abs ** 2 there)
#pragma unroll
    for (int r = 0; r < RY; ++r)
      if (y0 + r < ny) Z[(y0 + r) * nx + x] = fmaf(re[r], re[r], im[r] * im[r]);
  }
  __syncthreads();

  // ---- 2. select -----------------------------------------------------------
  // local maxima: a thread walks a column's chunk of rows with its 3 x 3
  // window in registers (-inf past the borders; any NaN in it, as in the
  // max-pool, fails the test) and sets the candidates' bits
  const int chunks = nx >= 2 * NT ? 1 : (2 * NT) / nx;
  const int rows = (ny + chunks - 1) / chunks;
  for (int t = tid; t < chunks * nx; t += NT) {
    const int c = t / nx, x = t - c * nx, y0 = c * rows, y1 = min(ny, y0 + rows);
    auto row = [&](int y, float& l, float& m, float& r) {
      const bool in = y >= 0 && y < ny;
      const float* zr = Z + y * nx + x;
      l = in && x > 0 ? zr[-1] : -INFINITY;
      m = in ? zr[0] : -INFINITY;
      r = in && x + 1 < nx ? zr[1] : -INFINITY;
    };
    float a0, a1, a2, b0, b1, b2, c0, c1, c2;
    row(y0 - 1, a0, a1, a2);
    row(y0, b0, b1, b2);
    for (int y = y0; y < y1; ++y) {
      row(y + 1, c0, c1, c2);
      if (b1 >= a0 && b1 >= a1 && b1 >= a2 && b1 >= b0 && b1 >= b2 && b1 >= c0 &&
          b1 >= c1 && b1 >= c2) {
        const int i = y * nx + x;
        atomicOr(cand + (i >> 5), 1u << (i & 31));
      }
      a0 = b0; a1 = b1; a2 = b2;
      b0 = c0; b1 = c1; b2 = c2;
    }
  }
  __syncthreads();

  // each thread owns the words w = tid (mod NT) and keeps its best candidate
  float bv = -INFINITY;
  int bi = INT_MAX;
  auto rescan = [&]() {
    bv = -INFINITY;
    bi = INT_MAX;
    for (int w = tid; w < L.words; w += NT) {
      uint32_t m = cand[w];
      while (m) {
        const int i = w * 32 + __ffs(m) - 1;
        m &= m - 1;
        if (better(Z[i], i, bv, bi)) {
          bv = Z[i];
          bi = i;
        }
      }
    }
  };
  rescan();
  int found = 0;
  for (; found < K; ++found) {
    float v = bv;
    int i = bi;
    warp_best(v, i);
    if (lane == 0) {
      red_v[warp] = v;
      red_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < NW ? red_v[lane] : -INFINITY;
      i = lane < NW ? red_i[lane] : INT_MAX;
      warp_best(v, i);
      if (lane == 0) {
        *pick = i;
        if (i != INT_MAX) {
          const bool ok = isfinite(v);
          pk_valid[found] = ok ? 1.f : 0.f;
          pk_tau[found] = ok ? a.taus[i % nx] : a.tau_lo;
          pk_f[found] = ok ? a.fs[i / nx] : a.f_lo;
        }
      }
    }
    __syncthreads();
    const int p = *pick;
    if (p == INT_MAX) break;  // no candidate left: the block leaves together
    if ((p >> 5) % NT == tid) {
      cand[p >> 5] &= ~(1u << (p & 31));
      rescan();
    }
  }
  for (int j = found + tid; j < K; j += NT) {
    pk_valid[j] = 0.f;
    pk_tau[j] = a.tau_lo;
    pk_f[j] = a.f_lo;
  }
  __syncthreads();  // Z, T, D and cand are dead from here: the refine reuses them
  if (a.one_pass) {
    for (int i = tid; i < n; i += NT) Ph[i] = round_if(Ph[i], 1);
    __syncthreads();
  }

  // ---- 3. refine: one warp a peak --------------------------------------------
  float* tt = sm + L.warp + warp * L.wstride;
  float* ff = tt + align4(P);
  float2* Sw = reinterpret_cast<float2*>(ff + align4(P));
  float2* Dw = Sw + align4(2 * P * Nb) / 2;
  float2* SP = Dw + align4(2 * P * Nd) / 2;
  for (int j = warp; j < K; j += NW) {
    float tau = pk_tau[j], f = pk_f[j], h = 0.f;
    double half_t = a.half_t, half_f = a.half_f;
    for (int r = 0; r < a.iters; ++r) {
      const float ht = static_cast<float>(half_t), hf = static_cast<float>(half_f);
      if (lane < P) {
        tt[lane] = clamp_like_torch(__fadd_rn(tau, __fmul_rn(ht, rel)), a.tau_lo, a.tau_hi);
        ff[lane] = clamp_like_torch(__fadd_rn(f, __fmul_rn(hf, rel)), a.f_lo, a.f_hi);
      }
      __syncwarp();
      for (int e = lane; e < P * Nb; e += 32) {
        const int p = e / Nb, m = e - p * Nb;
        float s, c;
        sincosf(__fmul_rn(__fmul_rn(TWO_PI, ff[p]), static_cast<float>(m)), &s, &c);
        Sw[e] = round_if(make_float2(c, s), a.one_pass);
      }
      for (int e = lane; e < P * Nd; e += 32) {
        const int p = e / Nd, k = e - p * Nd;
        float s, c;
        sincosf(__fmul_rn(__fmul_rn(TWO_PI, tt[p]), static_cast<float>(k)), &s, &c);
        Dw[e] = round_if(make_float2(c, -s), a.one_pass);
      }
      __syncwarp();
      for (int e = lane; e < P * Nd; e += 32) {
        const int p = e / Nd, k = e - p * Nd;
        float re = 0.f, im = 0.f;
        for (int m = 0; m < Nb; ++m) {
          const float2 s = Sw[p * Nb + m], q = Ph[m * Nd + k];
          cmac(re, im, s.x, s.y, q.x, q.y);
        }
        SP[e] = round_if(make_float2(re, im), a.one_pass);
      }
      __syncwarp();
      float v = -INFINITY;
      int vi = INT_MAX;
      for (int e = lane; e < P * P; e += 32) {
        const int p = e / P, q = e - p * P;  // Zl[p][q]: doppler p, delay q
        float re = 0.f, im = 0.f;
        for (int k = 0; k < Nd; ++k) {
          const float2 s = SP[p * Nd + k], d = Dw[q * Nd + k];
          cmac(re, im, s.x, s.y, d.x, d.y);
        }
        const float z = sq_abs(re, im);
        if (better(z, e, v, vi)) {
          v = z;
          vi = e;
        }
      }
      warp_best(v, vi);
      if (vi == INT_MAX) {  // every value NaN: torch.argmax gives the first
        vi = 0;
        v = NAN;
      }
      h = v;
      f = ff[vi / P];
      tau = tt[vi % P];
      __syncwarp();
      half_t *= a.reduce;
      half_f *= a.reduce;
    }
    if (lane == 0) {
      pk_tau[j] = tau;
      pk_f[j] = f;
      pk_h[j] = pk_valid[j] != 0.f ? h : -INFINITY;
    }
  }
  __syncthreads();

  // ---- 4. order: stable, by height descending --------------------------------
  if (warp == 0 && lane < K) {
    const float h = pk_h[lane];
    int rank = 0;
    for (int j = 0; j < K; ++j) {
      const float hj = pk_h[j];
      rank += hj > h || (hj == h && j < lane);
    }
    const size_t o = static_cast<size_t>(blockIdx.x) * K + rank;
    a.tau_out[o] = pk_tau[lane];
    a.f_out[o] = pk_f[lane];
    a.h_out[o] = h;
    a.valid_out[o] = pk_valid[lane] != 0.f;
  }
}

}  // namespace peaks
}  // namespace admmk

// C entry point.  phi: (B, Nb Nd) complex64; S: (ny, Nb), DcT: (Nd, nx)
// complex64 (conjugated, resolved); taus (nx,), fs (ny,), rel (P,)
// float32; tau, f, height: (B, K) float32 and valid (B, K) bool, written.
// K <= 32 (one warp sorts), P <= 32; smem is the caller's count of the
// block's shared memory in bytes.  Returns -1 where smem is not layout's
// total, else the launch's cudaError_t.
extern "C" int peak_search_launch(const void* phi, const void* S, const void* DcT,
                                  const float* taus, const float* fs, const float* rel,
                                  float* tau, float* f, float* height, unsigned char* valid,
                                  int B, int Nb, int Nd, int ny, int nx, int K, int P,
                                  int smem, int iters, int one_pass, float tau_lo, float tau_hi,
                                  float f_lo, float f_hi, double half_t, double half_f,
                                  double reduce, void* stream) {
  using namespace admmk::peaks;
  if (B <= 0 || Nb < 1 || Nd < 1 || ny < 1 || nx < 1 || K < 1 || K > 32 || P < 1 || P > 32 ||
      iters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = layout(Nb, Nd, ny, nx, K, P).total * static_cast<int>(sizeof(float));
  if (bytes != smem) return -1;
  cudaError_t err = cudaFuncSetAttribute(peak_search_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.phi = static_cast<const float2*>(phi);
  a.S = static_cast<const float2*>(S);
  a.DcT = static_cast<const float2*>(DcT);
  a.taus = taus;
  a.fs = fs;
  a.rel = rel;
  a.tau_out = tau;
  a.f_out = f;
  a.h_out = height;
  a.valid_out = valid;
  a.Nb = Nb;
  a.Nd = Nd;
  a.ny = ny;
  a.nx = nx;
  a.K = K;
  a.P = P;
  a.iters = iters;
  a.one_pass = one_pass;
  a.tau_lo = tau_lo;
  a.tau_hi = tau_hi;
  a.f_lo = f_lo;
  a.f_hi = f_hi;
  a.half_t = half_t;
  a.half_f = half_f;
  a.reduce = reduce;
  peak_search_kernel<<<B, NT, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
