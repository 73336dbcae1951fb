// Device helpers shared by the kernels: the sign schedule's coefficients,
// bf16 rounding and warp reductions.  The polar PSD kernel (polar.cu, K1)
// and the first-generation fused solve (fused_admm.cu, K7) run on the
// body of polar_cta.cuh; K2 and K3 (fused_admm_fast*.cu) on
// fused_solve_tc.cuh; K4-K6 (cheb_filter.cu, cheb_bwd.cu) on their own
// cluster bodies.  A complex Hermitian matrix is two float planes (real,
// imaginary) of side P (112 or 128), zero-padded past the logical side;
// zero rows and columns stay exactly zero through every product and
// polynomial step, so the padding changes nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace admmk {

constexpr int ROW = 128;      // length of the shared row buffers (>= P)
constexpr int MAX_STEPS = 8;  // longest sign schedule

struct Schedule {
  float a[MAX_STEPS], b[MAX_STEPS], c[MAX_STEPS];
  int n;
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

}  // namespace admmk
