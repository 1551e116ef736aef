// Shared device helpers of the batched OMP kernels (select_argmax.cu,
// omp_append.cu): the select tile width, cdt rounding, and the argmax
// rule of cstpu/ops/fused_solve.py::_solve_kernel (:157-163).
#pragma once

#include <climits>
#include <cmath>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cstpu {

// Atoms per select block, and per partial (value, index) it writes.
constexpr int kTile = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to the correlation dtype T (round to nearest even), back in f32.
template <typename T>
__device__ __forceinline__ float round_cdt(float x) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// Max of (value, index) pairs: the larger value wins, ties go to the lower
// index, and a NaN anywhere makes the result (NaN, INT_MAX). That is
// _solve_kernel's rule: a NaN maximum fails every `scores == smax` test, so
// the masked index min returns INT_MAX. The rule is a total order with an
// absorbing element, so any reduction tree gives the same answer.
__device__ __forceinline__ void argmax_combine(float& v, int& i, float v2,
                                               int i2) {
  if (isnan(v) || isnan(v2)) {
    v = __int_as_float(0x7fc00000);
    i = INT_MAX;
  } else if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// argmax_combine over the 32 lanes of a warp; lane 0 holds the result.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    float v2 = __shfl_down_sync(0xffffffffu, v, off);
    int i2 = __shfl_down_sync(0xffffffffu, i, off);
    argmax_combine(v, i, v2, i2);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

}  // namespace cstpu
