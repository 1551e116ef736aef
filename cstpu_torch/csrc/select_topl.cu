// Batched GOMP, stage 1: select. For every measurement row b and every tile
// of kTile atoms, the l largest |<r_b, a_j>|, ordered by value descending
// and then by index ascending.
//
// Replaces the score GEMM and the top-l picks of cstpu/ops/fused_solve.py::
// _gomp_kernel (:788-793, :749-755): there the l appends of an iteration
// take, one after the other, the lowest-index maximum of one score vector
// and mask it out, which is the top-l in that order. A NaN anywhere in the
// row makes every pick INT_MAX there (`scores == smax` fails everywhere, and
// nothing is masked); here a tile holding a NaN writes l (NaN, INT_MAX)
// partials, and the append kernel gives such a row l INT_MAX picks.
//
// Math as select_argmax.cu: scores = |round_cdt(r) . A_cdt|, products and
// sums in f32 on CUDA cores (no TF32).
//
// What bounds it on an H100: the same B*n*m multiply-adds per iteration as
// the OMP select (0.54 G at B=64, n=1024, m=8192); the top-l epilogue is
// small beside them. Design: the main loop is common.cuh::score_tile, as
// in select_argmax.cu (one thread per atom, kRows rows of r staged in
// shared memory); the epilogue stages the block's kRows x kTile scores in
// shared memory and common.cuh::topl_partials takes each row's top l from
// them (order: value descending, index ascending). Partials (B, T, l); the
// ragged atom edge, and a tile with fewer than l atoms, give (-inf,
// INT_MAX) pads, which lose to every score.
#include "common.cuh"

namespace cstpu {

template <typename T>
__global__ void __launch_bounds__(kTile)
select_topl_kernel(const float* __restrict__ r, const T* __restrict__ A,
                   float* __restrict__ pval, int* __restrict__ pidx, int B,
                   int n, int m, int ntiles, int l) {
  __shared__ __align__(16) float rs[kChunk][kRows];
  __shared__ float ss[kRows][kTile];

  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int j = tile * kTile + threadIdx.x;
  const bool live = j < m;

  float acc[kRows];
  score_tile<T>(acc, rs, r, A, row0, j, live, B, n, m);

#pragma unroll
  for (int q = 0; q < kRows; ++q) ss[q][threadIdx.x] = live ? fabsf(acc[q]) : -INFINITY;
  __syncthreads();

  topl_partials(ss, tile, row0, B, m, ntiles, l, pval, pidx);
}

}  // namespace cstpu

// r (B, n) f32, A (n, m) in cdt (bf16 if cdt_bf16 else f32), all
// contiguous, 1 <= l <= kTopLMax; writes pval (B, ntiles, l) f32 and pidx
// (B, ntiles, l) i32, ntiles = ceil(m / kTile). Returns the launch's
// cudaError_t (cudaErrorInvalidValue for l out of range).
extern "C" int cstpu_select_topl(const float* r, const void* A, int cdt_bf16,
                                 float* pval, int* pidx, int B, int n, int m,
                                 int l, void* stream) {
  using namespace cstpu;
  if (l < 1 || l > kTopLMax) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = (m + kTile - 1) / kTile;
  const dim3 grid(ntiles, (B + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cdt_bf16) {
    select_topl_kernel<__nv_bfloat16><<<grid, kTile, 0, s>>>(
        r, static_cast<const __nv_bfloat16*>(A), pval, pidx, B, n, m, ntiles,
        l);
  } else {
    select_topl_kernel<float><<<grid, kTile, 0, s>>>(
        r, static_cast<const float*>(A), pval, pidx, B, n, m, ntiles, l);
  }
  return static_cast<int>(cudaGetLastError());
}
