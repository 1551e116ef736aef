// Batched GOMP and SP, and the top-k init of OMPR and SRR, stage 1: select.
// For every measurement row b and every tile of kTile atoms, the l largest
// |<r_b, a_j>|, ordered by value descending and then by index ascending.
//
// Replaces the score GEMM and the top-l picks of cstpu/ops/fused_solve.py::
// _gomp_kernel (:788-793, :749-755): there the l appends of an iteration
// take, one after the other, the lowest-index maximum of one score vector
// and mask it out, which is the top-l in that order. A NaN anywhere in the
// row makes every pick INT_MAX there (`scores == smax` fails everywhere, and
// nothing is masked); here a tile holding a NaN writes l (NaN, INT_MAX)
// partials, and the append kernel gives such a row l INT_MAX picks. The same
// partials feed SP's round (cstpu/ops/fused_twostage.py::_sp_kernel) and the
// top-k init of ::_ompr_kernel and ::_srr_kernel (engine_init.cu).
//
// Math as select_argmax.cu: scores = |round_cdt(r) . A_cdt|, products and
// sums in f32. Partials (B, T, l), T = ceil(m / kTile); the ragged atom
// edge, and a tile with fewer than l atoms, give (-inf, INT_MAX) pads, which
// lose to every score.
//
// What bounds it on an H100: the bytes of the dictionary, as for the top-1
// select (B n m multiply-adds per call, 0.54 G at B=64, n=1024, m=8192,
// against 16 MB of bf16), plus a top-l epilogue. Two hand-written variants;
// the Python wrapper picks one by the top-1 selects' predicate on dtype,
// alignment and pitch and passes it as `use_mma`:
//
//   tensor cores (bf16 correlation): mma_topl.cuh, the top-1 selects' wgmma
//     loop (mma_select.cuh) with an epilogue that sorts each row's 128
//     scores of the tile across a warp; its cost does not grow with l.
//   CUDA cores (f32 correlation, and what the loop does not take):
//     common.cuh::score_tile (one thread per atom, kRows rows of r staged in
//     shared memory) and common.cuh::topl_partials, l rounds of a warp argmax
//     per row. That epilogue is NOT small beside the loop: at l = 32 it is
//     about as long as the multiply-adds.
#include "common.cuh"
#include "mma_topl.cuh"

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
// (B, ntiles, l) i32, ntiles = ceil(m / kTile). With use_mma the
// tensor-core variant runs, with rb (B, roundup(n, 8)) bf16 as its scratch
// for the rounded r; it takes bf16 only, A aligned to 16 bytes and m a
// multiple of 8, and the call returns cudaErrorInvalidValue otherwise.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for l out of
// range).
extern "C" int cstpu_select_topl(const float* r, const void* A, int cdt_bf16,
                                 float* pval, int* pidx, int B, int n, int m,
                                 int l, int use_mma, void* rb, void* stream) {
  using namespace cstpu;
  if (l < 1 || l > kTopLMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma) {
    if (!cdt_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(mma::launch_topl(
        r, n, 1, static_cast<__nv_bfloat16*>(rb), A, m, pval, pidx, B, n, m,
        l, s));
  }
  const int ntiles = (m + kTile - 1) / kTile;
  const dim3 grid(ntiles, (B + kRows - 1) / kRows);
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
